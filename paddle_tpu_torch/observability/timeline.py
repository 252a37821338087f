"""Step-timeline flight recorder: ONE bounded event ring for the process.

Reference parity: paddle_tpu/observability/timeline.py.  The executor
runs a program op by op, so where the time goes is read a level up, per
step and phase: feed staging, plan build, compute, scope update and
prefetch staging, recorded at the instrumentation points the executor,
the prefetch pipeline and the servers already own.  Categories and event
names are the reference's, so a trace of either package reads the same.

- Bounded ring: a deque capped by ``PADDLE_TPU_TORCH_PROFILER_EVENT_CAP``;
  profiler.py's ``RecordEvent`` records into it too, so one event buffer
  exists.  Events are dicts ``{name, cat, ts, dur, step, tid, args}``
  with ``ts`` in seconds from the process clock origin.
- Chrome trace export: ``export_chrome_trace(path)`` writes the ring as
  ``trace_event`` JSON (``ph: "X"`` events), loadable in Perfetto or
  ``chrome://tracing``, by atomic replace.  With
  ``PADDLE_TPU_TORCH_TRACE_DIR`` set the executor flushes
  ``trace_<pid>.json`` there after every ``run_steps`` call.
- Crash forensics: ``PADDLE_TPU_TORCH_TRACE_DUMP_ON_ERROR=1`` makes the
  executor dump the last ``PADDLE_TPU_TORCH_TRACE_STEPS`` steps to
  ``trace_<pid>_error.json`` on an exception; the servers' dispatch
  threads dump with their tag (``trace_<pid>_error_<tag>.json``).
- Counter tracks: :meth:`Timeline.counter_sample` samples export as
  Chrome ``ph: "C"`` events: the memory model's live bytes along the
  step and the card's measured bytes in use
  (``torch.cuda.memory_stats``, :func:`device_memory_stats`).
- Summary CLI: ``python -m paddle_tpu_torch.observability.timeline
  <trace.json>`` prints the top phases by total wall, a per-step phase
  table and each counter track's min, max and last value.

Zero cost when disarmed: instrumented sites call :func:`ring_if_armed`,
one cached-bool check, with no ring allocation and no clock read (no
trace dir and dump-on-error off).  The profiler API (``RecordEvent``,
``profiler()``) records whatever the arming, bounded by the cap.
"""
import collections
import json
import os
import threading
import time

__all__ = ['ring', 'ring_if_armed', 'armed', 'reload_armed', 'reset',
           'record', 'set_step', 'export_chrome_trace', 'maybe_flush',
           'maybe_dump_on_error', 'device_memory_stats', 'Timeline']

# process clock origin: every event's ts is perf_counter-relative to
# this, so exported traces start near t=0 instead of an opaque epoch
_PC0 = time.perf_counter()

# event categories (the `cat` field; Perfetto colors/filters by it)
CATEGORIES = ('feed', 'compute', 'compile', 'update', 'collective',
              'donation', 'span', 'user', 'memory')


def _event_cap():
    """PADDLE_TPU_TORCH_PROFILER_EVENT_CAP as a deque maxlen (None means
    unbounded): one bound shared with the profiler API, whose RecordEvent
    a long-lived server may wrap around every request."""
    from ..flags import FLAGS
    cap = int(FLAGS.profiler_event_cap)
    return cap if cap > 0 else None


class Timeline(object):
    """Thread-safe bounded ring of timing events."""

    def __init__(self, cap):
        self._lock = threading.Lock()
        self._dq = collections.deque(maxlen=cap)
        self._step = 0

    def set_step(self, step):
        """Current global step — events recorded without an explicit
        ``step`` are stamped with it (the executor advances it)."""
        self._step = int(step)

    @property
    def step(self):
        return self._step

    def record(self, name, cat='user', t0=None, dur=0.0, step=None,
               args=None):
        """Append one complete event.  ``t0`` is a time.perf_counter()
        reading (defaults to now - dur); ``dur`` is seconds."""
        if t0 is None:
            t0 = time.perf_counter() - dur
        e = {'name': name, 'cat': cat, 'ts': t0 - _PC0,
             'dur': float(dur),
             'step': self._step if step is None else int(step),
             'tid': threading.get_ident(), 'args': args}
        with self._lock:
            self._dq.append(e)

    def counter_sample(self, name, value, cat='memory', t0=None,
                       step=None):
        """Append one counter sample (Chrome ``ph:"C"`` on export): a
        stepped series — live bytes along op_seq, measured device
        bytes-in-use — rendered as its own counter track in Perfetto.
        ``value`` lands in ``args['bytes']``."""
        if t0 is None:
            t0 = time.perf_counter()
        e = {'name': name, 'cat': cat, 'ts': t0 - _PC0, 'dur': 0.0,
             'step': self._step if step is None else int(step),
             'tid': threading.get_ident(), 'ph': 'C',
             'args': {'bytes': int(value)}}
        with self._lock:
            self._dq.append(e)

    def events(self, cat=None, last_steps=0):
        """Snapshot of the ring, optionally filtered to one category
        and/or to events of the trailing ``last_steps`` steps."""
        with self._lock:
            evs = list(self._dq)
        if cat is not None:
            evs = [e for e in evs if e['cat'] == cat]
        if last_steps:
            steps = [e['step'] for e in evs]
            if steps:
                floor = max(steps) - int(last_steps)
                evs = [e for e in evs if e['step'] > floor]
        return evs

    def clear(self):
        with self._lock:
            self._dq.clear()

    def export_chrome_trace(self, path, last_steps=0):
        """Write the ring as Chrome ``trace_event`` JSON (Perfetto /
        chrome://tracing loadable).  Atomic: writes ``path + '.tmp'``
        then os.replace, so a reader never sees a torn file.  Returns
        ``path``."""
        evs = self.events(last_steps=last_steps)
        pid = os.getpid()
        trace_events = [
            {'name': 'process_name', 'ph': 'M', 'pid': pid, 'tid': 0,
             'args': {'name': 'paddle_tpu executor (pid %d)' % pid}}]
        for e in evs:
            if e.get('ph') == 'C':
                # counter sample: args hold exactly the series values
                # (adding `step` here would graph as a second series)
                te = {'name': e['name'], 'cat': e['cat'], 'ph': 'C',
                      'ts': round(e['ts'] * 1e6, 3), 'pid': pid,
                      'tid': 0, 'args': dict(e['args'] or {})}
            else:
                te = {'name': e['name'], 'cat': e['cat'], 'ph': 'X',
                      'ts': round(e['ts'] * 1e6, 3),
                      'dur': round(e['dur'] * 1e6, 3),
                      'pid': pid, 'tid': e['tid'],
                      'args': dict(e['args'] or {}, step=e['step'])}
            trace_events.append(te)
        doc = {'traceEvents': trace_events, 'displayTimeUnit': 'ms'}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


_ring = None
_ring_lock = threading.Lock()
# cached (record_armed, flush_armed, dump_armed) — the executor hot path
# asks once per call; an os.environ read per step would be measurable
_armed = None


def ring():
    """The process-wide ring (created lazily with the flag cap)."""
    global _ring
    if _ring is None:
        with _ring_lock:
            if _ring is None:
                _ring = Timeline(_event_cap())
    return _ring


def _armed_tuple():
    global _armed
    if _armed is None:
        from ..flags import FLAGS
        trace_dir = (FLAGS.trace_dir or '').strip()
        dump = bool(FLAGS.trace_dump_on_error)
        _armed = (bool(trace_dir) or dump, bool(trace_dir), dump)
    return _armed


def armed():
    """True when executor-side timeline recording is on: a trace dir is
    configured (PADDLE_TPU_TORCH_TRACE_DIR) or dump-on-error is armed."""
    return _armed_tuple()[0]


def ring_if_armed():
    """The ring when recording is armed, else None — the one-cached-bool
    guard executor instrumentation sites use."""
    return ring() if _armed_tuple()[0] else None


def reload_armed():
    """Drop the cached arming so the next check re-reads the flags."""
    global _armed
    _armed = None


def reset(cap=None):
    """Clear the ring and re-read the caps/arming flags (the profiler's
    reset_profiler() contract, now covering the shared ring).  ``cap``
    overrides the flag-derived event cap."""
    global _ring
    with _ring_lock:
        _ring = Timeline(_event_cap() if cap is None else (cap or None))
    reload_armed()


def record(name, cat='user', t0=None, dur=0.0, step=None, args=None):
    """Record into the process ring unconditionally (legacy profiler
    path).  Executor sites use ring_if_armed() instead."""
    ring().record(name, cat=cat, t0=t0, dur=dur, step=step, args=args)


def set_step(step):
    ring().set_step(step)


def export_chrome_trace(path, last_steps=0):
    return ring().export_chrome_trace(path, last_steps=last_steps)


def _trace_path(suffix=''):
    from ..flags import FLAGS
    d = (FLAGS.trace_dir or '').strip() or FLAGS.profile_dir
    return os.path.join(d, 'trace_%d%s.json' % (os.getpid(), suffix))


def maybe_flush():
    """Export the ring to PADDLE_TPU_TORCH_TRACE_DIR when configured (called
    by the executor after run_steps).  Returns the path or None."""
    if not _armed_tuple()[1]:
        return None
    from ..flags import FLAGS
    try:
        return ring().export_chrome_trace(
            _trace_path(), last_steps=int(FLAGS.trace_steps))
    except OSError:
        return None  # an unwritable trace dir must not fail the step


def maybe_dump_on_error(tag=None):
    """Flush the last-N-steps ring on an executor/dispatch exception
    when PADDLE_TPU_TORCH_TRACE_DUMP_ON_ERROR is armed (crash forensics).
    ``tag`` distinguishes non-executor dump sites — the serving
    dispatch threads pass their server id / fleet+version so a
    mid-rollout crash says WHOSE timeline this is
    (``trace_<pid>_error_<tag>.json``).  Never raises — the original
    exception must surface, not a dump failure."""
    if not _armed_tuple()[2]:
        return None
    try:
        from ..flags import FLAGS
        suffix = '_error'
        if tag:
            import re
            suffix += '_' + re.sub(r'[^A-Za-z0-9_.-]', '_', str(tag))
        return ring().export_chrome_trace(
            _trace_path(suffix), last_steps=int(FLAGS.trace_steps))
    except Exception:
        return None


def device_memory_stats(device=None):
    """The card's measured memory from the caching allocator's counters
    (``torch.cuda.memory_stats``, read on the host: no device sync), under
    the reference's keys: ``bytes_in_use`` / ``peak_bytes_in_use`` (bytes
    allocated to tensors, now and at the peak since the last
    ``torch.cuda.reset_peak_memory_stats``) and ``bytes_reserved`` /
    ``peak_bytes_reserved`` (held by the allocator).  None off the card
    (a CPU device, or no CUDA), so a report can say ``measured: None``
    rather than print a made-up zero."""
    try:
        import torch
        if device is None:
            if not torch.cuda.is_available():
                return None
            device = torch.device('cuda', torch.cuda.current_device())
        device = torch.device(device)
        if device.type != 'cuda':
            return None
        ms = torch.cuda.memory_stats(device)
    except Exception:
        return None
    if not ms:
        return None
    keys = {'bytes_in_use': 'allocated_bytes.all.current',
            'peak_bytes_in_use': 'allocated_bytes.all.peak',
            'bytes_reserved': 'reserved_bytes.all.current',
            'peak_bytes_reserved': 'reserved_bytes.all.peak'}
    out = {k: int(ms[v]) for k, v in keys.items() if v in ms}
    return out or None


# ---------------------------------------------------------------------------
# summary CLI: triage an exported trace without loading Perfetto
# ---------------------------------------------------------------------------

def summarize_trace(doc, top=10, step_rows=16):
    """Summarize a Chrome trace_event document (the dict form of an
    exported ``trace_<pid>.json``) into printable lines: top-N phases
    by total wall, a per-step phase-wall table, and min/max per memory
    counter track.  Pure — the CLI prints its return value, tests
    assert on it."""
    evs = doc.get('traceEvents', [])
    spans = [e for e in evs if e.get('ph') == 'X']
    counters = [e for e in evs if e.get('ph') == 'C']

    lines = []
    by_name = {}
    for e in spans:
        agg = by_name.setdefault(e['name'], [0, 0.0])
        agg[0] += 1
        agg[1] += float(e.get('dur', 0.0))
    lines.append('top phases by total wall (%d span events):'
                 % len(spans))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    for name, (count, total_us) in ranked:
        lines.append('  %-34s %8.3f ms  x%d' % (name, total_us / 1e3,
                                                count))

    by_step = {}
    for e in spans:
        step = (e.get('args') or {}).get('step')
        if step is None:
            continue
        row = by_step.setdefault(int(step), {})
        cat = e.get('cat', 'user')
        row[cat] = row.get(cat, 0.0) + float(e.get('dur', 0.0))
    if by_step:
        cats = sorted({c for row in by_step.values() for c in row})
        lines.append('')
        lines.append('per-step phase walls (ms), last %d steps:'
                     % step_rows)
        lines.append('  %-8s' % 'step'
                     + ''.join('%12s' % c for c in cats))
        for step in sorted(by_step)[-step_rows:]:
            row = by_step[step]
            lines.append('  %-8d' % step + ''.join(
                '%12.3f' % (row.get(c, 0.0) / 1e3) for c in cats))

    if counters:
        series = {}
        for e in counters:
            for k, v in (e.get('args') or {}).items():
                s = series.setdefault('%s.%s' % (e['name'], k), [])
                s.append(float(v))
        lines.append('')
        lines.append('counter tracks (min / max / last):')
        for name in sorted(series):
            vals = series[name]
            lines.append('  %-44s %14.0f %14.0f %14.0f'
                         % (name, min(vals), max(vals), vals[-1]))
    if not spans and not counters:
        lines.append('(trace carries no span or counter events)')
    return lines


def _cli(argv):
    import argparse
    ap = argparse.ArgumentParser(
        prog='python -m paddle_tpu_torch.observability.timeline',
        description='Summarize an exported Chrome trace '
                    '(PADDLE_TPU_TORCH_TRACE_DIR flight-recorder output): '
                    'top phases by wall, per-step phase table, memory '
                    'counter min/max.')
    ap.add_argument('trace', help='path to a trace_<pid>.json export')
    ap.add_argument('--top', type=int, default=10,
                    help='how many phases to rank (default 10)')
    ap.add_argument('--steps', type=int, default=16,
                    help='trailing steps in the per-step table '
                         '(default 16)')
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)
    for line in summarize_trace(doc, top=args.top,
                                step_rows=args.steps):
        print(line)
    return 0


if __name__ == '__main__':  # pragma: no cover - exercised via tests
    import sys
    sys.exit(_cli(sys.argv[1:]))
