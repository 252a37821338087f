"""Profiler on ``torch.profiler``.

Reference parity: paddle_tpu/profiler.py (python/paddle/v2/fluid/
profiler.py: ``profiler``, ``cuda_profiler``, ``reset_profiler``), with
``torch.profiler`` in the place of ``jax.profiler``: a traced region is
written as a Chrome trace (``*.pt.trace.json``) under ``log_dir``, and
``profile_table`` reads the newest one back into the reference's
ParseEvents table (platform/profiler.cc): one row per device kernel,
copy or fill, with calls, total, min, max and mean microseconds.  On the
card the port's hand-written kernels appear there under their symbol
names (``fa_fwd_kernel``, ``dense_update_kernel``, ...); a trace with no
device events (a CPU run) tabulates its host events instead.

Host-side events (``RecordEvent``, the ``profiler()`` region) record into
the one process event ring (observability/timeline.py), the same ring the
step-timeline recorder uses, so both land on one exported trace;
``get_events()`` returns the ``user`` category's ``(name, seconds)``.

``cost_analysis`` returns the port's static cost model's totals
(transpiler/cost_model.py) under the reference's keys (``flops``,
``bytes accessed``): the reference reads them from XLA's
``cost_analysis()`` of the compiled step, which the port does not have.
"""
import contextlib
import glob
import json
import os
import time

from .observability import timeline as _timeline

__all__ = ['profiler', 'cuda_profiler', 'CudaProfiler',
           'reset_profiler', 'RecordEvent', 'get_events',
           'start_profiler', 'stop_profiler', 'profile_table',
           'cost_analysis']

# chrome-trace categories of device work in a torch.profiler trace
_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')

_active = None        # the running torch.profiler.profile, if any
_last_log_dir = None


def _event_cap():
    """PADDLE_TPU_TORCH_PROFILER_EVENT_CAP as a deque maxlen (None means
    unbounded); it bounds the shared timeline ring."""
    from .flags import FLAGS
    cap = int(FLAGS.profiler_event_cap)
    return cap if cap > 0 else None


def _log_dir(log_dir):
    if log_dir is None:
        from .flags import FLAGS
        log_dir = FLAGS.profile_dir
    return log_dir


def _activities(state):
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if str(state).upper() != 'CPU' and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def start_profiler(state='All', log_dir=None):
    """Start a ``torch.profiler`` trace: host events, and the card's
    kernels, copies and fills unless ``state`` is ``'CPU'``."""
    global _active, _last_log_dir
    from torch.profiler import profile
    if _active is not None:
        raise RuntimeError("a profiler trace is already running")
    log_dir = _log_dir(log_dir)
    os.makedirs(log_dir, exist_ok=True)
    acts = _activities(state)
    prof = profile(activities=acts)
    prof.__enter__()
    if len(acts) > 1:
        # the card idle when the trace opens: no kernel of earlier work
        # runs into the window
        import torch
        torch.cuda.synchronize()
    _active = (prof, log_dir)
    _last_log_dir = log_dir


def stop_profiler(sorted_key=None, profile_path=None):
    """Stop the trace and write it to the log dir; with ``sorted_key``
    print (and write to ``profile_path``) the per-kernel table, sorted by
    ``sorted_key`` in {'calls', 'total', 'max', 'min', 'ave'}.  Returns
    the table, or None without a key."""
    global _active
    if _active is None:
        raise RuntimeError("no profiler trace is running")
    prof, log_dir = _active
    _active = None
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        # every kernel of the region has run before the trace closes
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    path = os.path.join(log_dir, 'paddle_tpu_torch_%d_%d.pt.trace.json'
                        % (os.getpid(), int(time.time() * 1e6)))
    prof.export_chrome_trace(path)
    if sorted_key is None:
        return None
    table = profile_table(sorted_key=sorted_key, log_dir=log_dir)
    print(table)
    if profile_path:
        with open(profile_path, 'w') as f:
            f.write(table)
    return table


@contextlib.contextmanager
def profiler(state='All', sorted_key=None, log_dir=None):
    """Trace the enclosed region with ``torch.profiler``; on exit a
    ``sorted_key`` prints the per-kernel table (the reference's
    profiler.cc ParseEvents table)."""
    t0 = time.perf_counter()
    start_profiler(state, log_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key)
        _timeline.record('profile_region', cat='user',
                         t0=t0, dur=time.perf_counter() - t0)


# The reference exposes cuda_profiler / CudaProfiler; here they are the
# same torch.profiler context.
cuda_profiler = profiler
CudaProfiler = profiler


def profile_rows(log_dir=None):
    """{name: [calls, total_us, min_us, max_us]} of the newest trace in
    ``log_dir``: its device events (kernels, copies, fills) when it has
    any, else its host events."""
    log_dir = log_dir or _last_log_dir or _log_dir(None)
    files = sorted(glob.glob(os.path.join(glob.escape(log_dir),
                                          '*.pt.trace.json')),
                   key=os.path.getmtime)
    if not files:
        return {}
    with open(files[-1]) as f:
        trace = json.load(f)
    events = [e for e in trace.get('traceEvents', [])
              if e.get('ph') == 'X' and 'dur' in e and e.get('name')]
    device = [e for e in events if e.get('cat') in _DEVICE_CATS]
    rows = {}
    for e in device or events:
        d = float(e['dur'])
        row = rows.get(e['name'])
        if row is None:
            rows[e['name']] = [1, d, d, d]
        else:
            row[0] += 1
            row[1] += d
            row[2] = min(row[2], d)
            row[3] = max(row[3], d)
    return rows


def profile_table(sorted_key='total', log_dir=None):
    """The per-kernel table of the newest trace in ``log_dir`` (default:
    the directory the last trace used)."""
    key = (sorted_key or 'total').lower()
    order = {'calls': lambda r: r[1][0], 'total': lambda r: r[1][1],
             'min': lambda r: r[1][2], 'max': lambda r: r[1][3],
             'ave': lambda r: r[1][1] / r[1][0]}
    if key not in order:
        raise ValueError("sorted_key must be one of %s, got %r"
                         % (sorted(order), sorted_key))
    rows = profile_rows(log_dir)
    lines = ["%-52s %8s %12s %12s %12s %12s" %
             ("Event", "Calls", "Total(us)", "Min(us)", "Max(us)",
              "Ave(us)")]
    for name, (calls, total, mn, mx) in sorted(
            rows.items(), key=order[key], reverse=True):
        lines.append("%-52s %8d %12.1f %12.1f %12.1f %12.1f" %
                     (name[:52], calls, total, mn, mx, total / calls))
    return "\n".join(lines)


def reset_profiler():
    """Drop recorded events and re-read the event-cap flag: this resets
    the shared ring, the executor's timeline events with the profiler's,
    and re-reads the trace arming flags."""
    _timeline.reset(cap=_event_cap())


class RecordEvent(object):
    """Named host-side timing region (platform::RecordEvent): annotates
    profiler traces (``torch.profiler.record_function``) and records into
    the shared ring under the ``user`` category."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        from torch.profiler import record_function
        self._ann = record_function(self.name)
        self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _timeline.record(self.name, cat='user', t0=self._t0,
                         dur=time.perf_counter() - self._t0)
        self._ann.__exit__(*exc)
        return False


def get_events():
    """``(name, seconds)`` of the user-recorded events (RecordEvent,
    profile regions) in the shared ring; the executor's events there are
    in other categories and left out."""
    return [(e['name'], e['dur'])
            for e in _timeline.ring().events(cat='user')]


def cost_analysis(program, feed, fetch_list, scope=None, place=None):
    """One step's static costs from the port's cost model, under the keys
    the reference reads from XLA's ``cost_analysis()``: ``flops`` and
    ``bytes accessed`` a step.  ``place`` None means the card."""
    from .core.executor import Executor
    exe = Executor(place)
    program, scope, fetch_names = exe._resolve(program, scope, fetch_list)
    staged = exe._stage_feed(program.global_block(), feed or {})
    plan = exe._plan(program, fetch_names, staged)[0]
    total = ((plan.report.get('cost') or {}).get('total')) or {}
    return {'flops': float(total.get('flops', 0.0)),
            'bytes accessed': float(total.get('bytes', 0.0))}
