"""The step-timeline flight recorder of the port
(paddle_tpu_torch/observability/timeline.py) and its executor join,
against the reference's (paddle_tpu/observability/timeline.py), on the
CPU.

- Ring semantics: the event cap (PADDLE_TPU_TORCH_PROFILER_EVENT_CAP),
  category and last-steps filters, the Chrome trace export, the
  disarmed path (no ring), the cached arming and its reload.
- ``summarize_trace`` gives the reference's lines on one trace document
  (an exported port trace, handed to both), and the CLI prints them.
- The executor: ``run_steps`` flushes ``trace_<pid>.json`` to the trace
  dir with the reference's event names; its feed, compile, compute and
  update events tile the call (their sum within 5% of ``wall_s``, or 2
  ms on this tiny step); the prefetch path's ``prefetch.stage`` events
  (the first primed); dump-on-error files, their tag sanitized into the
  name; a disarmed executor records nothing; the modelled live-bytes
  counter track peaks at the memory model's peak, and no measured track
  exists off the card; downsampling keeps the peak.
- ``last_step_report``: feed + compute + update == wall, the cost
  model's phases, ``feed_overlap_s`` and ``chunks``; no rate from an
  unsynced call.
"""
import json
import os

import numpy as np
import pytest

from paddle_tpu.observability import timeline as jtimeline

import paddle_tpu_torch as tfl
from paddle_tpu_torch.observability import timeline


@pytest.fixture(autouse=True)
def _fresh_ring(monkeypatch):
    for v in ('TRACE_DIR', 'TRACE_DUMP_ON_ERROR', 'DEVICE_PREFETCH',
              'DEVICE_PREFETCH_CHUNK', 'PROFILER_EVENT_CAP'):
        monkeypatch.delenv('PADDLE_TPU_TORCH_' + v, raising=False)
    timeline.reset()
    yield
    monkeypatch.delenv('PADDLE_TPU_TORCH_TRACE_DIR', raising=False)
    monkeypatch.delenv('PADDLE_TPU_TORCH_TRACE_DUMP_ON_ERROR',
                       raising=False)
    timeline.reset()


def test_ring_records_bounds_and_filters():
    tl = timeline.Timeline(cap=4)
    for i in range(10):
        tl.record('ev%d' % i, cat='user', dur=0.001, step=i)
    evs = tl.events()
    assert [e['name'] for e in evs] == ['ev6', 'ev7', 'ev8', 'ev9']
    tl = timeline.Timeline(cap=None)
    for s in range(6):
        tl.set_step(s)
        tl.record('feed', cat='feed')
        tl.record('user', cat='user')
    assert len(tl.events(cat='feed')) == 6
    assert {e['step'] for e in tl.events(last_steps=2)} == {4, 5}


def test_event_cap_flag_bounds_the_shared_ring(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_PROFILER_EVENT_CAP', '3')
    timeline.reset()
    for i in range(7):
        timeline.record('e%d' % i, dur=0.001)
    assert [e['name'] for e in timeline.ring().events()] == \
        ['e4', 'e5', 'e6']


def test_chrome_trace_export_is_loadable(tmp_path):
    tl = timeline.Timeline(cap=None)
    tl.set_step(3)
    tl.record('executor.dispatch', cat='compute', dur=0.5, args={'k': 8})
    tl.counter_sample('paddle_tpu.device_bytes_in_use', 1024)
    path = tl.export_chrome_trace(str(tmp_path / 'd' / 'trace.json'))
    doc = json.load(open(path))
    evs = doc['traceEvents']
    assert evs[0]['ph'] == 'M'
    x = [e for e in evs if e['ph'] == 'X']
    assert len(x) == 1 and x[0]['name'] == 'executor.dispatch'
    assert x[0]['dur'] == pytest.approx(5e5)
    assert x[0]['args'] == {'k': 8, 'step': 3}
    c = [e for e in evs if e['ph'] == 'C']
    assert c[0]['args'] == {'bytes': 1024}
    assert not os.path.exists(path + '.tmp')


def test_disarmed_is_a_null_path_and_arming_reloads(monkeypatch, tmp_path):
    assert timeline.ring_if_armed() is None and not timeline.armed()
    monkeypatch.setenv('PADDLE_TPU_TORCH_TRACE_DIR', str(tmp_path))
    assert timeline.ring_if_armed() is None     # cached until reloaded
    timeline.reload_armed()
    assert timeline.ring_if_armed() is timeline.ring()
    assert timeline.maybe_flush().endswith('trace_%d.json' % os.getpid())


def _build():
    main, startup = tfl.Program(), tfl.Program()
    with tfl.program_guard(main, startup):
        x = tfl.layers.data(name='x', shape=[16], dtype='float32')
        y = tfl.layers.data(name='y', shape=[1], dtype='float32')
        p = tfl.layers.fc(input=x, size=8)
        loss = tfl.layers.mean(
            x=tfl.layers.square_error_cost(input=p, label=y))
        tfl.optimizer.SGDOptimizer(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _feeds(k, b=4):
    rng = np.random.default_rng(0)
    return [{'x': rng.normal(size=(b, 16)).astype(np.float32),
             'y': rng.normal(size=(b, 1)).astype(np.float32)}
            for _ in range(k)]


def _run_steps(k=3, return_numpy=True):
    main, startup, loss = _build()
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    exe.run_steps(main, feed=_feeds(k), fetch_list=[loss], scope=scope,
                  return_numpy=return_numpy)
    return exe


def _trace(tmp_path):
    files = [f for f in os.listdir(str(tmp_path)) if f.endswith('.json')]
    assert files, 'no trace exported'
    with open(str(tmp_path / files[0])) as f:
        return json.load(f)


def test_last_step_report_phases_sum_to_wall(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_PEAK_TFLOPS', '0.001')
    exe = _run_steps(k=3)
    rep = exe.last_step_report
    assert rep['k'] == 3 and rep['chunks'] == 1
    assert rep['feed_overlap_s'] == 0.0 and rep['synced'] is True
    assert rep['feed_s'] + rep['compute_s'] + rep['update_s'] == \
        pytest.approx(rep['wall_s'])
    ph = rep['phases']
    assert ph['feed']['bytes'] == 3 * 4 * (16 + 1) * 4
    assert ph['feed']['modeled_bytes_per_step'] == 4 * (16 + 1) * 4
    fwd = ph['compute']['per_role_flops']['forward']
    assert fwd == 2 * 4 * 16 * 8
    assert ph['compute']['per_role_flops']['backward'] == 2 * fwd
    assert ph['compute']['mfu'] == pytest.approx(
        ph['compute']['flops_per_s'] / 1e9)
    exe = _run_steps(k=2, return_numpy=False)
    comp = exe.last_step_report['phases']['compute']
    assert comp['flops_per_step'] > 0
    assert 'flops_per_s' not in comp and 'mfu' not in comp


def test_run_steps_flushes_a_trace_whose_phases_tile_the_call(
        tmp_path, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_TRACE_DIR', str(tmp_path))
    timeline.reload_armed()
    exe = _run_steps(k=3)
    doc = _trace(tmp_path)
    xs = [e for e in doc['traceEvents'] if e.get('ph') == 'X']
    names = {e['name'] for e in xs}
    for n in ('executor.feed_stack', 'executor.compile',
              'executor.dispatch', 'executor.scope_update',
              'executor.fetch_sync', 'executor.run_steps'):
        assert n in names, n
    assert any(isinstance(e['args'].get('step'), int) for e in xs)
    # the last call's phase events tile its wall (spans overlap them)
    rep = exe.last_step_report
    last = [e for e in xs if e['cat'] in ('feed', 'compile', 'compute',
                                          'update')
            and e['args']['step'] >= 1]
    total = sum(e['dur'] for e in last) / 1e6
    assert abs(total - rep['wall_s']) <= max(0.05 * rep['wall_s'], 2e-3)
    # the reference's summary reads the port's trace line for line
    assert timeline.summarize_trace(doc) == jtimeline.summarize_trace(doc)
    assert any('executor.dispatch' in ln
               for ln in timeline.summarize_trace(doc))


def test_timeline_cli_summarizes_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv('PADDLE_TPU_TORCH_TRACE_DIR', str(tmp_path))
    timeline.reload_armed()
    _run_steps(k=2)
    path = str(tmp_path / ('trace_%d.json' % os.getpid()))
    assert timeline._cli([path, '--top', '5']) == 0
    out = capsys.readouterr().out
    for s in ('top phases by total wall', 'executor.',
              'per-step phase walls', 'counter tracks',
              'paddle_tpu.modeled_live_bytes.bytes'):
        assert s in out, s
    assert timeline.summarize_trace({'traceEvents': []}) == \
        jtimeline.summarize_trace({'traceEvents': []})


def test_prefetch_path_emits_stage_events(tmp_path, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_TRACE_DIR', str(tmp_path))
    monkeypatch.setenv('PADDLE_TPU_TORCH_DEVICE_PREFETCH', '1')
    monkeypatch.setenv('PADDLE_TPU_TORCH_DEVICE_PREFETCH_CHUNK', '2')
    timeline.reload_armed()
    exe = _run_steps(k=4)
    assert exe.last_step_report['chunks'] == 2
    stage = [e for e in timeline.ring().events(cat='feed')
             if e['name'] == 'prefetch.stage']
    assert len(stage) == 2
    assert stage[0]['args']['primed'] is True
    assert stage[1]['args']['primed'] is False


def test_dump_on_error_writes_forensics_files(tmp_path, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_TRACE_DIR', str(tmp_path))
    monkeypatch.setenv('PADDLE_TPU_TORCH_TRACE_DUMP_ON_ERROR', '1')
    timeline.reload_armed()
    main, startup, loss = _build()
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(Exception):
        exe.run_steps(main, feed=[{'x': np.zeros((4, 16), np.float32)}],
                      fetch_list=[loss], scope=scope)
    err = [f for f in os.listdir(str(tmp_path)) if '_error' in f]
    assert err == ['trace_%d_error.json' % os.getpid()]
    assert 'traceEvents' in json.load(open(str(tmp_path / err[0])))
    timeline.record('something', cat='user', dur=0.001)
    path = timeline.maybe_dump_on_error(tag='b7/v1 x')
    assert os.path.basename(path) == \
        'trace_%d_error_b7_v1_x.json' % os.getpid()


def test_disarmed_executor_records_nothing():
    _run_steps(k=2)
    cats = {e['cat'] for e in timeline.ring().events()}
    assert not cats & {'feed', 'compute', 'compile', 'update'}


def test_memory_counter_track_schema(tmp_path, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_TRACE_DIR', str(tmp_path))
    timeline.reload_armed()
    exe = _run_steps(k=3)
    counters = [e for e in _trace(tmp_path)['traceEvents']
                if e.get('ph') == 'C']
    modeled = [e for e in counters
               if e['name'] == 'paddle_tpu.modeled_live_bytes']
    assert modeled
    for e in modeled:
        assert e['cat'] == 'memory' and set(e['args']) == {'bytes'}
        assert isinstance(e['args']['bytes'], int) and 'dur' not in e
    peak = exe.last_step_report['memory']['modeled_peak_bytes']
    assert max(e['args']['bytes'] for e in modeled) == peak
    # off the card no measured track: honestly absent, not zeros
    assert not [e for e in counters
                if e['name'] == 'paddle_tpu.device_bytes_in_use']
    assert timeline.device_memory_stats('cpu') is None


def test_counter_downsampling_keeps_the_peak():
    tl = timeline.Timeline(cap=None)
    pts = [{'op_seq': i, 'live_bytes': 10 + (10 ** 6 if i == 333
                                             else i % 7)}
           for i in range(500)]
    tfl.Executor._emit_memory_counters(tl, {'timeline': pts}, t0=0.0,
                                       span=1.0)
    evs = [e for e in tl.events() if e.get('ph') == 'C']
    assert 0 < len(evs) <= 100
    assert max(e['args']['bytes'] for e in evs) == 10 + 10 ** 6
