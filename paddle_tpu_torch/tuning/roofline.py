"""Roofline model over the static cost report, at the H100's peaks.

Port of paddle_tpu/tuning/roofline.py.  Turns transpiler/cost_model.py's
per-op FLOPs and bytes into modelled time floors: an op's floor is
max(flops / peak FLOP/s, bytes / memory rate), its limiting resource the
term that wins ('compute' or 'hbm'), and the program's floor the sum
(ops taken one after another, so the floor is optimistic; the gap ratio
absorbs the rest).  Two consumers:

- the autotuner's prior: ``modeled_step_s`` scores candidates before
  anything is measured, so modelled-worse configurations are pruned for
  free;
- the roofline report (``report`` / ``format_report``): the top ops by
  modelled floor, each with its limiting resource and its share of a
  measured gap.

The peaks are those of an NVIDIA H100 80GB HBM3 (the SXM part) at its
700 W power limit:

- float32: 67 TFLOP/s on the CUDA cores.  The port keeps TF32 off, so
  float32 GEMMs and convolutions run there;
- bf16 and f16: 989 TFLOP/s dense on the tensor cores;
- HBM: 3.35 TB/s.

Departure from the reference, which takes one peak (192 TFLOP/s, 819
GB/s: a TPU v5e's figures; its MXU runs float32 matmuls too): the
default peak here follows the plan's compute dtype, the AMP mode
(PADDLE_TPU_TORCH_AMP '0' versus 'bf16' / 'f16'), since one peak would
misprice the ``amp`` tunable's candidates by about 15x on this card.
PADDLE_TPU_TORCH_PEAK_TFLOPS and PADDLE_TPU_TORCH_HBM_GBPS override both.
The collective term is the reference's, priced only when a caller gives
a link rate (the port's cost report has no collectives until
distribution, ROADMAP.md Queue 1 item 10).
"""

__all__ = ['DEVICE', 'PEAK_TFLOPS', 'DEFAULT_HBM_GBPS', 'compute_dtype',
           'resolved_peak_tflops', 'resolved_hbm_gbps', 'modeled_step_s',
           'report', 'format_report']

DEVICE = 'NVIDIA H100 80GB HBM3 (SXM), 700 W power limit'
# peak TFLOP/s by compute dtype on DEVICE: float32 on the CUDA cores
# (TF32 off), 16-bit on the tensor cores (dense)
PEAK_TFLOPS = {'float32': 67.0, 'bfloat16': 989.0, 'float16': 989.0}
DEFAULT_HBM_GBPS = 3350.0     # DEVICE's HBM3

_AMP_DTYPE = {'0': 'float32', 'bf16': 'bfloat16', 'f16': 'float16'}


def compute_dtype(amp=None):
    """The dtype a plan's matmuls and convolutions compute in under the
    AMP mode ``amp`` (None: PADDLE_TPU_TORCH_AMP now)."""
    if amp is None:
        from ..flags import FLAGS
        amp = FLAGS.amp
    amp = str(amp or '0').strip().lower()
    return _AMP_DTYPE.get(amp, 'float32')


def resolved_peak_tflops(amp=None):
    """PADDLE_TPU_TORCH_PEAK_TFLOPS when > 0, else DEVICE's peak for the
    compute dtype of ``amp``."""
    from ..flags import FLAGS
    v = float(FLAGS.peak_tflops or 0.0)
    return v if v > 0 else PEAK_TFLOPS[compute_dtype(amp)]


def resolved_hbm_gbps():
    from ..flags import FLAGS
    v = float(FLAGS.hbm_gbps or 0.0)
    return v if v > 0 else DEFAULT_HBM_GBPS


def _resources(peak_tflops, hbm_gbps, amp):
    peak = peak_tflops if peak_tflops else resolved_peak_tflops(amp)
    hbm = hbm_gbps if hbm_gbps else resolved_hbm_gbps()
    return float(peak) * 1e12, float(hbm) * 1e9


def _collective_s(cost, ici_gbps=None):
    coll = cost.get('collectives') or {}
    split = coll.get('bytes') or {}
    ici_bytes = split.get('exposed', coll.get('ici_bytes')) or 0
    if ici_bytes and ici_gbps:
        return ici_bytes / (ici_gbps * 1e9)
    return 0.0


def modeled_step_s(cost, peak_tflops=None, hbm_gbps=None, ici_gbps=None,
                   amp=None):
    """Modelled step-time floor of a whole cost report: the program's
    max(flops / peak, bytes / rate) plus the collective term.  The
    autotuner's prior: cheap, deterministic, monotone in what the search
    compares."""
    total = cost.get('total') or {}
    flops = total.get('flops') or 0
    nbytes = total.get('bytes') or 0
    peak_fs, hbm_bs = _resources(peak_tflops, hbm_gbps, amp)
    return max(flops / peak_fs, nbytes / hbm_bs) + \
        _collective_s(cost, ici_gbps)


def report(cost, measured_step_s=None, peak_tflops=None, hbm_gbps=None,
           ici_gbps=None, top=3, amp=None):
    """Roofline report dict of one cost report.

    Per-op floors rank the ops; with a measured step time the gap ratio
    (measured / floor) attributes the lost time to each op in proportion
    to its modelled floor (``lost_s``), under the uniform-slowdown
    assumption ``basis`` states.  ``peak_tflops``, ``hbm_gbps``,
    ``compute_dtype`` and ``device`` say which peaks priced it."""
    peak_fs, hbm_bs = _resources(peak_tflops, hbm_gbps, amp)
    ops = []
    for e in cost.get('per_op') or ():
        flops = e.get('flops') or 0
        nbytes = e.get('bytes') or 0
        t_compute = flops / peak_fs
        t_hbm = nbytes / hbm_bs
        floor = max(t_compute, t_hbm)
        if floor <= 0:
            continue
        ops.append({
            'index': e.get('index'),
            'type': e.get('type'),
            'role': e.get('role'),
            'floor_s': floor,
            'bound': 'compute' if t_compute >= t_hbm else 'hbm',
            'flops': flops,
            'bytes': nbytes,
        })
    op_floor = sum(o['floor_s'] for o in ops)
    coll_s = _collective_s(cost, ici_gbps)
    floor = op_floor + coll_s
    ops.sort(key=lambda o: (-o['floor_s'], o['index'] or 0))
    rep = {
        'floor_s': floor,
        'collective_s': coll_s,
        'peak_tflops': peak_fs / 1e12,
        'hbm_gbps': hbm_bs / 1e9,
        'compute_dtype': compute_dtype(amp),
        'device': DEVICE,
        'op_count': len(ops),
        'top': ops[:max(int(top), 0)],
        'basis': ('per-op floor = max(flops/peak, bytes/hbm_bw), '
                  'program floor = sum of op floors (+ modeled '
                  'collective); measured gap attributed to ops in '
                  'proportion to their modeled floor'),
    }
    if floor > 0:
        for o in rep['top']:
            o['share'] = o['floor_s'] / floor
    if measured_step_s is not None and floor > 0:
        gap = measured_step_s / floor
        rep['measured_step_s'] = measured_step_s
        rep['gap'] = gap
        total_flops = (cost.get('total') or {}).get('flops') or 0
        if measured_step_s > 0:
            rep['mfu'] = total_flops / (measured_step_s * peak_fs)
        for o in rep['top']:
            o['lost_s'] = o['floor_s'] * max(gap - 1.0, 0.0)
    return rep


def format_report(rep):
    """Printable lines of a report, the peaks it used included."""
    lines = []
    head = ('roofline: floor %.3gms' % (rep['floor_s'] * 1e3))
    if 'measured_step_s' in rep:
        head += (', measured %.3gms (%.2fx off roofline'
                 % (rep['measured_step_s'] * 1e3, rep['gap']))
        if 'mfu' in rep:
            head += ', mfu %.3f' % rep['mfu']
        head += ')'
    head += (' [peak %g TFLOP/s %s, hbm %g GB/s; %s]'
             % (rep['peak_tflops'], rep.get('compute_dtype', '?'),
                rep['hbm_gbps'], rep.get('device', '?')))
    lines.append(head)
    for i, o in enumerate(rep['top'], 1):
        row = ('  #%d %s (op %s, %s): floor %.3gms, %.1f%% of program, '
               '%s-bound'
               % (i, o['type'], o['index'], o.get('role') or '?',
                  o['floor_s'] * 1e3, 100.0 * o.get('share', 0.0),
                  o['bound']))
        if 'lost_s' in o:
            row += ', ~%.3gms of the gap' % (o['lost_s'] * 1e3)
        lines.append(row)
    return '\n'.join(lines)
