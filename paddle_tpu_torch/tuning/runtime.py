"""Glue between the tuner, the executor and the harness that searches.

Port of paddle_tpu/tuning/runtime.py.  Keying: winners persist under
(plan key, device kind, mesh), every component computed under
:func:`registry.base_env` (the environment a fresh, untuned process with
the same user configuration sees), so the winners process N stores are
what process N+1's first lookup finds.  The mesh component is ``''``
until distribution (ROADMAP.md Queue 1 item 10); the device kind is
``torch.cuda.get_device_name`` of the card, or ``'cpu'``.

Apply: ``PADDLE_TPU_TORCH_TUNE=cached`` makes the executor call
:func:`maybe_apply_cached` before a program's plan key is computed.
Winners apply as env overrides (registry.apply_persistent), which every
consumer re-reads, so the tuned plan builds as a fresh tuned process
builds it.  The lookup is memoised per (program uid, version).
"""
import torch

from . import cache as cache_mod
from . import registry
from . import roofline

__all__ = ['base_plan_key', 'device_kind', 'program_fingerprint',
           'cache_key_for', 'maybe_apply_cached', 'model_program',
           'reset']

_APPLIED = {}  # (program uid, version) -> winners dict or None

MESH_KEY = ''  # one device until distribution (Queue 1 item 10)


def reset():
    """Forget the per-program apply memos (tests)."""
    _APPLIED.clear()


def base_plan_key(program):
    """pass_manager.plan_key under the base (untuned) environment."""
    from ..transpiler import pass_manager
    with registry.base_env():
        return pass_manager.plan_key(program)


def device_kind(place=None):
    """The device component of the winner-cache key, so winners tuned on
    one card never apply on another: ``torch.cuda.get_device_name`` of a
    CUDA place, ``'cpu'`` for the CPU.  None means the card."""
    from ..core.place import resolve_device
    dev = resolve_device(place)
    if dev.type != 'cuda':
        return 'cpu'
    return torch.cuda.get_device_name(dev)


def program_fingerprint(program):
    """Structural identity of ``program`` for the winner-cache key: the
    op-type multiset over its blocks and the count of persistables.
    Stable across rebuilds and processes (op types carry no name
    counters), while distinct models differ.  Shapes are left out: the
    batch is itself a searched tunable, so batch variants of one program
    share winners."""
    counts = {}
    nparam = 0
    try:
        for block in program.blocks:
            for op in block.ops:
                counts[op.type] = counts.get(op.type, 0) + 1
            for var in block.vars.values():
                if getattr(var, 'persistable', False):
                    nparam += 1
    except Exception:  # pragma: no cover - exotic program objects
        return None
    return (tuple(sorted(counts.items())), nparam)


def cache_key_for(program, place=None):
    """The persistent winner-cache key of ``program`` here and now."""
    from ..transpiler import pass_manager
    with registry.base_env():
        pk = pass_manager.plan_key(program)
    pk = (pk, program_fingerprint(program))
    return cache_mod.TuneCache.key(pk, device_kind(place), MESH_KEY)


def maybe_apply_cached(program, place=None):
    """PADDLE_TPU_TORCH_TUNE=cached executor hook: look up the persisted
    winners of ``program`` and apply them as env overrides, once per
    (program, version).  Returns the winners applied, None on a miss or
    when tuning is off.  Never raises: an unreadable cache runs
    untuned."""
    from ..flags import FLAGS
    if FLAGS.tune != 'cached':
        return None
    memo = (program._uid, program.version)
    if memo in _APPLIED:
        return _APPLIED[memo]
    winners = None
    try:
        tc = cache_mod.TuneCache()
        if tc.enabled():
            winners = tc.load(cache_key_for(program, place))
            if winners:
                winners = registry.apply_persistent(winners)
    except Exception:  # pragma: no cover - defensive: run untuned
        import logging
        logging.getLogger(__name__).warning(
            'tuning winner apply failed; running untuned',
            exc_info=True)
        winners = None
    _APPLIED[memo] = winners
    return winners


def model_program(program, fetch_names=(), feed_specs=None,
                  peak_tflops=None, hbm_gbps=None):
    """Modelled {'score', 'peak_bytes', 'cost'} of ``program`` under the
    CURRENT environment: call it inside ``registry.applied(cfg)`` to
    price a candidate.  ``score`` is the modelled roofline step time in
    seconds at the peak of the plan's compute dtype (roofline.py); a
    caller searching the batch normalises it per example.  None when the
    pipeline gives no cost report (graph-opt level 0)."""
    from ..transpiler import pass_manager
    feed_names = tuple(sorted(feed_specs)) if feed_specs else ()
    _prog, rep = pass_manager.run_pipeline(
        program, fetch_names=tuple(fetch_names), feed_names=feed_names,
        feed_specs=feed_specs)
    cost = (rep or {}).get('cost')
    if not cost or not (cost.get('total') or {}).get('flops'):
        return None
    mem = cost.get('memory') or {}
    return {'score': roofline.modeled_step_s(
                cost, peak_tflops=peak_tflops, hbm_gbps=hbm_gbps),
            'peak_bytes': mem.get('peak_bytes'),
            'cost': cost}
