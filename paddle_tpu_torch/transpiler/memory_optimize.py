"""memory_optimize / release_memory: rematerialization, and the pass
pipeline armed for a program.

Reference parity: paddle_tpu/transpiler/memory_optimize.py
(python/paddle/v2/fluid/memory_optimization_transpiler.py).  Both calls
request the pipeline for the program (the executor floors the graph-opt
level at 1, so dead ops, which pin their outputs, are dropped), record
the names the caller wants left alone (``skip_opt_set``, which roots
dead-op elimination), attach the donation/liveness report, and bump the
program's version so the next run plans anew.

``memory_optimize`` also marks the program for rematerialization: the
gradient pass recomputes forward activations in the backward instead of
keeping them (core/executor.py ``_run_autodiff``).  The reference wraps
its whole forward in ``jax.checkpoint`` and XLA schedules the
recompute; in eager PyTorch one checkpoint over the whole forward would
recompute it all at the backward's first step and hold every recomputed
value, so the port recomputes region by region, through saved-tensor
hooks of its own over each region (core/executor.py ``_Region``).
Levels:

- ``'dots'`` (the default, as the reference's): the outputs of the
  matmul-shaped ops (``registry.COST_MAC``: mul, matmul, conv2d,
  flash_attention, the RNN ops, ...) are kept; each run of other ops
  between them is a region, recomputed in the backward.  This is the
  memory model's definition of 'dots' (transpiler/memory_model.py
  ``_saved_activations``), so flash attention's output is kept and #1
  does not launch again.  The reference's ``dots_saveable`` keeps only
  ``dot_general`` outputs and recomputes its Pallas flash forward.
- ``'full'``: the forward is cut into regions of consecutive ops, and
  only the values crossing the cuts are kept; every op, flash attention
  included, runs again in the backward.  The cuts minimise the values
  kept at them plus the largest region's recompute, from the declared
  sizes at the fed batch (core/executor.py ``_full_cuts``).  The memory
  model's 'full' keeps nothing, an idealisation.
- ``None``: no rematerialization.
"""
import logging

from . import passes

__all__ = ['memory_optimize', 'release_memory', 'get_remat_policy',
           'REMAT_LEVELS']

_log = logging.getLogger(__name__)

REMAT_LEVELS = ('full', 'dots')


def _arm_pipeline(input_program, skip_opt_set):
    if skip_opt_set:
        skip = {s.name if hasattr(s, 'name') else str(s)
                for s in skip_opt_set}
        existing = getattr(input_program, '_graph_opt_skip_set', None)
        input_program._graph_opt_skip_set = (existing or set()) | skip
    input_program._graph_opt_requested = True
    report = passes.analyze_donation(input_program)
    input_program._donation_report = report
    input_program._bump_version()   # invalidate executor plans
    return report


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level='dots'):
    """Mark ``input_program`` for rematerialization at ``level`` ('dots',
    'full' or None) and arm the pass pipeline (dead-op elimination and
    the donation analysis) for it on its next plan."""
    if level is not None and level not in REMAT_LEVELS:
        raise ValueError("level must be one of %s or None"
                         % sorted(REMAT_LEVELS))
    input_program._remat_level = level
    report = _arm_pipeline(input_program, skip_opt_set)
    if print_log:
        print("memory_optimize: remat level = %r; %d block "
              "intermediates, %d donatable (%.1f KiB statically known), "
              "%d die immediately"
              % (level, report['intermediates'], len(report['donatable']),
                 report['bytes_known'] / 1024.0,
                 len(report['short_lived'])))
    return input_program


def release_memory(input_program, skip_opt_set=None):
    """The reference's release_memory: arm the pipeline and report the
    donation headroom.  The executor frees each value after its last
    reader (core/executor.py liveness)."""
    report = _arm_pipeline(input_program, skip_opt_set)
    _log.info(
        "release_memory: armed the pass pipeline (dead-op elimination on "
        "the next plan); %d intermediates, %d donatable buffers (%.1f KiB "
        "statically known)", report['intermediates'],
        len(report['donatable']), report['bytes_known'] / 1024.0)
    return input_program


def get_remat_policy(program):
    """The program's rematerialization level: 'dots', 'full' or None."""
    return getattr(program, '_remat_level', None)
