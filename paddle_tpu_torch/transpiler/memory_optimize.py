"""memory_optimize / release_memory: arm the pass pipeline for a program.

Reference parity: paddle_tpu/transpiler/memory_optimize.py
(python/paddle/v2/fluid/memory_optimization_transpiler.py).  Both calls
request the pipeline for the program (the executor floors the graph-opt
level at 1, so dead ops, which pin their outputs, are dropped), record
the names the caller wants left alone (``skip_opt_set``, which roots
dead-op elimination), attach the donation/liveness report, and bump the
program's version so the next run plans anew.

The reference's ``memory_optimize`` also arms rematerialization
(``jax.checkpoint`` over the gradient pass, levels 'full' and 'dots');
in the port that is ``torch.utils.checkpoint`` and comes with the memory
model (ROADMAP.md Queue 1 item 7): a level other than None raises
rather than run without the recomputation it asks for.
"""
import logging

from . import passes

__all__ = ['memory_optimize', 'release_memory']

_log = logging.getLogger(__name__)


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
                    level=None):
    """Arm the pass pipeline (dead-op elimination and the donation
    analysis) for ``input_program`` on its next plan.  ``level`` names the
    reference's rematerialization policy; only None is ported."""
    if level is not None:
        raise NotImplementedError(
            "memory_optimize(level=%r): rematerialization "
            "(torch.utils.checkpoint) comes with the memory model, "
            "ROADMAP.md Queue 1 item 7; level=None arms the pass pipeline "
            "alone" % (level,))
    report = _arm_pipeline(input_program, skip_opt_set)
    if print_log:
        print("memory_optimize: %d block intermediates, %d donatable "
              "(%.1f KiB statically known), %d die immediately"
              % (report['intermediates'], len(report['donatable']),
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
