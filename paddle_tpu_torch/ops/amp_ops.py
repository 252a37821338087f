"""AMP dynamic-loss-scaling ops (f16 mode of the transpiler/amp.py pass).

Reference parity: paddle_tpu/ops/amp_ops.py (the check_finite_and_unscale
+ update_loss_scaling pair of Micikevicius et al. 2018, "Mixed Precision
Training"): the loss is multiplied by a scale before the backward so
small f16 gradients do not flush to zero, the gradients are divided back
down before clipping, regularization and the apply, a step whose
gradients hold inf/nan is skipped whole (the executor gates optimize-role
ops on FoundInfinite, core/executor.py ``_run_one``), and the scale grows
after N finite steps in a row and shrinks after M overflows in a row.

Both ops are eager torch over their inputs, as the reference leaves them
to XLA; the verdict stays on the device (no host sync).  The scale and
the counters are persistable [1] vars in the Scope.
"""
import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows
from .common import first


def _any_nonfinite(x):
    return ~torch.isfinite(x.float()).all()


@register_op('check_finite_and_unscale')
def _check_finite_and_unscale(ctx, ins, attrs):
    """Out[i] = X[i] / Scale; FoundInfinite = any X holds inf/nan (OR'd
    with the optional FoundAcc input, so programs with several autodiff
    ops chain one check per autodiff into one verdict).  SelectedRows
    grads unscale their values (rows untouched)."""
    scale = first(ins, 'Scale').float().reshape(())
    inv = 1.0 / scale
    found = torch.zeros((), dtype=torch.bool, device=scale.device)
    for acc in ins.get('FoundAcc', []):
        found = found | acc.reshape(()).bool()
    outs = []
    for g in ins.get('X', []):
        if isinstance(g, SelectedRows):
            v = g.values.float()
            found = found | _any_nonfinite(v)
            outs.append(SelectedRows(g.rows, (v * inv).to(g.values.dtype),
                                     g.height))
        else:
            found = found | _any_nonfinite(g)
            outs.append((g.float() * inv).to(g.dtype))
    return {'Out': outs, 'FoundInfinite': [found.reshape(1)]}


@register_op('update_loss_scale')
def _update_loss_scale(ctx, ins, attrs):
    """Grow or back off the dynamic loss scale.  Non-finite step: bad+1,
    good=0, and after decr_every_n_nan_or_inf overflows in a row the scale
    halves (floored at 1.0).  Finite step: good+1, bad=0, and after
    incr_every_n_steps finite steps in a row the scale doubles (capped at
    2^31).  SkippedSteps counts the overflowed (gated) steps."""
    found = first(ins, 'FoundInfinite').reshape(()).bool()
    scale = first(ins, 'LossScale').float().reshape(())
    good = first(ins, 'GoodSteps').reshape(()).int()
    bad = first(ins, 'BadSteps').reshape(()).int()
    skipped = first(ins, 'SkippedSteps').reshape(()).int()
    incr_every = int(attrs.get('incr_every_n_steps', 1000))
    decr_every = int(attrs.get('decr_every_n_nan_or_inf', 2))
    incr_ratio = float(attrs.get('incr_ratio', 2.0))
    decr_ratio = float(attrs.get('decr_ratio', 0.5))
    zero = torch.zeros_like(good)
    bad_new = torch.where(found, bad + 1, zero)
    good_new = torch.where(found, zero, good + 1)
    shrink = bad_new >= decr_every
    grow = good_new >= incr_every
    scale_new = torch.where(
        shrink, torch.clamp(scale * decr_ratio, min=1.0),
        torch.where(grow, torch.clamp(scale * incr_ratio, max=2.0 ** 31),
                    scale))
    return {
        'LossScaleOut': [scale_new.reshape(1)],
        'GoodStepsOut': [torch.where(grow, zero, good_new).reshape(1)],
        'BadStepsOut': [torch.where(shrink, zero, bad_new).reshape(1)],
        'SkippedStepsOut': [(skipped + found.int()).reshape(1)],
    }
