"""Autodiff over a program block.

Reference parity: paddle_tpu/core/backward.py (fluid backward.py).  One
``autodiff`` op is appended after the loss; the executor interprets it
with ``torch.autograd.grad`` over the forward ops before it
(core/executor.py ``_run_autodiff``), so there are no per-op grad ops to
maintain.  Gradients are dense: the row-sparse (SelectedRows) embedding
gradient of ``is_sparse`` lookups comes with the sparse CTR slice.
"""
from .program import Variable, grad_var_name

__all__ = ['append_backward']


def _collect_trainable_params(block, parameter_list=None, no_grad_set=None):
    no_grad = set(no_grad_set or [])
    if parameter_list is not None:
        names = [p.name if isinstance(p, Variable) else p
                 for p in parameter_list]
    else:
        names = [p.name for p in block.program.all_parameters()
                 if getattr(p, 'trainable', True)]
    return [n for n in names if n not in no_grad]


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Append an ``autodiff`` op producing ``<param>@GRAD`` for every
    trainable parameter; returns [(param, grad_var)] like fluid's
    append_backward."""
    if not isinstance(loss, Variable):
        raise TypeError("append_backward takes the loss Variable, got %r"
                        % (loss,))
    if callbacks:
        raise NotImplementedError(
            "append_backward callbacks (error clip) are not ported yet: "
            "ROADMAP.md Queue 1, gradient clip and regularizers")
    program = loss.block.program
    block = program.global_block()
    for b in program.blocks:
        for op in b.ops:
            if op.type == 'lookup_table' and op.attrs.get('is_sparse'):
                raise NotImplementedError(
                    "is_sparse embedding gradients (SelectedRows) are not "
                    "ported yet: ROADMAP.md Queue 1, the sparse CTR slice")
    param_names = _collect_trainable_params(block, parameter_list,
                                            no_grad_set)
    grad_names = [grad_var_name(n) for n in param_names]
    params_and_grads = []
    for pn, gn in zip(param_names, grad_names):
        p = block.var(pn)
        if not block.has_var(gn):
            g = block.create_var(name=gn, shape=p.shape, dtype=p.dtype,
                                 persistable=False)
            g.stop_gradient = True
        else:
            g = block.var(gn)
        params_and_grads.append((p, g))
    block.append_op(
        type='autodiff',
        inputs={'Loss': [loss]},
        outputs={'Grads': grad_names},
        attrs={
            'loss_name': loss.name,
            'param_names': param_names,
            'grad_names': grad_names,
            'loss_scale': 1.0,
            'op_role': 'backward',
        })
    return params_and_grads
