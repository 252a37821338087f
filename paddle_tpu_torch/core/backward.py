"""Autodiff over a program block.

Reference parity: paddle_tpu/core/backward.py (fluid backward.py).  One
``autodiff`` op is appended after the loss; the executor interprets it
with ``torch.autograd.grad`` over the forward ops before it
(core/executor.py ``_run_autodiff``), so there are no per-op grad ops to
maintain.

A table read only by ``is_sparse`` lookups takes the row-sparse
(SelectedRows) path: the autodiff op differentiates with respect to the
lookups' outputs instead of the table, and a ``sparse_grad_assemble`` op
per table packs (ids, output gradients) into the table's ``@GRAD``
SelectedRows (reference lookup_table_op.cc:52 and the optimizers' sparse
branches): the vocab-height dense gradient never exists.

``calc_gradient`` appends an autodiff op over any variables, fed inputs
and intermediates included (fluid's calc_gradient).
"""
from .program import Variable, grad_var_name

__all__ = ['append_backward', 'calc_gradient']


def _collect_trainable_params(block, parameter_list=None, no_grad_set=None):
    no_grad = set(no_grad_set or [])
    if parameter_list is not None:
        names = [p.name if isinstance(p, Variable) else p
                 for p in parameter_list]
    else:
        names = [p.name for p in block.program.all_parameters()
                 if getattr(p, 'trainable', True)]
    return [n for n in names if n not in no_grad]


def _find_sparse_params(block, param_names):
    """Params eligible for the SelectedRows path: every op reading the
    param, in any block, is a global-block ``lookup_table`` with
    ``is_sparse``, and those lookups share one ``padding_idx``.  A param
    with a regularizer or gradient clip, or in a program with a global
    gradient clip, keeps the dense gradient: those append elementwise ops
    over the gradient, which must stay a tensor.  Returns {param:
    (height, padding_idx, [(ids, out), ...])}."""
    from ..clip import current_gradient_clip
    readers = {}   # var name -> [ops reading it, any block]
    global_ops = set()
    lookups = {}   # table -> (padding_idx set, [(ids, out, op id)])
    for b in block.program.blocks:
        for op in b.ops:
            for n in op.input_arg_names:
                readers.setdefault(n, []).append(op)
            if b is block:
                global_ops.add(id(op))
            if op.type == 'lookup_table' and op.attrs.get('is_sparse'):
                pads, pairs = lookups.setdefault(op.inputs['W'][0],
                                                 (set(), []))
                pads.add(op.attrs.get('padding_idx', None))
                pairs.append((op.inputs['Ids'][0], op.outputs['Out'][0],
                              id(op)))
    sparse = {}
    for pn in param_names:
        if pn not in lookups:
            continue
        if any(op.type != 'lookup_table' or not op.attrs.get('is_sparse')
               for op in readers.get(pn, [])):
            continue   # also read densely: keep the dense gradient
        pads, pairs = lookups[pn]
        if any(oid not in global_ops for _, _, oid in pairs):
            continue   # a lookup inside a sub-block: dense
        if len(pads) != 1:
            continue   # conflicting padding_idx across lookups: dense
        p = block.var(pn)
        if getattr(p, 'regularizer', None) is not None or \
                getattr(p, 'gradient_clip_attr', None) is not None or \
                current_gradient_clip() is not None:
            continue   # regularizer / clip ops need a dense gradient
        sparse[pn] = (p.shape[0], next(iter(pads)),
                      [(ids, out) for ids, out, _ in pairs])
    return sparse


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Append an ``autodiff`` op producing ``<param>@GRAD`` for every
    trainable parameter (and a ``sparse_grad_assemble`` op per sparse
    table); returns [(param, grad_var)] like fluid's append_backward.

    fluid's ``error_clip_callback`` weaves clip ops into the grad-op
    chain; here a variable's ``error_clip`` is read by the executor,
    which clips the cotangent reaching it inside the gradient pass
    (core/executor.py ``_ClipCotangent``), so that callback adds nothing.
    Any other callback is called once per (param, grad), in the backward
    role."""
    if not isinstance(loss, Variable):
        raise TypeError("append_backward takes the loss Variable, got %r"
                        % (loss,))
    program = loss.block.program
    block = program.global_block()
    param_names = _collect_trainable_params(block, parameter_list,
                                            no_grad_set)
    sparse = _find_sparse_params(block, param_names)
    params_and_grads = []
    for pn in param_names:
        gn = grad_var_name(pn)
        p = block.var(pn)
        if not block.has_var(gn):
            g = block.create_var(name=gn, shape=p.shape, dtype=p.dtype,
                                 persistable=False)
            g.stop_gradient = True
        else:
            g = block.var(gn)
        params_and_grads.append((p, g))

    # autodiff targets: dense params as they are; a sparse table's lookup
    # outputs in its place (deduplicated, in program order)
    ad_params = []
    for pn in param_names:
        outs = [o for _, o in sparse[pn][2]] if pn in sparse else [pn]
        ad_params += [n for n in outs if n not in ad_params]
    ad_grads = [grad_var_name(n) for n in ad_params]
    for n, gn in zip(ad_params, ad_grads):
        if not block.has_var(gn):
            v = block.var(n)
            g = block.create_var(name=gn, shape=v.shape, dtype=v.dtype,
                                 persistable=False)
            g.stop_gradient = True
    block.append_op(
        type='autodiff',
        inputs={'Loss': [loss]},
        outputs={'Grads': ad_grads},
        attrs={
            'loss_name': loss.name,
            'param_names': ad_params,
            'grad_names': ad_grads,
            'loss_scale': 1.0,
            'op_role': 'backward',
        })
    for pn, (height, pad, pairs) in sparse.items():
        attrs = {'height': height, 'op_role': 'backward'}
        if pad is not None:
            attrs['padding_idx'] = pad
        block.append_op(
            type='sparse_grad_assemble',
            inputs={'Ids': [ids for ids, _ in pairs],
                    'OutGrad': [grad_var_name(o) for _, o in pairs]},
            outputs={'Out': [grad_var_name(pn)]},
            attrs=attrs)
    if callbacks:
        from ..clip import error_clip_callback
        for cb in (callbacks if isinstance(callbacks, (list, tuple))
                   else [callbacks]):
            if cb is error_clip_callback:
                continue
            with program.op_role_guard('backward'):
                for p, g in params_and_grads:
                    cb(block, {'param': p, 'grad': g})
    return params_and_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of one target with respect to ``inputs``, any variables
    (fluid.backward.calc_gradient): an ``autodiff`` op writing
    ``<input>@GRAD`` for each; returns those variables.  The executor
    makes a fed input a leaf before the forward ops and an intermediate a
    leaf from the moment its op writes it."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if len(targets) != 1:
        raise ValueError("calc_gradient takes a single target, got %d"
                         % len(targets))
    loss = targets[0]
    block = loss.block.program.global_block()
    in_names = [v.name if isinstance(v, Variable) else v for v in inputs]
    grad_names = [grad_var_name(n) for n in in_names]
    grads = []
    for n, gn in zip(in_names, grad_names):
        v = block.var(n)
        if not block.has_var(gn):
            g = block.create_var(name=gn, shape=v.shape, dtype=v.dtype)
            g.stop_gradient = True
        else:
            g = block.var(gn)
        grads.append(g)
    block.append_op(
        type='autodiff',
        inputs={'Loss': [loss]},
        outputs={'Grads': grad_names},
        attrs={
            'loss_name': loss.name,
            'param_names': in_names,
            'grad_names': grad_names,
            'loss_scale': 1.0,
            'op_role': 'backward',
        })
    return grads
