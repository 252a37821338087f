"""Executor: runs a Program block op by op on the card.

Reference parity: paddle_tpu/core/executor.py ``Executor.run`` /
``_run_one`` / ``_run_ops`` / ``_run_autodiff``.  The reference traces
the whole block once into one XLA computation; PyTorch runs eagerly, so
here each op's compute function runs as it is reached, and the kernels
behind an op (flash attention, the dense optimizer apply) launch from
their wrappers.

- The first ``autodiff`` op runs every forward-role op before it under
  ``torch.enable_grad()``, with each differentiated parameter as a leaf,
  and takes ``torch.autograd.grad`` of the summed loss.  The forward's
  outputs are published to the environment, detached.
- Every other op runs under ``torch.no_grad()``.  Optimize-role ops
  update the scope's tensors in place (the optimizer kernels write
  param and moments where they lie); any other persistable output is
  copied into the scope tensor it replaces.  This is the port's form of
  the reference's buffer donation.
- Outputs of ``stop_gradient`` variables that are not fed data are
  detached, as the reference wraps them in ``stop_gradient``.

Not in this slice (each raises): ``run_steps``, ``compile``, a program
with more than one ``autodiff`` op, AMP loss scaling and skip-step
gates, overlap buckets, remat, meshes.
"""
import numpy as np
import torch

from . import datatypes
from .place import resolve_device
from .program import Program, Variable, default_main_program
from .registry import get_op_impl
from .scope import global_scope

__all__ = ['Executor', 'ExecutionContext']

# op attrs of reference features this slice does not bring
_UNPORTED_ATTRS = {
    'amp_gate_var': 'the AMP slice',
    'loss_scale_var': 'the AMP slice',
    'overlap_buckets': 'the multi-chip slice',
}


class ExecutionContext(object):
    """Per-run context handed to op compute functions: the device and a
    per-op random generator."""

    def __init__(self, program, block, device, base_seed, step):
        self.program = program
        self.block = block
        self.device = device
        self.base_seed = base_seed
        self.step = step
        self.op_index = 0

    def generator(self, extra=0):
        """A ``torch.Generator`` on the device, seeded from (program
        seed, step, block, op position, ``extra``): the reference keys
        its per-op PRNG the same way (executor.py ExecutionContext.rng),
        so replaying an op gives the same numbers.  The numbers differ
        from JAX's; tests carry the reference's values across instead."""
        words = [self.base_seed, self.step, self.block.idx, self.op_index,
                 int(extra)]
        state = np.random.SeedSequence(
            [w & 0xFFFFFFFF for w in words]).generate_state(2, np.uint32)
        seed = (int(state[0]) << 31) ^ int(state[1])
        return torch.Generator(device=self.device).manual_seed(seed)


def _op_role(op):
    return op.attrs.get('op_role', 'forward')


def _run_one(op, env, ctx, op_index):
    impl = get_op_impl(op.type)
    for attr, slice_name in _UNPORTED_ATTRS.items():
        if op.attrs.get(attr):
            raise NotImplementedError(
                "op %s carries %r, which comes with %s (ROADMAP.md)"
                % (op.type, attr, slice_name))
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n not in env:
                raise KeyError(
                    "op %s reads %r which has no value; feed it, run the "
                    "startup program, or check op ordering" % (op.type, n))
            vals.append(env[n])
        ins[slot] = vals
    ctx.op_index = op.attrs.get('op_seq', op_index)
    outs = impl.compute(ctx, ins, op.attrs) or {}
    for slot, names in op.outputs.items():
        for n, v in zip(names, outs.get(slot, [])):
            if v is None:
                continue
            try:
                var = ctx.block.var_recursive(n)
            except KeyError:
                var = None
            if var is not None and var.stop_gradient and not var.is_data:
                v = v.detach()
            env[n] = v


def _run_ops(ops, env, ctx):
    """Interpret ``ops`` in program order.  The first ``autodiff`` op
    runs the forward-role ops before it inside its gradient pass; they
    are skipped at top level."""
    ad_idxs = [i for i, op in enumerate(ops) if op.type == 'autodiff']
    if len(ad_idxs) > 1:
        raise NotImplementedError(
            "programs with more than one autodiff op (multi-loss, GAN) are "
            "not ported yet: ROADMAP.md Queue 1")
    fwd = []
    if ad_idxs:
        fwd = [(j, ops[j]) for j in range(ad_idxs[0])
               if _op_role(ops[j]) == 'forward']
    in_fwd = {j for j, _ in fwd}
    for i, op in enumerate(ops):
        if op.type == 'autodiff':
            _run_autodiff(op, fwd, env, ctx)
        elif i not in in_fwd:
            _run_one(op, env, ctx, i)


def _run_autodiff(ad_op, fwd_ops, env, ctx):
    param_names = list(ad_op.attrs['param_names'])
    grad_names = list(ad_op.attrs['grad_names'])
    loss_name = ad_op.attrs['loss_name']
    loss_scale = float(ad_op.attrs.get('loss_scale', 1.0))
    written = set()
    for _, op in fwd_ops:
        written.update(op.output_arg_names)
    missing = [n for n in param_names if n not in env or n in written]
    if missing:
        raise NotImplementedError(
            "gradients with respect to intermediate variables %s "
            "(calc_gradient) are not ported yet: ROADMAP.md Queue 1"
            % missing[:3])
    env2 = dict(env)
    leaves = []
    with torch.enable_grad():
        for n in param_names:
            leaf = env[n].detach().requires_grad_(True)
            env2[n] = leaf
            leaves.append(leaf)
        for j, op in fwd_ops:
            _run_one(op, env2, ctx, j)
        if loss_name not in env2:
            raise KeyError("autodiff loss %r was never computed"
                           % loss_name)
        loss = env2[loss_name].float().sum() * loss_scale
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for n in written:
        if n in env2:
            env[n] = env2[n].detach()
    for leaf, gn, g in zip(leaves, grad_names, grads):
        env[gn] = (torch.zeros_like(leaf) if g is None
                   else g.to(leaf.dtype)).detach()


class Executor(object):
    """Runs Programs on ``place``: None means CUDA device 0 (and raises
    without a card); ``CPUPlace()`` or ``'cpu'`` runs on the CPU."""

    def __init__(self, place=None):
        if isinstance(place, (list, tuple)):
            place = place[0]
        self.place = resolve_device(place)
        self._step = 0

    def _base_seed(self, program):
        seed = program.random_seed
        return seed if seed else id(self) % (2 ** 31)

    def _to_device(self, name, value, var):
        """One feed or scope value as a tensor on the executor's device.
        Host float64 narrows to float32 and a declared float dtype is
        honoured, as the reference's feed conversion does."""
        if torch.is_tensor(value):
            t = value
        else:
            if isinstance(value, tuple):
                raise NotImplementedError(
                    "ragged (LoD) feed %r is not ported yet: ROADMAP.md "
                    "Queue 1, the sequence slice" % name)
            arr = np.asarray(value)
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            t = torch.from_numpy(np.array(arr, copy=True))
        if var is not None and datatypes.is_float_dtype(var.dtype) and \
                t.dtype != torch.bool:
            t = t.to(datatypes.as_torch_dtype(var.dtype))
        return t.to(self.place)

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name='feed', fetch_var_name='fetch', scope=None,
            return_numpy=True, use_program_cache=True):
        if program is None:
            program = default_main_program()
        if not isinstance(program, Program):
            raise TypeError("Executor requires a Program, got %r"
                            % type(program))
        if scope is None:
            scope = global_scope()
        feed = feed or {}
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        block = program.global_block()
        if len(program.blocks) > 1:
            raise NotImplementedError(
                "programs with sub-blocks (control flow) are not ported "
                "yet: ROADMAP.md Queue 1")

        known = set(block.vars)
        for op in block.ops:
            known.update(op.output_arg_names)
        for n in fetch_names:
            if n not in known and n not in feed:
                raise KeyError(
                    "fetch var %r is not produced by any op in the program "
                    "and is not fed" % n)

        env = {}
        for v in program.list_vars():
            if v.persistable and v.name not in feed and scope.has(v.name):
                t = scope.get(v.name)
                if not torch.is_tensor(t):
                    t = self._to_device(v.name, t, v)
                    scope.set(v.name, t)
                elif t.device != self.place:
                    raise ValueError(
                        "scope value %r lies on %s, the executor runs on %s"
                        % (v.name, t.device, self.place))
                env[v.name] = t
        for name, value in feed.items():
            env[name] = self._to_device(name, value, block.vars.get(name))

        ctx = ExecutionContext(program, block, self.place,
                               self._base_seed(program), self._step)
        self._step += 1
        with torch.no_grad():
            _run_ops(block.ops, env, ctx)
            written = set()
            for op in block.ops:
                written.update(op.output_arg_names)
            for v in program.list_vars():
                if not v.persistable or v.name not in written or \
                        v.name not in env:
                    continue
                new = env[v.name]
                old = scope.find_var(v.name)
                if old is new:
                    continue
                if torch.is_tensor(old) and old.shape == new.shape and \
                        old.dtype == new.dtype and old.device == new.device:
                    old.copy_(new)   # in place: the scope tensor stays
                else:
                    scope.set(v.name, new)
        fetches = []
        for n in fetch_names:
            if n not in env:
                raise KeyError("fetch var %r was never computed" % n)
            t = env[n]
            fetches.append(t.detach().cpu().numpy() if return_numpy else t)
        return fetches

    def run_steps(self, *args, **kwargs):
        raise NotImplementedError(
            "Executor.run_steps (K steps as one compiled loop) is not "
            "ported yet: ROADMAP.md Queue 1; call run() per step")

    def compile(self, *args, **kwargs):
        raise NotImplementedError(
            "Executor.compile (ahead-of-time plans) is not ported yet: "
            "ROADMAP.md Queue 1")
