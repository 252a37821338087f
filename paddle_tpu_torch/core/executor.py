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
- A table read only by ``is_sparse`` lookups is differentiated through
  its lookups' outputs (core/backward.py): inside the gradient pass each
  such output becomes a leaf right after its op writes it, and keeps that
  value, as the reference's "frozen" names do.  Its gradient then reaches
  the optimizer as a ``SelectedRows``; a fetch of one returns it in a 0-d
  object array with numpy fields, as the reference's ``np.asarray`` of the
  pytree does.
- Only the ops that a fetch, the autodiff op's loss or a persistable write
  needs are run (with every stateful-random op and every op without
  outputs): the reference traces the block into one XLA program, whose
  dead-code elimination drops the rest (the seq2seq translator's
  ``prediction`` branch, a [B, T, vocab] projection and softmax, when only
  the loss is fetched).  ``Executor.skipped_ops`` names the ops the last
  run skipped.

- ``run_steps`` runs K steps as a host loop over the same step, every
  feed staged on the device first; fetches come back stacked [K, ...].

Not in this slice (each raises): ``compile``, a program with more than
one ``autodiff`` op, AMP loss scaling and skip-step gates, overlap
buckets, remat, meshes.
"""
import numpy as np
import torch

from . import datatypes
from .lod import LoDTensor
from .place import resolve_device
from .program import LEN_SUFFIX, Program, Variable, default_main_program
from .registry import get_op_impl
from .scope import global_scope
from .selected_rows import SelectedRows

__all__ = ['Executor', 'ExecutionContext']

# ops whose random draws advance generator state: kept when their outputs
# are unused, as the reference keeps them
_STATEFUL_RANDOM = frozenset({'uniform_random', 'gaussian_random',
                              'truncated_gaussian_random', 'dropout',
                              'random_crop', 'sampling_id'})

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


_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def _feed_columns(name, value, var):
    """One feed entry as {name: value} plus ``name@LEN`` (int32 lengths)
    for a ragged feed: a ``LoDTensor``, or a ``(data, lengths)`` tuple fed
    to a ``lod_level > 0`` variable (reference: executor.py
    ``_to_feed_arrays``)."""
    if isinstance(value, LoDTensor):
        out = {name: value.padded()}
        if value.is_ragged():
            out[name + LEN_SUFFIX] = np.asarray(value.lengths(), np.int32)
        return out
    if isinstance(value, tuple) and len(value) == 2 and var is not None \
            and var.lod_level > 0:
        data, lengths = value
        return {name: data, name + LEN_SUFFIX: np.asarray(lengths, np.int32)}
    return {name: value}


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
            if var is not None and var.stop_gradient and not var.is_data \
                    and torch.is_tensor(v):
                v = v.detach()
            env[n] = v


def live_ops(block, fetch_names):
    """Indices of the ops of ``block`` that a run fetching ``fetch_names``
    needs: ops writing a persistable, stateful-random ops and ops without
    outputs, and, backwards, every op writing an input of a needed op (an
    ``autodiff`` op reads its loss)."""
    needed = set(fetch_names)
    live = []
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        outs = op.output_arg_names
        keep = (not outs or op.type in _STATEFUL_RANDOM or
                any(n in needed for n in outs))
        if not keep:
            for n in outs:
                try:
                    keep = block.var_recursive(n).persistable
                except KeyError:
                    keep = False
                if keep:
                    break
        if keep:
            live.append(i)
            needed.update(op.input_arg_names)
    return live[::-1]


def _run_ops(ops, env, ctx, live):
    """Interpret the ops at indices ``live`` in program order.  The first
    ``autodiff`` op runs the forward-role ops before it inside its
    gradient pass; they are skipped at top level."""
    ad_idxs = [i for i in live if ops[i].type == 'autodiff']
    if len(ad_idxs) > 1:
        raise NotImplementedError(
            "programs with more than one autodiff op (multi-loss, GAN) are "
            "not ported yet: ROADMAP.md Queue 1")
    fwd = []
    if ad_idxs:
        fwd = [(j, ops[j]) for j in live
               if j < ad_idxs[0] and _op_role(ops[j]) == 'forward']
    in_fwd = {j for j, _ in fwd}
    for i in live:
        op = ops[i]
        if op.type == 'autodiff':
            _run_autodiff(op, fwd, env, ctx)
        elif i not in in_fwd:
            _run_one(op, env, ctx, i)


def _sparse_lookup_outputs(fwd_ops):
    return {op.outputs['Out'][0] for _, op in fwd_ops
            if op.type == 'lookup_table' and op.attrs.get('is_sparse')}


def _run_autodiff(ad_op, fwd_ops, env, ctx):
    """Gradients of the loss with respect to ``param_names``: parameters
    from the environment, and the outputs of ``is_sparse`` lookups, each a
    leaf from the moment its op writes it (later writes keep the leaf)."""
    param_names = list(ad_op.attrs['param_names'])
    grad_names = list(ad_op.attrs['grad_names'])
    loss_name = ad_op.attrs['loss_name']
    loss_scale = float(ad_op.attrs.get('loss_scale', 1.0))
    written = set()
    for _, op in fwd_ops:
        written.update(op.output_arg_names)
    frozen = set(param_names) & written
    missing = [n for n in param_names
               if (n not in env and n not in written) or
               (n in frozen and n not in _sparse_lookup_outputs(fwd_ops))]
    if missing:
        raise NotImplementedError(
            "gradients with respect to intermediate variables %s "
            "(calc_gradient) are not ported yet: ROADMAP.md Queue 1 item 5"
            % missing[:3])
    env2 = dict(env)
    leaves = {}
    with torch.enable_grad():
        for n in param_names:
            if n not in frozen:
                leaves[n] = env[n].detach().requires_grad_(True)
                env2[n] = leaves[n]
        for j, op in fwd_ops:
            _run_one(op, env2, ctx, j)
            for n in frozen.intersection(op.output_arg_names):
                if n not in leaves:
                    leaves[n] = env2[n].detach().requires_grad_(True)
                env2[n] = leaves[n]
        if loss_name not in env2:
            raise KeyError("autodiff loss %r was never computed"
                           % loss_name)
        loss = env2[loss_name].float().sum() * loss_scale
        wrt = [leaves[n] for n in param_names]
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    for n in written:
        if n in env2:
            env[n] = env2[n].detach()
    for leaf, gn, g in zip(wrt, grad_names, grads):
        env[gn] = (torch.zeros_like(leaf) if g is None
                   else g.to(leaf.dtype)).detach()


def _fetched(t, return_numpy):
    if not return_numpy:
        return t
    if isinstance(t, SelectedRows):
        box = np.empty((), dtype=object)
        box[()] = t.numpy()
        return box
    return t.detach().cpu().numpy()


class Executor(object):
    """Runs Programs on ``place``: None means CUDA device 0 (and raises
    without a card); ``CPUPlace()`` or ``'cpu'`` runs on the CPU."""

    def __init__(self, place=None):
        if isinstance(place, (list, tuple)):
            place = place[0]
        self.place = resolve_device(place)
        self._step_count = 0
        self.skipped_ops = []

    def _base_seed(self, program):
        seed = program.random_seed
        return seed if seed else id(self) % (2 ** 31)

    def _to_device(self, name, value, var):
        """One feed or scope value as a tensor on the executor's device.
        Host 64-bit types narrow to 32 bits and a declared float dtype is
        honoured, as the reference's feed conversion
        (``_np_to_device_dtype``) does."""
        if torch.is_tensor(value):
            t = value
        else:
            arr = np.asarray(value)
            if arr.dtype in _NARROW:
                arr = arr.astype(_NARROW[arr.dtype])
            t = torch.from_numpy(np.array(arr, copy=True))
        if var is not None and datatypes.is_float_dtype(var.dtype) and \
                t.dtype != torch.bool:
            t = t.to(datatypes.as_torch_dtype(var.dtype))
        return t.to(self.place)

    def _resolve(self, program, scope, fetch_list):
        if program is None:
            program = default_main_program()
        if not isinstance(program, Program):
            raise TypeError("Executor requires a Program, got %r"
                            % type(program))
        if scope is None:
            scope = global_scope()
        if len(program.blocks) > 1:
            raise NotImplementedError(
                "programs with sub-blocks (control flow) are not ported "
                "yet: ROADMAP.md Queue 1")
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        return program, scope, fetch_names

    def _stage_feed(self, block, feed):
        """A feed dict as {column: tensor on the executor's device}."""
        staged = {}
        for name, value in feed.items():
            for col, v in _feed_columns(name, value,
                                        block.vars.get(name)).items():
                staged[col] = self._to_device(col, v, block.vars.get(col))
        return staged

    def _step(self, program, scope, staged, fetch_names):
        """One run of the block on a staged feed; returns the fetched
        tensors."""
        block = program.global_block()
        known = set(block.vars)
        for op in block.ops:
            known.update(op.output_arg_names)
        for n in fetch_names:
            if n not in known and n not in staged:
                raise KeyError(
                    "fetch var %r is not produced by any op in the program "
                    "and is not fed" % n)

        env = {}
        for v in program.list_vars():
            if v.persistable and v.name not in staged and scope.has(v.name):
                t = scope.get(v.name)
                if not torch.is_tensor(t):
                    t = self._to_device(v.name, t, v)
                    scope.set(v.name, t)
                elif t.device != self.place:
                    raise ValueError(
                        "scope value %r lies on %s, the executor runs on %s"
                        % (v.name, t.device, self.place))
                env[v.name] = t
        env.update(staged)

        ctx = ExecutionContext(program, block, self.place,
                               self._base_seed(program), self._step_count)
        self._step_count += 1
        live = live_ops(block, fetch_names)
        alive = set(live)
        self.skipped_ops = [(i, op.type) for i, op in enumerate(block.ops)
                            if i not in alive]
        with torch.no_grad():
            _run_ops(block.ops, env, ctx, live)
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
            fetches.append(env[n])
        return fetches

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name='feed', fetch_var_name='fetch', scope=None,
            return_numpy=True, use_program_cache=True):
        program, scope, fetch_names = self._resolve(program, scope,
                                                    fetch_list)
        staged = self._stage_feed(program.global_block(), feed or {})
        return [_fetched(t, return_numpy) for t in
                self._step(program, scope, staged, fetch_names)]

    def run_steps(self, program=None, feed=None, fetch_list=None,
                  scope=None, repeat=None, return_numpy=True):
        """K training steps (reference ``Executor.run_steps``): ``feed``
        is a list of K feed dicts, or one feed dict with ``repeat=K``
        (one batch, staged once, for every step).  Every feed is staged
        on the device before the first step; the steps then run as K
        calls of ``run`` would, with the same per-step generators.
        Returns one [K, ...]-stacked array (a tensor with
        ``return_numpy=False``) per fetch.

        The reference scans the K steps in one compiled loop; here they
        are a host loop over the eager step."""
        program, scope, fetch_names = self._resolve(program, scope,
                                                    fetch_list)
        if isinstance(feed, dict):
            if not repeat:
                raise ValueError("run_steps with a single feed dict "
                                 "needs repeat=K")
            feeds, k = [feed], int(repeat)
        else:
            if repeat:
                raise ValueError("repeat= only combines with a single "
                                 "feed dict")
            feeds = list(feed or [])
            k = len(feeds)
            if k == 0:
                return []
        names0 = set(feeds[0])
        for i, f in enumerate(feeds[1:], start=1):
            if set(f) != names0:
                raise ValueError(
                    "run_steps feeds must use one key set across steps; "
                    "step %d has %s, step 0 %s"
                    % (i, sorted(f), sorted(names0)))
        block = program.global_block()
        staged = [self._stage_feed(block, f) for f in feeds]
        per_step = []
        for i in range(k):
            outs = self._step(program, scope, staged[i % len(staged)],
                              fetch_names)
            for n, t in zip(fetch_names, outs):
                if not torch.is_tensor(t):
                    raise TypeError(
                        "run_steps stacks dense fetches; %r is a %s"
                        % (n, type(t).__name__))
            # a fetched persistable is updated in place by later steps
            per_step.append([t.detach().clone() for t in outs])
        stacked = [torch.stack(ts) for ts in zip(*per_step)]
        return [_fetched(t, return_numpy) for t in stacked]

    def compile(self, *args, **kwargs):
        raise NotImplementedError(
            "Executor.compile (ahead-of-time plans) is not ported yet: "
            "ROADMAP.md Queue 1 item 5")
