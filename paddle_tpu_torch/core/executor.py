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
- A later ``autodiff`` op (a program with several ``minimize`` passes:
  the GAN, multi-loss) reruns only the forward ops its parameters taint,
  at program-order values, as the reference's does: a parameter that an
  optimizer op updated before it is read at its value from before the
  update where the slice read it before the update.  The optimizer ops
  update in place, so the plan copies just those parameters before their
  update (``_StepPlan.snapshots``).
- Every other op runs under ``torch.no_grad()``.  Optimize-role ops
  update the scope's tensors in place (the optimizer kernels write
  param and moments where they lie); any other persistable output is
  copied into the scope tensor it replaces.  This is the port's form of
  the reference's buffer donation.
- Outputs of ``stop_gradient`` variables that are not fed data are
  detached, as the reference wraps them in ``stop_gradient``.
- A variable with an ``error_clip`` (clip.py ``ErrorClipByValue``) passes
  through ``_ClipCotangent`` inside the gradient pass: identity forward,
  its cotangent clipped backward, at the op output that writes it or, for
  a differentiated parameter, at its leaf (the reference's
  ``_clip_cotangent``).
- A table read only by ``is_sparse`` lookups is differentiated through
  its lookups' outputs (core/backward.py): inside the gradient pass each
  such output becomes a leaf right after its op writes it, and keeps that
  value, as the reference's "frozen" names do.  Its gradient then reaches
  the optimizer as a ``SelectedRows``; a fetch of one returns it in a 0-d
  object array with numpy fields, as the reference's ``np.asarray`` of the
  pytree does.
- Liveness: each value leaves the environment right after the last op
  that reads or writes it, unless it is fetched or persistable (a name
  written twice, a counter or an in-place sum, leaves after its last use).
  Inside the gradient pass each forward value leaves likewise after its
  last forward reader, so autograd alone decides which activations stay
  saved for the backward, and only the forward outputs that a later op, a
  fetch or a persistable reads are published back.  The reference's
  modelled counterpart is ``analyze_memory``
  (paddle_tpu/transpiler/memory_model.py); XLA frees buffers by the same
  rule inside its one program.
- ``calc_gradient`` (core/backward.py) differentiates with respect to
  fed inputs and intermediates: an intermediate becomes a leaf from the
  moment its op writes it, as the sparse lookups' outputs do.
- Only the ops that a fetch, the autodiff op's loss or a persistable write
  needs are run (with every stateful-random op and every op without
  outputs): the reference traces the block into one XLA program, whose
  dead-code elimination drops the rest (the seq2seq translator's
  ``prediction`` branch, a [B, T, vocab] projection and softmax, when only
  the loss is fetched).  ``Executor.skipped_ops`` names the ops the last
  run skipped.

- Rematerialization (``memory_optimize(level=...)``, transpiler/
  memory_optimize.py): the gradient pass runs its forward as units, each
  an op kept as it is or a region of ops whose saved tensors are
  recomputed in the backward (``_Region``, on
  ``torch.autograd.graph.saved_tensors_hooks``).  'dots' keeps the
  matmul-shaped ops (``registry.COST_MAC``) and makes each run of other
  ops between them a region; 'full' cuts the forward where the values
  kept at the cuts plus the largest region's recompute are least.  A
  kept op that saves a region's output (a matmul's input) saves a
  handle to it, so the region recomputes it too.  Ops writing a
  ``frozen`` leaf are always kept, so the leaf the gradient is taken
  with is never recomputed.  A region recomputes once per backward,
  from its inputs, which it keeps; its ops run again with the same
  ``op_index``, so random ops draw the same numbers (dropout's masks
  replay), and the gradients are bitwise those of a run without it.
- ``run_steps`` runs K steps as a host loop over the same step, every
  feed staged on the device first; fetches come back stacked [K, ...].
- ``last_step_report`` (``run`` and ``run_steps``): the measured walls
  (``wall_s``, ``feed_s`` staging, ``update_s`` the scope write-back,
  ``compute_s`` the rest), ``phases`` joined with the plan's cost report
  (FLOPs and bytes a step; achieved FLOP/s on a synced call, and ``mfu``
  when ``PADDLE_TPU_TORCH_PEAK_TFLOPS`` is set), and ``memory``: the
  modelled peak and watermark op (transpiler/memory_model.py), the remat
  level, and ``torch.cuda.max_memory_allocated`` on a CUDA place (None
  on the CPU, never 0).
- The pass pipeline (transpiler/pass_manager.py: dead-op elimination,
  constant folding, CSE, AMP, the static verifier) runs once per plan,
  on a copy of the program, and the plan runs the rewritten copy.  Plans
  are keyed on (program, version, fetches, feeds, the batch size the
  feeds bind, the pipeline's ``plan_key``), so a flag flip plans anew
  and no step pays for the passes; the cost and memory models describe
  the feed shapes of a plan's first run.  A pass or the verifier that
  raises makes the run raise: there is no fallback to the unrewritten
  program (the reference falls back, executor.py:1335-1340).
  ``last_graph_opt_report`` holds the plan's report.
- Control flow (``while``, ``conditional_block``, ``recurrent``;
  ops/control_flow.py): an op registered ``needs_env`` gets the live
  environment as ``ins['__env__']`` and interprets its sub-block through
  ``ExecutionContext.run_block`` (a sub-context whose ``block`` is the
  sub-block); the dict it returns as ``'__env_update__'`` is applied to
  the environment.  Liveness, the skipped ops and remat's regions count
  what an op's sub-block reads and writes as the op's own (``_op_rw``):
  a ``while`` declares only its condition, so a value only its body
  reads would otherwise be skipped or dropped before the loop.
- AMP f16 gates (``amp_gate_var``): on an overflow step, a gated dense
  update keeps every output's old value, and a gated ``SelectedRows``
  gradient has its ids swapped to the ``height`` sentinel, which the
  row-wise rules skip, so the table is left as it was.  The autodiff op's
  ``loss_scale_var`` multiplies the loss by the dynamic scale.

- ``compile`` / ``compile_raw``: the plan of a run as a pure function
  of (feed, state, seed), with no host sync and nothing written to the
  scope, which ``torch.export`` traces (inference/serving.py).

Not in this slice (each raises): ``parallel_do``, overlap buckets,
meshes (item 10).
"""
import itertools
import math
import time
import weakref

import numpy as np
import torch

from . import datatypes
from .lod import LoDTensor
from .place import resolve_device
from .program import LEN_SUFFIX, Program, Variable, default_main_program
from .registry import cost_class, get_op_impl
from .scope import global_scope
from .selected_rows import SelectedRows
from ..ops.kernels import build as _build
from ..transpiler.passes import (_attr_names, _block_rw_recursive,
                                 _sub_block_idxs)

__all__ = ['Executor', 'ExecutionContext']

# ops whose random draws advance generator state: kept when their outputs
# are unused, as the reference keeps them
_STATEFUL_RANDOM = frozenset({'uniform_random', 'gaussian_random',
                              'truncated_gaussian_random', 'dropout',
                              'random_crop', 'sampling_id'})

# op attrs of reference features this slice does not bring
_UNPORTED_ATTRS = {
    'overlap_buckets': 'the multi-chip slice',
}

# sparse optimizers whose row-wise rule skips sentinel ids: an overflow
# gate swaps the ids and needs no copy of the old state
_ROWWISE_SPARSE_OPS = frozenset({'sgd', 'adagrad', 'adam'})


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

    def sub_context(self, block):
        """The context of a sub-block's ops: the same run, ``block`` for
        their variable lookups and generator keys."""
        return ExecutionContext(self.program, block, self.device,
                                self.base_seed, self.step)

    def run_block(self, block_idx, env):
        """Interpret sub-block ``block_idx`` over ``env`` in place, op by op
        (reference: executor.py ``ExecutionContext.run_block``).  No
        liveness here: a control-flow op hands each run a copy of its
        environment and keeps what it carries."""
        block = self.program.blocks[block_idx]
        sub = self.sub_context(block)
        for i, op in enumerate(block.ops):
            _run_one(op, env, sub, i)
        return env

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


class _ClipCotangent(torch.autograd.Function):
    """Identity whose backward clamps the incoming gradient to [lo, hi]:
    fluid's ErrorClipByValue riding the VJP of the variable it guards."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.lo, ctx.hi = lo, hi
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, ctx.lo, ctx.hi), None, None


def _error_clipped(var, v):
    """``v`` through ``_ClipCotangent`` if ``var`` has an error clip and
    ``v`` is in a gradient pass; else ``v``."""
    ec = getattr(var, 'error_clip', None)
    if ec is None or not torch.is_tensor(v) or not v.requires_grad:
        return v
    return _ClipCotangent.apply(v, float(ec.min), float(ec.max))


def _gate(op, ins, env):
    """AMP f16 skip-step (transpiler/amp.py): an optimize-role op stamped
    with ``amp_gate_var`` leaves the state as it was when this step's
    gradients were not finite.  SelectedRows gradients get their ids
    swapped to the ``height`` sentinel (the row-wise rules of #6 and the
    plain versions skip it, so the table is untouched without a copy of
    it); every other gated op has its outputs' old values copied first,
    as the optimizer ops update in place.  Returns (found, olds): the
    device verdict and {name: old value}, or (None, None) ungated.  The
    gate is a soft read: a program whose gate var is not yet defined
    runs ungated, as in the reference."""
    gate = op.attrs.get('amp_gate_var')
    if gate is None or gate not in env:
        return None, None
    found = env[gate].reshape(()).bool()
    sparse_gated = False
    for vals in ins.values():
        for k, v in enumerate(vals):
            if isinstance(v, SelectedRows):
                vals[k] = SelectedRows(
                    torch.where(found, torch.full_like(v.rows, v.height),
                                v.rows), v.values, v.height)
                sparse_gated = True
    if sparse_gated and op.type in _ROWWISE_SPARSE_OPS:
        return found, None
    return found, {n: env[n].clone() for n in op.output_arg_names
                   if torch.is_tensor(env.get(n))}


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
    if impl.needs_env:
        ins['__env__'] = [env]
    found, olds = _gate(op, ins, env)
    ctx.op_index = op.attrs.get('op_seq', op_index)
    try:
        outs = impl.compute(ctx, ins, op.attrs) or {}
    except _build.NotTraceable as e:
        raise _build.NotTraceable("op %r: %s" % (op.type, e)) from None
    if '__env_update__' in outs:
        env.update(outs.pop('__env_update__')[0])
    for slot, names in op.outputs.items():
        for n, v in zip(names, outs.get(slot, [])):
            if v is None:
                continue
            if olds is not None and n in olds:
                v = torch.where(found, olds[n], v)
            try:
                var = ctx.block.var_recursive(n)
            except KeyError:
                var = None
            if var is not None and var.stop_gradient and not var.is_data \
                    and torch.is_tensor(v):
                v = v.detach()
            env[n] = _error_clipped(var, v)


def _op_rw(op):
    """(the names ``op`` reads, the names it writes): its slots and, for an
    op that carries a sub-block (``while``, ``conditional_block``,
    ``recurrent``), the names its attrs name (a while's condition, a
    recurrent's outer step inputs) and everything the sub-block reads or
    writes, nested blocks included.  A loop carry is read too, so what a
    sub-block writes counts among the reads; a ``while`` declares no
    outputs and reads only its condition, so without this a value only
    its body reads would be skipped or dropped before the loop runs."""
    reads, writes = set(op.input_arg_names), set(op.output_arg_names)
    idxs = _sub_block_idxs(op)
    if idxs:
        reads.update(_attr_names(op))
        for pair in op.attrs.get('step_inputs', ()):
            reads.update(pair)
        for idx in idxs:
            r, w = _block_rw_recursive(op.block.program, idx)
            reads |= r | w
            writes |= w
    return reads, writes


def live_ops(block, fetch_names):
    """Indices of the ops of ``block`` that a run fetching ``fetch_names``
    needs: ops writing a persistable, stateful-random ops and ops without
    declared outputs, and, backwards, every op writing an input of a needed
    op (an ``autodiff`` op reads its loss; a control-flow op what its
    sub-block reads, ``_op_rw``)."""
    needed = set(fetch_names)
    live = []
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        reads, outs = _op_rw(op)
        keep = (not op.output_arg_names or op.type in _STATEFUL_RANDOM or
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
            needed.update(reads)
    return live[::-1]


def _names(op):
    reads, writes = _op_rw(op)
    return reads | writes


def _drops(uses, keep):
    """For each position of ``uses`` (the names each op reads or writes),
    the names not in ``keep`` whose last use it is."""
    last = {}
    for pos, names in enumerate(uses):
        for n in names:
            last[n] = pos
    drops = [[] for _ in uses]
    for n, pos in last.items():
        if n not in keep:
            drops[pos].append(n)
    return drops


def _remat_units(fwd, frozen, level, size=None):
    """The gradient pass's forward as units ``(kind, [positions in
    fwd])``: 'keep' runs an op as it is, 'region' a run of ops whose
    saved tensors are recomputed in the backward.  ``level`` 'dots' keeps
    the COST_MAC ops and makes each run between them a region; 'full'
    cuts each run between kept ops where ``_full_cuts`` says, from the
    bytes of each value (``size``: name -> bytes, the declared shapes at
    the fed batch).  An op writing a
    ``frozen`` leaf is always kept."""
    units, run = [], []

    def flush():
        if not run:
            return
        if level == 'dots':
            units.append(('region', list(run)))
        else:
            starts = _full_cuts([fwd[k][1] for k in run], size)
            for a, b in zip(starts, starts[1:] + [len(run)]):
                units.append(('region', run[a:b]))
        del run[:]

    for k, (_, op) in enumerate(fwd):
        if frozen.intersection(op.output_arg_names) or (
                level == 'dots' and cost_class(op.type) == 'mac'):
            flush()
            units.append(('keep', [k]))
        else:
            run.append(k)
    flush()
    return units


def _full_cuts(ops, size):
    """Where 'full' starts its regions in the run ``ops``: the cuts, over
    the number of regions, that minimise the modelled memory of the
    backward, the values kept at the cuts plus the largest region's
    recompute.  A cut at p keeps what ops before p write and ops from p
    on read (``cross[p]``); a region's recompute holds what its ops
    write (``out``).  For k regions the run fills to sum(out) / k a
    region, and each cut moves back, within the second half of its
    region, to where the fewest bytes cross (in a residual net, a block's
    edge, where one value crosses, not two)."""
    n = len(ops)
    # without sizes (none declared), every value counts 1
    sized = bool(size) and any(size.get(o) for op in ops
                               for o in op.output_arg_names)

    def nbytes(name):
        return size.get(name, 0) if sized else 1

    out = [sum(nbytes(o) for o in op.output_arg_names) for op in ops]
    first, last = {}, {}
    for p, op in enumerate(ops):
        for name in op.output_arg_names:
            first.setdefault(name, p)
        for name in op.input_arg_names:
            last[name] = p
    delta = [0] * (n + 1)
    for name, w in first.items():
        if last.get(name, -1) > w:
            delta[w + 1] += nbytes(name)
            delta[last[name] + 1] -= nbytes(name)
    cross = list(itertools.accumulate(delta))
    prefix = [0] + list(itertools.accumulate(out))
    best = None
    for k in range(1, 2 * int(math.ceil(math.sqrt(n))) + 1):
        cap = prefix[n] / k
        cuts, start = [0], 0
        for p in range(n):
            if p > start and prefix[p + 1] - prefix[start] > cap:
                lo = start + max(1, (p - start) // 2)
                start = min(range(lo, p + 1), key=lambda q: (cross[q], -q))
                cuts.append(start)
        ends = cuts[1:] + [n]
        cost = sum(cross[c] for c in cuts[1:]) + max(
            prefix[b] - prefix[a] for a, b in zip(cuts, ends))
        if best is None or cost < best[0]:
            best = (cost, cuts)
    return best[1]


def _region_io(ops):
    """(the names a run of ops reads before writing them, the names it
    writes)."""
    reads, written = [], []
    seen_r, seen_w = set(), set()
    for op in ops:
        r, w = _op_rw(op)
        for n in sorted(r):
            if n not in seen_w and n not in seen_r:
                seen_r.add(n)
                reads.append(n)
        for n in sorted(w):
            if n not in seen_w:
                seen_w.add(n)
                written.append(n)
    return reads, written


def _storage_key(t):
    return t.untyped_storage().data_ptr()


class _RegionOutputs(object):
    """The tensors regions wrote in this gradient pass, by storage: a kept
    op (or another region) that saves one of them, or a view of one,
    saves a handle instead, resolved from the region's recompute.  An
    entry leaves when its tensor dies, so a reused storage is never
    taken for it."""

    def __init__(self):
        self._by_key = {}

    def add(self, t, region, name):
        key = _storage_key(t)
        entries = self._by_key.setdefault(key, [])

        def _gone(ref, key=key):
            left = [e for e in self._by_key.get(key, ()) if e[0] is not ref]
            if left:
                self._by_key[key] = left
            else:
                self._by_key.pop(key, None)
        entries.append((weakref.ref(t, _gone), region, name))

    def clear(self):
        self._by_key.clear()

    def handle(self, t):
        """('out', region, name, size, stride, offset) for a tensor whose
        storage a region's output holds, else None."""
        for ref, region, name in self._by_key.get(_storage_key(t), ()):
            base = ref()
            if base is not None and base.dtype == t.dtype:
                region.outstanding += 1
                region.out_needed.add(name)
                return ('out', region, name, tuple(t.size()), t.stride(),
                        t.storage_offset())
        return None


class _Region(object):
    """A run of forward ops whose saved tensors are recomputed in the
    backward.  The first run, under ``saved_tensors_hooks``, keeps
    strongly only what shares storage with the region's inputs (which the
    region holds) and saves a handle ``(region, k)`` for everything the
    region made; the first unpack reruns the ops on detached copies of
    the inputs, with the same ``op_index`` each, and caches the k-th
    saved tensor of the rerun for handle k, letting go of each once
    read.  Both runs drop each value after its last reader, as the
    executor does op by op; the rerun keeps, besides what was saved,
    only the outputs that kept ops took handles to (``out_needed``)."""

    def __init__(self, ops, in_names, out_names, drops, env, ctx, outputs):
        self.ops = ops
        self.inputs = {n: env[n] for n in in_names if n in env}
        self.out_names = out_names
        self.drops = drops
        self.ctx = ctx
        self.outputs = outputs
        self._in_keys = {_storage_key(t) for t in self.inputs.values()
                         if torch.is_tensor(t)}
        self.n_saved = 0
        self.outstanding = 0
        self.out_needed = set()
        self.saved = None
        self.outs = None

    def run(self, env):
        with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                      _unpack_handle):
            for (j, op), drops in zip(self.ops, self.drops):
                _run_one(op, env, self.ctx, j)
                for n in drops:
                    env.pop(n, None)
        for n in self.out_names:
            v = env.get(n)
            if torch.is_tensor(v):
                self.outputs.add(v, self, n)
        self.outputs = None   # no cycle: the registry holds the region

    def _pack(self, t):
        k = self.n_saved
        self.n_saved += 1
        if _storage_key(t) in self._in_keys:
            return _detached(t)
        h = self.outputs.handle(t)
        if h is not None:
            return h
        self.outstanding += 1
        return ('own', self, k, tuple(t.size()), t.dtype)

    def recompute(self):
        local = {n: (v.detach().requires_grad_(v.requires_grad)
                     if torch.is_tensor(v) else v)
                 for n, v in self.inputs.items()}
        rec = []

        def pack(t):
            # the rerun's graph is never differentiated: it keeps nothing
            rec.append(_detached(t))

        uses = [_names(op) for _, op in self.ops]
        last = {}
        for i, names in enumerate(uses):
            for n in names:
                last[n] = i
        with torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            for i, (j, op) in enumerate(self.ops):
                _run_one(op, local, self.ctx, j)
                for n in uses[i]:
                    if last[n] == i and n not in self.out_needed:
                        local.pop(n, None)
        if len(rec) != self.n_saved:
            raise RuntimeError(
                "rematerialization: the recompute of ops %s saved %d "
                "tensors, the forward %d; an op is not deterministic in "
                "what it saves" % ([op.type for _, op in self.ops][:4],
                                   len(rec), self.n_saved))
        self.saved = rec
        self.outs = {n: _detached(local[n]) for n in self.out_needed}

    def take(self, k, size, dtype):
        """The k-th saved tensor, recomputed at the first read; the cache
        lets go of it once read (its node holds it while it runs)."""
        if self.saved is None or self.saved[k] is None:
            self.recompute()
        t, self.saved[k] = self.saved[k], None
        if tuple(t.size()) != size or t.dtype != dtype:
            raise RuntimeError(
                "rematerialization: a recomputed tensor is %s %s, the "
                "forward saved %s %s" % (tuple(t.size()), t.dtype, size,
                                         dtype))
        self._read()
        return t

    def output(self, name):
        """The output ``name`` of the region, recomputed at need."""
        if self.outs is None:
            self.recompute()
        t = self.outs[name]
        self._read()
        return t

    def _read(self):
        self.outstanding -= 1
        if self.outstanding <= 0:
            self.saved = self.outs = None


def _unpack_handle(h):
    if not isinstance(h, tuple):
        return h
    if h[0] == 'own':
        _, region, k, size, dtype = h
        return region.take(k, size, dtype)
    _, region, name, size, stride, offset = h
    return region.output(name).as_strided(size, stride, offset)


def _detached(t):
    """``t`` without its graph: a saved tensor that holds its own
    producer would make a cycle through the graph that outlives a node
    the backward never runs."""
    return t.detach() if t.requires_grad else t


def _kept_pack(outputs):
    def pack(t):
        h = outputs.handle(t)
        return _detached(t) if h is None else h
    return pack


def _value_bytes(program, batch):
    """{name: bytes} of the global block's non-persistable values, from
    their declared shapes with the batch bound (the cost model's
    resolution); values declared without a shape are left out."""
    from ..transpiler import cost_model
    block = program.global_block()
    out = {}
    for v in block.vars.values():
        spec = None if v.persistable else cost_model._declared_spec(
            block, v.name, batch)
        if spec is not None:
            out[v.name] = cost_model._spec_bytes(spec, [0])
    return out


def _grad_slice(ops, k, ad_idxs, live):
    """The forward slice the later ``autodiff`` op ``ops[k]`` runs: the
    reference's ``_tainted_slice`` (the forward-role ops before k that
    read a name its parameters taint, by declared inputs and outputs),
    and of those the live ones its loss or a frozen parameter depends on
    (the rest cannot reach its gradients: XLA's dead-code elimination
    drops them in the reference).  Returns (the slice [(j, op)], the
    tainted ops' indices, for the reference's rollback rule)."""
    ad_op = ops[k]
    tainted = set(ad_op.attrs['param_names'])
    picked = []
    for j in range(k):
        if j in ad_idxs or _op_role(ops[j]) != 'forward':
            continue
        if set(ops[j].input_arg_names) & tainted:
            picked.append(j)
            tainted.update(ops[j].output_arg_names)
    need = {ad_op.attrs['loss_name']} | set(ad_op.attrs['param_names'])
    kept = []
    for j in reversed(picked):
        reads, writes = _op_rw(ops[j])
        if j in live and writes & need:
            kept.append(j)
            need |= reads
    return [(j, ops[j]) for j in reversed(kept)], picked


class _GradPass(object):
    """How one ``autodiff`` op runs: its forward slice ``fwd`` [(j, op)],
    the names to drop after each of its ops (``fwd_drops``), what it
    writes, its ``frozen`` leaves (parameters a slice op writes), its
    remat units, and, for a later autodiff, the names it reads at their
    pre-update values (``rollback``).  The first pass ``publish``es the
    forward values a later op, a fetch or a persistable reads
    (``needed``); a later one publishes nothing, as the reference's."""

    def __init__(self, ad_op, fwd, needed, publish, remat, size):
        self.fwd = fwd
        self.publish = publish
        self.needed = needed if publish else set()
        self.rollback = []
        self.written = set()
        for _, op in fwd:
            self.written.update(_op_rw(op)[1])
        self.fwd_drops = _drops([_names(op) for _, op in fwd],
                                self.needed | {ad_op.attrs['loss_name']})
        self.frozen = set(ad_op.attrs['param_names']) & self.written
        self.remat = remat
        self.units = []
        for kind, ks in (_remat_units(fwd, self.frozen, remat, size)
                         if remat else ()):
            reads, written = _region_io([fwd[k][1] for k in ks])
            self.units.append((kind, [fwd[k] for k in ks], reads,
                               written, [self.fwd_drops[k] for k in ks]))

    def reads(self, ad_op):
        """The names this pass reads from the environment: its
        parameters, the loss-scale var, and what its ops read before an
        op of the slice writes it."""
        out = set(ad_op.attrs['param_names'])
        out.update(n for n in (ad_op.attrs.get('loss_scale_var'),) if n)
        written = set()
        for _, op in self.fwd:
            reads, writes = _op_rw(op)
            out |= reads - written
            written |= writes
        return out


class _StepPlan(object):
    """How a run of a program's global block for one fetch list goes,
    worked out from the program alone and kept per program version (the
    reference keys its compiled plans the same way): the live ops; the
    top-level sequence, in which the first ``autodiff`` op stands for the
    forward-role ops before it (its gradient pass runs them); a
    ``_GradPass`` per autodiff op; the names to drop after each op of the
    sequence (liveness); and, for a program with several autodiff ops
    (the GAN's two ``minimize`` passes), the parameters to copy before an
    optimizer op updates them in place, because a later autodiff reads
    their pre-update values (``snapshots``: op index -> names).

    Several autodiff ops follow the reference (executor.py
    ``_run_ops``): the first runs every forward op and publishes their
    values; each later one reruns only the forward ops its parameters
    taint (``_grad_slice``), reading every other name from the
    environment, and a name an optimize-role op updated before it reads
    its value from before that update when the slice read it, in program
    order, before the update (the reference's ``pre_update_vals``)."""

    def __init__(self, program, fetch_names, size=None):
        block = program.global_block()
        ops = block.ops
        self.live = live_ops(block, fetch_names)
        alive = set(self.live)
        self.skipped = [(i, op.type) for i, op in enumerate(ops)
                        if i not in alive]
        persistable = [v.name for v in program.list_vars() if v.persistable]
        self.keep = set(fetch_names) | set(persistable)
        written = set()
        for op in ops:
            written.update(_op_rw(op)[1])
        self.write_back = [n for n in persistable if n in written]
        ad = [i for i in self.live if ops[i].type == 'autodiff']
        fwd = [(j, ops[j]) for j in self.live
               if ad and j < ad[0] and _op_role(ops[j]) == 'forward']
        in_fwd = {j for j, _ in fwd}
        self.seq = [i for i in self.live if i not in in_fwd]
        self.remat = getattr(program, '_remat_level', None)
        self.passes, self.snapshots = {}, {}
        reads = {}   # a later autodiff's reads, for liveness
        all_ad = {i for i, op in enumerate(ops) if op.type == 'autodiff'}
        for k in ad[1:]:
            sl, tainted = _grad_slice(ops, k, all_ad, alive)
            gp = self.passes[k] = _GradPass(ops[k], sl, None, False,
                                            self.remat, size)
            reads[k] = gp.reads(ops[k])
            # the reference's rollback rule, on its tainted slice: a name
            # an optimize-role op updated before k (first update only) is
            # read at its pre-update value unless every tainted op that
            # reads it came after the update
            first_update = {}
            for i in self.live:
                if i < k and _op_role(ops[i]) == 'optimize':
                    for n in ops[i].output_arg_names:
                        first_update.setdefault(n, i)
            for n, i in first_update.items():
                idxs = [j for j in tainted if n in ops[j].input_arg_names]
                if n in reads[k] and (not idxs or min(idxs) < i):
                    gp.rollback.append(n)
                    self.snapshots.setdefault(i, []).append(n)
        uses = [_names(ops[i]) for i in self.seq]
        for pos, i in enumerate(self.seq):
            if i in reads:
                uses[pos] |= reads[i]
        if ad:
            pos = self.seq.index(ad[0])
            ad_op = ops[ad[0]]
            for _, op in fwd:
                uses[pos] |= _names(op)
            uses[pos].update(ad_op.attrs['param_names'])
            # what outlives the first pass: a later op's inputs (a later
            # pass's reads), the fetches and the persistables
            needed = set(self.keep)
            for i in self.seq[pos + 1:]:
                needed.update(reads.get(i, _op_rw(ops[i])[0]))
            first = self.passes[ad[0]] = _GradPass(ad_op, fwd, needed, True,
                                                   self.remat, size)
            # the first pass's forward, as tests and tools read it
            self.fwd, self.units = first.fwd, first.units
        self.drops = _drops(uses, self.keep)


def _run_ops(ops, env, ctx, plan):
    """Interpret ``plan``'s sequence of ops in program order, dropping each
    environment entry after its last use; the parameters a later
    autodiff reads from before an update are copied just before it."""
    pre = {}
    for pos, i in enumerate(plan.seq):
        op = ops[i]
        for n in plan.snapshots.get(i, ()):
            if n in env:
                pre[n] = env[n].clone()
        if op.type == 'autodiff':
            _run_autodiff(op, plan.passes[i], env, ctx, pre)
        else:
            _run_one(op, env, ctx, i)
        for n in plan.drops[pos]:
            env.pop(n, None)


def _freeze(op, frozen, leaves, env2):
    """A ``frozen`` name ``op`` wrote becomes (or stays) its leaf."""
    for n in frozen.intersection(op.output_arg_names):
        if n not in leaves:
            leaves[n] = env2[n].detach().requires_grad_(True)
        env2[n] = leaves[n]


def _run_autodiff(ad_op, gp, env, ctx, pre):
    """Gradients of the loss with respect to ``param_names``: values from
    the environment (parameters, fed inputs; for a later autodiff, a
    rolled-back name from ``pre``), and values written by a forward op
    (``is_sparse`` lookups' outputs, ``calc_gradient``'s intermediates),
    each a leaf from the moment its op writes it (later writes keep the
    leaf).  A forward value leaves the pass's environment after its last
    forward reader unless a later op, a fetch, a persistable or the loss
    needs it (``gp.needed``); the first pass publishes the forward outputs
    needed later to ``env``, detached."""
    param_names = list(ad_op.attrs['param_names'])
    grad_names = list(ad_op.attrs['grad_names'])
    loss_name = ad_op.attrs['loss_name']
    loss_scale = float(ad_op.attrs.get('loss_scale', 1.0))
    # AMP f16: the dynamic loss scale, a persistable var; the
    # check_finite_and_unscale op after the pass divides it back out
    ls_var = ad_op.attrs.get('loss_scale_var')
    frozen = gp.frozen
    env2 = dict(env)
    for n in gp.rollback:
        if n in pre:   # absent when the update created it
            env2[n] = pre[n]
    missing = [n for n in param_names
               if n not in env2 and n not in gp.written]
    if missing:
        raise KeyError("autodiff: %s has no value before the gradient pass "
                       "and no forward op writes it" % missing[:3])
    leaves = {}
    with torch.enable_grad():
        for n in param_names:
            if n not in frozen:
                leaves[n] = env2[n].detach().requires_grad_(True)
                env2[n] = _error_clipped(ctx.block.vars.get(n), leaves[n])
        if gp.remat is None:
            for (j, op), drops in zip(gp.fwd, gp.fwd_drops):
                _run_one(op, env2, ctx, j)
                _freeze(op, frozen, leaves, env2)
                for n in drops:
                    env2.pop(n, None)
        else:
            outputs = _RegionOutputs()
            kept = _kept_pack(outputs)
            for kind, ops, reads, written_u, drops in gp.units:
                if kind == 'region':
                    # held only by the graph's handles and, while its
                    # outputs live, the registry: it goes when the
                    # backward has read what it saved
                    _Region(ops, reads, written_u, drops, env2, ctx,
                            outputs).run(env2)
                else:
                    (j, op), = ops
                    with torch.autograd.graph.saved_tensors_hooks(
                            kept, _unpack_handle):
                        _run_one(op, env2, ctx, j)
                    _freeze(op, frozen, leaves, env2)
                    for n in drops[0]:
                        env2.pop(n, None)
            # the forward is done: no more handles to hand out, and a
            # region the registry held (while its output lived, as the
            # next region's input does) would hold its own inputs through
            # the whole backward
            outputs.clear()
        if loss_name not in env2:
            raise KeyError("autodiff loss %r was never computed"
                           % loss_name)
        loss = env2[loss_name].float().sum() * loss_scale
        if ls_var is not None and ls_var in env2:
            loss = loss * env2[ls_var].float().reshape(())
        wrt = [leaves[n] for n in param_names]
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    for n in gp.written & gp.needed:
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
        # (program uid, version, fetches, feeds, plan_key) -> _StepPlan
        self._plans = {}
        self.last_graph_opt_report = None
        # the last run's or run_steps call's measured walls joined with
        # the plan's cost and memory reports (_finalize_step_report)
        self.last_step_report = None

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

    def _plan(self, program, fetch_names, staged):
        """The plan of a run: the pass pipeline's rewrite of ``program``
        and its ``_StepPlan``, kept per (program, version, fetches, feeds,
        the batch size they bind, pass configuration)."""
        from ..transpiler import cost_model, pass_manager
        feed_names = list(staged)
        feed_specs = {n: (tuple(t.shape), datatypes.convert_dtype(t.dtype))
                      for n, t in staged.items()}
        batch = cost_model._batch_binding(program.global_block(),
                                          feed_specs)
        key = (program._uid, program.version, tuple(fetch_names),
               tuple(sorted(feed_names)), batch,
               pass_manager.plan_key(program))
        plan = self._plans.get(key)
        if plan is None:
            known = set(program.global_block().vars)
            for op in program.global_block().ops:
                known.update(op.output_arg_names)
            for n in fetch_names:
                if n not in known and n not in feed_names:
                    raise KeyError(
                        "fetch var %r is not produced by any op in the "
                        "program and is not fed" % n)
            prog, report = pass_manager.run_pipeline(
                program, fetch_names=fetch_names,
                feed_names=tuple(sorted(feed_names)), feed_specs=feed_specs)
            plan = _StepPlan(prog, fetch_names, _value_bytes(prog, batch)
                             if getattr(prog, '_remat_level', None) == 'full'
                             else None)
            plan.program, plan.report = prog, report
            ops = prog.global_block().ops
            # the user's op positions the run leaves out: the pipeline's
            # dead-op elimination and the plan's own liveness
            plan.skipped = sorted(report['removed'] + [
                (ops[i].attrs.get('op_seq', i), t) for i, t in plan.skipped])
            self._plans[key] = plan
        # None when nothing rewrote the program (the reference's bypass)
        self.last_graph_opt_report = (
            plan.report if plan.report['level'] > 0 or 'amp' in plan.report
            else None)
        return plan

    def reset_cache(self):
        """Drop every plan; the next run of each program plans anew."""
        self._plans.clear()

    def _step(self, program, scope, staged, fetch_names, report=None):
        """One run of the block on a staged feed; returns the fetched
        tensors.  ``report['update_s']`` gains the write-back's wall."""
        plan = self._plan(program, fetch_names, staged)
        program = plan.program
        block = program.global_block()
        amp = plan.report.get('amp')
        if amp is not None:
            # the f16 loss-scale state the pass declares: the user runs
            # no startup program for it
            for n, v in amp['state_defaults'].items():
                if not scope.has(n):
                    scope.set(n, torch.from_numpy(v).to(self.place))

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
        self.skipped_ops = list(plan.skipped)
        with torch.no_grad():
            _run_ops(block.ops, env, ctx, plan)
            t_update = time.perf_counter()
            for name in plan.write_back:
                if name not in env:
                    continue
                new = env[name]
                old = scope.find_var(name)
                if old is new:
                    continue
                if torch.is_tensor(old) and old.shape == new.shape and \
                        old.dtype == new.dtype and old.device == new.device:
                    old.copy_(new)   # in place: the scope tensor stays
                else:
                    scope.set(name, new)
            if report is not None:
                report['update_s'] += time.perf_counter() - t_update
        fetches = []
        for n in fetch_names:
            if n not in env:
                raise KeyError("fetch var %r was never computed" % n)
            fetches.append(env[n])
        return fetches

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name='feed', fetch_var_name='fetch', scope=None,
            return_numpy=True, use_program_cache=True):
        t_call = time.perf_counter()
        program, scope, fetch_names = self._resolve(program, scope,
                                                    fetch_list)
        report = self._new_report(1)
        staged = self._stage_feed(program.global_block(), feed or {})
        report['feed_s'] = time.perf_counter() - t_call
        outs = [_fetched(t, return_numpy) for t in
                self._step(program, scope, staged, fetch_names, report)]
        self._finalize_step_report(report, t_call,
                                   synced=return_numpy and bool(outs))
        return outs

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
        t_call = time.perf_counter()
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
        report = self._new_report(k)
        staged = [self._stage_feed(block, f) for f in feeds]
        report['feed_s'] = time.perf_counter() - t_call
        per_step = []
        for i in range(k):
            outs = self._step(program, scope, staged[i % len(staged)],
                              fetch_names, report)
            for n, t in zip(fetch_names, outs):
                if not torch.is_tensor(t):
                    raise TypeError(
                        "run_steps stacks dense fetches; %r is a %s"
                        % (n, type(t).__name__))
            # a fetched persistable is updated in place by later steps
            per_step.append([t.detach().clone() for t in outs])
        stacked = [torch.stack(ts) for ts in zip(*per_step)]
        outs = [_fetched(t, return_numpy) for t in stacked]
        self._finalize_step_report(report, t_call,
                                   synced=return_numpy and bool(outs))
        return outs

    def _new_report(self, k):
        report = {'k': k, 'feed_s': 0.0, 'update_s': 0.0}
        self.last_step_report = report
        return report

    def _finalize_step_report(self, report, t_call, synced=False):
        """Join the measured walls of a ``run`` or ``run_steps`` call with
        the plan's cost report (reference: executor.py
        ``_finalize_step_report``).  ``compute_s`` is the wall less
        ``feed_s`` and ``update_s``.  Achieved FLOP/s, and ``mfu`` against
        ``PADDLE_TPU_TORCH_PEAK_TFLOPS``, are given only when ``synced``:
        the fetch copied a result to the host, so the card had finished
        inside the measured wall."""
        from ..flags import FLAGS
        wall = time.perf_counter() - t_call
        k = max(int(report['k']), 1)
        compute = max(wall - report['feed_s'] - report['update_s'], 0.0)
        report.update(wall_s=wall, compute_s=compute, synced=bool(synced))
        cost = (self.last_graph_opt_report or {}).get('cost')
        feed_phase = {'wall_s': report['feed_s']}
        compute_phase = {'wall_s': compute}
        update_phase = {'wall_s': report['update_s']}
        if cost is not None and cost.get('total') is not None:
            total = cost['total']
            compute_phase.update({
                'flops': total['flops'] * k,
                'bytes': total['bytes'] * k,
                'flops_per_step': total['flops'],
                'bytes_per_step': total['bytes'],
                'intensity': total['intensity'],
                'per_role_flops': {r: v['flops']
                                   for r, v in cost['per_role'].items()},
            })
            if synced and compute > 0.0 and total['flops']:
                compute_phase['flops_per_s'] = total['flops'] * k / compute
                peak = float(FLAGS.peak_tflops or 0.0)
                if peak > 0:
                    compute_phase['mfu'] = (compute_phase['flops_per_s'] /
                                            (peak * 1e12))
            if cost.get('feed_bytes') is not None:
                feed_phase['modeled_bytes_per_step'] = cost['feed_bytes']
            update_phase['state_bytes'] = cost.get('state_bytes', 0)
        report['phases'] = {'feed': feed_phase, 'compute': compute_phase,
                            'update': update_phase}
        report['cost'] = cost
        report['memory'] = self._memory_report(cost)
        return report

    def _memory_report(self, cost):
        """The memory block of ``last_step_report``: the modelled peak
        (transpiler/memory_model.py) beside the measured one,
        ``torch.cuda.max_memory_allocated`` (the peak since the caller's
        last ``torch.cuda.reset_peak_memory_stats``) on a CUDA place and
        None on the CPU, with a headroom block against
        ``PADDLE_TPU_TORCH_PEAK_HBM_BYTES`` when it is set."""
        from ..flags import FLAGS
        mem = (cost or {}).get('memory')
        measured = None
        if self.place.type == 'cuda':
            measured = {'peak_bytes_in_use':
                        torch.cuda.max_memory_allocated(self.place),
                        'bytes_in_use':
                        torch.cuda.memory_allocated(self.place)}
        entry = {
            'modeled_peak_bytes': (mem or {}).get('peak_bytes'),
            'modeled_persistable_bytes':
                (mem or {}).get('persistable_bytes'),
            'watermark_op': ((mem or {}).get('watermark') or [None])[0],
            'remat_level': (mem or {}).get('remat_level'),
            'measured': measured,
        }
        if measured is not None:
            entry['measured_peak_bytes'] = measured['peak_bytes_in_use']
        budget = int(FLAGS.peak_hbm_bytes or 0)
        if budget > 0:
            head = {'budget_bytes': budget}
            if entry['modeled_peak_bytes']:
                head['modeled_ratio'] = entry['modeled_peak_bytes'] / budget
            if measured is not None and measured['peak_bytes_in_use']:
                head['measured_ratio'] = (measured['peak_bytes_in_use'] /
                                          budget)
            entry['headroom'] = head
        return entry

    def _compile_common(self, program, feed, fetch_list, scope):
        """The pure step function of ``program`` for ``fetch_list`` and
        its example arguments (reference: executor.py
        ``_compile_common``).  ``feed`` is staged as ``run`` stages it
        and binds the plan; the state is read from ``scope`` as tensors
        on the executor's device and nothing is written back."""
        program, scope, fetch_names = self._resolve(program, scope,
                                                    fetch_list)
        staged = self._stage_feed(program.global_block(), feed or {})
        plan = self._plan(program, fetch_names, staged)
        prog = plan.program
        state_rw, state_ro = {}, {}
        written = set(plan.write_back)
        defaults = (plan.report.get('amp') or {}).get('state_defaults', {})
        for v in prog.list_vars():
            if not v.persistable or v.name in staged:
                continue
            if scope.has(v.name):
                t = scope.get(v.name)
                if not torch.is_tensor(t):
                    t = self._to_device(v.name, t, v)
                elif t.device != self.place:
                    raise ValueError(
                        "scope value %r lies on %s, the executor runs on %s"
                        % (v.name, t.device, self.place))
            elif v.name in defaults:
                t = torch.from_numpy(defaults[v.name]).to(self.place)
            else:
                continue
            (state_rw if v.name in written else state_ro)[v.name] = t
        seed = (self._base_seed(program), self._step_count)
        device = self.place

        def raw(feed, state_rw, state_ro, seed):
            """(fetches, new_state): one run of the plan on ``feed`` (card
            tensors, as ``run`` stages them) and the state, whose
            read-write part is copied first so the caller's tensors stay
            as they were.  No host sync, nothing written to a scope."""
            block = prog.global_block()
            env = {n: t.clone() for n, t in state_rw.items()}
            env.update(state_ro)
            env.update(feed)
            ctx = ExecutionContext(prog, block, device, seed[0], seed[1])
            with torch.no_grad():
                _run_ops(block.ops, env, ctx, plan)
            for n in fetch_names:
                if n not in env:
                    raise KeyError("fetch var %r was never computed" % n)
            return ([env[n] for n in fetch_names],
                    {n: env[n] for n in state_rw if n in env})

        return raw, (staged, state_rw, state_ro, seed)

    def compile(self, program=None, feed=None, fetch_list=None, scope=None):
        """Build (but do not run) the step function of a program: returns
        (fn, example_args) where ``fn(feed, state_rw, state_ro, seed) ->
        (fetches, new_state)`` runs the plan ``run`` would run on that
        feed's shapes, without writing the scope or counting a step.
        ``seed`` is (base seed, step), the per-op generators' key, in the
        place of the reference's ``rng_key``.  The function is what
        ``torch.export`` traces (inference/serving.py).  The reference
        returns it jitted; PyTorch runs eagerly, so ``compile`` and
        ``compile_raw`` return the same function."""
        return self._compile_common(program, feed, fetch_list, scope)

    def compile_raw(self, program=None, feed=None, fetch_list=None,
                    scope=None):
        """``compile``'s function, unwrapped (the reference's hook for
        re-jitting with explicit shardings): the same function here."""
        return self._compile_common(program, feed, fetch_list, scope)
