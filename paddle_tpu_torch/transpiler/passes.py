"""Graph-optimization passes: rewrite a Program block before the
executor runs it.

Reference parity: paddle_tpu/transpiler/passes.py (paddle/framework/
prune.cc and the ProgramDesc-rewriting transpilers).  The pipeline
(transpiler/pass_manager.py) runs them once per executor plan, gated by
``PADDLE_TPU_TORCH_GRAPH_OPT_LEVEL`` (0 off, 1 dead-op elimination only,
2 all, default 2).  The port runs ops eagerly, so a dead or duplicate op
costs a kernel launch (or several) on every step, and a constant chain
recomputes on every step what the plan can compute once.

Passes (each rewrites the pipeline's own copy of the program):

- **dead-op elimination**: backward liveness from the fetch set plus
  persistable writes; ops whose outputs are never consumed are dropped.
- **constant folding**: ops whose inputs are all plan-time constants
  (``fill_constant`` / shape / scale / cast chains) are evaluated on the
  CPU, with the port's own op implementations, when the plan is built,
  and replaced by one ``assign_value`` where the value is still read.
- **common-subexpression elimination**: side-effect-free ops with equal
  (type, inputs, attrs) within the block reuse the first result.
- **donation/liveness analysis**: reports which non-persistable
  intermediates die right after their last reader (the executor frees
  them there, core/executor.py).

Conservatism contract: ops with side effects, random draws, control flow
or sub-block attrs are never folded or deduped; random streams survive
op removal because every surviving op is stamped with its pre-pass
position (``op_seq``) and the executor keys each op's generator on that
stamp.
"""
import collections

import numpy as np
import torch

from ..core import datatypes
from ..core.registry import has_op, op_traits

__all__ = [
    'dce_pass', 'constant_fold_pass', 'cse_pass',
    'analyze_donation', 'EFFECTFUL_OPS', 'CSE_OPS', 'FOLDABLE_OPS',
]

# ---------------------------------------------------------------------------
# Op classification.
#
# EFFECTFUL_OPS are never removed, folded, or deduped: control flow
# (sub-block interpreters), cross-device communication (removing a dead
# collective on one peer deadlocks the others), and host side effects.
EFFECTFUL_OPS = frozenset({
    'while', 'conditional_block', 'parallel_do', 'recurrent',
    'print', 'send', 'recv',
    'allreduce', 'allgather', 'reducescatter', 'broadcast',
})

# CSE_OPS: deterministic value-semantics ops safe to dedupe within a block
# — pure functions of (inputs, attrs) with no RNG, no env access, no
# LoDTensorArray/beam/optimizer-state structure.  This is an explicit
# whitelist, not a denylist: a newly registered op is NOT CSE-able until
# someone asserts its purity by adding it here.  The list is the
# reference's, names the port does not register yet included.
CSE_OPS = frozenset({
    # activations (ops/activations.py — all elementwise pure)
    'abs', 'brelu', 'ceil', 'elu', 'exp', 'floor', 'hard_shrink',
    'hard_sigmoid', 'leaky_relu', 'log', 'logsigmoid', 'pow', 'prelu',
    'reciprocal', 'relu', 'relu6', 'round', 'sigmoid', 'sign',
    'soft_relu', 'softplus', 'softshrink', 'softsign', 'sqrt', 'square',
    'stanh', 'swish', 'tanh', 'tanh_shrink', 'thresholded_relu',
    # math
    'matmul', 'mul', 'minus', 'scale', 'sum', 'mean', 'increment',
    'sign_of', 'clip', 'clip_by_norm', 'l1_norm', 'squared_l2_norm',
    'squared_l2_distance', 'cos_sim', 'bilinear_tensor_product',
    'elementwise_add', 'elementwise_sub', 'elementwise_mul',
    'elementwise_div', 'elementwise_max', 'elementwise_min',
    'elementwise_mod', 'elementwise_pow',
    'reduce_sum', 'reduce_mean', 'reduce_max', 'reduce_min',
    'reduce_prod',
    # compare / logical
    'equal', 'not_equal', 'less_than', 'less_equal', 'greater_than',
    'greater_equal', 'logical_and', 'logical_or', 'logical_not',
    'logical_xor',
    # tensor manipulation
    'cast', 'assign', 'assign_value', 'fill_constant', 'fill',
    'fill_zeros_like', 'fill_constant_batch_size_like', 'reshape',
    'transpose', 'concat', 'split', 'expand', 'pad', 'crop', 'gather',
    'one_hot', 'multiplex', 'select', 'top_k',
    # nn forward (pure given inputs; running-stat updates ride declared
    # persistable outputs, which the dedup guard protects anyway, but
    # batch_norm is excluded outright below for clarity)
    'conv2d', 'conv2d_transpose', 'conv3d', 'conv3d_transpose',
    'pool2d', 'pool3d', 'max_pool2d_with_index', 'lrn', 'layer_norm',
    'softmax', 'lookup_table', 'row_conv', 'conv_shift', 'maxout',
    # losses
    'cross_entropy', 'softmax_with_cross_entropy',
    'sigmoid_cross_entropy_with_logits', 'square_error_cost',
    'smooth_l1', 'smooth_l1_loss', 'hinge_loss', 'huber_loss',
    'log_loss', 'margin_rank_loss', 'modified_huber_loss', 'rank_loss',
    # metrics (stateless computations; accumulator state is persistable)
    'accuracy',
})

# FOLDABLE_OPS ⊂ CSE_OPS: additionally cheap + meaningful to evaluate
# eagerly on the host at plan-build time.  Heavy ops (conv/matmul) are
# excluded, and constants that big get capped anyway.
FOLDABLE_OPS = frozenset({
    'fill_constant', 'fill', 'assign_value', 'fill_zeros_like',
    'fill_constant_batch_size_like', 'cast', 'scale', 'assign',
    'increment', 'reshape', 'transpose', 'concat', 'split', 'expand',
    'pad', 'crop', 'one_hot', 'gather', 'select', 'clip',
    'elementwise_add', 'elementwise_sub', 'elementwise_mul',
    'elementwise_div', 'elementwise_max', 'elementwise_min',
    'elementwise_mod', 'elementwise_pow', 'minus', 'sum', 'mean',
    'reduce_sum', 'reduce_mean', 'reduce_max', 'reduce_min',
    'reduce_prod', 'equal', 'not_equal', 'less_than', 'less_equal',
    'greater_than', 'greater_equal', 'logical_and', 'logical_or',
    'logical_not', 'logical_xor', 'abs', 'exp', 'log', 'sqrt',
    'square', 'sign', 'floor', 'ceil', 'round', 'relu', 'sigmoid',
    'tanh', 'pow',
})

# ops that source constants from attrs alone (no inputs); when their
# value is needed after a fold, the original op is re-inserted rather
# than rewritten to assign_value (no win in replacing like with like)
CONST_SOURCE_OPS = frozenset({'fill_constant', 'fill', 'assign_value'})

# never bake a folded constant bigger than this into the program (it
# would bloat the program instead of shrinking it)
MAX_FOLD_BYTES = 1 << 20

# attr keys whose values name variables (control-flow carries, autodiff
# diff targets).  Names reached only through these must stay defined.
_NAME_ATTR_KEYS = (
    'condition', 'loss_name', 'param_names', 'grad_names',
    'split_inputs', 'output_names', 'step_outputs',
)
_SUB_BLOCK_ATTR_KEYS = ('sub_block', 'block')


def _resolve_level(level):
    if level is None:
        from ..flags import FLAGS
        try:
            level = int(FLAGS.graph_opt_level)
        except (ValueError, TypeError):
            level = 2
    return max(0, min(2, int(level)))


def _is_effectful(op):
    if op.type in EFFECTFUL_OPS:
        return True
    if op_traits(op.type).needs_env:
        return True   # an environment op is a barrier even if not listed
    if any(k in op.attrs for k in _SUB_BLOCK_ATTR_KEYS):
        return True
    if not op_traits(op.type).registered and op.type != 'autodiff':
        return True  # unknown op: never touch it
    return False


def _sub_block_idxs(op):
    return [int(op.attrs[k]) for k in _SUB_BLOCK_ATTR_KEYS
            if k in op.attrs]


def _block_rw_recursive(program, block_idx, _seen=None):
    """(read, written) var-name sets of a block, nested blocks included."""
    if _seen is None:
        _seen = set()
    if block_idx in _seen:
        return set(), set()
    _seen.add(block_idx)
    read, written = set(), set()
    for op in program.blocks[block_idx].ops:
        read.update(op.input_arg_names)
        written.update(op.output_arg_names)
        for idx in _sub_block_idxs(op):
            r2, w2 = _block_rw_recursive(program, idx, _seen)
            read |= r2
            written |= w2
    return read, written


def _attr_names(op):
    """Variable names referenced through attrs (not input/output slots)."""
    names = []
    for k in _NAME_ATTR_KEYS:
        v = op.attrs.get(k)
        if isinstance(v, str):
            names.append(v)
        elif isinstance(v, (list, tuple)):
            for item in v:
                if isinstance(item, str):
                    names.append(item)
                elif isinstance(item, (list, tuple)):
                    names.extend(s for s in item if isinstance(s, str))
    # recurrent memories: [{'outer':…, 'inner':…, 'init':…}, …]
    mems = op.attrs.get('memories')
    if isinstance(mems, (list, tuple)):
        for m in mems:
            if isinstance(m, dict):
                names.extend(v for v in m.values() if isinstance(v, str))
    # recurrent step_inputs: [(outer, inner), …] covered by the generic
    # list-of-lists walk above
    return names


def _op_reads(program, op):
    """Every name whose value the op may consume: declared inputs, names
    referenced via attrs, and — for sub-block ops — everything the
    sub-block reads OR writes (control-flow carries seed from the outer
    env, so sub-block-written names are read too)."""
    names = set(op.input_arg_names)
    names.update(_attr_names(op))
    if op.type == 'autodiff':
        names.update(op.attrs.get('param_names', ()))
        loss = op.attrs.get('loss_name')
        if loss:
            names.add(loss)
    for idx in _sub_block_idxs(op):
        r, w = _block_rw_recursive(program, idx)
        names |= r
        names |= w
    return names


def _op_writes(program, op):
    """Every name the op may (re)define in the outer env: declared
    outputs plus — for sub-block ops — the sub-block's written set
    (control-flow ops publish carries via __env_update__ without
    declaring them as outputs, e.g. `while` declares outputs={})."""
    names = set(op.output_arg_names)
    for idx in _sub_block_idxs(op):
        _r, w = _block_rw_recursive(program, idx)
        names |= w
    return names


def _persistable_names(program):
    return {v.name for v in program.list_vars() if v.persistable}


def _control_referenced_names(program):
    """Names reachable only through control-flow machinery or attrs:
    anything a sub-block reads or writes, and anything referenced by an
    attr (renames rewrite input slots only, never attrs).  Producers of
    these names must stay in place verbatim — no dedup, no
    fold-and-rematerialize (rematerialization moves the definition to
    the consumer's position)."""
    names = set()
    for b in program.blocks:
        for op in b.ops:
            names.update(_attr_names(op))
            if op.type == 'autodiff':
                names.update(op.attrs.get('param_names', ()))
                names.update(op.attrs.get('grad_names', ()))
            for idx in _sub_block_idxs(op):
                r, w = _block_rw_recursive(program, idx)
                names |= r
                names |= w
    return names


def _protected_names(program, fetch_names, feed_names):
    """Names whose producing op must never be removed-by-dedup or left
    unmaterialized by folding: the fetch set, persistables, feeds, and
    every control-referenced name."""
    protected = set(fetch_names) | set(feed_names)
    protected |= _persistable_names(program)
    protected |= _control_referenced_names(program)
    return protected


def _stamp_op_seq(block):
    """Stamp every op with its pre-pass position.  The executor keys
    each op's generator on this stamp (ctx.op_index), so random streams
    (dropout masks, *_random draws) are bitwise-identical whether or not
    earlier ops were eliminated: the level-1 exactness contract."""
    for i, op in enumerate(block.ops):
        op.attrs.setdefault('op_seq', i)


# ---------------------------------------------------------------------------
# Pass 1: dead-op elimination
# ---------------------------------------------------------------------------

def dce_pass(program, fetch_names=(), extra_live=()):
    """Backward liveness from fetch targets + persistable writes (+ any
    caller-pinned `extra_live` names, e.g. memory_optimize's
    skip_opt_set); drop ops whose outputs are never consumed.  Effectful
    ops are always kept and root everything they may read.  Returns
    #ops removed."""
    block = program.global_block()
    persist = _persistable_names(program)
    live = set(fetch_names) | persist | set(extra_live)
    kept = []
    removed = 0
    for op in reversed(block.ops):
        outs = set(op.output_arg_names)
        if _is_effectful(op):
            keep = True
        elif op.type == 'autodiff':
            keep = bool(set(op.attrs.get('grad_names', ())) & live)
        else:
            keep = bool(outs & live)
        if not keep:
            removed += 1
            continue
        kept.append(op)
        # redefinition kills liveness of the *declared* outputs only —
        # undeclared sub-block publishes are conservatively never killed
        live -= set(op.output_arg_names)
        live |= _op_reads(program, op)
    kept.reverse()
    block.ops = kept
    return removed


# ---------------------------------------------------------------------------
# Pass 2: constant folding
# ---------------------------------------------------------------------------

class _FoldCtx(object):
    """Minimal ExecutionContext stand-in for eager evaluation of pure
    whitelisted ops on the CPU.  Anything random raises, which the fold
    loop treats as 'not foldable'."""
    device = torch.device('cpu')
    op_index = 0
    block = None
    program = None

    def generator(self, extra=0):
        raise RuntimeError("constant folding must not draw random numbers")


# the reference evaluates with 64-bit types off; a folded constant keeps
# its width
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32}


def _eval_op(op, const_env):
    """Eagerly evaluate one whitelisted op over host constants.  Returns
    {output_name: np.ndarray} or raises (caller skips the fold)."""
    from ..core.registry import get_op_impl
    impl = get_op_impl(op.type)
    if impl.needs_env or impl.stateful_rng:
        raise RuntimeError("op %r draws random numbers" % op.type)
    ins = {slot: [torch.from_numpy(np.array(const_env[n])) for n in names]
           for slot, names in op.inputs.items()}
    with torch.no_grad():
        outs = impl.compute(_FoldCtx(), ins, op.attrs) or {}
    result = {}
    total = 0
    for slot, names in op.outputs.items():
        vals = outs.get(slot, [])
        if len(vals) < len(names):
            raise RuntimeError("op %r produced fewer outputs than "
                               "declared" % op.type)
        for n, v in zip(names, vals):
            if v is None:
                raise RuntimeError("null output")
            v = v.to(_NARROW.get(v.dtype, v.dtype))
            arr = v.numpy()   # raises for bfloat16: that value stays live
            total += arr.nbytes
            result[n] = arr
    if total > MAX_FOLD_BYTES:
        raise RuntimeError("folded constant too large (%d bytes)" % total)
    return result


def _materialize_const(src_op, name, value):
    """Build the op that re-defines a folded-away constant where it is
    still consumed: the original op when it was already a pure constant
    source, else a single assign_value holding the computed value.

    Materialized ops carry NO op_seq stamp: they land at the consumer's
    position, so a copied stamp would break the strictly-monotonic
    stamp order the verifier enforces, and none of them draws random
    numbers."""
    from ..core.program import Operator
    if src_op.type in CONST_SOURCE_OPS and not src_op.input_arg_names:
        src_op.attrs.pop('op_seq', None)
        return src_op
    attrs = {
        'values': np.asarray(value),
        'shape': list(value.shape),  # [] keeps a 0-d scalar 0-d
        'dtype': str(value.dtype),
        'op_role': src_op.attrs.get('op_role', 'forward'),
    }
    return Operator(src_op.block, 'assign_value',
                    inputs={}, outputs={'Out': [name]}, attrs=attrs)


def constant_fold_pass(program, fetch_names=(), feed_names=(),
                       protected=None, no_fold=None):
    """Evaluate ops whose inputs are all compile-time constants into
    single constant vars.  Ops writing persistables, feed names, or
    `no_fold` names (control-referenced + caller-pinned — the pass manager
    passes the precomputed set so the block walk isn't repeated per
    pass) are never folded.  Returns #ops eliminated (folded minus
    materialized)."""
    block = program.global_block()
    if protected is None:
        protected = _protected_names(program, fetch_names, feed_names)
    if no_fold is None:
        no_fold = (_persistable_names(program)
                   | _control_referenced_names(program))
    no_fold_out = set(no_fold) | set(feed_names)

    const_env = {}   # name -> np value (current definition is constant)
    pending = {}     # folded-away name -> (source op, np value)
    new_ops = []
    folded = 0
    materialized = 0

    def materialize(name):
        src, val = pending.pop(name)
        new_ops.append(_materialize_const(src, name, val))

    for op in block.ops:
        outs = set(op.output_arg_names)
        # control-referenced outputs are in no_fold_out: their
        # rematerialization would land at the consumer's position, and
        # control-flow programs must keep their op order verbatim
        foldable = (
            op.type in FOLDABLE_OPS and has_op(op.type)
            and not _is_effectful(op)
            and not (outs & no_fold_out)
            and all(n in const_env for n in op.input_arg_names))
        if foldable:
            try:
                vals = _eval_op(op, const_env)
            except Exception:
                vals = None
            if vals is not None:
                folded += 1
                for n, v in vals.items():
                    const_env[n] = v
                    pending[n] = (op, v)
                continue
        # op survives: materialize any folded constant it still reads
        # (declared inputs, attr-referenced names, sub-block reads),
        # *before* it runs
        for n in sorted(_op_reads(program, op) & set(pending)):
            materialized += 1
            materialize(n)
        # its writes invalidate constness of the names it (re)defines
        for n in _op_writes(program, op):
            const_env.pop(n, None)
            pending.pop(n, None)
        new_ops.append(op)

    # constants that escape the block (fetched / protected) need a
    # definition at the end of the rewritten op list
    for n in sorted((set(fetch_names) | protected) & set(pending)):
        materialized += 1
        materialize(n)
    block.ops = new_ops
    return folded - materialized


# ---------------------------------------------------------------------------
# Pass 3: common-subexpression elimination
# ---------------------------------------------------------------------------

def _attr_key(attrs):
    """Stable hashable serialization of an op's attrs, ignoring keys that
    don't affect the computed value (position stamps, role tags)."""
    items = []
    for k in sorted(attrs):
        if k in ('op_seq', 'op_role'):
            continue
        items.append((k, _val_key(attrs[k])))
    return tuple(items)


def _val_key(v):
    if isinstance(v, np.ndarray):
        return ('nd', str(v.dtype), v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return ('seq',) + tuple(_val_key(x) for x in v)
    if isinstance(v, dict):
        return ('map',) + tuple(
            (k, _val_key(v[k])) for k in sorted(v))
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def cse_pass(program, fetch_names=(), feed_names=(), protected=None):
    """Hash side-effect-free ops by (type, input values, attrs) within
    the global block and reuse the first result.  Name redefinition is
    handled by versioning: an expression is only reusable while both its
    inputs and its outputs still hold the values they had at definition.
    Returns #ops removed."""
    block = program.global_block()
    if protected is None:
        protected = _protected_names(program, fetch_names, feed_names)

    # only names written exactly once in the block are safe canonical
    # targets: a rename points at them forever, so a later redefinition
    # would silently swap the value under the renamed readers
    write_counts = collections.Counter()
    for op in block.ops:
        for n in _op_writes(program, op):
            write_counts[n] += 1

    ver = collections.defaultdict(int)  # name -> definition version
    rename = {}                         # removed name -> canonical name
    exprs = {}                          # expr key -> (outputs, versions)
    new_ops = []
    removed = 0

    for op in block.ops:
        if rename:
            op.inputs = {
                slot: [rename.get(n, n) for n in names]
                for slot, names in op.inputs.items()}
        outs = op.output_arg_names
        candidate = (
            op.type in CSE_OPS and has_op(op.type)
            and not _is_effectful(op)
            and op.attrs.get('op_role', 'forward') == 'forward'
            and not (set(outs) & protected))
        if candidate:
            in_key = tuple(
                (slot, tuple((n, ver[n]) for n in names))
                for slot, names in sorted(op.inputs.items()))
            out_slots = tuple(
                (slot, len(names))
                for slot, names in sorted(op.outputs.items()))
            key = (op.type, in_key, _attr_key(op.attrs), out_slots)
            hit = exprs.get(key)
            if hit is not None:
                canon_outputs, canon_vers = hit
                if all(ver[n] == canon_vers[n]
                       for ns in canon_outputs.values() for n in ns):
                    # drop the duplicate; later reads of its outputs go
                    # to the canonical names
                    for slot, names in op.outputs.items():
                        for old, new in zip(names, canon_outputs[slot]):
                            if old != new:
                                rename[old] = new
                    removed += 1
                    continue
            # miss (or canonical overwritten since): this op defines the
            # expression from here on — recordable only when its outputs
            # are single-assignment in the block (see write_counts)
            for n in outs:
                ver[n] += 1
                rename.pop(n, None)
            if all(write_counts[n] == 1 for n in outs):
                exprs[key] = (dict(op.outputs),
                              {n: ver[n] for n in outs})
            new_ops.append(op)
            continue
        # non-candidate: it may redefine anything it writes (sub-block
        # publishes included), killing both renames and cached exprs
        # that read the old values
        for n in _op_writes(program, op):
            ver[n] += 1
            rename.pop(n, None)
        new_ops.append(op)

    block.ops = new_ops
    return removed


# ---------------------------------------------------------------------------
# Pass 4: donation / liveness analysis
# ---------------------------------------------------------------------------

def analyze_donation(program, fetch_names=(), feed_names=()):
    """Classify non-persistable intermediates of the global block by
    lifetime.  ``donatable`` vars never escape the step (not fetched,
    not persistable, not feeds) so their buffers are dead the moment
    their last consumer runs; the executor frees them there, and this
    report is how that headroom becomes visible (memory_optimize).
    ``short_lived`` names die at the op immediately after their birth —
    the tightest reuse candidates."""
    block = program.global_block()
    persist = _persistable_names(program)
    birth, last_use = {}, {}
    for i, op in enumerate(block.ops):
        for n in _op_reads(program, op):
            last_use[n] = i
        for n in _op_writes(program, op):
            birth.setdefault(n, i)
    escaping = set(fetch_names) | persist | set(feed_names)
    donatable, short_lived = [], []
    for n, b in birth.items():
        if n in escaping:
            continue
        lu = last_use.get(n)
        if lu is None or lu < b:
            continue  # dead (DCE territory), not a reuse candidate
        donatable.append(n)
        if lu == b + 1:
            short_lived.append(n)
    bytes_known = 0
    for n in donatable:
        v = block.vars.get(n)
        if v is None or not v.shape:
            continue
        size = 1
        for d in v.shape:
            size *= max(int(d), 1)  # -1 batch dims count 1: lower bound
        bytes_known += size * datatypes.itemsize(v.dtype)
    return {
        'intermediates': len(birth) - len(set(birth) & escaping),
        'donatable': sorted(donatable),
        'short_lived': sorted(short_lived),
        'bytes_known': int(bytes_known),
    }
