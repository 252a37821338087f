"""Static program verifier for the pass-pipeline.

Reference parity: paddle_tpu/transpiler/verify.py (the Fluid core's
framework.proto schema checks, shape_inference.h re-inference and
op_registry.h proto checks).  The executor runs a program op by op, so a
rewrite-pass bug or a mis-built layer would otherwise surface as a
KeyError or a shape error in some later op.  The verifier checks the
global block after the pass pipeline (``PADDLE_TPU_TORCH_VERIFY_IR=
boundary``, the default) or after every rewrite pass (``every_pass``,
which names the pass at fault), with op- and var-precise messages.

Checks (each returns diagnostics and never mutates the program):

- **def-before-use**: every name an op reads (input slots, attr-read
  names, a sub-block's external reads) is a feed, a persistable, or
  written earlier.
- **op signatures**: declared input/output slots and required attrs
  against the registry's introspected ``op_signature()``.
- **dtype/shape re-inference**: declared VarDesc dtype and shape agree
  with the op's compute function run on meta tensors (core/infer.py;
  memoized, and skipped where the function cannot run on meta tensors).
- **op_seq monotonicity**: position stamps strictly increase, and every
  random op carries one after stamping ran.
- **pinned-name invariants** (``verify_rewrite`` against a pre-pass
  ``pin_snapshot``): persistables are never renamed, eliminated or
  re-typed, and fetch targets stay produced.
- **AMP cast consistency** (post-AMP): no weaver cast to a 16-bit dtype
  feeds an AMP_BLACK op directly, and cast CSE holds: at most one cast
  per (value, dtype) within one definition of the value.
- **donation order**: no read of a name moved after the op that ended
  its value's life (a feed redefined, an optimizer's in-place update).

The reference's sharding, embedding-lowering and overlap checks come with
the passes they check (ROADMAP.md Queue 1 item 10).
"""
import numpy as np

from ..core import datatypes
from ..core.registry import op_signature, op_traits
from . import passes

__all__ = [
    'IRVerificationError', 'resolve_mode', 'verify_program',
    'check_program', 'pin_snapshot', 'verify_rewrite',
]

_MODES = ('off', 'boundary', 'every_pass')


class IRVerificationError(KeyError):
    """A program failed static verification.  ``errors`` is the full
    diagnostic list; ``pass_name`` attributes the failure to the rewrite
    pass after which verification first failed (every_pass mode), or
    None for a boundary check.

    A KeyError, as the executor's own "reads a name which has no value"
    is: a program that reads an unfed, unwritten name is now caught here,
    before its first op runs, and callers catching the executor's error
    catch this one."""

    def __init__(self, errors, pass_name=None):
        self.errors = list(errors)
        self.pass_name = pass_name
        where = (" after pass %r" % pass_name) if pass_name else ""
        self.message = "IR verification failed%s (%d error%s):\n  %s" % (
            where, len(self.errors), 's' if len(self.errors) != 1 else '',
            '\n  '.join(self.errors))
        super(IRVerificationError, self).__init__(self.message)

    def __str__(self):
        return self.message


def resolve_mode(mode=None):
    """Normalise a PADDLE_TPU_TORCH_VERIFY_IR value to one of _MODES."""
    if mode is None:
        from ..flags import FLAGS
        mode = FLAGS.verify_ir
    mode = str(mode or '').strip().lower()
    if mode in ('', '0', 'false', 'no', 'none', 'off'):
        return 'off'
    if mode in ('boundary', '1', 'true', 'yes', 'on'):
        return 'boundary'
    if mode in ('every_pass', 'everypass', 'every-pass', 'all'):
        return 'every_pass'
    raise ValueError(
        "PADDLE_TPU_TORCH_VERIFY_IR must be one of off/boundary/"
        "every_pass, "
        "got %r" % (mode,))


# The reference's per-op waivers of the signature checks: its
# ALLOWED_EXTRA_IN_SLOTS and ALLOWED_EXTRA_OUT_SLOTS are empty.

# op type -> attr keys introspected as required that an OpDesc may omit.
ALLOWED_MISSING_ATTRS = {
    # `recurrent` reads attrs['seq_len'] only when it has no step inputs
    # (a boot-only RNN), in a conditional expression the introspection
    # counts as unconditional.
    'recurrent': {'seq_len'},
}

# ops excluded from the re-inference agreement check.
INFER_SKIP_OPS = {
    # interpreter-level pseudo-op: no registered compute function
    'autodiff',
    # returns a SelectedRows — there is no (shape, dtype) verdict to
    # compare, and a sparse model carries one per sparse param, so
    # evaluating them is pure cold-start cost with zero findings
    'sparse_grad_assemble',
}

# attr keys that name variables the op READS (subset of
# passes._NAME_ATTR_KEYS — the others name variables the op defines).
# `amp_gate_var` is deliberately absent: the executor reads it through
# an `in env` guard (soft read), so a program where the gate var is
# only defined downstream is still well-formed.
_ATTR_READ_KEYS = ('condition', 'loss_name', 'split_inputs',
                   'loss_scale_var')


def _op_str(block_idx, i, op):
    return "op #%d (%s) in block %d" % (i, op.type, block_idx)


# ---------------------------------------------------------------------------
# structure: sub-block references, attr sanity
# ---------------------------------------------------------------------------

def _check_structure(program, errors):
    n_blocks = len(program.blocks)
    for b in program.blocks:
        for i, op in enumerate(b.ops):
            for k in passes._SUB_BLOCK_ATTR_KEYS:
                if k not in op.attrs:
                    continue
                try:
                    idx = int(op.attrs[k])
                except (TypeError, ValueError):
                    errors.append(
                        "%s: attr %r must be a block index, got %r"
                        % (_op_str(b.idx, i, op), k, op.attrs[k]))
                    continue
                if not (0 < idx < n_blocks):
                    errors.append(
                        "%s: attr %r references sub-block %d, but the "
                        "program has blocks 0..%d (dangling sub-block "
                        "ref)" % (_op_str(b.idx, i, op), k, idx,
                                  n_blocks - 1))
            if 'op_seq' in op.attrs and \
                    not isinstance(op.attrs['op_seq'], (int, np.integer)):
                errors.append(
                    "%s: op_seq stamp must be an int, got %r"
                    % (_op_str(b.idx, i, op), op.attrs['op_seq']))


# ---------------------------------------------------------------------------
# registry signatures
# ---------------------------------------------------------------------------

def _check_signatures(program, errors):
    for b in program.blocks:
        for i, op in enumerate(b.ops):
            if op.type == 'autodiff':
                continue  # interpreter pseudo-op (core/backward.py)
            traits = op_traits(op.type)
            if not traits.registered:
                errors.append(
                    "%s: op type %r is not registered — the executor "
                    "would raise when it reaches the op"
                    % (_op_str(b.idx, i, op), op.type))
                continue
            sig = op_signature(op.type)
            if sig is None:
                continue
            if not traits.needs_env:
                # a control-flow op binds its slots through the live
                # environment: they exist for liveness, not for its
                # compute function
                if not sig.in_open:
                    for slot in sorted(set(op.inputs) - sig.in_slots):
                        if op.inputs[slot]:
                            errors.append(
                                "%s declares input slot %r (vars %s), "
                                "but the registered compute function "
                                "only reads %s"
                                % (_op_str(b.idx, i, op), slot,
                                   op.inputs[slot],
                                   sorted(sig.in_slots)))
                if not sig.out_open:
                    for slot in sorted(set(op.outputs) - sig.out_slots):
                        if op.outputs[slot]:
                            errors.append(
                                "%s declares output slot %r (vars %s), "
                                "but the compute function only produces "
                                "%s — those vars would stay undefined"
                                % (_op_str(b.idx, i, op), slot,
                                   op.outputs[slot],
                                   sorted(sig.out_slots)))
            missing = (sig.required_attrs - set(op.attrs)
                       - ALLOWED_MISSING_ATTRS.get(op.type, set()))
            for k in sorted(missing):
                errors.append(
                    "%s: attr %r is read unconditionally by the compute "
                    "function but the OpDesc does not carry it"
                    % (_op_str(b.idx, i, op), k))


# ---------------------------------------------------------------------------
# def-before-use
# ---------------------------------------------------------------------------

def _attr_read_names(op):
    """Names the op reads through attrs (NOT the full _NAME_ATTR_KEYS
    set — grad_names/output_names/step_outputs are definitions)."""
    names = []
    for k in _ATTR_READ_KEYS:
        v = op.attrs.get(k)
        if isinstance(v, str):
            names.append(v)
        elif isinstance(v, (list, tuple)):
            names.extend(s for s in v if isinstance(s, str))
    if op.type == 'autodiff':
        names.extend(op.attrs.get('param_names', ()))
    return names


def _valid_sub_idxs(program, op):
    """Sub-block indices that actually exist — dangling refs are
    reported by _check_structure, not crashed on here."""
    return [i for i in passes._sub_block_idxs(op)
            if 0 <= i < len(program.blocks)]


def _op_writes_safe(program, op):
    """passes._op_writes with dangling sub-block refs dropped."""
    names = set(op.output_arg_names)
    for idx in _valid_sub_idxs(program, op):
        _r, w = passes._block_rw_recursive(program, idx)
        names |= w
    return names


def _locally_bound(op):
    """Sub-block names the op itself binds before interpreting the block
    (recurrent per-step inputs and carried memories) — not outer reads."""
    if op.type != 'recurrent':
        return set()
    bound = set()
    for pair in op.attrs.get('step_inputs', ()):
        if isinstance(pair, (list, tuple)) and len(pair) == 2:
            bound.add(pair[1])
    for pair in op.attrs.get('memories', ()):
        if isinstance(pair, (list, tuple)) and len(pair) == 2:
            bound.update(pair)
    return bound


def _external_reads(program, idx, cache, visiting=None):
    """Names a block reads from its enclosing environment: every read
    (input slots, attr reads, nested external reads) not preceded by a
    write within the block."""
    if idx in cache:
        return cache[idx]
    visiting = visiting or set()
    if idx in visiting or not (0 <= idx < len(program.blocks)):
        return set()  # cycle / dangling ref — _check_structure reports
    visiting.add(idx)
    defined, ext = set(), set()
    for op in program.blocks[idx].ops:
        reads = set(op.input_arg_names) | set(_attr_read_names(op))
        for s in _valid_sub_idxs(program, op):
            reads |= (_external_reads(program, s, cache, visiting)
                      - _locally_bound(op))
        ext |= (reads - defined)
        defined |= _op_writes_safe(program, op)
    visiting.discard(idx)
    cache[idx] = ext
    return ext


def _check_def_before_use(program, fetch_names, feed_names, errors):
    block = program.global_block()
    defined = set(feed_names) | passes._persistable_names(program)
    sub_cache = {}
    for i, op in enumerate(block.ops):
        reads = set(op.input_arg_names) | set(_attr_read_names(op))
        for s in _valid_sub_idxs(program, op):
            reads |= (_external_reads(program, s, sub_cache)
                      - _locally_bound(op))
        for n in sorted(reads - defined):
            errors.append(
                "%s reads %r before any definition — feed it, write it "
                "earlier in the block, or make its source persistable"
                % (_op_str(0, i, op), n))
            defined.add(n)  # report each missing name once
        defined |= _op_writes_safe(program, op)
    for n in sorted(set(fetch_names) - defined):
        errors.append(
            "fetch target %r is never produced by the block and is not "
            "fed" % n)


# ---------------------------------------------------------------------------
# dtype/shape re-inference agreement
# ---------------------------------------------------------------------------

_NARROWED = {'int64': 'int32', 'float64': 'float32'}


def _narrow(dtype):
    """The 64->32 narrowing of the reference's devices: declared-vs-
    inferred comparisons happen in the narrowed space, where the port's
    int64 indices and the reference's declared int64 agree."""
    d = datatypes.convert_dtype(dtype)
    return _NARROWED.get(d, d)


def _shapes_agree(declared, inferred):
    if len(declared) != len(inferred):
        return False
    return all(a == b or a == -1 or b == -1
               for a, b in zip(declared, inferred))


def _infer_specs(block, op):
    specs = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            try:
                v = block.var_recursive(n)
            except KeyError:
                return None  # undeclared input: cannot infer
            if not v.shape and v.lod_level == 0 and not v.is_data:
                return None  # declaration carries no shape information
            vals.append((v.shape, v.dtype))
        specs[slot] = vals
    return specs


def _check_infer(program, errors):
    from ..core.infer import infer_outputs_cached
    tasks = []
    for b in program.blocks:
        for i, op in enumerate(b.ops):
            traits = op_traits(op.type)
            if (op.type in INFER_SKIP_OPS or not traits.registered
                    or traits.needs_env
                    or op.type in passes.EFFECTFUL_OPS
                    or any(k in op.attrs
                           for k in passes._SUB_BLOCK_ATTR_KEYS)):
                continue
            specs = _infer_specs(b, op)
            if specs is None:
                continue
            tasks.append((b, i, op, specs))
    for b, i, op, specs in tasks:
        try:
            outs = infer_outputs_cached(op.type, specs, op.attrs,
                                        list(op.outputs))
        except Exception:
            continue  # does not run on meta tensors: no verdict
        for slot, names in op.outputs.items():
            for n, spec in zip(names, outs.get(slot, [])):
                if spec is None:
                    continue
                try:
                    v = b.var_recursive(n)
                except KeyError:
                    continue
                shape, dtype = spec
                try:
                    want, got = _narrow(v.dtype), _narrow(dtype)
                except ValueError:
                    continue
                if want != got:
                    errors.append(
                        "%s: output %r is declared %s but "
                        "re-inference (core/infer.py) produces %s"
                        % (_op_str(b.idx, i, op), n, v.dtype, dtype))
                elif v.shape and not _shapes_agree(v.shape, shape):
                    errors.append(
                        "%s: output %r is declared with shape %s "
                        "but re-inference produces %s"
                        % (_op_str(b.idx, i, op), n,
                           tuple(v.shape), tuple(shape)))


# ---------------------------------------------------------------------------
# op_seq stamps
# ---------------------------------------------------------------------------

def _check_op_seq(program, require, errors):
    block = program.global_block()
    last = None
    for i, op in enumerate(block.ops):
        seq = op.attrs.get('op_seq')
        if seq is None:
            if require and op_traits(op.type).stateful_rng:
                errors.append(
                    "%s is an RNG op without an op_seq stamp — its "
                    "PRNG stream would shift with every rewrite"
                    % _op_str(0, i, op))
            continue
        if not isinstance(seq, (int, np.integer)):
            continue  # _check_structure already reported
        if last is not None and seq <= last[1]:
            errors.append(
                "%s carries op_seq %d, but %s already carries op_seq "
                "%d — stamps must be strictly monotonic (duplicated or "
                "reordered stamp corrupts the RNG-exactness contract)"
                % (_op_str(0, i, op), seq,
                   _op_str(0, last[0], block.ops[last[0]]), last[1]))
        last = (i, int(seq))


# ---------------------------------------------------------------------------
# AMP cast consistency (post-AMP programs)
# ---------------------------------------------------------------------------

_LOW_NP = ('bfloat16', 'float16')


def _is_weaver_cast(op):
    out = op.output_arg_names
    return (op.type == 'cast' and out and '@amp.' in out[0]
            and str(op.attrs.get('out_dtype', '')) in _LOW_NP)


def _check_amp(program, low_dtype, errors):
    block = program.global_block()
    last_writer = {}   # name -> op
    version = {}       # name -> redefinition epoch
    seen_casts = set()  # (src, dtype, src_version)
    for i, op in enumerate(block.ops):
        if _is_weaver_cast(op):
            src = op.input_arg_names[0]
            dt = str(op.attrs['out_dtype'])
            key = (src, dt, version.get(src, 0))
            if key in seen_casts:
                errors.append(
                    "%s duplicates the AMP cast (%r -> %s) within one "
                    "definition epoch — weaver cast CSE violated"
                    % (_op_str(0, i, op), src, dt))
            seen_casts.add(key)
        traits = op_traits(op.type)
        if traits.registered and traits.amp == 'black':
            for n in op.input_arg_names:
                w = last_writer.get(n)
                if w is not None and _is_weaver_cast(w):
                    errors.append(
                        "%s is AMP_BLACK but reads %r straight from an "
                        "f32->%s weaver cast — black inputs must be "
                        "promoted back to f32"
                        % (_op_str(0, i, op), n,
                           w.attrs.get('out_dtype')))
        for n in op.output_arg_names:
            last_writer[n] = op
            version[n] = version.get(n, 0) + 1


# ---------------------------------------------------------------------------
# donation / in-place aliasing order safety
# ---------------------------------------------------------------------------

def _check_donation_order(program, feed_names, errors):
    """A donated-feed write or an optimizer's in-place aliased update
    ends the old value's life; an op whose op_seq says it originally ran
    before that write must not read the name after it (a pass moved the
    read across the kill)."""
    block = program.global_block()
    feed_names = set(feed_names)
    kills = {}  # name -> (pos, seq, kind)
    for i, op in enumerate(block.ops):
        seq = op.attrs.get('op_seq')
        seq = int(seq) if isinstance(seq, (int, np.integer)) else None
        reads = set(op.input_arg_names) | set(_attr_read_names(op))
        for n in sorted(reads):
            k = kills.get(n)
            if k is not None and seq is not None and \
                    k[1] is not None and seq < k[1]:
                errors.append(
                    "%s (op_seq %d) reads %r after %s (op_seq %d) "
                    "%s it — the read originally preceded the kill; a "
                    "pass moved it across (read after last legal use)"
                    % (_op_str(0, i, op), seq,
                       n, _op_str(0, k[0], block.ops[k[0]]), k[1],
                       k[2]))
        ins = set(op.input_arg_names)
        wseq = seq
        for n in op.output_arg_names:
            if n in feed_names:
                kills[n] = (i, wseq, 'redefined the donated feed')
            elif op.attrs.get('op_role') == 'optimize' and n in ins:
                kills[n] = (i, wseq, 'updated in place (donated alias)')


# ---------------------------------------------------------------------------
# pinned-name invariants across one rewrite
# ---------------------------------------------------------------------------

def pin_snapshot(program, fetch_names=(), feed_names=()):
    """Cheap name-set snapshot taken BEFORE a rewrite pass; feed it to
    verify_rewrite with the pass output to check the pinned-name
    invariants (no deep copy involved)."""
    persist = {v.name: datatypes.convert_dtype(v.dtype)
               for v in program.list_vars() if v.persistable}
    written = set()
    for b in program.blocks:
        for op in b.ops:
            written.update(op.output_arg_names)
    return {
        'persistable': persist,
        'persistable_written': set(persist) & written,
        'produced': written | set(feed_names),
    }


def verify_rewrite(snapshot, program, fetch_names=(), feed_names=()):
    """Invariants a rewrite pass must keep, checked against a pre-pass
    pin_snapshot.  Returns a list of error strings."""
    errors = []
    persist_after = {v.name: datatypes.convert_dtype(v.dtype)
                     for v in program.list_vars() if v.persistable}
    written_after = set()
    for b in program.blocks:
        for op in b.ops:
            written_after.update(op.output_arg_names)
    for n in sorted(set(snapshot['persistable']) - set(persist_after)):
        errors.append(
            "persistable var %r disappeared from the program "
            "declarations — pinned names must never be renamed or "
            "eliminated" % n)
    for n, dt in sorted(snapshot['persistable'].items()):
        after = persist_after.get(n)
        if after is not None and after != dt:
            errors.append(
                "persistable var %r was re-typed from %s to %s — "
                "master weights keep their declared dtype" % (n, dt,
                                                              after))
    for n in sorted(snapshot['persistable_written'] - written_after):
        errors.append(
            "pinned name %r (persistable) was written before the pass "
            "but no surviving op writes it — renamed or eliminated" % n)
    produced_after = written_after | set(feed_names)
    for n in fetch_names:
        if n in snapshot['produced'] and n not in produced_after:
            errors.append(
                "fetch target %r was produced before the pass but is "
                "no longer produced" % n)
    return errors


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def verify_program(program, fetch_names=(), feed_names=(),
                   require_op_seq=False, amp_low=None, check_infer=True):
    """Run every single-program check; returns the diagnostic list
    (empty = verified)."""
    errors = []
    _check_structure(program, errors)
    _check_signatures(program, errors)
    _check_def_before_use(program, tuple(fetch_names),
                          tuple(feed_names), errors)
    _check_op_seq(program, require_op_seq, errors)
    if check_infer:
        _check_infer(program, errors)
    if amp_low:
        _check_amp(program, amp_low, errors)
    _check_donation_order(program, feed_names, errors)
    return errors


def check_program(program, fetch_names=(), feed_names=(),
                  require_op_seq=False, amp_low=None, check_infer=True,
                  snapshot=None, pass_name=None):
    """verify_program (+ verify_rewrite when a snapshot is given) that
    raises IRVerificationError on any finding."""
    errors = verify_program(program, fetch_names, feed_names,
                            require_op_seq=require_op_seq,
                            amp_low=amp_low, check_infer=check_infer)
    if snapshot is not None:
        errors += verify_rewrite(snapshot, program, fetch_names,
                                 feed_names)
    if errors:
        raise IRVerificationError(errors, pass_name=pass_name)
