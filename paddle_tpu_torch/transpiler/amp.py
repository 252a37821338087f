"""Automatic mixed-precision (AMP) cast-insertion pass.

Reference parity: paddle_tpu/transpiler/amp.py, pass 60 of the pipeline
(transpiler/pass_manager.py).  The H100's tensor cores run bf16 and f16
products; a float32 program runs its matmuls as float32 SIMT GEMMs and
moves twice the activation bytes.  This pass rewrites a program block
(a COPY — the user's program is never mutated) so white-listed compute
runs in a low precision while the numerically sensitive spine stays
f32, following Micikevicius et al.
2018 ("Mixed Precision Training") with bf16's loss-scale-free variant
per Kalamkar et al. 2019 ("A Study of BFLOAT16 for Deep Learning
Training"):

- **white** ops (``registry.AMP_WHITE``: matmul/mul, conv, attention,
  LSTM/GRU gates, the fused vocab-CE heads) get their f32 float inputs
  cast down to the low dtype and their outputs tracked as low.
- **black** ops (``registry.AMP_BLACK``: softmax, losses, norm
  statistics, sums/means, exp/log/pow/square, metrics, optimizer
  updates) get any low-precision input cast back UP to f32.
- **grey** ops (everything else) follow their inputs: all-low inputs
  run low; mixed inputs pull the stragglers down to low (the classic
  fc-bias-add pattern); an op whose output must stay f32 (see pinned
  below) pushes its inputs up instead.

Casts are woven with CSE — one ``cast`` op per (value, target dtype),
reused by every consumer — so a parameter read by many matmuls is cast
to bf16 exactly once per step, at the graph edge.

**Master weights**: parameters are never renamed or re-typed — the f32
Parameter stays the autodiff leaf and the Scope resident; a cast op
derives the low copy under a new ``<name>@amp.bf16`` name, and the VJP
of that cast accumulates the gradient back in f32.  The optimizer
therefore applies f32 grads to f32 masters with no extra machinery.

**Pinned names** (persistables, control-flow/sub-block reads+writes,
attr-referenced names such as the autodiff's param/grad/loss lists)
must keep their original dtype: ops producing them are never lowered,
and grey producers force their inputs up to f32.  Programs with
sub-block ops in the global block keep those ops as barriers — their
declared inputs are restored to f32 and their sub-blocks are never
rewritten.

**f16 mode** additionally wires dynamic loss scaling: the autodiff op
multiplies the loss by a persistable scale var, a
``check_finite_and_unscale`` op divides the produced grads back down
and flags non-finite values, every optimize-role op is gated on that
flag (``amp_gate_var`` attr — executor._run_one keeps the old value on
overflow, i.e. the whole step is skipped), and an ``update_loss_scale``
op grows/backs off the scale with counters that persist in the Scope
like any optimizer state.  bf16 shares f32's exponent range, so bf16
mode needs none of this (Kalamkar et al.).
"""
import contextlib
import copy
import os

import numpy as np

from ..core import datatypes
from ..core.program import Operator, Variable
from ..flags import ENV_PREFIX
from ..core.registry import op_traits
from . import passes

__all__ = ['apply_amp', 'resolve_mode', 'plan_key_component', 'amp_guard',
           'LOSS_SCALE_VAR', 'FOUND_INF_VAR', 'GOOD_STEPS_VAR',
           'BAD_STEPS_VAR', 'SKIPPED_STEPS_VAR', 'WHITE_F32_OUTPUT_OPS']

LOW_DTYPE = {'bf16': 'bfloat16', 'f16': 'float16'}
_LOW_DTYPES = frozenset(LOW_DTYPE.values())
_SHORT = {'bfloat16': 'bf16', 'float16': 'f16', 'float32': 'f32'}

# white ops whose outputs are ALWAYS f32 regardless of input dtype: the
# fused CE heads run their matmul in the input dtype (that's the point
# of lowering them) but reduce to an f32 loss internally.
WHITE_F32_OUTPUT_OPS = frozenset({'fused_linear_softmax_ce',
                                  'vocab_parallel_ce'})

# ops that source their output dtype from an attr; the weaver reads the
# attr instead of rewriting them (casting a constant's output would just
# add an op the folder removed).
_DTYPE_SOURCE_OPS = frozenset({
    'cast', 'fill_constant', 'fill', 'assign_value',
    'fill_constant_batch_size_like', 'gaussian_random', 'uniform_random',
    'truncated_gaussian_random', 'one_hot',
})

# dynamic-loss-scaling state (f16 mode): persistable [1] vars, kept in
# the Scope across steps like optimizer state.
LOSS_SCALE_VAR = '@amp_loss_scale@'
GOOD_STEPS_VAR = '@amp_good_steps@'
BAD_STEPS_VAR = '@amp_bad_steps@'
SKIPPED_STEPS_VAR = '@amp_skipped_steps@'
FOUND_INF_VAR = '@amp_found_inf@'  # per-step bool [1], not persistable


def resolve_mode(mode=None):
    """Normalise a PADDLE_TPU_TORCH_AMP value to None | 'bf16' | 'f16'."""
    if mode is None:
        from ..flags import FLAGS
        mode = FLAGS.amp
    mode = str(mode or '').strip().lower()
    if mode in ('', '0', 'off', 'false', 'no', 'none'):
        return None
    if mode in ('bf16', 'bfloat16'):
        return 'bf16'
    if mode in ('f16', 'fp16', 'float16'):
        return 'f16'
    raise ValueError("PADDLE_TPU_TORCH_AMP must be one of 0/bf16/f16, got "
                     "%r" % (mode,))


@contextlib.contextmanager
def amp_guard(mode):
    """Scoped PADDLE_TPU_TORCH_AMP override: ``amp_guard('bf16')`` makes
    every plan build inside the block use that mode; ``None`` leaves the
    environment untouched (use '0' to force OFF).

    PROCESS-GLOBAL, not thread-local: the override mutates os.environ,
    which every concurrent plan build reads."""
    if mode is None:
        yield
        return
    resolve_mode(str(mode))  # validate before mutating the environment
    key = ENV_PREFIX + 'AMP'
    old = os.environ.get(key)
    os.environ[key] = str(mode)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old


def plan_key_component(mode=None):
    """The AMP contribution to an executor plan-cache key: the resolved
    mode plus the loss-scale knobs baked into the rewritten program's
    attrs (a knob flip must not be served a stale trace)."""
    mode = resolve_mode(mode)
    if mode is None:
        return None
    from ..flags import FLAGS
    if mode == 'f16':
        return (mode, float(FLAGS.amp_init_loss_scale),
                int(FLAGS.amp_incr_every_n_steps),
                int(FLAGS.amp_decr_every_n_nan_or_inf))
    return (mode,)


def _is_float(dtype):
    try:
        return datatypes.is_float_dtype(dtype)
    except ValueError:
        return False


def _barrier(op):
    """Ops the weaver must not lower and whose inputs are restored to
    f32: control flow / effectful / unregistered — the passes.py
    conservatism contract, verbatim."""
    traits = op_traits(op.type)
    if not traits.registered:
        return op.type != 'autodiff'
    if traits.needs_env or op.type in passes.EFFECTFUL_OPS:
        return True
    return any(k in op.attrs for k in passes._SUB_BLOCK_ATTR_KEYS)


class _Weaver(object):
    """Single forward walk over the global block, tracking each float
    var's current precision and inserting CSE'd cast ops at precision
    boundaries."""

    def __init__(self, program, low, pinned):
        self.program = program
        self.block = program.global_block()
        self.low = low                  # 'bfloat16' | 'float16'
        self.pinned = pinned
        self.prec = {}                  # name -> float dtype string
        for v in self.block.vars.values():
            if _is_float(v.dtype):
                self.prec[v.name] = datatypes.convert_dtype(v.dtype)
        self.cast_cache = {}            # (src, dtype) -> cast out name
        self.casts = []                 # [(src, dtype)] insertion order
        self.new_ops = []
        self.ops_lowered = 0

    # -- cast insertion ----------------------------------------------------
    def _cast_to(self, src, dtype, role):
        key = (src, dtype)
        hit = self.cast_cache.get(key)
        if hit is not None:
            return hit
        name = '%s@amp.%s' % (src, _SHORT[dtype])
        src_var = self.block.vars.get(src)
        if not self.block.has_var(name):
            Variable(self.block, name=name,
                     shape=(src_var.shape if src_var is not None
                            else None),
                     dtype=dtype,
                     lod_level=(src_var.lod_level
                                if src_var is not None else 0))
        self.new_ops.append(Operator(
            self.block, 'cast', inputs={'X': [src]},
            outputs={'Out': [name]},
            attrs={'out_dtype': dtype, 'op_role': role}))
        self.cast_cache[key] = name
        self.casts.append((src, dtype))
        self.prec[name] = dtype
        return name

    def _rewrite_inputs(self, op, targets):
        """Swap `op`'s input names per {old: new} (every slot)."""
        if not targets:
            return
        op.inputs = {slot: [targets.get(n, n) for n in names]
                     for slot, names in op.inputs.items()}

    def _inputs_to(self, op, want, only_low=False, only_f32=False):
        """Cast the op's float inputs to `want`.  only_low: touch only
        currently-low inputs (the black/keep up-cast); only_f32: touch
        only currently-f32 inputs (the white down-cast — f64 etc. are
        left alone, and unknown-dtype names are never touched)."""
        role = op.attrs.get('op_role', 'forward')
        targets = {}
        for n in op.input_arg_names:  # declaration order: deterministic
            if n in targets:
                continue
            cur = self.prec.get(n)
            if cur is None:
                continue
            if only_low and not datatypes.is_low_precision(cur):
                continue
            if only_f32 and cur != 'float32':
                continue
            if cur == want:
                continue
            targets[n] = self._cast_to(n, want, role)
        self._rewrite_inputs(op, targets)
        return bool(targets)

    def _runtime_low(self, lows):
        """The dtype the low-precision members of an input set combine
        to under the promote_float_dtype lattice: the weave dtype when
        that's the only low dtype present, f32 when bf16 and f16 mix
        (they don't order against each other), None when no low inputs.
        One tested home for the rule (core/datatypes.py)."""
        out = None
        for d in sorted(lows):
            out = d if out is None else \
                datatypes.promote_float_dtype(out, d)
        return out

    # -- per-op precision bookkeeping --------------------------------------
    def _float_out_names(self, op, assume_float):
        """Output names the op produces as floats: declared float vars,
        plus — for white ops only (`assume_float`, their outputs are
        matmul results) — undeclared names.  Undeclared outputs of
        grey/black ops stay UNTRACKED: a grey op can emit integers
        (argmax indices, top_k ids) and marking those low would seed a
        dtype-corrupting cast at the next black consumer."""
        outs = []
        for n in op.output_arg_names:
            v = self.block.vars.get(n)
            if v is None:
                if assume_float:
                    outs.append(n)
                else:
                    self.prec.pop(n, None)  # unknown: never cast
            elif _is_float(v.dtype):
                outs.append(n)
        return outs

    def _set_out_prec(self, op, dtype, assume_float=False):
        for n in self._float_out_names(op, assume_float):
            self.prec[n] = dtype
            v = self.block.vars.get(n)
            # keep declarations honest (donation/bytes accounting reads
            # them); pinned/persistable declarations never change
            if v is not None and not v.persistable and \
                    n not in self.pinned and _is_float(v.dtype):
                v.dtype = dtype

    def _invalidate(self, op):
        """An op redefining a name kills cached casts of the old value."""
        for n in op.output_arg_names:
            for key in [k for k in self.cast_cache if k[0] == n]:
                del self.cast_cache[key]

    # -- the walk ----------------------------------------------------------
    def weave(self):
        low = self.low
        for op in self.block.ops:
            outs = set(op.output_arg_names)
            if op.type == 'autodiff':
                # leaves/grads are attr-referenced (pinned); the
                # executor casts published grads to the f32 leaf dtype
                self._invalidate(op)
                for n in op.attrs.get('grad_names', ()):
                    self.prec[n] = 'float32'
                self.new_ops.append(op)
                continue
            if op.type in _DTYPE_SOURCE_OPS:
                dt = op.attrs.get('out_dtype', op.attrs.get('dtype',
                                                            'float32'))
                self._invalidate(op)
                for n in op.output_arg_names:
                    if _is_float(dt):
                        self.prec[n] = datatypes.convert_dtype(dt)
                    else:
                        self.prec.pop(n, None)
                self.new_ops.append(op)
                continue
            cls = ('black' if _barrier(op)
                   else op_traits(op.type).amp)
            if cls == 'white' and not (outs & self.pinned):
                lowered = self._inputs_to(op, low, only_f32=True)
                in_lows = {self.prec.get(n)
                           for n in op.input_arg_names} & _LOW_DTYPES
                self._invalidate(op)
                if op.type in WHITE_F32_OUTPUT_OPS:
                    self._set_out_prec(op, 'float32', assume_float=True)
                elif self._runtime_low(in_lows) == low:
                    self._set_out_prec(op, low, assume_float=True)
                else:
                    # no low inputs, or a foreign 16-bit dtype mixed in
                    # (the promote_float_dtype lattice lands on f32)
                    self._set_out_prec(op, 'float32', assume_float=True)
                if lowered or in_lows:
                    self.ops_lowered += 1
            elif cls == 'grey':
                in_precs = {self.prec[n] for n in op.input_arg_names
                            if n in self.prec}
                lows = in_precs & _LOW_DTYPES
                if lows and (outs & self.pinned
                             or self._runtime_low(lows) != low):
                    # promote to f32: the output must keep its declared
                    # dtype, OR a foreign 16-bit dtype is present (a
                    # manual bf16 cast under an f16 weave — bf16 + f16
                    # don't order, promote_float_dtype says f32;
                    # following either one would mis-declare the
                    # output, since torch itself promotes the pair to f32)
                    self._inputs_to(op, 'float32', only_low=True)
                    self._invalidate(op)
                    self._set_out_prec(op, 'float32')
                elif lows:
                    # follow the low inputs: pull f32 stragglers down
                    self._inputs_to(op, low, only_f32=True)
                    self._invalidate(op)
                    self._set_out_prec(op, low)
                    self.ops_lowered += 1
                else:
                    self._invalidate(op)
                    if in_precs:
                        self._set_out_prec(
                            op, 'float64' if 'float64' in in_precs
                            else 'float32')
            else:  # black / white-but-pinned / barrier
                self._inputs_to(op, 'float32', only_low=True)
                self._invalidate(op)
                self._set_out_prec(op, 'float32')
            self.new_ops.append(op)
        self.block.ops = self.new_ops


# ---------------------------------------------------------------------------
# f16 dynamic loss scaling
# ---------------------------------------------------------------------------

def _wire_loss_scaling(program, report):
    """Weave the dynamic-loss-scaling machinery around the autodiff /
    optimizer structure.  No autodiff or no gradient-consuming optimizer
    op → nothing to scale (inference programs, calc_gradient-only
    programs); the lowering stands on its own.

    Multi-minimize programs (GAN, multi-loss: autodiff1, opt1...,
    autodiff2, opt2...) gate each optimizer group on the overflow
    verdicts available at its program position — group 1's ops run
    before check 2 exists, so an overflow detected only in group 2
    skips group 2 (and backs the shared scale off) while group 1's
    already-applied update stands.  FoundAcc chains the verdicts
    forward so update_loss_scale sees the OR over all groups.  The
    single-minimize case — every bench and book model — is the textbook
    wholesale skip."""
    from ..flags import FLAGS
    block = program.global_block()
    ops = block.ops
    ad_idxs = [i for i, op in enumerate(ops) if op.type == 'autodiff']
    has_opt = any(op.attrs.get('op_role') == 'optimize' and
                  op.inputs.get('Grad') for op in ops)
    if not ad_idxs or not has_opt:
        report['loss_scaling'] = False
        return
    report['loss_scaling'] = True

    for name, dtype, init in (
            (LOSS_SCALE_VAR, 'float32',
             np.full((1,), float(FLAGS.amp_init_loss_scale), np.float32)),
            (GOOD_STEPS_VAR, 'int32', np.zeros((1,), np.int32)),
            (BAD_STEPS_VAR, 'int32', np.zeros((1,), np.int32)),
            (SKIPPED_STEPS_VAR, 'int32', np.zeros((1,), np.int32))):
        if not block.has_var(name):
            Variable(block, name=name, shape=(1,), dtype=dtype,
                     persistable=True, stop_gradient=True)
        report['state_defaults'][name] = init
    if not block.has_var(FOUND_INF_VAR):
        Variable(block, name=FOUND_INF_VAR, shape=(1,), dtype='bool',
                 stop_gradient=True)

    # grad names to unscale, grouped per autodiff: the autodiff's own
    # outputs minus any that only exist to feed a sparse_grad_assemble
    # (the assembled SelectedRows is unscaled instead — unscaling is
    # linear, so post-assembly division is exact).  Each group's check
    # op lands after the LAST producer of the group — before the
    # clip/regularization ops, whose norms must see unscaled grads.
    assemble_ins = set()
    for op in ops:
        if op.type == 'sparse_grad_assemble':
            assemble_ins.update(op.inputs.get('OutGrad', ()))
    checks = {}  # insert-after index -> grad group
    for i in ad_idxs:
        ops[i].attrs['loss_scale_var'] = LOSS_SCALE_VAR
        grads = set(ops[i].attrs.get('grad_names', ()))
        group = [n for n in ops[i].attrs.get('grad_names', ())
                 if n not in assemble_ins]
        last = i
        for j, op in enumerate(ops):
            if op.type == 'sparse_grad_assemble' and \
                    set(op.inputs.get('OutGrad', ())) & grads:
                group.extend(op.output_arg_names)
                last = max(last, j)
        checks[last] = group

    new_ops = []
    first_check = True
    scale_knobs = {
        'incr_every_n_steps': int(FLAGS.amp_incr_every_n_steps),
        'decr_every_n_nan_or_inf': int(FLAGS.amp_decr_every_n_nan_or_inf),
        'incr_ratio': 2.0, 'decr_ratio': 0.5,
    }
    for i, op in enumerate(ops):
        if op.attrs.get('op_role') == 'optimize':
            # overflow step: the executor keeps every output's old value
            op.attrs['amp_gate_var'] = FOUND_INF_VAR
        new_ops.append(op)
        group = checks.get(i)
        if group is not None:
            check_ins = {'X': list(group), 'Scale': [LOSS_SCALE_VAR]}
            if not first_check:
                check_ins['FoundAcc'] = [FOUND_INF_VAR]
            new_ops.append(Operator(
                block, 'check_finite_and_unscale',
                inputs=check_ins,
                outputs={'Out': list(group),
                         'FoundInfinite': [FOUND_INF_VAR]},
                attrs={'op_role': 'backward'}))
            first_check = False
    new_ops.append(Operator(
        block, 'update_loss_scale',
        inputs={'FoundInfinite': [FOUND_INF_VAR],
                'LossScale': [LOSS_SCALE_VAR],
                'GoodSteps': [GOOD_STEPS_VAR],
                'BadSteps': [BAD_STEPS_VAR],
                'SkippedSteps': [SKIPPED_STEPS_VAR]},
        outputs={'LossScaleOut': [LOSS_SCALE_VAR],
                 'GoodStepsOut': [GOOD_STEPS_VAR],
                 'BadStepsOut': [BAD_STEPS_VAR],
                 'SkippedStepsOut': [SKIPPED_STEPS_VAR]},
        attrs=dict(scale_knobs, op_role='optimize')))
    block.ops = new_ops


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def apply_amp(program, mode=None):
    """Rewrite `program` for mixed-precision execution.

    Always weaves over its OWN deep copy — never the input, even when
    the caller already copied (the graph-opt pipeline's copy): the
    weaver mutates op inputs and var dtypes as it walks, so a mid-walk
    failure leaves the caller's program whole.  The copy is made once
    per executor plan.

    Everything the weave needs comes from the block itself: var
    declarations give the precision map, and the pinned set
    (persistables + control/attr-referenced names) gives the rewrite
    barriers.  Fetched intermediates are deliberately NOT pinned —
    fetching a lowered activation returns it in low precision, the
    standard AMP surface (the loss spine stays f32 via the black list).

    Returns ``(rewritten_program, report)``; with the mode off the
    original program comes back untouched with ``report=None``.  The
    report carries ``mode``, ``ops_lowered``, ``casts_inserted``, the
    ordered ``casts`` list [(src_name, target_dtype)] (golden-testable:
    CSE guarantees each pair appears at most once per redefinition),
    ``loss_scaling``, and ``state_defaults`` — {name: np initial value}
    the executor seeds into the Scope for the loss-scale state.
    """
    mode = resolve_mode(mode)
    if mode is None:
        return program, None
    low = LOW_DTYPE[mode]
    p = copy.deepcopy(program)
    block = p.global_block()
    # pre-pass positions key the per-op generators (executor
    # ctx.op_index), so inserting casts never shifts a random stream
    passes._stamp_op_seq(block)
    pinned = (passes._persistable_names(p)
              | passes._control_referenced_names(p))

    weaver = _Weaver(p, low, pinned)
    weaver.weave()
    report = {
        'mode': mode,
        'low_dtype': low,
        'ops_lowered': weaver.ops_lowered,
        'casts_inserted': len(weaver.casts),
        'casts': list(weaver.casts),
        'loss_scaling': False,
        'state_defaults': {},
    }
    if mode == 'f16':
        _wire_loss_scaling(p, report)
    return p, report
