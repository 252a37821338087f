"""Static per-op cost model: FLOPs, bytes and arithmetic intensity from
the program IR.

Reference parity: paddle_tpu/transpiler/cost_model.py.  An analysis pass
of the pipeline (transpiler/pass_manager.py, order 95), run after the
graph-opt passes and AMP, so eliminated ops cost nothing and AMP-lowered
values count their 16-bit bytes.  Its report joins the measured phases
of ``Executor.last_step_report`` (``phases['compute']``): the FLOPs a
step does, from the IR, not from hand math.

Model, per op (the class is ``registry.op_traits().cost``):

- **'mac' ops** (``registry.COST_MAC``, the matmul-shaped set): closed-
  form MAC counts from the shapes (``MAC_FORMULAS``), FLOPs = 2 x MACs,
  and the bytes the op reads and writes.
- **'bytes' ops** (everything else): the memory they move; FLOPs 0.
- **autodiff**: the backward is 2 x the cost of its loss-contributing
  forward slice (dgrad + wgrad).  Rematerialization's second forward is
  not in it, as it is not in the reference's.
- **waived ops** (``WAIVED_OPS``, and ops without a registration, with
  a sub-block or with effects): no per-op verdict; they are named in
  ``coverage['waived']``, never costed 0.

Shapes resolve as the reference resolves them: each op's outputs by its
compute function run on meta tensors from its input specs (core/infer.py
``infer_outputs_cached``), the declared VarDesc shapes with the -1 batch
bound from the feed specs where that fails.

Not ported: the collective and pipeline-parallel pricing (the reference's
``_collective_costs``, ``overlap_schedule``, ``_pp_exposure``) comes with
distribution (ROADMAP.md Queue 1 item 10); ``collectives`` reads None.
The roofline over this report (tuning/roofline.py) prices it at the
H100's peaks, not the reference's TPU figures.
"""
from ..core import datatypes
from ..core.registry import cost_class, op_traits
from . import passes

__all__ = ['analyze_cost', 'op_cost', 'MAC_FORMULAS', 'BYTES_FORMULAS',
           'WAIVED_OPS', 'FLOPS_BASIS', 'decode_step_cost',
           'prefill_cost']

FLOPS_BASIS = ('FLOPs = 2 x MACs from closed-form per-op formulas '
               '(registry.COST_MAC); elementwise/reduction ops cost '
               'bytes-moved with FLOPs=0; autodiff (backward) = 2 x its '
               'loss-contributing forward slice')

# Ops with no per-op dense-tensor cost, each with its reason (the
# reference's entries; control-flow ops are waived by their kind,
# ``_structurally_waived``).
WAIVED_OPS = {
    # modelled at the slice level (2 x forward), not as one op
    'autodiff': 'backward modeled as 2x the loss-contributing forward '
                'slice',
    # a (rows, values) handle whose extent is the touched rows
    'sparse_grad_assemble': 'SelectedRows handle; touched-row count is '
                            'data-dependent',
    # tensor-array handles: their length and content are loop state
    'write_to_array': 'LoDTensorArray handle op',
    'read_from_array': 'LoDTensorArray handle op',
    'array_length': 'LoDTensorArray handle op',
    'array_to_lod_tensor': 'LoDTensorArray handle op',
    'lod_tensor_to_array': 'LoDTensorArray handle op',
    # the beams' per-step hypothesis state
    'beam_search': 'ragged beam state; extent is data-dependent',
    'beam_search_decode': 'ragged beam state; extent is data-dependent',
}


def _prod(shape, unknown):
    """Product of a shape with -1 dims counted as 1 (and tallied)."""
    p = 1
    for d in shape:
        if d is None or d < 0:
            unknown[0] += 1
            continue
        p *= int(d)
    return p


def _first(specs, slot, i=0):
    vals = specs.get(slot) or []
    if len(vals) <= i:
        return None
    return vals[i]


_ITEMSIZE = {}


def _dtype_bytes(dt):
    """Bytes an element of ``dt`` takes; a declared 64-bit type runs in 32
    bits (feeds narrow), as in the reference."""
    n = _ITEMSIZE.get(dt)
    if n is None:
        try:
            n = int(datatypes.itemsize(dt))
        except Exception:
            n = 4
        if n == 8:
            n = 4
        _ITEMSIZE[dt] = n
    return n


def _spec_bytes(spec, unknown):
    if spec is None:
        return 0
    shape, dt = spec
    return _prod(shape, unknown) * _dtype_bytes(dt)


# ---------------------------------------------------------------------------
# MAC formulas, one per COST_MAC op: (in_specs, out_specs, attrs, unknown)
# -> MACs, or None when a needed shape is missing (no verdict).
# ---------------------------------------------------------------------------

def _macs_mul(ins, outs, attrs, unknown):
    x = _first(ins, 'X')
    o = _first(outs, 'Out')
    if x is None or o is None:
        return None
    xnc = int(attrs.get('x_num_col_dims', 1))
    k = _prod(x[0][xnc:], unknown)
    return _prod(o[0], unknown) * k


def _macs_matmul(ins, outs, attrs, unknown):
    x = _first(ins, 'X')
    o = _first(outs, 'Out')
    if x is None or o is None:
        return None
    xs = x[0]
    if len(xs) == 0:
        return None
    if len(xs) == 1:
        k = xs[0]
    elif attrs.get('transpose_X', False):
        k = xs[-2]
    else:
        k = xs[-1]
    if k is None or k < 0:
        unknown[0] += 1
        k = 1
    return _prod(o[0], unknown) * int(k)


def _macs_conv(ins, outs, attrs, unknown):
    # Filter is (O, I/groups, k...): prod(filter[1:]) MACs an output
    w = _first(ins, 'Filter')
    o = _first(outs, 'Output')
    if w is None or o is None:
        return None
    return _prod(o[0], unknown) * _prod(w[0][1:], unknown)


def _macs_conv_transpose(ins, outs, attrs, unknown):
    # filter (in_c, out_c, k...): each input element scatters into
    # out_c * prod(k) outputs
    x = _first(ins, 'Input')
    w = _first(ins, 'Filter')
    if x is None or w is None:
        return None
    return _prod(x[0], unknown) * _prod(w[0][1:], unknown)


def _macs_sequence_conv(ins, outs, attrs, unknown):
    # Filter [ctx_len*D, M]: one matmul over the gathered context frames
    w = _first(ins, 'Filter')
    o = _first(outs, 'Out')
    if w is None or o is None:
        return None
    return _prod(o[0], unknown) * int(w[0][0])


def _macs_conv_shift(ins, outs, attrs, unknown):
    x = _first(ins, 'X')
    y = _first(ins, 'Y')
    if x is None or y is None:
        return None
    return _prod(x[0], unknown) * int(y[0][-1])


def _macs_row_conv(ins, outs, attrs, unknown):
    x = _first(ins, 'X')
    w = _first(ins, 'Filter')
    if x is None or w is None:
        return None
    return _prod(x[0], unknown) * int(w[0][0])


def _macs_bilinear(ins, outs, attrs, unknown):
    # 'ni,kij,nj->nk': B*K*M*N for x@W plus B*K*N for (..)·y
    x = _first(ins, 'X')
    w = _first(ins, 'Weight')
    if x is None or w is None:
        return None
    b = _prod(x[0][:1], unknown)
    k, m, n = (int(d) for d in w[0])
    return b * k * n * (m + 1)


def _macs_lstm(ins, outs, attrs, unknown):
    # Input [B, T, 4H], gates projected outside; per step [B, H] x [H, 4H]
    x = _first(ins, 'Input')
    if x is None:
        return None
    h = int(x[0][-1]) // 4
    return _prod(x[0], unknown) * h


def _macs_lstm_unit(ins, outs, attrs, unknown):
    # the elementwise cell only: no MACs, its bytes are its cost
    return 0


def _macs_gru(ins, outs, attrs, unknown):
    # Input [B, T, 3H]; per step [B,H]x[H,2H] + [B,H]x[H,H]
    x = _first(ins, 'Input')
    if x is None:
        return None
    h = int(x[0][-1]) // 3
    return _prod(x[0], unknown) * h


_macs_gru_unit = _macs_gru


def _macs_flash_attention(ins, outs, attrs, unknown):
    # QK^T + PV: 2 * B*H*Tq*Tk*D
    q = _first(ins, 'Q')
    k = _first(ins, 'K')
    if q is None or k is None:
        return None
    qs = q[0]
    if len(qs) == 4:
        b, tq, h, d = qs
        tk = k[0][1]
    elif len(qs) == 3:
        b, tq, d = qs
        h, tk = 1, k[0][1]
    else:
        return None
    for v in (b, tq, h, d, tk):
        if v is None or v < 0:
            unknown[0] += 1
            return None
    return 2 * int(b) * int(h) * int(tq) * int(tk) * int(d)


def _macs_vocab_ce(ins, outs, attrs, unknown):
    # the [N, D] x [D, V] vocab head
    x = _first(ins, 'X')
    w = _first(ins, 'W')
    if x is None or w is None:
        return None
    flatten = int(attrs.get('flatten', len(x[0]) - 1))
    n = _prod(x[0][:flatten], unknown)
    d = _prod(x[0][flatten:], unknown)
    return n * d * int(w[0][1])


def _paged_dims(q, kp, pt, pt_rank):
    if q is None or kp is None or pt is None:
        return None
    if len(q[0]) != 3 or len(kp[0]) != 4 or len(pt[0]) != pt_rank:
        return None
    return q[0], kp[0][1], pt[0][-1]


def _macs_paged_attention(ins, outs, attrs, unknown):
    # per stream q·K^T + P·V over its page span MPP * page_size
    dims = _paged_dims(_first(ins, 'Q'), _first(ins, 'KPool'),
                       _first(ins, 'PT'), 2)
    if dims is None:
        return None
    (s, h, d), p, mpp = dims
    for v in (s, h, d, p, mpp):
        if v is None or v < 0:
            unknown[0] += 1
            return None
    return 2 * int(s) * int(h) * int(mpp) * int(p) * int(d)


def _macs_chunked_prefill_attention(ins, outs, attrs, unknown):
    # one stream's prompt chunk of C queries over its page span
    dims = _paged_dims(_first(ins, 'Q'), _first(ins, 'KPool'),
                       _first(ins, 'PT'), 1)
    if dims is None:
        return None
    (c, h, d), p, mpp = dims
    for v in (c, h, d, p, mpp):
        if v is None or v < 0:
            unknown[0] += 1
            return None
    return 2 * int(c) * int(h) * int(mpp) * int(p) * int(d)


MAC_FORMULAS = {
    'mul': _macs_mul,
    'matmul': _macs_matmul,
    'conv2d': _macs_conv,
    'conv3d': _macs_conv,
    'conv2d_transpose': _macs_conv_transpose,
    'conv3d_transpose': _macs_conv_transpose,
    'sequence_conv': _macs_sequence_conv,
    'conv_shift': _macs_conv_shift,
    'row_conv': _macs_row_conv,
    'bilinear_tensor_product': _macs_bilinear,
    'lstm': _macs_lstm,
    'lstm_unit': _macs_lstm_unit,
    'gru': _macs_gru,
    'gru_unit': _macs_gru_unit,
    'flash_attention': _macs_flash_attention,
    'paged_attention': _macs_paged_attention,
    'chunked_prefill_attention': _macs_chunked_prefill_attention,
    'fused_linear_softmax_ce': _macs_vocab_ce,
    'vocab_parallel_ce': _macs_vocab_ce,
}


# Per-op overrides of the generic bytes tally (inputs read + outputs
# written at full extent), where an input is a pool the op only partly
# touches; None falls back to the generic tally.
def _bytes_paged_attention(ins, outs, attrs, unknown):
    # the pages the page tables name, not the whole pool
    q = _first(ins, 'Q')
    kp = _first(ins, 'KPool')
    pt = _first(ins, 'PT')
    cl = _first(ins, 'CtxLen')
    o = _first(outs, 'Out')
    if q is None or kp is None or pt is None:
        return None
    if len(kp[0]) != 4 or len(pt[0]) != 2:
        return None
    s = _prod(pt[0][:1], unknown)
    mpp = int(pt[0][1])
    p, h, d = (int(x) for x in kp[0][1:])
    kv = 2 * s * mpp * p * h * d * _dtype_bytes(kp[1])
    return (kv + _spec_bytes(q, unknown) + _spec_bytes(o, unknown)
            + _spec_bytes(pt, unknown) + _spec_bytes(cl, unknown))


def _bytes_chunked_prefill_attention(ins, outs, attrs, unknown):
    # one stream's MPP pages of K and V, read once
    q = _first(ins, 'Q')
    kp = _first(ins, 'KPool')
    pt = _first(ins, 'PT')
    p0 = _first(ins, 'Pos0')
    o = _first(outs, 'Out')
    if q is None or kp is None or pt is None:
        return None
    if len(kp[0]) != 4 or len(pt[0]) != 1:
        return None
    mpp = pt[0][0]
    if mpp is None or mpp < 0:
        unknown[0] += 1
        return None
    p, h, d = (int(x) for x in kp[0][1:])
    kv = 2 * int(mpp) * p * h * d * _dtype_bytes(kp[1])
    return (kv + _spec_bytes(q, unknown) + _spec_bytes(o, unknown)
            + _spec_bytes(pt, unknown) + _spec_bytes(p0, unknown))


BYTES_FORMULAS = {
    'paged_attention': _bytes_paged_attention,
    'chunked_prefill_attention': _bytes_chunked_prefill_attention,
}


def decode_step_cost(n_layers, d_model, n_heads, d_ff, vocab_size,
                     streams, ctx_len, dtype_bytes=4):
    """Closed-form cost of one continuous-batching decode step: S streams
    each generate one token against a mean context of ``ctx_len`` cached
    positions.  FLOPs = 2 x MACs (projections + per-token attention);
    bytes = the parameters read once plus the KV-cache traffic."""
    s, t = int(streams), int(ctx_len)
    d, f, v, h = int(d_model), int(d_ff), int(vocab_size), int(n_heads)
    head_dim = d // max(h, 1)
    per_layer_macs = s * (d * 3 * d + d * d + d * f + f * d) \
        + 2 * s * h * t * head_dim
    macs = n_layers * per_layer_macs + s * d * v
    param_bytes = (n_layers * (3 * d * d + d * d + d * f + f * d)
                   + v * d) * dtype_bytes
    # read the whole context per layer, write one position
    kv_bytes = n_layers * 2 * s * (t + 1) * d * dtype_bytes
    return {'flops': 2 * int(macs),
            'bytes': int(param_bytes + kv_bytes),
            'kv_bytes': int(kv_bytes)}


def prefill_cost(n_layers, d_model, n_heads, d_ff, vocab_size,
                 prompt_len, cached_len=0, dtype_bytes=4):
    """Closed-form cost of one stream's prefill with ``cached_len`` prompt
    positions served from the prefix cache: positions [cached_len,
    prompt_len) run the projections and attend causally over the whole
    prompt.  ``flops_cached`` is what a cold run would spend on the
    cached span (cached + computed == the cached_len=0 total)."""
    t, m = int(prompt_len), int(cached_len)
    m = max(0, min(m, t))
    d, f, v, h = int(d_model), int(d_ff), int(vocab_size), int(n_heads)
    head_dim = d // max(h, 1)

    def span_macs(lo, hi):
        # query i attends i + 1 keys: sum = (hi(hi+1) - lo(lo+1)) / 2
        proj = (hi - lo) * (3 * d * d + d * d + d * f + f * d)
        attn = 2 * h * head_dim * (hi * (hi + 1) - lo * (lo + 1)) // 2
        return int(n_layers) * (proj + attn)

    computed = span_macs(m, t) + d * v  # the head: last position only
    cached = span_macs(0, m)
    param_bytes = (int(n_layers) * (3 * d * d + d * d + d * f + f * d)
                   + v * d) * dtype_bytes
    kv_bytes = int(n_layers) * 2 * t * d * dtype_bytes
    return {'flops': 2 * int(computed),
            'flops_cached': 2 * int(cached),
            'bytes': int(param_bytes + kv_bytes),
            'kv_bytes': int(kv_bytes)}


def _structurally_waived(op):
    """Ops without a per-op verdict by their kind: unregistered, reading
    the live environment or with effects (control flow, communication),
    or with a sub-block."""
    traits = op_traits(op.type)
    return (not traits.registered or traits.needs_env
            or op.type in passes.EFFECTFUL_OPS
            or any(k in op.attrs for k in passes._SUB_BLOCK_ATTR_KEYS))


def op_cost(op_type, in_specs, out_specs, attrs):
    """One op's cost verdict from resolved specs:
    ``{'class', 'macs', 'flops', 'bytes', 'unknown_dims'}`` or None when
    the needed shapes are missing."""
    unknown = [0]
    nbytes = None
    bfn = BYTES_FORMULAS.get(op_type)
    if bfn is not None:
        nbytes = bfn(in_specs, out_specs, attrs, unknown)
    if nbytes is None:
        nbytes = 0
        for specs in (in_specs, out_specs):
            for vals in specs.values():
                for s in vals:
                    nbytes += _spec_bytes(s, unknown)
    cls = cost_class(op_type)
    macs = 0
    if cls == 'mac':
        fn = MAC_FORMULAS.get(op_type)
        if fn is None:
            return None  # COST_MAC without a formula: a coverage failure
        macs = fn(in_specs, out_specs, attrs, unknown)
        if macs is None:
            return None
    if nbytes == 0 and macs == 0:
        return None  # nothing resolvable: no verdict, not "free"
    return {'class': cls, 'macs': int(macs), 'flops': 2 * int(macs),
            'bytes': int(nbytes), 'unknown_dims': unknown[0]}


# ---------------------------------------------------------------------------
# the program walk
# ---------------------------------------------------------------------------

def _batch_binding(block, feed_specs):
    """The size of the -1 batch dimension, from a feed's declared shape
    against its fed shape (one binding a program)."""
    for n in sorted(feed_specs or {}):
        shape, _dt = feed_specs[n]
        try:
            v = block.var_recursive(n)
        except KeyError:
            continue
        if v.shape and len(v.shape) == len(shape):
            for dv, dc in zip(v.shape, shape):
                if dv == -1:
                    return int(dc)
    return None


def _declared_spec(block, name, batch=None):
    """A var's declared spec with -1 dims bound to the feed batch."""
    try:
        v = block.var_recursive(name)
    except KeyError:
        return None
    if not v.shape and v.lod_level == 0 and not v.is_data:
        return None
    shape = tuple(batch if (d == -1 and batch is not None) else d
                  for d in v.shape)
    return (shape, v.dtype)


def _resolve_in_specs(block, op, env, batch):
    specs = {}
    for slot, names in op.inputs.items():
        specs[slot] = [env.get(n) or _declared_spec(block, n, batch)
                       for n in names]
    return specs


def _out_specs(block, op, in_specs, env, batch):
    """Output specs: the op's meta-tensor inference from its input specs
    (core/infer.py, memoized), with the declared (batch-bound) shapes as
    the fallback; an inferred output declared without a shape enters the
    propagation environment.  As the reference: a declaration binds every
    -1 to the batch, which a ragged [B, T, D] value's time axis is not."""
    from ..core.infer import infer_outputs_cached
    try:
        outs = infer_outputs_cached(op.type, in_specs, op.attrs,
                                    list(op.outputs))
    except Exception:
        outs = None
    specs = {}
    for slot, names in op.outputs.items():
        inferred = (outs or {}).get(slot, [])
        vals = []
        for i, n in enumerate(names):
            s = inferred[i] if i < len(inferred) else None
            declared = _declared_spec(block, n, batch)
            if s is None:
                s = declared
            elif declared is None:
                env[n] = s
            vals.append(s)
        specs[slot] = vals
    return specs


def _role(op):
    return op.attrs.get('op_role', 'forward')


def _autodiff_slice(ops, idx, loss_name):
    """Indices of the forward-role ops before ``idx`` on the dependency
    path into ``loss_name``: the subgraph the backward differentiates."""
    live = {loss_name}
    picked = []
    for j in range(idx - 1, -1, -1):
        op = ops[j]
        if op.type == 'autodiff' or _role(op) != 'forward':
            continue
        if set(op.output_arg_names) & live:
            picked.append(j)
            live.update(op.input_arg_names)
    return picked


def analyze_cost(program, fetch_names=(), feed_specs=None):
    """Walk the (rewritten) global block and report its cost.

    :param feed_specs: ``{name: (shape, dtype)}`` of the fed values
        (without them -1 dims count 1 and are tallied in
        ``coverage['unknown_dims']``).
    :returns: ``per_op`` verdicts, ``per_role`` and ``total`` FLOPs,
        bytes and intensity, feed and state bytes, and ``coverage``
        naming every waived or no-verdict op type.
    """
    block = program.global_block()
    ops = block.ops
    batch = _batch_binding(block, feed_specs)
    env = {}
    for n, (shape, dt) in (feed_specs or {}).items():
        env[n] = (tuple(int(d) for d in shape), str(dt))

    per_op = []
    per_role = {}
    waived = {}
    no_verdict = []
    unknown_dims = 0
    costs_by_index = {}
    for i, op in enumerate(ops):
        if op.type == 'autodiff':
            continue  # modelled from its slice below
        if _structurally_waived(op):
            waived[op.type] = 'control-flow/env/sub-block op: cost is ' \
                              'its body\'s'
            continue
        if op.type in WAIVED_OPS:
            waived[op.type] = WAIVED_OPS[op.type]
            continue
        in_specs = _resolve_in_specs(block, op, env, batch)
        out_specs = _out_specs(block, op, in_specs, env, batch)
        c = op_cost(op.type, in_specs, out_specs, op.attrs)
        if c is None:
            if op.type not in no_verdict:
                no_verdict.append(op.type)
            continue
        unknown_dims += c.pop('unknown_dims')
        entry = dict(c, index=i, type=op.type, role=_role(op))
        costs_by_index[i] = entry
        per_op.append(entry)
        r = per_role.setdefault(entry['role'], {'flops': 0, 'bytes': 0})
        r['flops'] += entry['flops']
        r['bytes'] += entry['bytes']

    # autodiff: 2x the loss-contributing forward slice (dgrad + wgrad)
    for i, op in enumerate(ops):
        if op.type != 'autodiff':
            continue
        sl = _autodiff_slice(ops, i, op.attrs.get('loss_name'))
        flops = sum(costs_by_index[j]['flops'] for j in sl
                    if j in costs_by_index)
        nbytes = sum(costs_by_index[j]['bytes'] for j in sl
                     if j in costs_by_index)
        entry = {'index': i, 'type': 'autodiff', 'role': 'backward',
                 'class': 'autodiff', 'macs': flops,  # 2x fwd MACs
                 'flops': 2 * flops, 'bytes': 2 * nbytes,
                 'fwd_slice_ops': len(sl)}
        per_op.append(entry)
        r = per_role.setdefault('backward', {'flops': 0, 'bytes': 0})
        r['flops'] += entry['flops']
        r['bytes'] += entry['bytes']

    for r in per_role.values():
        r['intensity'] = (r['flops'] / r['bytes']) if r['bytes'] else 0.0
    total_flops = sum(r['flops'] for r in per_role.values())
    total_bytes = sum(r['bytes'] for r in per_role.values())

    unk = [0]
    feed_bytes = None
    if feed_specs:
        feed_bytes = sum(_spec_bytes((tuple(s), d), unk)
                         for s, d in feed_specs.values())
    state_bytes = sum(_spec_bytes((tuple(v.shape), v.dtype), unk)
                      for v in program.list_vars()
                      if v.persistable and v.shape)
    return {
        'collectives': None,
        'flops_basis': FLOPS_BASIS,
        'per_op': per_op,
        'per_role': per_role,
        'total': {'flops': total_flops, 'bytes': total_bytes,
                  'intensity': (total_flops / total_bytes)
                               if total_bytes else 0.0},
        'feed_bytes': feed_bytes,
        'state_bytes': state_bytes,
        'coverage': {
            'ops': len(ops),
            'modeled': len(per_op),
            'waived': waived,
            'no_verdict': no_verdict,
            'unknown_dims': unknown_dims,
        },
    }
