"""Liveness-based peak-memory model over the program IR, and the
closed-form residency of the decode engine's KV page pools.

Reference parity: paddle_tpu/transpiler/memory_model.py.  An analysis
pass of the pipeline (transpiler/pass_manager.py, order 96, right after
the cost model, on the same rewritten program and feed shapes); its
report lands in ``last_graph_opt_report['cost']['memory']`` and, with
the measured peak beside it, in ``Executor.last_step_report['memory']``.

Model, in op order over the global block:

- **Persistables** (parameters, optimizer moments, scale state) are
  resident for the whole step and counted once: the executor updates
  them in place.
- **Feeds** are live before op 0 and, with ``donate_feeds`` (the
  default), credited back after their last reader, as the executor's
  liveness drops them.
- **Intermediates** live from the op that writes them to the op that
  last reads them; fetched names stay live to the end.  Bytes come from
  the cost model's resolution (declared shapes with the batch bound from
  the feeds, meta-tensor inference for undeclared outputs), so a bf16
  value counts 2 bytes.
- **The backward** (the ``autodiff`` op) keeps the activations of its
  loss-contributing forward slice alive until it runs, filtered by the
  program's rematerialization level (transpiler/memory_optimize.py):
  'dots' keeps only the outputs of ``registry.COST_MAC`` ops, 'full'
  none.  This is the reference's idealisation: the executor's 'full'
  keeps its segments' boundary values too (core/executor.py), so the
  measured peak sits above this model's there.
- **Waived ops** (``WAIVED_OPS``): outputs whose extent depends on the
  data; they are named in ``coverage``, never sized 0.

``watermark`` names the top-K ops by modelled live bytes; ``timeline``
is the per-op sawtooth.  Shard divisors are 1 until distribution
(ROADMAP.md Queue 1 item 10): ``sharding`` reads None and
``overlap_bucket_bytes`` 0.
"""
from ..core import registry
from ..core.datatypes import itemsize
from . import cost_model as _cm

__all__ = ['analyze_memory', 'page_pool_bytes', 'prefix_cached_bytes',
           'WAIVED_OPS']


def page_pool_bytes(num_pages, page_size, num_heads, head_dim,
                    dtype='float32', n_layers=1, kv=2):
    """Device residency of the paged KV cache: ``n_layers x kv x
    num_pages x page_size x num_heads x head_dim x itemsize`` bytes."""
    return (int(n_layers) * int(kv) * int(num_pages) * int(page_size)
            * int(num_heads) * int(head_dim) * itemsize(dtype))


def prefix_cached_bytes(num_cached_pages, page_size, num_heads,
                        head_dim, dtype='float32', n_layers=1):
    """Bytes of pool residency held by the prefix cache.  Cached pages
    live inside the page pools, so ``page_pool_bytes`` of the pool
    already counts each shared page once; this sizes the trie-held
    subset an eviction sweep could reclaim."""
    return page_pool_bytes(num_cached_pages, page_size, num_heads,
                           head_dim, dtype, n_layers=n_layers)


# the cost model's waivers but 'autodiff', whose frontier this model sizes
WAIVED_OPS = {k: v for k, v in _cm.WAIVED_OPS.items() if k != 'autodiff'}


def _saved_activations(ops, ad_idx, loss_name, remat_level):
    """Names the backward keeps live across the forward/backward
    boundary: the outputs of the loss-contributing forward slice, filtered
    by the rematerialization level."""
    if remat_level == 'full':
        return set()
    saved = set()
    for j in _cm._autodiff_slice(ops, ad_idx, loss_name):
        op = ops[j]
        if remat_level == 'dots' and \
                registry.cost_class(op.type) != 'mac':
            continue
        saved.update(op.output_arg_names)
    return saved


def analyze_memory(program, fetch_names=(), feed_specs=None,
                   donate_feeds=True, top_k=5):
    """Walk the (rewritten) global block and model peak residency.

    :param feed_specs: ``{name: (shape, dtype)}`` of the fed values
        (without them -1 dims count 1 and feeds read 0 bytes).
    :param donate_feeds: credit each feed back after its last reader.
    :param top_k: how many watermark ops to name.
    :returns: ``peak_bytes`` and its parts, ``watermark``, ``timeline``
        and ``coverage`` (every op type whose outputs were not sized).
    """
    block = program.global_block()
    ops = block.ops
    batch = _cm._batch_binding(block, feed_specs)
    feed_specs = dict(feed_specs or {})
    env = {}
    for n, (shape, dt) in feed_specs.items():
        env[n] = (tuple(int(d) for d in shape), str(dt))

    persist_names = {v.name for v in program.list_vars() if v.persistable}
    unk = [0]
    persistable_bytes = sum(
        _cm._spec_bytes((tuple(v.shape), v.dtype), unk)
        for v in program.list_vars() if v.persistable and v.shape)

    # -- size every name the walk sees ---------------------------------
    sizes = {}
    unsized = set()
    no_verdict = {}
    waived = {}
    for n, spec in env.items():
        sizes[n] = _cm._spec_bytes(spec, unk)
    for op in ops:
        if op.type == 'autodiff':
            # its gradients are declared vars
            for n in op.output_arg_names:
                s = _cm._declared_spec(block, n, batch)
                if s is not None and n not in sizes:
                    sizes[n] = _cm._spec_bytes(s, unk)
            continue
        structurally = _cm._structurally_waived(op)
        explicitly = op.type in WAIVED_OPS
        if structurally or explicitly:
            waived[op.type] = (WAIVED_OPS.get(op.type)
                               or 'control-flow/env/sub-block op')
        in_specs = _cm._resolve_in_specs(block, op, env, batch)
        out_specs = _cm._out_specs(block, op, in_specs, env, batch)
        for specs, slots in ((in_specs, op.inputs), (out_specs, op.outputs)):
            for slot, vals in specs.items():
                for n, s in zip(slots[slot], vals):
                    if s is None:
                        if n not in sizes:
                            unsized.add(n)
                        continue
                    sizes.setdefault(n, _cm._spec_bytes(s, unk))
        if not (structurally or explicitly):
            missing = [n for n in op.output_arg_names
                       if n not in sizes and n not in persist_names]
            if missing:
                no_verdict.setdefault(op.type, sorted(missing))

    # -- liveness intervals --------------------------------------------
    n_ops = len(ops)
    birth, last_use = {}, {}
    for i, op in enumerate(ops):
        for n in op.input_arg_names:
            last_use[n] = i
        for n in op.output_arg_names:
            birth.setdefault(n, i)
            last_use[n] = max(last_use.get(n, -1), i)
    for n in fetch_names:
        if n in birth or n in feed_specs:
            last_use[n] = n_ops - 1  # escapes the step
    for n in feed_specs:
        birth[n] = -1  # staged before op 0
        if not donate_feeds:
            last_use[n] = n_ops - 1
        else:
            last_use.setdefault(n, -1)  # fed, never read: dies at once

    # the backward keeps its (remat-filtered) activation frontier alive
    remat_level = getattr(program, '_remat_level', None)
    for i, op in enumerate(ops):
        if op.type != 'autodiff':
            continue
        for n in _saved_activations(ops, i, op.attrs.get('loss_name'),
                                    remat_level):
            last_use[n] = max(last_use.get(n, i), i)

    # -- the walk --------------------------------------------------------
    tracked = [n for n in birth if n not in persist_names and sizes.get(n)]
    births, deaths = {}, {}
    feed_bytes = 0
    live = 0
    for n in tracked:
        if birth[n] < 0:
            feed_bytes += sizes[n]
            if last_use[n] < 0:
                continue  # fed, never read
            live += sizes[n]
        else:
            births.setdefault(birth[n], []).append(n)
        deaths.setdefault(last_use[n], []).append(n)

    per_op = []
    peak = persistable_bytes + live
    peak_entry = None
    for i, op in enumerate(ops):
        for n in births.get(i, ()):
            live += sizes[n]
        total = persistable_bytes + live
        entry = {'index': i,
                 'op_seq': op.attrs.get('op_seq', i),
                 'type': op.type,
                 'role': _cm._role(op),
                 'live_bytes': total,
                 'intermediate_bytes': live}
        per_op.append(entry)
        if total > peak or peak_entry is None:
            peak = total
            peak_entry = entry
        for n in deaths.get(i, ()):
            live -= sizes[n]

    watermark = sorted(per_op, key=lambda e: -e['live_bytes'])[:top_k]
    return {
        'peak_bytes': int(peak),
        'peak_intermediate_bytes': int(
            peak_entry['intermediate_bytes'] if peak_entry else 0),
        'overlap_bucket_bytes': 0,
        'persistable_bytes': int(persistable_bytes),
        'feed_bytes': int(feed_bytes),
        'sharding': None,
        'remat_level': remat_level,
        'donated_feed_credit': bool(donate_feeds),
        'watermark': [dict(e) for e in watermark],
        'timeline': [{'op_seq': e['op_seq'],
                      'live_bytes': e['live_bytes']} for e in per_op],
        'coverage': {
            'ops': n_ops,
            'sized_vars': len(sizes),
            'unsized_vars': sorted(unsized)[:32],
            'no_verdict': sorted(no_verdict),
            'waived': waived,
            'unknown_dims': unk[0],
        },
    }
