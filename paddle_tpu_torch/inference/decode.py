"""Autoregressive decode engine: continuous batching over a
device-resident paged KV cache.

Reference parity: paddle_tpu/inference/decode.py, the whole module.

- **prefill/decode split**: a prompt runs once through a full-context
  forward, padded to a page-size-multiple bucket.  Its attention is the
  flash_attention op (ops/attention.py), so on the card every layer of
  every prefill launches the hand-written flash-attention kernel.  Its
  per-layer K/V land in claimed cache pages, and its last-position
  logits give the first token.  Every later token is one batched decode
  step over all stream slots, attending over pages through the
  ``paged_attention`` op (a chunked prefill through
  ``chunked_prefill_attention``), reached through the op registry as the
  reference's engine reaches them.
- **paged KV cache**: per-layer page pools ``[L, num_pages + 1,
  page_size, heads, head_dim]`` in device memory, with a host-side page
  table and free list.  Where the reference donates the pools through
  every compiled pack and step, the port writes them in place: the
  prefill pack, the chunked prefill and the decode step index-write the
  pool tensors, so the cache is never copied or double-buffered.
- **continuous batching**: admission at step granularity;
  ``static_batching=True`` on the server reproduces the
  generation-barriered baseline.

There is no jit: PyTorch runs eagerly.  ``warmup()`` runs every prefill
bucket and the step once, which builds the kernel library on the card.
``compiles_total`` counts the kernel libraries built or loaded while the
engine ran, and ``compiles_after_warmup`` any that came after warmup.

Every engine entry point runs on the engine's device and on the CUDA
stream that was current when it was built, whichever thread calls it:
the server's worker thread launches where warmup did.
"""
import contextlib
import itertools
import threading
import time
from collections import deque

import numpy as np
import torch

from ..core.place import resolve_device
from ..flags import FLAGS
from .. import observability as _obs
from ..analysis import lockdebug as _lkd
from ..observability.metrics import DEFAULT_LATENCY_BUCKETS
from ..core.registry import get_op_impl
from ..ops.attention import flash_attention
from ..ops.kernels import build as _build
from ..transpiler.memory_model import page_pool_bytes, prefix_cached_bytes

__all__ = ['DecodeEngine', 'DecodeServer', 'DecodeStream',
           'params_from_numpy', 'extract_params', 'decode_buckets',
           'PrefixCache', 'PagedKVCache', 'PromptTooLongError']

_server_seq = itertools.count()


class PromptTooLongError(ValueError):
    """A submitted prompt cannot be served: longer than the top prefill
    bucket (monolithic prefill), or prompt+max_new exceeds the model
    context.  Raised in the submitting thread, never the worker."""


def params_from_numpy(np_params, device=None):
    """``{name: np.ndarray}`` (what the reference's ``extract_params``
    gives, through ``np.asarray``) -> ``{name: tensor}`` on ``device``
    (None: the card), so both engines run the same weights."""
    device = resolve_device(device)
    return {n: torch.from_numpy(np.array(a, copy=True)).to(device)
            for n, a in np_params.items()}


def extract_params(scope, n_layers):
    """The transformer's fixed-name ``tr_*`` parameters of a scope
    (models/transformer.py ``param_names``) as ``{name: tensor}``: the
    engine serves the weights a training run left there, on the device
    they lie on."""
    from ..models.transformer import param_names
    return {n: scope.get(n) for n in param_names(n_layers)}


def decode_buckets(page_size, top):
    """The prefill bucket ladder: page-size multiples doubling up to
    ``top`` (inclusive), [P, 2P, 4P, ...]."""
    page_size, top = int(page_size), int(top)
    if top < page_size or top % page_size:
        raise ValueError(
            "prefill bucket top %d must be a multiple of page_size %d"
            % (top, page_size))
    sizes = [page_size]
    while sizes[-1] < top:
        sizes.append(min(sizes[-1] * 2, top))
    return sizes


def _ln(x, w, b, eps=1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return (xf - mean) / torch.sqrt(var + eps) * w + b


def _ffn(params, p, x):
    h = _ln(x, params[p + 'ln_ffn_w'], params[p + 'ln_ffn_b'])
    h = torch.relu(h @ params[p + 'ffn_up_w'] + params[p + 'ffn_up_b'])
    return x + h @ params[p + 'ffn_down_w'] + params[p + 'ffn_down_b']


def _forward(params, tokens, n_layers, n_heads):
    """Full-context forward over [B, T] integer tokens: the prefill path
    and the parity reference.  Attention is the flash_attention op with
    a causal mask.  Returns (logits [B, T, V], k_all [L, B, T, H, Dh],
    v_all)."""
    b, t = tokens.shape
    x = params['tr_embed'][tokens] + params['tr_pos'][:t][None]
    d = x.shape[-1]
    dh = d // n_heads
    ks, vs = [], []
    for i in range(n_layers):
        p = 'tr_l%d_' % i
        h = _ln(x, params[p + 'ln_attn_w'], params[p + 'ln_attn_b'])
        qkv = h @ params[p + 'qkv_w'] + params[p + 'qkv_b']
        q, k, v = (y.reshape(b, t, n_heads, dh)
                   for y in qkv.split(d, dim=-1))
        ks.append(k)
        vs.append(v)
        ctx = flash_attention(q, k, v, causal=True).reshape(b, t, d)
        x = x + ctx @ params[p + 'proj_w'] + params[p + 'proj_b']
        x = _ffn(params, p, x)
    x = _ln(x, params['tr_ln_f_w'], params['tr_ln_f_b'])
    logits = x @ params['tr_head_w'] + params['tr_head_b']
    return logits, torch.stack(ks), torch.stack(vs)


class PagedKVCache(object):
    """Device page pools + host free list.  The pools are tensors the
    engine writes in place; the free list is host state owned by the
    server's worker thread."""

    def __init__(self, n_layers, num_pages, page_size, n_heads,
                 head_dim, dtype=torch.float32, device=None):
        self.n_layers = int(n_layers)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        # one extra TRASH page (index num_pages): padded page-table
        # entries and inactive slots direct their writes there, so no
        # write needs a mask.  Writes to it may repeat an index, and
        # which of them lands is unspecified: nothing reads the page
        self.trash = self.num_pages
        shape = (self.n_layers, self.num_pages + 1, self.page_size,
                 self.n_heads, self.head_dim)
        device = resolve_device(device)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self._free = list(range(self.num_pages))

    def free_pages(self):
        return len(self._free)

    def alloc(self, n):
        """Claim ``n`` pages, or None when the pool can't supply them:
        the caller (admission) keeps the stream queued, never drops."""
        if n > len(self._free):
            return None
        pages, self._free = self._free[:n], self._free[n:]
        return pages

    def free(self, pages):
        self._free.extend(pages)

    def resident_bytes(self):
        """layers x {K,V} x pages x page_size x heads x head_dim x
        itemsize, the trash page included."""
        return page_pool_bytes(self.num_pages + 1, self.page_size,
                               self.n_heads, self.head_dim,
                               self.k.dtype, n_layers=self.n_layers)


class _PrefixNode(object):
    """One cached page: the KV of ``key`` (a page_size token tuple)
    computed under the prefix its trie path spells."""
    __slots__ = ('key', 'page', 'parent', 'children', 'refs',
                 'last_use')

    def __init__(self, key, page, parent):
        self.key = key
        self.page = page
        self.parent = parent
        self.children = {}
        self.refs = 0
        self.last_use = 0


class PrefixCache(object):
    """Radix trie over token sequences mapping page-aligned prefixes to
    ref-counted KV pages.

    Host state owned by the decode worker thread.  Chunked prefill runs
    on an absolute position grid, so a cached page's KV is bitwise the
    same for every stream sharing the prefix, and a hit reproduces the
    cold logits exactly.  Ownership rules:

    - ``match`` acquires a ref per matched node; the stream holds it
      until retire (or preemption) and ``release``s it.
    - ``insert`` adopts the caller's page for any prefix page not yet
      cached; an already-cached page is skipped, and the caller frees
      its own copy.
    - ``evict`` frees only unreferenced leaf pages, LRU-first.
    """

    def __init__(self, page_size):
        self.page_size = int(page_size)
        self._root = _PrefixNode(None, None, None)
        self._clock = 0
        self.cached_pages = 0

    def _tick(self):
        self._clock += 1
        return self._clock

    def match(self, tokens):
        """Longest cached page-aligned prefix of ``tokens``: returns
        (pages, nodes) root-first, one ref acquired per node."""
        P = self.page_size
        node, pages, nodes = self._root, [], []
        i = 0
        while i + P <= len(tokens):
            child = node.children.get(
                tuple(int(x) for x in tokens[i:i + P]))
            if child is None:
                break
            child.refs += 1
            child.last_use = self._tick()
            nodes.append(child)
            pages.append(child.page)
            node = child
            i += P
        return pages, nodes

    def release(self, nodes):
        for n in nodes:
            n.refs -= 1
            n.last_use = self._tick()

    def insert(self, tokens, pages, acquire=False):
        """Walk the full pages of ``tokens`` (pages[i] backs page i),
        creating nodes for uncached pages.  Returns (nodes,
        adopted_indices): the caller no longer owns pages at adopted
        indices.  With ``acquire`` every node on the path gains a ref."""
        P = self.page_size
        node, nodes, adopted = self._root, [], []
        for i in range(min(len(tokens) // P, len(pages))):
            key = tuple(int(x) for x in tokens[i * P:(i + 1) * P])
            child = node.children.get(key)
            if child is None:
                child = _PrefixNode(key, int(pages[i]), node)
                node.children[key] = child
                adopted.append(i)
                self.cached_pages += 1
            if acquire:
                child.refs += 1
            child.last_use = self._tick()
            nodes.append(child)
            node = child
        return nodes, adopted

    def evict(self, want):
        """Free up to ``want`` pages from unreferenced leaves, least
        recently used first; returns the freed page ids."""
        freed = []
        while len(freed) < int(want):
            best, stack = None, list(self._root.children.values())
            while stack:
                n = stack.pop()
                if n.children:
                    stack.extend(n.children.values())
                elif n.refs == 0 and (best is None
                                      or n.last_use < best.last_use):
                    best = n
            if best is None:
                break  # every leaf referenced: nothing evictable
            del best.parent.children[best.key]
            freed.append(best.page)
            self.cached_pages -= 1
        return freed


class DecodeEngine(object):
    """Prefill, pack and decode step over one weight set.

    Not thread-safe by design: exactly one caller (the DecodeServer
    worker) drives it, and the page pools are written in place.
    ``device`` None means the card; pass ``device='cpu'`` to run on the
    CPU.
    """

    def __init__(self, params, n_layers, n_heads, page_size=None,
                 num_pages=None, max_streams=None, prefill_bucket=None,
                 prefix_cache=None, prefill_chunk_tokens=None,
                 dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == 'cuda' else None)
        self.params = {n: torch.as_tensor(v, device=self.device)
                       for n, v in params.items()}
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.d_model = int(self.params['tr_embed'].shape[1])
        self.head_dim = self.d_model // self.n_heads
        self.vocab_size = int(self.params['tr_embed'].shape[0])
        self.max_seq = int(self.params['tr_pos'].shape[0])
        self.page_size = int(page_size or FLAGS.decode_page_size)
        self.max_streams = int(max_streams or FLAGS.decode_max_streams)
        if self.max_seq % self.page_size:
            raise ValueError("max_seq %d not a page_size %d multiple"
                             % (self.max_seq, self.page_size))
        self.pages_per_stream = self.max_seq // self.page_size
        if num_pages is None:
            num_pages = self.max_streams * self.pages_per_stream
        top = int(prefill_bucket or FLAGS.decode_prefill_bucket)
        self.buckets = decode_buckets(self.page_size,
                                      min(top, self.max_seq))
        self.cache = PagedKVCache(self.n_layers, num_pages,
                                  self.page_size, self.n_heads,
                                  self.head_dim, dtype, self.device)
        self.prefix_enabled = bool(FLAGS.decode_prefix_cache
                                   if prefix_cache is None
                                   else prefix_cache)
        self.chunk_tokens = int(FLAGS.decode_prefill_chunk_tokens
                                if prefill_chunk_tokens is None
                                else prefill_chunk_tokens)
        # chunked prefill path: active when either feature is on.  The
        # chunk GRID is anchored at absolute position 0, so a prefix
        # hit's tail chunks are an exact suffix of the cold chunk list,
        # the foundation of bitwise hit-vs-cold parity
        self.chunked = self.prefix_enabled or self.chunk_tokens > 0
        if self.chunked:
            g = max(self.page_size,
                    (self.chunk_tokens // self.page_size)
                    * self.page_size)
            self.chunk_grid = min(g, self.buckets[-1])
            top = next(b for b in self.buckets
                       if b >= self.chunk_grid)
            self.chunk_buckets = [b for b in self.buckets if b <= top]
        else:
            self.chunk_grid = None
            self.chunk_buckets = []
        self.prefix = PrefixCache(self.page_size) \
            if self.prefix_enabled else None
        self._builds_at_init = _build.builds
        self._compiles_at_warmup = None

    @property
    def compiles_total(self):
        """Kernel libraries built or loaded since the engine was made."""
        return _build.builds - self._builds_at_init

    @property
    def compiles_after_warmup(self):
        if self._compiles_at_warmup is None:
            return self.compiles_total
        return self.compiles_total - self._compiles_at_warmup

    def _on_device(self):
        """Run on the engine's device and stream, from any thread."""
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _ints(self, a):
        """Host integers -> an int64 tensor on the engine's device."""
        return torch.as_tensor(np.asarray(a, dtype=np.int64),
                               device=self.device)

    # -- device work ----------------------------------------------------

    def _prefill(self, toks, last):
        logits, k, v = _forward(self.params, toks[None], self.n_layers,
                                self.n_heads)
        return logits[0, last], k[:, 0], v[:, 0]

    def _pack(self, k, v, pages):
        """Scatter a prefill's K/V [L, T, H, Dh] into the pool pages
        ``pages`` (padded entries point at the trash page)."""
        L, P = self.n_layers, self.page_size
        shape = (L, k.shape[1] // P, P, self.n_heads, self.head_dim)
        self.cache.k[:, pages] = k.reshape(shape).to(self.cache.k.dtype)
        self.cache.v[:, pages] = v.reshape(shape).to(self.cache.v.dtype)

    def _chunk(self, toks, pt, pos0, n_valid):
        """One stream's prompt chunk of ``n_valid`` tokens (padded to the
        bucket ``len(toks)``) at absolute positions pos0.., scattered
        into the stream's pages and attending over every cached position
        through the page table.  Returns the last valid row's logits
        only, so intermediate chunks pay one [D] x [D, V] row."""
        params = self.params
        H, Dh, D = self.n_heads, self.head_dim, self.d_model
        P, mpp = self.page_size, self.pages_per_stream
        bucket = toks.shape[0]
        chunk_att = get_op_impl('chunked_prefill_attention').compute
        rows = torch.arange(bucket, device=self.device)
        pos = pos0 + rows
        # padded rows (i >= n_valid) write to the trash page
        page_idx = pt[(pos // P).clamp(0, mpp - 1)]
        page_idx = torch.where(rows < n_valid, page_idx,
                               torch.full_like(page_idx, self.cache.trash))
        offset = pos % P
        x = params['tr_embed'][toks] \
            + params['tr_pos'][pos.clamp(0, self.max_seq - 1)]
        for i in range(self.n_layers):
            p = 'tr_l%d_' % i
            h = _ln(x, params[p + 'ln_attn_w'], params[p + 'ln_attn_b'])
            qkv = h @ params[p + 'qkv_w'] + params[p + 'qkv_b']
            q, k, v = (y.reshape(bucket, H, Dh)
                       for y in qkv.split(D, dim=-1))
            self.cache.k[i, page_idx, offset] = k.to(self.cache.k.dtype)
            self.cache.v[i, page_idx, offset] = v.to(self.cache.v.dtype)
            ctx = chunk_att(None, {'Q': [q], 'KPool': [self.cache.k[i]],
                                   'VPool': [self.cache.v[i]], 'PT': [pt],
                                   'Pos0': [pos0]}, {})['Out'][0]
            x = x + ctx.reshape(bucket, D) @ params[p + 'proj_w'] \
                + params[p + 'proj_b']
            x = _ffn(params, p, x)
        x = _ln(x, params['tr_ln_f_w'], params['tr_ln_f_b'])
        x_last = x[min(max(n_valid - 1, 0), bucket - 1)]
        return x_last @ params['tr_head_w'] + params['tr_head_b']

    def _step(self, tokens, pt, ctx_len):
        """Batched decode step.  ctx_len counts cached positions per
        slot; the incoming token sits at position ctx_len and is cached
        this step."""
        params = self.params
        H, Dh, D = self.n_heads, self.head_dim, self.d_model
        S, P = self.max_streams, self.page_size
        paged = get_op_impl('paged_attention').compute
        pos = ctx_len.clamp(0, self.max_seq - 1)
        x = params['tr_embed'][tokens] + params['tr_pos'][pos]
        page_idx = pt.gather(1, (pos // P)[:, None])[:, 0]
        offset = pos % P
        for i in range(self.n_layers):
            p = 'tr_l%d_' % i
            h = _ln(x, params[p + 'ln_attn_w'], params[p + 'ln_attn_b'])
            qkv = h @ params[p + 'qkv_w'] + params[p + 'qkv_b']
            q, k, v = (y.reshape(S, H, Dh) for y in qkv.split(D, dim=-1))
            self.cache.k[i, page_idx, offset] = k.to(self.cache.k.dtype)
            self.cache.v[i, page_idx, offset] = v.to(self.cache.v.dtype)
            ctx = paged(None, {'Q': [q], 'KPool': [self.cache.k[i]],
                               'VPool': [self.cache.v[i]], 'PT': [pt],
                               'CtxLen': [pos + 1]}, {})['Out'][0]
            x = x + ctx.reshape(S, D) @ params[p + 'proj_w'] \
                + params[p + 'proj_b']
            x = _ffn(params, p, x)
        x = _ln(x, params['tr_ln_f_w'], params['tr_ln_f_b'])
        logits = x @ params['tr_head_w'] + params['tr_head_b']
        return logits, logits.argmax(dim=-1)

    def warmup(self):
        """Run every prefill bucket (or chunk bucket) and the decode step
        once, so one-time set-up (the kernel library's build and load on
        the card) never lands on a live stream's latency.  Every write
        goes to the trash page, so pool contents survive a re-warm with
        streams resident."""
        if self._compiles_at_warmup == self.compiles_total:
            return  # already warm, nothing new built since
        trash = self.cache.trash
        mpp = self.pages_per_stream
        with self._on_device(), torch.no_grad():
            if self.chunked:
                for b in self.chunk_buckets:
                    self._chunk(self._ints(np.zeros(b)),
                                self._ints(np.full(mpp, trash)), 0, b)
            else:
                for b in self.buckets:
                    _, k, v = self._prefill(self._ints(np.zeros(b)), 0)
                    self._pack(k, v, self._ints(
                        np.full(b // self.page_size, trash)))
            S = self.max_streams
            _, nxt = self._step(self._ints(np.zeros(S)),
                                self._ints(np.full((S, mpp), trash)),
                                self._ints(np.zeros(S)))
            nxt.cpu()   # waits for the device
        self._compiles_at_warmup = self.compiles_total

    # -- serving-loop entry points -------------------------------------

    def bucket_for(self, prompt_len):
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise PromptTooLongError(
            "prompt length %d exceeds top prefill bucket %d"
            % (prompt_len, self.buckets[-1]))

    def prefill_into(self, prompt, pages):
        """Run one prompt's prefill and pack its K/V into ``pages`` (the
        stream's claimed pages, page 0 of the stream first).  Returns the
        last-position logits as numpy [V]: the first generated token's
        distribution, the TTFT payload."""
        prompt = np.asarray(prompt, dtype=np.int64)
        t = int(prompt.shape[0])
        bucket = self.bucket_for(t)
        toks = np.zeros((bucket,), np.int64)
        toks[:t] = prompt
        n_pages = bucket // self.page_size
        page_ids = np.full((n_pages,), self.cache.trash, np.int64)
        n_real = min(len(pages), n_pages)
        page_ids[:n_real] = pages[:n_real]
        with self._on_device(), torch.no_grad():
            logits, k, v = self._prefill(self._ints(toks), t - 1)
            self._pack(k, v, self._ints(page_ids))
            return logits.cpu().numpy()

    def chunk_spans(self, prompt_len, start=0):
        """The grid-aligned chunk decomposition of positions
        [start, prompt_len): full ``chunk_grid`` chunks plus one ragged
        remainder.  ``start`` must sit on the grid, so a prefix hit's
        tail spans are an exact suffix of the cold spans."""
        g = self.chunk_grid
        if start % g:
            raise ValueError("chunk start %d off the %d-token grid"
                             % (start, g))
        spans, lo = [], int(start)
        while lo < prompt_len:
            hi = min(lo + g, int(prompt_len))
            spans.append((lo, hi))
            lo = hi
        return spans

    def prefill_chunk(self, tokens, pages, pos0):
        """Run one prefill chunk for a single stream: ``tokens`` [c]
        (c <= chunk_grid) land at absolute positions pos0..pos0+c-1 in
        the pages named by ``pages`` (entries past it route to trash).
        Returns the chunk's last-row logits as numpy [V]."""
        tokens = np.asarray(tokens, dtype=np.int64)
        c = int(tokens.shape[0])
        bucket = self.bucket_for(c)
        toks = np.zeros((bucket,), np.int64)
        toks[:c] = tokens
        mpp = self.pages_per_stream
        pt = np.full((mpp,), self.cache.trash, np.int64)
        n = min(len(pages), mpp)
        pt[:n] = pages[:n]
        with self._on_device(), torch.no_grad():
            logits = self._chunk(self._ints(toks), self._ints(pt),
                                 int(pos0), c)
            return logits.cpu().numpy()

    def step(self, tokens, page_tables, ctx_lens):
        """One batched decode step over all ``max_streams`` slots.
        Inactive slots pass token 0 with an all-trash page-table row:
        their writes land in the trash page and their outputs are
        ignored.  Returns (next_tokens [S], logits [S, V]) numpy."""
        with self._on_device(), torch.no_grad():
            logits, nxt = self._step(self._ints(tokens),
                                     self._ints(page_tables),
                                     self._ints(ctx_lens))
            return nxt.cpu().numpy(), logits.cpu().numpy()

    def resident_bytes(self):
        return self.cache.resident_bytes()


class _DecodeMetrics(object):
    """Per-server decode metrics in the process registry, labelled
    ``server="d<N>"`` (reference: decode.py ``_DecodeMetrics``, the same
    series); ``close()`` retires them.  With metrics disabled the server
    still counts there, as ``stats()`` reads them."""

    def __init__(self, reg, sid):
        L = ('server',)
        self._sid = sid
        self._families = []

        def child(metric):
            self._families.append(metric)
            return metric.labels(server=sid)

        self.streams_active = child(reg.gauge(
            'paddle_tpu_decode_streams_active',
            'streams currently holding a decode batch slot', L))
        self.queue_depth = child(reg.gauge(
            'paddle_tpu_decode_queue_depth',
            'streams waiting for a slot or pages', L))
        self.ttft = child(reg.histogram(
            'paddle_tpu_decode_ttft_seconds',
            'submit-to-first-token latency per stream (prefill path)',
            L, buckets=DEFAULT_LATENCY_BUCKETS))
        self.pages_allocated = child(reg.counter(
            'paddle_tpu_decode_pages_allocated_total',
            'KV-cache pages claimed at stream admission', L))
        self.pages_freed = child(reg.counter(
            'paddle_tpu_decode_pages_freed_total',
            'KV-cache pages returned by finished streams', L))
        self.tokens = child(reg.counter(
            'paddle_tpu_decode_tokens_generated_total',
            'tokens emitted across all streams (prefill + decode)', L))
        self.steps = child(reg.counter(
            'paddle_tpu_decode_steps_total',
            'batched decode steps executed', L))
        self.prefix_hits = child(reg.counter(
            'paddle_tpu_decode_prefix_hit_tokens_total',
            'prompt tokens served from cached prefix pages', L))
        self.prefix_misses = child(reg.counter(
            'paddle_tpu_decode_prefix_miss_tokens_total',
            'prompt tokens the prefill actually computed', L))
        self.prefix_evicted = child(reg.counter(
            'paddle_tpu_decode_prefix_evicted_tokens_total',
            'cached tokens LRU-evicted from the prefix trie', L))
        self.prefill_chunks = child(reg.counter(
            'paddle_tpu_decode_prefill_chunks_total',
            'chunked-prefill dispatches scheduled between decode steps',
            L))
        self.preempted = child(reg.counter(
            'paddle_tpu_decode_preempted_streams_total',
            'streams requeued on page-pool exhaustion mid-decode', L))
        self.cached_pages = child(reg.gauge(
            'paddle_tpu_decode_prefix_cached_pages',
            'KV pages currently held by the prefix trie', L))

    def close(self):
        for m in self._families:
            m.remove(server=self._sid)


class DecodeStream(object):
    """Submit handle: resolves to the generated token ids."""

    def __init__(self, rid, prompt, max_new_tokens):
        self.request_id = rid
        self.prompt = np.asarray(prompt, dtype=np.int64)
        self.max_new_tokens = int(max_new_tokens)
        self.tokens = []          # generated ids, worker-appended
        self.token_times = []     # perf_counter per emitted token
        self.submitted_t = time.perf_counter()
        self.first_token_t = None
        self.done_t = None
        self.error = None
        self._done = threading.Event()
        # worker-side state
        self._slot = None
        self._pages = None
        self._ctx_len = 0         # cached positions
        # chunked-path worker state
        self._prefill_pos = None  # next uncomputed position, else None
        self._prompt_eff = None   # prompt (+ generated, post-preempt)
        self._owned = []          # pages the stream must free/donate
        self._ref_nodes = []      # trie nodes held by reference

    @property
    def ttft_s(self):
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submitted_t

    def per_token_s(self):
        """Inter-token gaps (decode-step latency as a client sees it)."""
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError("stream %s still decoding"
                               % self.request_id)
        if self.error is not None:
            raise self.error
        return list(self.tokens)


class DecodeServer(object):
    """Continuous-batching decode worker over one DecodeEngine.

    ``submit`` queues a prompt; the worker admits it the moment a batch
    slot and enough cache pages free up (claiming
    ceil((prompt+max_new)/page_size) pages so a stream never stalls
    mid-decode), runs its prefill, and folds it into the running batched
    decode step.  Finished streams free their pages and slot at once.

    ``static_batching=True`` is the baseline: admission waits until the
    whole batch finished (generation-batch barriers).
    """

    def __init__(self, engine, static_batching=False, greedy=True,
                 warmup=True):
        self.engine = engine
        self.static = bool(static_batching)
        self.greedy = bool(greedy)
        self._reserve = max(0, int(FLAGS.decode_page_reserve))
        self._preempted = 0       # lock: guarded_by(_cv)
        self._chunk_rr = 0        # round-robin cursor, worker-owned
        # one lock, one wait-set: submit/close wake the worker
        self._cv = _lkd.make_condition('DecodeServer._cv', threading.Lock())
        self._queue = deque()     # guarded by _cv
        self._slots = [None] * engine.max_streams  # worker-owned
        self._stopping = False    # guarded by _cv
        self._submitted = 0
        self._completed = 0
        sid = 'd%d' % next(_server_seq)
        self._m = _DecodeMetrics(_obs.registry(), sid)
        if _obs.enabled():
            _obs.maybe_serve_from_env()
        if warmup:
            engine.warmup()
        self._worker = threading.Thread(target=self._loop,
                                        name='decode-worker-%s' % sid,
                                        daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------

    def submit(self, prompt, max_new_tokens=16, request_id=None):
        prompt = np.asarray(prompt, dtype=np.int64)
        span = int(prompt.shape[0]) + int(max_new_tokens)
        if span > self.engine.max_seq:
            raise PromptTooLongError(
                "prompt+max_new %d exceeds max_seq %d"
                % (span, self.engine.max_seq))
        if not self.engine.chunked:
            # monolithic prefill: a prompt above the top bucket would
            # only surface as a worker-thread error mid-serve; fail here,
            # in the submitting thread, typed
            self.engine.bucket_for(len(prompt))
        with self._cv:
            if self._stopping:
                raise RuntimeError("DecodeServer is closed")
            rid = request_id if request_id is not None \
                else 'r%d' % self._submitted
            st = DecodeStream(rid, prompt, max_new_tokens)
            self._queue.append(st)
            self._submitted += 1
            self._m.queue_depth.set(len(self._queue))
            self._cv.notify()
        return st

    def drain(self, timeout=60.0):
        """Block until every submitted stream finished."""
        deadline = time.perf_counter() + timeout
        with self._cv:
            while self._queue or any(s is not None
                                     for s in self._slots):
                left = deadline - time.perf_counter()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.1))
        return True

    def close(self):
        with self._cv:
            if self._stopping:
                return
            self._stopping = True
            self._cv.notify_all()
        self._worker.join(timeout=30.0)
        self._m.close()

    def stats(self):
        eng = self.engine
        prefix = eng.prefix
        cached = prefix.cached_pages if prefix is not None else 0
        with self._cv:
            active = sum(1 for s in self._slots if s is not None)
            return {
                'prefix_cache': prefix is not None,
                'chunked_prefill': eng.chunked,
                'prefix_hit_tokens': int(self._m.prefix_hits.value),
                'prefix_miss_tokens':
                    int(self._m.prefix_misses.value),
                'prefix_evicted_tokens':
                    int(self._m.prefix_evicted.value),
                'prefill_chunks': int(self._m.prefill_chunks.value),
                'preempted': self._preempted,
                'cached_pages': cached,
                # shared pages are counted once: they live inside the
                # pool resident_bytes already reports
                'prefix_cached_bytes': prefix_cached_bytes(
                    cached, eng.page_size, eng.n_heads, eng.head_dim,
                    eng.cache.k.dtype, n_layers=eng.n_layers),
                'submitted': self._submitted,
                'completed': self._completed,
                'dropped': 0,  # admission queues, never sheds
                'active_streams': active,
                'queued': len(self._queue),
                'free_pages': eng.cache.free_pages(),
                'generated_tokens': int(self._m.tokens.value),
                'decode_steps': int(self._m.steps.value),
                'compiles_total': eng.compiles_total,
                'compiles_after_warmup': eng.compiles_after_warmup,
                'resident_bytes': eng.resident_bytes(),
                'static_batching': self.static,
            }

    # -- worker side ---------------------------------------------------

    def _pages_needed(self, st):
        # the stream's whole span, claimed at admission so decode never
        # stalls on a page fault (bucket padding needs no extra pages:
        # pack routes pad pages to trash)
        span = len(st.prompt) + st.max_new_tokens
        return -(-span // self.engine.page_size)

    def _admit(self, st):
        """Page claim + prefill for a slot-reserved stream, on the
        worker outside the lock; the slot was reserved under ``_cv``."""
        eng = self.engine
        if eng.chunked:
            return self._admit_chunked(st)
        pages = eng.cache.alloc(self._pages_needed(st))
        if pages is None:
            return False
        st._pages = pages
        self._m.pages_allocated.inc(len(pages))
        logits = eng.prefill_into(st.prompt, pages)
        first = int(np.argmax(logits))
        now = time.perf_counter()
        st.first_token_t = now
        st.tokens.append(first)
        st.token_times.append(now)
        st._ctx_len = len(st.prompt)
        self._m.ttft.observe(st.ttft_s)
        self._m.tokens.inc()
        return True

    def _evict(self, want):
        """LRU-evict up to ``want`` unreferenced trie pages back to the
        pool free list."""
        eng = self.engine
        freed = eng.prefix.evict(want)
        if freed:
            eng.cache.free(freed)
            self._m.prefix_evicted.inc(len(freed) * eng.page_size)
        return len(freed)

    def _admit_chunked(self, st):
        """Incremental admission: match the prompt against the prefix
        trie (claiming cached pages by reference), then claim only the
        pages the computed tail needs, and only while the pool keeps
        ``reserve`` pages of headroom.  Prefill itself is scheduled
        chunk by chunk in the loop."""
        eng = self.engine
        P, G = eng.page_size, eng.chunk_grid
        if st._prompt_eff is None:
            # preemption resume: the prompt grows the tokens already
            # generated, so re-prefill recomputes the lost KV and its
            # final chunk emits the next token
            st._prompt_eff = np.concatenate(
                [st.prompt, np.asarray(st.tokens, np.int64)]) \
                if st.tokens else st.prompt
        prompt = st._prompt_eff
        t = len(prompt)
        m, ref_pages, nodes = 0, [], []
        if eng.prefix is not None and t > 0:
            pages, nodes = eng.prefix.match(prompt)
            # usable cached span: whole grid multiples only, capped at
            # t-1 so prefill always computes >= 1 token
            m = (min(len(pages) * P, t - 1) // G) * G
            keep = m // P
            if keep < len(nodes):
                eng.prefix.release(nodes[keep:])
                nodes = nodes[:keep]
            ref_pages = pages[:keep]
        n_tail = -(-t // P) - m // P
        short = n_tail + self._reserve - eng.cache.free_pages()
        if short > 0 and eng.prefix is not None:
            self._evict(short)
        owned = None
        if eng.cache.free_pages() >= n_tail + self._reserve:
            owned = eng.cache.alloc(n_tail)
        if owned is None:
            if nodes:
                eng.prefix.release(nodes)
            return False
        st._pages = list(ref_pages) + list(owned)
        st._owned = list(owned)
        st._ref_nodes = nodes
        st._prefill_pos = m
        self._m.pages_allocated.inc(len(owned))
        self._m.prefix_hits.inc(m)
        self._m.prefix_misses.inc(t - m)
        return True

    def _trie_insert(self, st, upto, acquire):
        """Insert the stream's full pages covering positions [0, upto)
        into the trie; adopted pages leave ``st._owned``.  With
        ``acquire`` the stream swaps its held refs for refs on the whole
        inserted path."""
        eng = self.engine
        seq = np.concatenate(
            [st._prompt_eff, np.asarray(st.tokens, np.int64)])[:upto] \
            if st.tokens else st._prompt_eff[:upto]
        if acquire and st._ref_nodes:
            eng.prefix.release(st._ref_nodes)
        nodes, adopted = eng.prefix.insert(seq, st._pages,
                                           acquire=acquire)
        for i in adopted:
            st._owned.remove(st._pages[i])
        if acquire:
            st._ref_nodes = nodes

    def _finish_prefill(self, st, logits):
        """The stream's final chunk ran: emit the first token and publish
        its full prompt pages to the trie."""
        eng = self.engine
        first = int(np.argmax(logits))
        now = time.perf_counter()
        if st.first_token_t is None:
            st.first_token_t = now
            self._m.ttft.observe(st.ttft_s)
        st.tokens.append(first)
        st.token_times.append(now)
        st._ctx_len = len(st._prompt_eff)
        self._m.tokens.inc()
        if eng.prefix is not None:
            self._trie_insert(st, st._ctx_len, acquire=True)

    def _run_prefill_chunks(self, active):
        """Schedule prefill chunks under the per-tick token budget,
        round-robin across streams.  Budget 0 = unlimited."""
        eng = self.engine
        budget = eng.chunk_tokens if eng.chunk_tokens > 0 else None
        pending = [st for st in active if st._prefill_pos is not None]
        if not pending:
            return
        rr = self._chunk_rr % len(pending)
        self._chunk_rr += 1
        used = 0
        for st in pending[rr:] + pending[:rr]:
            prompt = st._prompt_eff
            t = len(prompt)
            while st._prefill_pos is not None and \
                    (budget is None or used < budget):
                lo = st._prefill_pos
                hi = min(lo + eng.chunk_grid, t)
                logits = eng.prefill_chunk(prompt[lo:hi], st._pages, lo)
                self._m.prefill_chunks.inc()
                used += hi - lo
                if hi >= t:
                    st._prefill_pos = None
                    self._finish_prefill(st, logits)
                else:
                    st._prefill_pos = hi
            if budget is not None and used >= budget:
                break

    def _ensure_capacity(self, st):
        """Claim-as-context-grows: claim the page the next step writes
        if the stream outgrew its claim (evicting unreferenced cache
        pages first).  On exhaustion preempt: free everything, requeue
        at the front, recompute at readmission.  False when preempted."""
        eng = self.engine
        if st._ctx_len // eng.page_size < len(st._pages):
            return True
        if eng.cache.free_pages() < 1 and eng.prefix is not None:
            self._evict(1)
        pages = eng.cache.alloc(1)
        if pages is not None:
            st._pages.extend(pages)
            st._owned.extend(pages)
            self._m.pages_allocated.inc(1)
            return True
        if st._ref_nodes:
            eng.prefix.release(st._ref_nodes)
            st._ref_nodes = []
        if st._owned:
            eng.cache.free(st._owned)
            self._m.pages_freed.inc(len(st._owned))
            st._owned = []
        st._pages = None
        st._prompt_eff = None
        st._prefill_pos = None
        st._ctx_len = 0
        self._m.preempted.inc()
        with self._cv:
            self._preempted += 1
            self._slots[st._slot] = None
            st._slot = None
            self._queue.appendleft(st)
            self._m.queue_depth.set(len(self._queue))
        return False

    def _retire(self, st):
        self._slots[st._slot] = None
        eng = self.engine
        if eng.chunked:
            if eng.prefix is not None and st._pages:
                # donate the completed stream's full pages, prompt and
                # generated span, back to the trie (refs 0)
                self._trie_insert(st, st._ctx_len, acquire=False)
            if st._ref_nodes:
                eng.prefix.release(st._ref_nodes)
                st._ref_nodes = []
            eng.cache.free(st._owned)
            self._m.pages_freed.inc(len(st._owned))
            st._owned = []
        else:
            eng.cache.free(st._pages)
            self._m.pages_freed.inc(len(st._pages))
        st._pages = None
        st.done_t = time.perf_counter()
        self._completed += 1
        st._done.set()

    def _loop(self):
        eng = self.engine
        S, mpp = eng.max_streams, eng.pages_per_stream
        trash = eng.cache.trash
        while True:
            with self._cv:
                while not self._stopping and not self._queue and \
                        all(s is None for s in self._slots):
                    self._cv.wait(0.5)
                if self._stopping and not self._queue and \
                        all(s is None for s in self._slots):
                    return
                # admission at step granularity: continuous mode fills
                # any free slot; static mode only starts a fresh
                # generation once the whole previous batch retired
                admissible = []
                if not self.static or \
                        all(s is None for s in self._slots):
                    admissible = [i for i, s in enumerate(self._slots)
                                  if s is None]
                pending = []
                while self._queue and admissible:
                    st = self._queue.popleft()
                    slot = admissible.pop(0)
                    # reserve the slot under the lock so drain() never
                    # sees the stream in neither queue nor slots
                    st._slot = slot
                    self._slots[slot] = st
                    pending.append(st)
                self._m.queue_depth.set(len(self._queue))
            requeue = [st for st in pending if not self._admit(st)]
            with self._cv:
                for st in requeue:
                    self._slots[st._slot] = None
                    st._slot = None
                if requeue:
                    self._queue.extendleft(reversed(requeue))
                    self._m.queue_depth.set(len(self._queue))
                active = [s for s in self._slots if s is not None]
                self._m.streams_active.set(len(active))
            if not active:
                continue
            if eng.chunked:
                # interleave: up to chunk_tokens of prefill work, then
                # one decode step for every prefill-complete stream
                self._run_prefill_chunks(active)
                decoding = [st for st in active
                            if st._prefill_pos is None]
                decoding = [st for st in decoding
                            if self._ensure_capacity(st)]
                if eng.prefix is not None:
                    self._m.cached_pages.set(eng.prefix.cached_pages)
            else:
                decoding = active
            if not decoding:
                continue
            # build the batched step inputs from host stream state
            tokens = np.zeros((S,), np.int64)
            pts = np.full((S, mpp), trash, np.int64)
            ctx = np.zeros((S,), np.int64)
            for st in decoding:
                i = st._slot
                tokens[i] = st.tokens[-1]
                pts[i, :len(st._pages)] = st._pages
                ctx[i] = st._ctx_len
            nxt, logits = eng.step(tokens, pts, ctx)
            now = time.perf_counter()
            self._m.steps.inc()
            finished = []
            for st in decoding:
                i = st._slot
                st._ctx_len += 1
                if len(st.tokens) < st.max_new_tokens:
                    st.tokens.append(int(nxt[i]))
                    st.token_times.append(now)
                    self._m.tokens.inc()
                if len(st.tokens) >= st.max_new_tokens:
                    finished.append(st)
            with self._cv:
                for st in finished:
                    self._retire(st)
                if finished:
                    self._cv.notify_all()
