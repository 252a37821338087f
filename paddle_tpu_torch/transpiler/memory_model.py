"""Closed-form residency of the decode engine's KV page pools.

Reference parity: ``page_pool_bytes`` and ``prefix_cached_bytes`` of
paddle_tpu/transpiler/memory_model.py.  The liveness model over the
Program IR comes with the cost model, each as its pass (ROADMAP.md
Queue 1 item 7).
"""
from ..core.datatypes import itemsize

__all__ = ['page_pool_bytes', 'prefix_cached_bytes']


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
