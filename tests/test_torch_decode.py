"""The port's decode engine and server (paddle_tpu_torch/inference/
decode.py) against paddle_tpu/inference/decode.py, on the CPU.

Both engines run the same weights: the reference's startup program
initialises them, ``extract_params`` pulls them out, and
``params_from_numpy`` hands the numpy arrays to the port.  Sizes are
tests/test_decode.py's (L=2, D=32, H=4, V=64, T=64; page 8, 4 streams,
prefill bucket 32).

Tolerance: 1e-5 absolute on logits and K/V.  Both sides compute in
float32 on the CPU with different BLAS and summation orders; logits are
O(1) after two layers, so the gap is a few ulps.  Greedy tokens must be
equal: the fixed seeds give no argmax near-ties at this gap.
"""
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.inference import decode as jdec
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.inference import decode as tdec
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

L, D, H, V, T = 2, 32, 4, 64, 64
PAGE, STREAMS, PREFILL_TOP = 8, 4, 32
TOL = 1e-5
PLENS = [5, 11, 17, 23, 8, 30]


@pytest.fixture(scope='module')
def np_params():
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 7
        startup.random_seed = 7
        with fluid.program_guard(main, startup):
            jtr.build(vocab_size=V, seq_len=T, n_layers=L, d_model=D,
                      n_heads=H)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        return {n: np.asarray(a)
                for n, a in jdec.extract_params(scope, L).items()}


def _engines(np_params, **kw):
    common = dict(n_layers=L, n_heads=H, page_size=PAGE,
                  max_streams=STREAMS, prefill_bucket=PREFILL_TOP, **kw)
    j = jdec.DecodeEngine({n: jnp.asarray(a) for n, a in np_params.items()},
                          **common)
    t = tdec.DecodeEngine(tdec.params_from_numpy(np_params, 'cpu'),
                          device='cpu', **common)
    return j, t


@pytest.fixture(scope='module')
def engines(np_params):
    j, t = _engines(np_params)
    j.warmup()
    t.warmup()
    return j, t


def _prompts(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, size=n) for n in PLENS]


def _close(got, want):
    assert got.shape == np.shape(want)
    assert np.max(np.abs(np.asarray(got) - np.asarray(want))) <= TOL


def test_init_params_shapes_and_families_match_startup(np_params):
    """init_params builds every tr_* tensor with the reference's shape
    and initializer family (values differ: torch.Generator)."""
    cfg = ttr.TransformerConfig(V, T, L, D, H)
    got = ttr.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    assert list(got) == ttr.param_names(L) == jtr.param_names(L)
    for name, ref in np_params.items():
        t = got[name].numpy()
        assert t.shape == ref.shape and t.dtype == ref.dtype, name
        if name.endswith(('_b', 'ln_attn_w', 'ln_ffn_w', 'ln_f_w')):
            assert np.array_equal(t, ref), name   # constant inits
        else:
            limit = np.sqrt(6.0 / sum(ref.shape))
            assert np.abs(t).max() <= limit, name
            assert np.abs(ref).max() <= limit, name


def test_forward_logits_and_kv_match_reference(np_params):
    tokens = np.random.default_rng(1).integers(0, V, size=(2, 19))
    jl, jk, jv = jdec._forward({n: jnp.asarray(a)
                                for n, a in np_params.items()},
                               jnp.asarray(tokens, jnp.int32), L, H)
    tl, tk, tv = tdec._forward(tdec.params_from_numpy(np_params, 'cpu'),
                               torch.from_numpy(tokens), L, H)
    for got, want in ((tl, jl), (tk, jk), (tv, jv)):
        _close(got.numpy(), want)


def test_engine_prefill_and_step_logits_match_reference(engines):
    j, t = engines
    prompt = np.random.default_rng(5).integers(0, V, size=11)
    jp, tp = j.cache.alloc(3), t.cache.alloc(3)
    assert jp == tp
    try:
        lj = j.prefill_into(prompt.astype(np.int32), jp)
        lt = t.prefill_into(prompt, tp)
        _close(lt, lj)
        toks = list(prompt) + [int(np.argmax(lj))]
        mpp = t.pages_per_stream
        for _ in range(6):
            pt = np.full((STREAMS, mpp), t.cache.trash, np.int64)
            pt[0, :3] = tp
            tok = np.zeros((STREAMS,), np.int64)
            tok[0] = toks[-1]
            ctx = np.zeros((STREAMS,), np.int64)
            ctx[0] = len(toks) - 1
            nj, gj = j.step(tok, pt, ctx)
            nt, gt = t.step(tok, pt, ctx)
            _close(gt[0], gj[0])
            assert int(nt[0]) == int(nj[0])
            toks.append(int(nj[0]))
    finally:
        j.cache.free(jp)
        t.cache.free(tp)
    assert t.compiles_total == t.compiles_after_warmup == 0
    assert t.cache.free_pages() == t.cache.num_pages


@pytest.mark.parametrize('mode', ['continuous', 'static', 'prefix_chunked'])
def test_server_greedy_tokens_match_reference(np_params, engines, mode):
    """Six mixed requests joining mid-decode.  ``prefix_chunked`` runs
    both servers with the prefix cache on and an 8-token chunk budget,
    on prompts sharing a 16-token preamble, so admissions hit the trie
    and prefill is scheduled chunk by chunk."""
    static = mode == 'static'
    if mode == 'prefix_chunked':
        j, t = _engines(np_params, prefix_cache=True,
                        prefill_chunk_tokens=8)
        j.warmup()
        t.warmup()
        pre = np.random.default_rng(19).integers(0, V, size=16)
        prompts = [np.concatenate([pre, p[:8]]) for p in _prompts(23)]
    else:
        j, t = engines
        prompts = _prompts(17)
    outs = []
    before = tfa.launches
    for eng in (j, t):
        srv = (jdec if eng is j else tdec).DecodeServer(
            eng, static_batching=static)
        try:
            streams = []
            for p in prompts:
                streams.append(srv.submit(p, max_new_tokens=6))
                time.sleep(0.002)   # stagger: joins land mid-decode
            assert srv.drain(timeout=120.0)
            outs.append([st.result(timeout=5.0) for st in streams])
            stats = srv.stats()
            assert stats['completed'] == len(prompts)
            assert stats['dropped'] == 0
            # every page is free or held by the prefix trie
            assert (stats['free_pages'] + stats['cached_pages']
                    == eng.cache.num_pages)
            assert stats['static_batching'] is static
            if mode == 'prefix_chunked':
                assert stats['prefix_hit_tokens'] > 0
                assert stats['prefill_chunks'] > len(prompts)
        finally:
            srv.close()
    assert outs[0] == outs[1]
    assert tfa.launches == before   # CPU: the kernel never launches


def test_stats_keys_match_reference(engines):
    j, t = engines
    sj, st = jdec.DecodeServer(j), tdec.DecodeServer(t)
    try:
        assert set(st.stats()) == set(sj.stats())
        assert st.stats()['resident_bytes'] == sj.stats()['resident_bytes']
    finally:
        sj.close()
        st.close()


def test_prefix_hit_bitwise_vs_cold_within_port(np_params):
    """Chunked prefill on the absolute position grid: a prefix hit's
    tail chunks are the cold run's last chunks, so the logits are
    bitwise equal; both sit within TOL of the reference engine."""
    j, t = _engines(np_params, prefix_cache=True)
    prompt = np.random.default_rng(41).integers(0, V, size=21)

    def run(eng, pages, start):
        logits = None
        for lo, hi in eng.chunk_spans(len(prompt), start=start):
            logits = eng.prefill_chunk(prompt[lo:hi], pages, lo)
        return logits

    cold_pages = t.cache.alloc(3)
    tail_pages = t.cache.alloc(1)
    cold = run(t, cold_pages, 0)
    hit = run(t, list(cold_pages[:2]) + list(tail_pages), 16)
    assert np.array_equal(cold, hit)
    _close(cold, run(j, j.cache.alloc(3), 0))


def test_prompt_too_long_is_typed(engines):
    _, t = engines
    srv = tdec.DecodeServer(t)
    try:
        with pytest.raises(tdec.PromptTooLongError):
            srv.submit(np.zeros(PREFILL_TOP + 1, np.int64), 4)
        with pytest.raises(tdec.PromptTooLongError):
            srv.submit(np.zeros(PREFILL_TOP, np.int64), T)
        assert issubclass(tdec.PromptTooLongError, ValueError)
    finally:
        srv.close()
