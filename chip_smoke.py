"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (nvcc).  It drives ``paddle_tpu_torch`` only (no JAX, nothing
of ``paddle_tpu``), in phases; any failure exits non-zero before the last
line:

1. environment: torch/CUDA versions, the card's name and power limit;
   TF32 is switched off for matmuls and cuDNN so float32 means float32.
2. kernel build: the three kernel libraries from the checkout's sources,
   one nvcc each, all started together; ptxas's register and spill lines.
3. flash forward vs its plain version on the card at the prefill's
   shapes (BH = 8, D = 64), with the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only, which the port
   never calls) timed twice: device time (``ms``: calls captured in a
   CUDA graph, replayed between CUDA events) and time per back-to-back
   eager call (``call_ms``, which includes the host's cost to enqueue it).
4. serving at full width: the transformer LM (L=6, D=512, H=8, V=30000,
   T=512; page 16, 16 streams, prefill bucket 256) with seeded random
   weights behind ``DecodeServer``; 24 requests of 4-200 prompt tokens
   and 16 generated tokens each.  The kernels' launch counts are set to
   0 just before and read just after.
5. path parity: the engine's prefill logits on the card (kernel
   attention) against the same engine on the CPU (plain attention), and
   teacher-forced decode steps against a full-context recompute.
6. profile: a traced prefill and decode step, device time by kernel and
   the device's idle share.
7. flash forward and backward vs their plain versions: the training
   shape (BH = 256, T = 512, D = 64, float32, causal) and ragged,
   non-causal, offset, fully-masked-row, dlse and bfloat16 cases; the
   backward's inputs (o, lse) come from the plain forward.  Both kernels
   timed at the training shape; the backward's library yardstick is the
   backward of ``F.scaled_dot_product_attention`` in device time (its
   forward and backward in one CUDA graph, less its forward; the port
   never calls it).
8. dense update vs its plain rules, bitwise, at the model's parameter
   shapes and N = 1,000,003, every rule; timed at 30000 x 512 beside
   ``torch.optim.Adam(fused=True)`` (a yardstick only), both in device
   time and per call.
9. training at full width (the reference's bench_transformer.py config:
   B=32, T=512, V=30000, L=6, D=512, H=8, float32, Adam lr 1e-3) through
   the port's layers, optimizer and Executor: a warm-up step and 8 timed
   steps on one seeded batch; the loss must be finite and fall, and each
   step must launch the forward, backward and dense-update kernels 6, 6
   and 78 times.  Counts are set to 0 just before and read just after.
10. training parity at B=2: one step on the card (kernels) against the
   same program and state on the CPU (plain versions): the loss, every
   gradient, and every parameter's Adam moments and update after the
   step; any non-finite value fails.
11. train -> serve: the trained scope's ``tr_*`` weights behind a
   DecodeServer (4 requests, none dropped), and the engine's prefill
   logits against the port's ``build_logits`` program run by the
   Executor.
12. profile: a traced training step, device time by kernel and idle share.
13. a ``{"kernels": [...]}`` line, the card's line, and last
   ``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import paddle_tpu_torch as tfl  # noqa: E402
from paddle_tpu_torch.inference.decode import (  # noqa: E402
    DecodeEngine, DecodeServer, _forward, extract_params)
from paddle_tpu_torch.models import transformer as ttr  # noqa: E402
from paddle_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig, init_params)
from paddle_tpu_torch.ops.kernels import build  # noqa: E402
from paddle_tpu_torch.ops.kernels import dense_update as du  # noqa: E402
from paddle_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

SEED = 20
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s; float32 on
# the CUDA cores and bf16 on the tensor cores, FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# kernel vs plain version: both accumulate in float32, in other orders
TOL_F32 = 1e-4
# bf16 outputs: both round the same float32 value to bf16; a different
# last float32 bit can flip one bf16 ulp (2^-7 relative at |o| < 4)
TOL_BF16_O = 3.2e-2
# engine logits, card (kernel, cuBLAS) vs CPU (plain, CPU BLAS), float32
TOL_PATH = 1e-3
# backward kernel vs plain version, float32: dq sums by atomics in a
# run-dependent order; bf16: one bf16 ulp of an O(1) gradient
TOL_BWD_F32 = 1e-4
TOL_BWD_BF16 = 3.2e-2
# one training step, card vs CPU: the loss; each gradient as the norm of
# the gap over the norm of the CPU's gradient (entry-wise gaps are larger:
# relu's derivative jumps where the two sides' pre-activations differ in
# the last bits, moving single entries by a whole contribution; the norm
# gaps measured on an H100 were up to 2.4e-3, and the bound leaves room
# for another card's cuBLAS kernels).  Adam's first moment after one step
# is (1 - beta1) * g, so it has the gradient's bound; the second moment is
# (1 - beta2) * g^2, whose relative gap is about twice the gradient's.
# The update p_new - p_old, norm-relative per parameter: Adam's first step
# is lr * g / (|g| + 3.2e-7), so entries whose gradient lies near or
# below 3.2e-7 carry the gradient's relative gap into the update and
# near-zero ones can flip (the largest gap measured on an H100 was 0.084,
# on a layer-0 bias); an update skipped or made to a copy reads 1, one
# flipped in sign 2
TOL_TRAIN_LOSS = 1e-3
TOL_TRAIN_GRAD = 1e-2
TOL_TRAIN_MOMENT2 = 2e-2
TOL_TRAIN_UPDATE = 0.25

KERNELS = ('flash_attention_fwd', 'flash_attention_bwd', 'dense_update')

SERVE = dict(L=6, D=512, H=8, V=30000, T=512, page=16, streams=16,
             bucket=256, n_req=24, max_new=16)
# benchmarks/bench_transformer.py:36-37, the reference's training config
TRAIN = dict(B=32, T=512, V=30000, L=6, D=512, H=8, lr=1e-3, steps=8,
             parity_B=2)


def _zero_counts():
    fa.launches = fa.bwd_launches = du.launches = 0


def _counts():
    return dict(flash_attention_fwd=fa.launches,
                flash_attention_bwd=fa.bwd_launches,
                dense_update=du.launches)


def _call_ms(fn, iters=50):
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events),
    after 3 warm-up calls.  Where the host takes longer to enqueue a call
    than the device to run it, this is the host's rate."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_kernels(fn):
    """Run ``fn`` once under torch.profiler; returns (wall ms,
    [(kernel name, device ms, count)]) for every CUDA kernel, copy and
    fill it ran."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return wall, rows


def _device_ms(fn, iters=20, replays=5):
    """Mean device ms per call: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    cost to enqueue each call drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def _bound(nbytes, flops, dtype=torch.float32):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def _live_pairs(tq, tk, causal, q_offset, k_offset):
    """(q, k) pairs the mask leaves alive, per head."""
    if not causal:
        return tq * tk
    qpos = q_offset + np.arange(tq)
    return int(np.clip(qpos - k_offset + 1, 0, tk).sum())


def phase_environment():
    print("python %s  torch %s  cuda %s"
          % (sys.version.split()[0], torch.__version__, torch.version.cuda))
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    print("card: %s (%d visible)" % (card, torch.cuda.device_count()))
    return card


def phase_build():
    t0 = time.perf_counter()
    build.load_all(KERNELS)
    secs = time.perf_counter() - t0
    print("built %s in %.2f s (parallel nvcc)" % (', '.join(KERNELS), secs))
    for name in KERNELS:
        lines = build.build_log[name].splitlines()
        for i, line in enumerate(lines):
            if 'Compiling entry function' in line:
                fn = line.split("'")[1] if "'" in line else line
                regs = next((x.split('info    : ')[-1]
                             for x in lines[i + 1:i + 4]
                             if 'registers' in x), '')
                spill = next((x.strip() for x in lines[i + 1:i + 4]
                              if 'spill' in x), '')
                print("ptxas %s %s | %s | %s" % (name, fn[-60:], regs,
                                                 spill))


KERNEL_CASES = (
    # name, tq, tk, causal, dtype, q_offset, k_offset
    [('causal_T%d' % t, t, t, True, torch.float32, 0, 0)
     for t in (16, 32, 64, 128, 256)]
    + [('noncausal_T256', 256, 256, False, torch.float32, 0, 0),
       ('ragged_T200', 200, 200, True, torch.float32, 0, 0),
       ('offsets_q128_over_k256', 128, 256, True, torch.float32, 128, 0),
       ('offsets_masked_rows', 128, 128, True, torch.float32, 0, 64),
       ('bf16_causal_T256', 256, 256, True, torch.bfloat16, 0, 0)])
MAIN_CASE = 'causal_T256'   # the top prefill bucket of the serving phase


def phase_kernel():
    bh, d = 8, 64
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    rows = []
    for name, tq, tk, causal, dtype, qo, ko in KERNEL_CASES:
        q = torch.randn((bh, tq, d), generator=gen, device='cuda').to(dtype)
        k = torch.randn((bh, tk, d), generator=gen, device='cuda').to(dtype)
        v = torch.randn((bh, tk, d), generator=gen, device='cuda').to(dtype)
        scale = d ** -0.5
        o, lse = fa._fa_forward(q, k, v, causal, scale, qo, ko)
        o_ref, lse_ref = fa._plain_forward(q, k, v, causal, scale, qo, ko)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        tol_o = TOL_BF16_O if dtype == torch.bfloat16 else TOL_F32
        ok = err_o <= tol_o and err_lse <= TOL_F32
        q4, k4, v4 = (x.view(1, bh, -1, d) for x in (q, k, v))
        mask = None
        if causal and (qo or ko or tq != tk):
            mask = ((qo + torch.arange(tq, device='cuda'))[:, None]
                    >= (ko + torch.arange(tk, device='cuda'))[None, :])
        fns = {
            '': lambda: fa._fa_forward(q, k, v, causal, scale, qo, ko),
            'plain_': lambda: fa._plain_forward(q, k, v, causal, scale,
                                                qo, ko),
            'library_': lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask,
                is_causal=causal and mask is None, scale=scale)}
        times = {}
        for key, fn in fns.items():
            times[key + 'ms'] = _device_ms(fn)
            times[key + 'call_ms'] = _call_ms(fn)
        item = q.element_size()
        nbytes = ((2 * bh * tq * d + 2 * bh * tk * d) * item
                  + bh * tq * 4)
        flops = 4 * d * bh * _live_pairs(tq, tk, causal, qo, ko)
        bound_ms, bound_by = _bound(nbytes, flops, dtype)
        rows.append(dict(
            case=name, tq=tq, tk=tk, causal=causal,
            dtype=str(dtype).replace('torch.', ''), q_offset=qo,
            k_offset=ko, err_o=err_o, err_lse=err_lse, tol_o=tol_o,
            tol_lse=TOL_F32, bound_ms=bound_ms, bound_by=bound_by,
            bytes=nbytes, flops=flops, ok=ok, **times))
        print("kernel %-24s err o %.3g lse %.3g (tol %.3g/%.3g) %s | "
              "device ms: kernel %.4f plain %.4f sdpa %.4f bound %.6f (%s)"
              " | per call ms: kernel %.4f plain %.4f sdpa %.4f"
              % (name, err_o, err_lse, tol_o, TOL_F32,
                 'ok' if ok else 'FAIL', times['ms'], times['plain_ms'],
                 times['library_ms'], rows[-1]['bound_ms'],
                 rows[-1]['bound_by'], times['call_ms'],
                 times['plain_call_ms'], times['library_call_ms']))
    bad = [r['case'] for r in rows if not r['ok']]
    if bad:
        raise SystemExit("kernel disagrees with its plain version: %s"
                         % bad)
    return rows


def _serving_prompts(rng, n, vocab):
    # every prefill bucket (16, 32, 64, 128, 256) gets requests
    lens = [4, 16, 17, 32, 33, 64, 65, 128, 129, 200]
    lens += rng.integers(4, 201, size=n - len(lens)).tolist()
    return [rng.integers(0, vocab, size=t) for t in lens]


def phase_serving():
    c = SERVE
    cfg = TransformerConfig(vocab_size=c['V'], seq_len=c['T'],
                            n_layers=c['L'], d_model=c['D'],
                            n_heads=c['H'])
    params = init_params(cfg, torch.Generator().manual_seed(SEED))
    eng = DecodeEngine(params, n_layers=c['L'], n_heads=c['H'],
                       page_size=c['page'], max_streams=c['streams'],
                       prefill_bucket=c['bucket'])
    t0 = time.perf_counter()
    srv = DecodeServer(eng)   # warmup: every bucket and the step
    warm_s = time.perf_counter() - t0
    prompts = _serving_prompts(np.random.default_rng(SEED), c['n_req'],
                               c['V'])
    _zero_counts()
    t0 = time.perf_counter()
    streams = [srv.submit(p, max_new_tokens=c['max_new']) for p in prompts]
    drained = srv.drain(timeout=600.0)
    wall = time.perf_counter() - t0
    launches = fa.launches
    stats = srv.stats()
    srv.close()
    if not drained:
        raise SystemExit("server did not drain: %s" % stats)
    outs = [st.result(timeout=1.0) for st in streams]
    if any(len(o) != c['max_new'] for o in outs):
        raise SystemExit("a stream came back short: %s"
                         % [len(o) for o in outs])
    if stats['completed'] != c['n_req'] or stats['dropped'] != 0:
        raise SystemExit("completed %d of %d, dropped %d"
                         % (stats['completed'], c['n_req'],
                            stats['dropped']))
    if stats['free_pages'] != eng.cache.num_pages:
        raise SystemExit("pages leaked: %d free of %d"
                         % (stats['free_pages'], eng.cache.num_pages))
    if stats['compiles_after_warmup'] != 0:
        raise SystemExit("kernel built after warmup: %s" % stats)
    if launches < c['n_req'] * c['L']:
        raise SystemExit("flash kernel launched %d times, want >= %d"
                         % (launches, c['n_req'] * c['L']))
    ttft = np.asarray([st.ttft_s for st in streams]) * 1e3
    gaps = np.concatenate([st.per_token_s() for st in streams]) * 1e3
    gen = stats['generated_tokens']
    res = dict(
        requests=c['n_req'], generated_tokens=gen, wall_s=wall,
        generated_tok_s=gen / wall, ttft_ms_p50=float(np.median(ttft)),
        ttft_ms_p99=float(np.percentile(ttft, 99)),
        step_ms_p50=float(np.median(gaps)),
        step_ms_p99=float(np.percentile(gaps, 99)),
        decode_steps=stats['decode_steps'], warmup_s=warm_s,
        flash_launches=launches,
        launches_per_request=launches / c['n_req'],
        prompt_lens=[len(p) for p in prompts])
    print("serving: %s" % json.dumps(res))
    return eng, params, launches


def phase_parity(eng, params):
    c = SERVE
    cpu = DecodeEngine({n: t.cpu() for n, t in params.items()},
                       n_layers=c['L'], n_heads=c['H'],
                       page_size=c['page'], max_streams=c['streams'],
                       prefill_bucket=c['bucket'], device='cpu')
    rng = np.random.default_rng(SEED + 1)
    S, mpp, P = eng.max_streams, eng.pages_per_stream, eng.page_size
    worst_prefill = worst_step = 0.0
    for t in (7, 100, 200):
        prompt = rng.integers(0, c['V'], size=t)
        n_steps = 4
        pages = eng.cache.alloc(-(-(t + n_steps) // P))
        cpu_pages = cpu.cache.alloc(len(pages))
        got = eng.prefill_into(prompt, pages)
        ref = cpu.prefill_into(prompt, cpu_pages)
        worst_prefill = max(worst_prefill, float(np.abs(got - ref).max()))
        toks = list(prompt) + [int(np.argmax(ref))]
        for _ in range(n_steps):
            pt = np.full((S, mpp), eng.cache.trash, np.int64)
            pt[0, :len(pages)] = pages
            tok = np.zeros((S,), np.int64)
            tok[0] = toks[-1]
            ctx = np.zeros((S,), np.int64)
            ctx[0] = len(toks) - 1
            _, lg = eng.step(tok, pt, ctx)
            with torch.no_grad():
                full, _, _ = _forward(
                    eng.params, torch.as_tensor([toks], device='cuda'),
                    c['L'], c['H'])
            full = full[0, -1].cpu().numpy()
            worst_step = max(worst_step, float(np.abs(lg[0] - full).max()))
            toks.append(int(np.argmax(full)))   # teacher forcing
        eng.cache.free(pages)
        cpu.cache.free(cpu_pages)
    print("parity: prefill logits card vs cpu max err %.3g, decode step "
          "vs recompute max err %.3g (tol %.3g)"
          % (worst_prefill, worst_step, TOL_PATH))
    if worst_prefill > TOL_PATH or worst_step > TOL_PATH:
        raise SystemExit("path parity outside tolerance")
    return worst_prefill, worst_step


def phase_profile(eng):
    """A traced run, apart from the timed one: where one prefill (200
    tokens, bucket 256) and one decode step spend device time, and the
    share of the wall time the device sat idle."""
    c = SERVE
    prompt = np.random.default_rng(SEED + 2).integers(0, c['V'], size=200)
    S, mpp = eng.max_streams, eng.pages_per_stream
    pt = np.full((S, mpp), eng.cache.trash, np.int64)
    zeros = np.zeros((S,), np.int64)
    out = {}
    for name, fn in (('prefill_T200', lambda: eng.prefill_into(prompt, [])),
                     ('decode_step_S16', lambda: eng.step(zeros, pt,
                                                          zeros))):
        fn()
        torch.cuda.synchronize()
        wall, rows = _device_kernels(fn)
        busy = sum(ms for _, ms, _ in rows)
        top = sorted(rows, key=lambda r: -r[1])[:6]
        # an empty trace is a missing measurement, not an idle device
        out[name] = dict(
            wall_ms=wall, device_busy_ms=busy if rows else None,
            idle_share=1.0 - busy / wall if rows else None,
            kernels=sum(n for *_, n in rows),
            flash_ms=sum(ms for k, ms, _ in rows if 'fa_fwd_kernel' in k),
            top=[dict(kernel=k[:80], ms=ms, count=n) for k, ms, n in top])
    print("profile: %s" % json.dumps(out))
    return out


BWD_CASES = (
    # name, bh, tq, tk, causal, dtype, q_offset, k_offset, dlse
    ('train_causal_T512_BH256', 256, 512, 512, True, torch.float32, 0, 0,
     False),
    ('causal_T64', 8, 64, 64, True, torch.float32, 0, 0, False),
    ('ragged_T200', 8, 200, 200, True, torch.float32, 0, 0, False),
    ('noncausal_T256', 8, 256, 256, False, torch.float32, 0, 0, False),
    ('offsets_q128_over_k256', 8, 128, 256, True, torch.float32, 128, 0,
     False),
    ('offsets_masked_rows_k64', 8, 128, 128, True, torch.float32, 0, 64,
     False),
    ('dlse_causal_T128', 8, 128, 128, True, torch.float32, 0, 0, True),
    ('bf16_causal_T256', 8, 256, 256, True, torch.bfloat16, 0, 0, False))
BWD_MAIN = 'train_causal_T512_BH256'


def phase_bwd_kernel():
    """At each case, kernel #1 against ``_plain_forward`` (o and lse: the
    training shape is kernel #1's main training case), then kernel #2
    against ``_plain_backward`` on the same inputs, which come from the
    plain forward so that neither check leans on the other kernel.  At
    the training shape also both kernels' times and their yardsticks."""
    d = 64
    gen = torch.Generator(device='cuda').manual_seed(SEED + 3)
    rows, fwd_train = [], None
    for name, bh, tq, tk, causal, dtype, qo, ko, with_dlse in BWD_CASES:
        def rnd(t):
            return torch.randn((bh, t, d), generator=gen,
                               device='cuda').to(dtype)
        q, k, v, do = rnd(tq), rnd(tk), rnd(tk), rnd(tq)
        scale = d ** -0.5
        o_k, lse_k = fa._fa_forward(q, k, v, causal, scale, qo, ko)
        o, lse = fa._plain_forward(q, k, v, causal, scale, qo, ko)
        torch.cuda.synchronize()
        err_o = float((o_k.float() - o.float()).abs().max())
        # a fully masked row carries lse = -1e30 on both sides: gap 0
        err_lse = float((lse_k - lse).abs().max())
        fwd_finite = bool(torch.isfinite(o_k).all())
        tol_o = TOL_BF16_O if dtype == torch.bfloat16 else TOL_F32
        fwd_ok = fwd_finite and err_o <= tol_o and err_lse <= TOL_F32
        di = (do.float() * o.float()).sum(-1)
        if with_dlse:
            di = di - torch.randn((bh, tq), generator=gen, device='cuda')
        di = di.contiguous()
        got = fa._fa_backward(q, k, v, lse, do, di, causal, scale, qo, ko)
        ref = fa._plain_backward(q, k, v, lse, do, di, causal, scale, qo,
                                 ko)
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, ref))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        tol = TOL_BWD_BF16 if dtype == torch.bfloat16 else TOL_BWD_F32
        row = dict(case=name, bh=bh, tq=tq, tk=tk, causal=causal,
                   dtype=str(dtype).replace('torch.', ''), q_offset=qo,
                   k_offset=ko, dlse=with_dlse, max_abs_err=err, tol=tol,
                   finite=finite, fwd_err_o=err_o, fwd_err_lse=err_lse,
                   fwd_tol_o=tol_o, fwd_tol_lse=TOL_F32,
                   fwd_finite=fwd_finite,
                   ok=finite and err <= tol and fwd_ok)
        if name == BWD_MAIN:
            fns = {'': lambda: fa._fa_backward(q, k, v, lse, do, di, causal,
                                               scale, qo, ko),
                   'plain_': lambda: fa._plain_backward(
                       q, k, v, lse, do, di, causal, scale, qo, ko)}
            for key, fn in fns.items():
                row[key + 'ms'] = _device_ms(fn, iters=10, replays=3)
                row[key + 'call_ms'] = _call_ms(fn, iters=20)
            q4, k4, v4 = (x.view(1, bh, -1, d).clone().requires_grad_(True)
                          for x in (q, k, v))
            do4 = do.view(1, bh, tq, d)

            def sdpa():
                return F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True, scale=scale)

            def sdpa_fwd_bwd():
                return torch.autograd.grad(sdpa(), (q4, k4, v4), do4)
            # SDPA's backward alone, in device time: its forward and
            # backward captured in one graph, less its forward (with the
            # lse it saves for the backward) captured alone
            both = _device_ms(sdpa_fwd_bwd, iters=10, replays=3)
            row['library_fwd_ms'] = _device_ms(sdpa, iters=10, replays=3)
            row['library_ms'] = both - row['library_fwd_ms']
            out4 = sdpa()
            row['library_call_ms'] = _call_ms(
                lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                            retain_graph=True), iters=20)
            pairs = bh * _live_pairs(tq, tk, causal, qo, ko)
            item = q.element_size()
            nbytes = 7 * bh * tq * d * item + 2 * bh * tq * 4
            row['bytes'], row['flops'] = nbytes, 10 * d * pairs
            row['bound_ms'], row['bound_by'] = _bound(nbytes, 10 * d * pairs)
            # kernel #1 at the training shape
            f = {'ms': lambda: fa._fa_forward(q, k, v, causal, scale),
                 'plain_ms': lambda: fa._plain_forward(q, k, v, causal,
                                                       scale),
                 'library_ms': lambda: F.scaled_dot_product_attention(
                     q4.detach(), k4.detach(), v4.detach(), is_causal=True,
                     scale=scale)}
            fwd_train = {key: _device_ms(fn, iters=10, replays=3)
                         for key, fn in f.items()}
            fbytes = 4 * bh * tq * d * item + bh * tq * 4
            fwd_train['bound_ms'], fwd_train['bound_by'] = _bound(
                fbytes, 4 * d * pairs)
            fwd_train['shape'] = 'BH=256 T=512 D=64 float32 causal'
            fwd_train['err_o'], fwd_train['err_lse'] = err_o, err_lse
            del q4, k4, v4, out4
        rows.append(row)
        print("fwd kernel %-26s err o %.3g lse %.3g (tol %.3g/%.3g) finite "
              "%s | bwd kernel err %.3g (tol %.3g) finite %s | %s%s"
              % (name, err_o, err_lse, tol_o, TOL_F32, fwd_finite, err, tol,
                 finite, 'ok' if row['ok'] else 'FAIL',
                 '' if 'ms' not in row else
                 " | bwd device ms: kernel %.4f plain %.4f sdpa bwd %.4f "
                 "bound %.4f (%s) | per call ms: kernel %.4f plain %.4f "
                 "sdpa bwd %.4f"
                 % (row['ms'], row['plain_ms'], row['library_ms'],
                    row['bound_ms'], row['bound_by'], row['call_ms'],
                    row['plain_call_ms'], row['library_call_ms'])))
    print("fwd kernel at the training shape: %s" % json.dumps(fwd_train))
    bad = [r['case'] for r in rows if not r['ok']]
    if bad:
        raise SystemExit("flash forward or backward kernel disagrees with "
                         "its plain version or is not finite: %s" % bad)
    return rows, fwd_train


def _model_shapes():
    c = TRAIN
    return [(c['D'],), (3 * c['D'],), (c['D'], 3 * c['D']),
            (4 * c['D'], c['D']), (c['V'], c['D']), (1000003,)]


DENSE_RULES = ('sgd', 'sgd_wd', 'momentum', 'nesterov', 'adam')


def _dense_call(rule, p, m, v, g, lr, plain):
    if rule.startswith('sgd'):
        wd = 0.01 if rule == 'sgd_wd' else None
        return ((du.plain_sgd(p, g, lr, wd),) if plain
                else (du.dense_apply_sgd(p, g, lr, wd),))
    if rule in ('momentum', 'nesterov'):
        nest = rule == 'nesterov'
        return (du.plain_momentum(p, m, g, lr, 0.9, nest) if plain
                else du.dense_apply_momentum(p, m, g, lr, 0.9, nest))
    return (du.plain_adam(p, m, v, g, lr, 0.9, 0.999, 1e-8) if plain
            else du.dense_apply_adam(p, m, v, g, lr, 0.9, 0.999, 1e-8))


def phase_dense_kernel():
    """Kernel #5 against its plain rules, bitwise, on the same inputs."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 4)
    lr = torch.tensor([1e-3], device='cuda')
    b1p = torch.tensor([0.9 ** 3], device='cuda')
    b2p = torch.tensor([0.999 ** 3], device='cuda')
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    results, worst = [], 0.0
    for shape in _model_shapes():
        p, m, g = (torch.randn(shape, generator=gen, device='cuda')
                   for _ in range(3))
        v = torch.rand(shape, generator=gen, device='cuda')
        for rule in DENSE_RULES:
            rate = lr_t if rule == 'adam' else lr
            want = _dense_call(rule, p, m, v, g, rate, plain=True)
            got = _dense_call(rule, p.clone(), m.clone(), v.clone(), g, rate,
                              plain=False)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            worst = max(worst, max(float((a - b).abs().max())
                                   for a, b in zip(got, want)))
            results.append(dict(shape=list(shape), rule=rule, bitwise=same))
    empty = torch.zeros((0,), device='cuda')
    du.dense_apply_sgd(empty, empty, lr)
    bad = [r for r in results if not r['bitwise']]
    print("dense kernel: %d shape x rule cases, bitwise equal %d, max abs "
          "err %.3g" % (len(results), len(results) - len(bad), worst))
    if bad:
        raise SystemExit("dense kernel differs from its plain rule: %s"
                         % bad)
    # timing: the Adam rule on the embedding-sized table
    shape = (TRAIN['V'], TRAIN['D'])
    p, m, g = (torch.randn(shape, generator=gen, device='cuda') * 1e-2
               for _ in range(3))
    v = torch.rand(shape, generator=gen, device='cuda') * 1e-4
    t = dict(
        ms=_device_ms(lambda: du.dense_apply_adam(p, m, v, g, lr_t, 0.9,
                                                  0.999, 1e-8)),
        plain_ms=_device_ms(lambda: du.plain_adam(p, m, v, g, lr_t, 0.9,
                                                  0.999, 1e-8)))
    t['call_ms'] = _call_ms(lambda: du.dense_apply_adam(
        p, m, v, g, lr_t, 0.9, 0.999, 1e-8))
    lib_p = torch.nn.Parameter(p.clone())
    lib_p.grad = g.clone()
    # capturable: its step count stays on the card, so a graph can hold it
    opt = torch.optim.Adam([lib_p], lr=1e-3, fused=True, capturable=True)
    t['library_ms'] = _device_ms(opt.step)
    t['library_call_ms'] = _call_ms(opt.step)
    n = p.numel()
    t['bound_ms'], t['bound_by'] = _bound(28 * n, 10 * n)
    t['shape'] = 'adam %d x %d float32' % shape
    print("dense kernel timing: %s" % json.dumps(t))
    return dict(worst=worst, cases=results, **t)


def _train_programs():
    c = TRAIN
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        _, _, cost = ttr.build(vocab_size=c['V'], seq_len=c['T'],
                               n_layers=c['L'], d_model=c['D'],
                               n_heads=c['H'])
        tfl.optimizer.AdamOptimizer(learning_rate=c['lr']).minimize(cost)
    return main, startup, cost


def _train_feed(batch, seed):
    src = np.random.default_rng(seed).integers(
        1, TRAIN['V'], (batch, TRAIN['T'])).astype(np.int64)
    return {'src': src, 'target': np.roll(src, -1, axis=1)[..., None]}


def phase_training():
    c = TRAIN
    main, startup, cost = _train_programs()
    n_adam = sum(op.type == 'adam' for op in main.global_block().ops)
    exe = tfl.Executor()
    scope = tfl.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    n_params = sum(scope.get(p.name).numel() for p in main.all_parameters())
    feed = _train_feed(c['B'], SEED + 5)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, step_ms = [], []
    for i in range(1 + c['steps']):
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss[0]))
    counts = _counts()
    steps = 1 + c['steps']
    per_step = {k: n / steps for k, n in counts.items()}
    timed = step_ms[1:]
    p50 = float(np.median(timed))
    res = dict(config='B=%d T=%d V=%d L=%d D=%d H=%d float32 Adam lr %g'
               % (c['B'], c['T'], c['V'], c['L'], c['D'], c['H'], c['lr']),
               params=n_params, adam_ops=n_adam, startup_s=startup_s,
               losses=losses, step_ms=step_ms, step_ms_p50=p50,
               tokens_per_s=c['B'] * c['T'] / (p50 / 1e3),
               launches=counts, launches_per_step=per_step,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    print("training: %s" % json.dumps(res))
    want = {'flash_attention_fwd': c['L'], 'flash_attention_bwd': c['L'],
            'dense_update': n_adam}
    if n_adam != 2 + 12 * c['L'] + 4:
        raise SystemExit("program has %d adam ops" % n_adam)
    if per_step != {k: float(n) for k, n in want.items()}:
        raise SystemExit("launches per step %s, want %s" % (per_step, want))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit("loss not finite or not falling: %s" % losses)
    return dict(main=main, startup=startup, cost=cost, scope=scope,
                exe=exe, counts=counts, **res)


def _norm_rel(a, b):
    """||a - b|| / ||b|| (0 when both are zero); NaN stays NaN."""
    gap = float(np.linalg.norm((a - b).ravel()))
    ref = float(np.linalg.norm(b.ravel()))
    return gap / ref if ref > 0 else gap


def phase_train_parity(tr):
    """One step at B=2 on the card (kernels) and on the CPU (plain
    versions) from the same state: the loss, every gradient, and every
    parameter's Adam state after the step (both moments and the update
    p_new - p_old).  Any non-finite value fails."""
    main, startup, cost = tr['main'], tr['startup'], tr['cost']
    card_scope = tfl.Scope()
    tr['exe'].run(startup, scope=card_scope)
    names = [p.name for p in main.all_parameters()]
    adam = {op.input('Param')[0]: (op.input('Moment1')[0],
                                   op.input('Moment2')[0])
            for op in main.global_block().ops if op.type == 'adam'}
    if sorted(adam) != sorted(names):
        raise SystemExit("adam ops do not cover the parameters")
    cpu_scope = tfl.Scope()
    for v in main.list_vars():
        if v.persistable and card_scope.has(v.name):
            cpu_scope.set(v.name, card_scope.get(v.name).to('cpu',
                                                             copy=True))
    before = {n: cpu_scope.get_numpy(n).copy() for n in names}
    feed = _train_feed(TRAIN['parity_B'], SEED + 6)
    fetch = [cost.name] + [n + '@GRAD' for n in names]
    t0 = time.perf_counter()
    card = tr['exe'].run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    cpu = tfl.Executor('cpu').run(main, feed=feed, fetch_list=fetch,
                                  scope=cpu_scope)
    secs = time.perf_counter() - t0
    nonfinite = [n for n, a in zip(['loss'] + fetch[1:], card)
                 if not np.isfinite(a).all()]
    gaps = {'grad': [], 'moment1': [], 'moment2': [], 'update': []}
    param_err, moved, total = 0.0, 0, 0
    for n, g_card, g_cpu in zip(names, card[1:], cpu[1:]):
        gaps['grad'].append((_norm_rel(g_card, g_cpu), n))
        for key, var in zip(('moment1', 'moment2'), adam[n]):
            a, b = card_scope.get_numpy(var), cpu_scope.get_numpy(var)
            if not np.isfinite(a).all():
                nonfinite.append(var)
            gaps[key].append((_norm_rel(a, b), n))
        a, b = card_scope.get_numpy(n), cpu_scope.get_numpy(n)
        if not np.isfinite(a).all():
            nonfinite.append(n)
        gaps['update'].append((_norm_rel(a - before[n], b - before[n]), n))
        diff = np.abs(a - b)
        param_err = max(param_err, float(np.nanmax(diff)))
        moved += int((diff > 1e-6).sum())   # entries apart by > 1e-6
        total += diff.size
    loss_err = abs(float(card[0][0]) - float(cpu[0][0]))
    tol = dict(loss=TOL_TRAIN_LOSS, grad=TOL_TRAIN_GRAD,
               moment1=TOL_TRAIN_GRAD, moment2=TOL_TRAIN_MOMENT2,
               update=TOL_TRAIN_UPDATE)
    # NaN compares False, so `not gap <= tol` fails a NaN gap too
    worst = {k: max(v, key=lambda x: (np.nan_to_num(x[0], nan=np.inf), x[1]))
             for k, v in gaps.items()}
    bad = [k for k, (e, _) in worst.items() if not e <= tol[k]]
    if not loss_err <= TOL_TRAIN_LOSS:
        bad.append('loss')
    res = dict(batch=TRAIN['parity_B'], loss_card=float(card[0][0]),
               loss_cpu=float(cpu[0][0]), loss_err=loss_err,
               norm_rel_err={k: e for k, (e, _) in worst.items()},
               largest_gaps={k: [dict(param=n, norm_rel=e) for e, n in
                                 sorted(v, reverse=True)[:3]]
                             for k, v in gaps.items()},
               param_err=param_err,
               param_share_differing=moved / total, nonfinite=nonfinite,
               seconds=secs, tol=tol)
    print("training parity: %s" % json.dumps(res))
    if nonfinite or bad:
        raise SystemExit("training step on the card disagrees with the CPU "
                         "(%s) or is not finite (%s)" % (bad, nonfinite))
    return res


def phase_train_serve(tr):
    """The trained weights behind the decode server, and the engine's
    prefill logits against the port's build_logits program."""
    c = TRAIN
    params = extract_params(tr['scope'], c['L'])
    eng = DecodeEngine(params, n_layers=c['L'], n_heads=c['H'],
                       page_size=SERVE['page'],
                       max_streams=SERVE['streams'],
                       prefill_bucket=SERVE['bucket'])
    srv = DecodeServer(eng)
    rng = np.random.default_rng(SEED + 7)
    streams = [srv.submit(rng.integers(0, c['V'], size=t), max_new_tokens=8)
               for t in (9, 50, 120, 200)]
    drained = srv.drain(timeout=300.0)
    stats = srv.stats()
    srv.close()
    if not drained or stats['dropped'] != 0 or stats['completed'] != 4:
        raise SystemExit("serving the trained weights: %s" % stats)
    outs = [st.result(timeout=1.0) for st in streams]
    main, startup = tfl.Program(), tfl.Program()
    with tfl.program_guard(main, startup):
        _, logits = ttr.build_logits(vocab_size=c['V'], seq_len=c['T'],
                                     n_layers=c['L'], d_model=c['D'],
                                     n_heads=c['H'])
    worst = 0.0
    for t in (7, 100, 200):
        prompt = rng.integers(0, c['V'], size=t)
        pages = eng.cache.alloc(-(-t // eng.page_size))
        got = eng.prefill_into(prompt, pages)
        eng.cache.free(pages)
        src = np.zeros((1, c['T']), np.int64)
        src[0, :t] = prompt   # causal: later positions cannot leak in
        want, = tr['exe'].run(main, feed={'src': src}, fetch_list=[logits],
                              scope=tr['scope'])
        worst = max(worst, float(np.abs(got - want[0, t - 1]).max()))
    res = dict(completed=stats['completed'], dropped=stats['dropped'],
               generated=[len(o) for o in outs],
               engine_vs_program_logits_err=worst, tol=TOL_PATH)
    print("train -> serve: %s" % json.dumps(res))
    if worst > TOL_PATH:
        raise SystemExit("engine logits disagree with build_logits")
    return res


def phase_train_profile(tr):
    """A traced training step, apart from the timed ones."""
    feed = _train_feed(TRAIN['B'], SEED + 5)

    def step():
        tr['exe'].run(tr['main'], feed=feed, fetch_list=[tr['cost']],
                      scope=tr['scope'])
    wall, rows = _device_kernels(step)
    busy = sum(ms for _, ms, _ in rows)
    top = sorted(rows, key=lambda r: -r[1])[:10]

    def by(tag):
        return sum(ms for k, ms, _ in rows if tag in k)
    out = dict(wall_ms=wall, device_busy_ms=busy if rows else None,
               idle_share=1.0 - busy / wall if rows else None,
               kernels=sum(n for *_, n in rows),
               flash_fwd_ms=by('fa_fwd_kernel'),
               flash_bwd_ms=by('fa_bwd_kernel') + by('fa_bwd_dq_finish'),
               dense_update_ms=by('dense_update_kernel'),
               top=[dict(kernel=k[:80], ms=ms, count=n) for k, ms, n in top])
    print("training profile: %s" % json.dumps(out))
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = phase_environment()
    phase_build()
    rows = phase_kernel()
    eng, params, serve_launches = phase_serving()
    phase_parity(eng, params)
    phase_profile(eng)
    del eng, params
    bwd_rows, fwd_train = phase_bwd_kernel()
    dense = phase_dense_kernel()
    tr = phase_training()
    phase_train_parity(tr)
    phase_train_serve(tr)
    phase_train_profile(tr)
    counts = tr['counts']
    main_row = next(r for r in rows if r['case'] == MAIN_CASE)
    fwd = dict(
        name='flash_attention_fwd', route='cuda',
        source='paddle_tpu_torch/csrc/flash_attention_fwd.cu',
        replaces='paddle_tpu/ops/pallas/flash_attention.py:56',
        launches=serve_launches + counts['flash_attention_fwd'],
        launches_by_path=dict(serving=serve_launches,
                              training=counts['flash_attention_fwd']),
        max_abs_err=max(
            [max(r['err_o'], r['err_lse']) for r in rows
             if r['dtype'] == 'float32']
            + [max(r['fwd_err_o'], r['fwd_err_lse']) for r in bwd_rows
               if r['dtype'] == 'float32']),
        ms=main_row['ms'], plain_ms=main_row['plain_ms'],
        bound_ms=main_row['bound_ms'], bound_by=main_row['bound_by'],
        library_ms=main_row['library_ms'],
        call_ms=main_row['call_ms'],
        plain_call_ms=main_row['plain_call_ms'],
        library_call_ms=main_row['library_call_ms'],
        shape='BH=8 T=256 D=64 float32 causal', training_shape=fwd_train,
        cases=rows)
    bmain = next(r for r in bwd_rows if r['case'] == BWD_MAIN)
    bwd = dict(
        name='flash_attention_bwd', route='cuda',
        source='paddle_tpu_torch/csrc/flash_attention_bwd.cu',
        replaces='paddle_tpu/ops/pallas/flash_attention.py:454',
        launches=counts['flash_attention_bwd'],
        max_abs_err=max(r['max_abs_err'] for r in bwd_rows
                        if r['dtype'] == 'float32'),
        ms=bmain['ms'], plain_ms=bmain['plain_ms'],
        bound_ms=bmain['bound_ms'], bound_by=bmain['bound_by'],
        library_ms=bmain['library_ms'], call_ms=bmain['call_ms'],
        plain_call_ms=bmain['plain_call_ms'],
        library_call_ms=bmain['library_call_ms'],
        shape='BH=256 T=512 D=64 float32 causal', cases=bwd_rows)
    dense_line = dict(
        name='dense_update', route='cuda',
        source='paddle_tpu_torch/csrc/dense_update.cu',
        replaces='paddle_tpu/ops/pallas/dense_update.py:109',
        launches=counts['dense_update'], max_abs_err=dense['worst'],
        ms=dense['ms'], plain_ms=dense['plain_ms'],
        bound_ms=dense['bound_ms'], bound_by=dense['bound_by'],
        library_ms=dense['library_ms'], call_ms=dense['call_ms'],
        library_call_ms=dense['library_call_ms'], shape=dense['shape'],
        cases=len(dense['cases']))
    print(json.dumps({'kernels': [fwd, bwd, dense_line]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
