"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (nvcc).  It drives ``paddle_tpu_torch`` only (no JAX, nothing
of ``paddle_tpu``), in phases; any failure exits non-zero before the last
line:

1. environment: torch/CUDA versions, the card's name and power limit;
   TF32 is switched off for matmuls and cuDNN so float32 means float32.
2. kernel build: the flash-attention library from the checkout's source.
3. kernel vs plain version on the card at the prefill's shapes (BH = 8,
   D = 64), with the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only, which the port
   never calls) timed twice: device time (``ms``: calls captured in a
   CUDA graph, replayed between CUDA events) and time per back-to-back
   eager call (``call_ms``, which includes the host's cost to enqueue it).
4. serving at full width: the transformer LM (L=6, D=512, H=8, V=30000,
   T=512; page 16, 16 streams, prefill bucket 256) with seeded random
   weights behind ``DecodeServer``; 24 requests of 4-200 prompt tokens
   and 16 generated tokens each.  The kernel's launch count is set to 0
   just before and read just after.
5. path parity: the engine's prefill logits on the card (kernel
   attention) against the same engine on the CPU (plain attention), and
   teacher-forced decode steps against a full-context recompute.
6. profile: a traced prefill and decode step, device time by kernel and
   the device's idle share.
7. a ``{"kernels": [...]}`` line, the card's line, and last
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

from paddle_tpu_torch.inference.decode import (  # noqa: E402
    DecodeEngine, DecodeServer, _forward)
from paddle_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig, init_params)
from paddle_tpu_torch.ops.kernels import build  # noqa: E402
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

SERVE = dict(L=6, D=512, H=8, V=30000, T=512, page=16, streams=16,
             bucket=256, n_req=24, max_new=16)


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
    build.load('flash_attention_fwd')
    secs = time.perf_counter() - t0
    print("built flash_attention_fwd in %.2f s" % secs)
    print(build.build_log['flash_attention_fwd'].strip())


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
        t_bytes = nbytes / HBM_BPS * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        rows.append(dict(
            case=name, tq=tq, tk=tk, causal=causal,
            dtype=str(dtype).replace('torch.', ''), q_offset=qo,
            k_offset=ko, err_o=err_o, err_lse=err_lse, tol_o=tol_o,
            tol_lse=TOL_F32, bound_ms=max(t_bytes, t_ops),
            bound_by='bytes' if t_bytes >= t_ops else 'operations',
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
    fa.launches = 0
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = phase_environment()
    phase_build()
    rows = phase_kernel()
    eng, params, launches = phase_serving()
    phase_parity(eng, params)
    phase_profile(eng)
    main_row = next(r for r in rows if r['case'] == MAIN_CASE)
    kernel = dict(
        name='flash_attention_fwd', route='cuda',
        source='paddle_tpu_torch/csrc/flash_attention_fwd.cu',
        replaces='paddle_tpu/ops/pallas/flash_attention.py:56',
        launches=launches,
        max_abs_err=max(max(r['err_o'], r['err_lse']) for r in rows
                        if r['dtype'] == 'float32'),
        ms=main_row['ms'], plain_ms=main_row['plain_ms'],
        bound_ms=main_row['bound_ms'], bound_by=main_row['bound_by'],
        library_ms=main_row['library_ms'],
        call_ms=main_row['call_ms'],
        plain_call_ms=main_row['plain_call_ms'],
        library_call_ms=main_row['library_call_ms'],
        shape='BH=8 T=256 D=64 float32 causal', cases=rows)
    print(json.dumps({'kernels': [kernel]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
