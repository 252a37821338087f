"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --long-step   # phase 26 alone, see below

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (nvcc).  It drives ``paddle_tpu_torch`` only (no JAX, nothing
of ``paddle_tpu``), in phases; any failure exits non-zero before the last
line:

1. environment: torch/CUDA versions, the card's name and power limit;
   TF32 is switched off for matmuls and cuDNN so float32 means float32.
2. kernel build: the nine kernel sources of the checkout (ten kernels:
   #3 and #4 share one), one nvcc each, all started together; ptxas's
   register and spill lines; the count of tensor-core instructions (HMMA,
   HGMMA) in each kernel function's SASS (``cuobjdump -sass``), which must
   not be 0 in any instance of #1, #2, #3 and #4, nor in the cluster
   chains of #7, #8, #9 and #10, nor in #8's and #10's dW kernels; #7's
   cluster chain must not spill.
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
   shapes and N = 1,000,003, every rule, and the momentum rule with and
   without Nesterov at ResNet-50's 28 parameter shapes (OIHW filters from
   64x3x7x7 to 2048x512x1x1, the 1-D biases and BN vectors, the fc);
   timed at 30000 x 512 beside ``torch.optim.Adam(fused=True)`` (a
   yardstick only), both in device time and per call, and the momentum
   rule at ResNet-50's largest filter (512x512x3x3, four sets in turn so
   each call finds its data cold in L2) beside
   ``torch.optim.SGD(momentum=0.9, fused=True)`` (a yardstick only).
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
13. LSTM forward (#7) and backward (#8) vs their plain versions on the
   card: the LM's training shape (T=128, B=256, H=256), the sentiment
   net's (T=120, B=32, H=128), no peepholes, batches that are not a
   multiple of the kernels' 8-row tile (B=13 at H=256 and H=128), H=32 (a
   cluster of one block), H=100 (units past H within a block), #8's
   cluster cap (H=416) and the first width past it (H=420, #8's wide
   path), the cell's cotangent present and absent, and a ragged, reversed
   batch through the ``lstm`` op (card against CPU, outputs and the grads
   of Input, Weight and Bias).  The backward's inputs come from the plain
   forward; #7 runs twice with its gates and once without on each case's
   inputs: hs, cs and the gates must agree bitwise, and the no-gates
   call's hs and cs with the gated call's; #8 runs twice and must agree
   with itself bitwise; and at H=32 (T=64, B=512) and the cap (T=32,
   B=256) each of #7 and #8 runs 200 and 100 times, each call bitwise
   equal to the first (a race in a cluster chain's exchange or reduction
   shows as a call that differs).  Each case prints #7's and #8's plans
   (path, cluster size, batch rows per cluster, the clusters the card
   runs at once); H=420 must take both wide paths and every other case
   both cluster paths, and the path rule (``lk.cluster_size``, decided
   without a build) must equal both libraries' at widths 4 to 1136.  At
   the LM shape both kernels and their plain versions are timed in device
   time, #7 also as first built (the row-tiled loop, its wide path, on
   every width: lstm_fwd_probe.py's ``row_tiled`` build), #8's time is
   split by kernel function (its chain and dW; torch.profiler), both are
   timed on their wide paths at H=420, and the layer pair fc + lstm
   without peepholes is timed against ``torch.nn.LSTM`` (cuDNN; a
   yardstick only, which the port never calls, and not the kernels'
   function: it has no peepholes).
14. LM training at full width (benchmarks/bench_lstm_lm.py's float32
   config: B=256, T=128, V=10000, E=128, H=256, L=2, Adagrad lr 0.1)
   through the port's layers, optimizer and Executor: a warm-up step and
   8 timed steps on one seeded batch of Zipf-distributed token ids (the
   repo's synthetic text) with full lengths, then more steps on it to 24
   in all (Adagrad at lr 0.1 spikes the loss first); the loss must be
   finite at every step and the last below the first, and each step must
   launch #7 and #8 twice each, every launch of either on its cluster
   path.  Counts are set to 0 just before.
15. LM parity at B=4 with ragged lengths: one step on the card (kernels)
   against the same program and state on the CPU (plain versions): the
   loss, every gradient, and Adagrad's moment and update; every #7 and
   #8 launch of the card's step on its cluster path.
16. sentiment: ``stacked_lstm_net`` at its widths (emb 128, hid 512, 3
   layers, the middle one reversed), V=5148, batch 32 with ragged lengths
   8-120, a warm-up step and 4 timed Adagrad steps; finite losses and 3
   launches each of #7 and #8 per step, every launch of either on its
   cluster path.  Counts are set to 0 just before.
17. profile: a traced LM training step, device time by kernel and idle
   share; #7's time (both its kernel functions); #8's split into its
   chain, dW, the finish and the wide path's transpose.
18. GRU forward (#9) and backward (#10) vs their plain versions on the
   card: the seq2seq translator's training shape (T=64, B=512, H=512) with
   and without h0, H=256 (both on a smaller cluster), H=1024 (both
   kernels' wide path: no cluster holds W), a batch that is not a
   multiple of 16 rows, and two ragged batches through the ``gru`` op
   (card against CPU): one reversed, one with H0 (dH0 compared).  #9 runs
   twice with its gates and once without on each case's inputs: hs and
   the gates must agree bitwise, and the no-gates call's hs with the
   gated call's; #10 runs twice and must agree with itself bitwise.  Each
   case prints both plans (path, cluster size, batch rows per cluster, the
   clusters the card runs at once); the main case must take both cluster
   paths and H=1024 both wide paths, and the path rule (``cluster_size``,
   decided without a build) must equal both libraries' at widths 4 to
   1816.  At the training shape #9, #10 and the plain versions are timed
   in device time, #10's time is split by kernel function (its chain and
   dW; torch.profiler); at H=1024 #9 (8 and 16 batch rows per block) and
   #10 are timed on their wide paths; and the layer pair fc + gru with h0
   at the decoder's widths is timed against ``torch.nn.GRU`` (cuDNN; a
   yardstick only, which the port never calls, and not the kernels'
   function: it applies the reset gate after the product).
19. the row-sparse update (#6) vs its plain rules, bitwise, for sgd,
   adagrad and lazy adam on a 30000 x 256 table with K = 32768 ids: the
   synthetic text's Zipf ids, the bench's uniform ids, ids with
   sentinels, out-of-range and negative ids, all K slots on one id, and
   runs straddling every edge of the kernel's design (at widths 250 and
   100); rows not touched must stay bitwise unchanged.  Timed: the kernel
   alone in device time and the whole call (sort and kernel) per call;
   at the Zipf and uniform ids also the id sort, the plain rules, and
   the whole call and ``torch.optim.SparseAdam`` / ``Adagrad`` on a
   sparse gradient and ``index_add_`` (yardsticks only, which cannot be
   captured in a CUDA graph) between CUDA events, per call over
   back-to-back calls and as the median single call.
20. seq2seq training at full width (benchmarks/bench_seq2seq.py's config:
   B=512, T=64, V=30000, word_dim 256, H=512, Adam lr 1e-3; float32) on the
   synthetic WMT14 task, through the port's layers, optimizer and
   Executor: a warm-up step and 8 timed steps on one seeded batch; the loss
   must be finite and fall, each step must launch #9, #10, #6 and the dense
   update 3, 3, 2 and 20 times, every launch of #9 and #10 on its cluster
   path, and the ``prediction`` branch must be skipped.  Counts are set to
   0 just before.
21. seq2seq parity at B=4 with ragged source and target lengths: one step
   on the card against the same program and state on the CPU: the loss,
   every gradient (the embeddings' densified), Adam's moments and update
   (mt_enc_proj_b, whose gradient is zero but for rounding, by its norm);
   untouched embedding rows and their moments unchanged bitwise on both.
21b. the RNN route: at hidden width 30, which the LSTM and GRU kernels
   run padded to 32, #7-#10 against their plain versions at width 30
   and one step of the LM (phase 15) and of the translator (phase 21),
   card against CPU at those phases' bounds, launching the kernels; past
   the backward kernels' caps (H = 1140 and 1820) a ragged batch through
   each op, card against CPU, through the op's eager scan with no LSTM or
   GRU kernel launched; the route's caps (``max_hidden``, decided without
   a build) equal to the built libraries' ``paddle_*_max_hidden``.
22. profile: a traced seq2seq training step, device time by kernel and
   idle share; #9's time by its kernel functions (the cluster chain, the
   wide path's loop), #10's split into its chain, dW, dW's finish and the
   wide path's transpose.
23. the split backward, #3 (dk, dv) and #4 (dq), vs their plain versions
   at every case of phase 7 and at head dims 32, 50 and 128, float32 and
   bfloat16, and at lengths that are no multiple of #4's 32-key warp
   halves, through their wrappers ``_fa_backward_dkv`` and
   ``_fa_backward_dq``; #3's dk and dv bitwise equal to #2's at every
   case; #3, #4 and #2 timed at the training shape beside the plain
   versions (SDPA's backward from phase 7).
24. full length: one layer's attention at 128K context (BH=8, T=131072,
   D=64, float32, causal; seeded inputs, lse from #1): #1's o and lse,
   #4's and #2's dq on 64-query slices (the first, one across the middle
   tile boundary, the last) and #3's and #2's dk, dv on 64-key slices
   against the plain versions on the same rows, with the slice's offset,
   against every key or query; the split pair's dq, dk, dv against #2's
   over the whole length, all norm-relative, and #3's dk and dv bitwise
   equal to #2's.  Reported, not gated: both sides' dk, dv of the first
   key tile and dq of the last query tile (each a sum over all 131072
   queries or keys) against float64 sums.  #1, #3, #4 and #2 timed once
   each after a warm-up, SDPA's forward and backward beside them.
25. long-context parity: phase 10 again (B=2, T=512) with the fused
   kernel's cap ``_FUSED_DQ_BYTES`` lowered to 0 (restored after), so the
   card's step runs #3 and #4 in every layer.
26. long-context training: the transformer of phase 9 at T=131072, B=1
   (where the reference's backward takes its split pair), a warm-up and 2
   timed steps on one seeded batch; the loss must be finite and fall, and
   each step must launch #1, #3 and #4 6 times each, #2 never, and one
   dense Adam apply per parameter.  Counts are set to 0 just before.
27. profile: a traced long-context step, device time by kernel and idle
   share.
28. ResNet-50 training at ``bench.py``'s width (bench.py:165-166,
   :189-199, :222-224: depth 50, 1000 classes, 224x224, batch 64,
   Momentum lr 0.1 mu 0.9; here float32 NCHW) through the port's layers,
   optimizer and ``Executor.run_steps`` on one seeded batch staged on the
   card: a warm-up step, 8 timed single-step calls (p50, img/s), one
   8-step call, then steps to 40 in all (lr 0.1 spikes the loss first);
   the loss must be finite and the last below the first, and each step
   must launch the dense update 214 times (once per parameter) and no
   other kernel.  Reported: peak memory, and the float32 flops of the
   step's convs and fc counted from the program's shapes with their bound
   at 67 TFLOP/s.  Counts are set to 0 just before.
29. ResNet-50 parity at B=2, 224x224: one step on the card against the
   same program and state on the CPU: the loss, every gradient, velocity
   and update, every BN running statistic (bounds and reasons at
   ``TOL_RESNET_*``); the lr-0 conv biases by their gradients' norm and
   an update of 0.
30. profile: a traced ResNet-50 step, device time by kernel and by group
   (cuDNN's and cuBLAS's conv and GEMM kernels, matched by name, and the
   convs' and fc's rate over their time alone; elementwise, reductions,
   pooling, #5, and the rest as ``other``) and idle share.
31. the book's MNIST convnet on the card: 20 Adam steps (lr 0.003) on
   batches of 64 of the synthetic set through ``batch`` and
   ``DataFeeder``; the loss must fall, and each step must launch the
   dense update 6 times.  Phases 28-31 take about 10 s on an H100.
32. a ``{"kernels": [...]}`` line (ten kernels, each with its launches by
   path; ``bound_ms`` at the rate of the units a kernel computes on: the
   tensor cores at 3xTF32 for #1-#4 and #7-#10, with their CUDA-core
   float32 bound beside it as ``cuda_core_bound_ms``; the CUDA cores for
   the rest),
   the card's line, and last ``{"ok": true, "device": {...}}``.

With ``--long-step`` the script runs phase 26 alone, in a process that
has allocated nothing before the step, and prints its record (step
times, peak memory): copied into another checkout and run there too in
the same call, it compares two trees' 128K step on one card.
"""
import json
import os
import re
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
from paddle_tpu_torch.core.registry import get_op_impl  # noqa: E402
from paddle_tpu_torch.datasets import mnist as mnist_data  # noqa: E402
from paddle_tpu_torch.datasets import wmt14  # noqa: E402
from paddle_tpu_torch.models import mnist, resnet  # noqa: E402
from paddle_tpu_torch.models import rnn_lm, sentiment  # noqa: E402
from paddle_tpu_torch.models import seq2seq  # noqa: E402
from paddle_tpu_torch.models import transformer as ttr  # noqa: E402
from paddle_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig, init_params)
from paddle_tpu_torch.ops.kernels import build  # noqa: E402
from paddle_tpu_torch.ops.kernels import dense_update as du  # noqa: E402
from paddle_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops.kernels import gru as gk  # noqa: E402
from paddle_tpu_torch.ops.kernels import lstm as lk  # noqa: E402
from paddle_tpu_torch.ops.kernels import table_update as tu  # noqa: E402

SEED = 20
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s; float32 on
# the CUDA cores and bf16 on the tensor cores, FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# float32 at float32 accuracy on the tensor cores: 3xTF32, three TF32
# products (495 TFLOP/s) for each float32 product, as the flash kernels
# #1-#4 compute
PEAK_3XTF32 = 495e12 / 3
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
# LSTM kernels vs plain versions, float32: h, c, the gates and dx are O(1)
# and both sides sum a dot product of H or 4H terms in other orders; dW and
# dpw sum T * B such terms (up to ~1e2 at the LM shape), so their bound is
# relative to the largest entry
TOL_LSTM = 1e-4
TOL_LSTM_PARAM_REL = 1e-5
# one LM step, card vs CPU: the same bounds and reasons as the transformer
# step's above; Adagrad's moment after one step is g^2 (twice the
# gradient's relative gap) and its first update lr * g / (|g| + 1e-6), so
# gradients near 1e-6 carry their gap into the update and near-zero ones
# can flip
TOL_LM_MOMENT = 2e-2

KERNELS = ('flash_attention_fwd', 'flash_attention_bwd', 'dense_update',
           'lstm_fwd', 'lstm_bwd', 'table_update', 'gru_fwd', 'gru_bwd',
           'flash_attention_bwd_dkv', 'flash_attention_bwd_dq')
# the csrc/*.cu sources: #3 (dkv) and #4 (dq) share one
SOURCES = ('flash_attention_fwd', 'flash_attention_bwd', 'dense_update',
           'lstm_fwd', 'lstm_bwd', 'table_update', 'gru_fwd', 'gru_bwd',
           'flash_attention_bwd_split')

SERVE = dict(L=6, D=512, H=8, V=30000, T=512, page=16, streams=16,
             bucket=256, n_req=24, max_new=16)
# benchmarks/bench_transformer.py:36-37, the reference's training config
TRAIN = dict(B=32, T=512, V=30000, L=6, D=512, H=8, lr=1e-3, steps=8,
             parity_B=2)
# benchmarks/bench_lstm_lm.py:30 and :65-70 (the float32 build) with
# models/rnn_lm.py:11's widths
# Adagrad at lr 0.1 spikes the loss before it falls (its first step moves
# every parameter by about lr): on the H100 the seeded batch's loss rose
# from 9.21 to 18.6 at step 5, was back below the first at step 11 and near
# 4.6 by step 20, so the run goes on past the 8 timed steps to 24
LM = dict(B=256, T=128, V=10000, E=128, H=256, L=2, lr=0.1, steps=8,
          total_steps=24, parity_B=4)
# models/sentiment.py:45-46 stacked_lstm_net widths; batch 32, V and the
# 8-120 lengths of the IMDB set tests/book/test_understand_sentiment.py
# reads (datasets/imdb.py), at that test's learning rate
SENT = dict(B=32, T=120, min_len=8, V=5148, emb=128, hid=512, stacked=3,
            lr=0.002, steps=4)
# benchmarks/bench_seq2seq.py:17 and :25-28 (on_tpu's row; word_dim = dim //
# 2), in float32 (the bench's bfloat16 comes with the AMP slice), on the
# synthetic WMT14 task at full lengths
S2S = dict(B=512, T=64, V=30000, word_dim=256, H=512, lr=1e-3, steps=8,
           parity_B=4)
# 128K-context training: TRAIN's model at T = 131072, B = 1, where the
# reference's backward takes its split pair in every layer (a dq
# accumulator of T * 64 * 4 bytes over flash_attention.py:527's 16 MiB).
# Full depth: a step took ~10.8 s on an H100 (PERF.md), under the 60 s that
# would call for L=2
LONG = dict(B=1, T=131072, V=30000, L=6, D=512, H=8, lr=1e-3, steps=2)
# the split pair vs the fused kernel at full length, norm-relative: both
# float32, dq in other orders (both on the tensor cores at 3xTF32
# accuracy, #2 in atomic order over k tiles, #4 in its walk's order); dk
# and dv must be bitwise equal (#3 and #2 share their engine)
TOL_SPLIT_VS_FUSED = 1e-5
# #1, #2, #3 and #4 at full length vs their plain versions on 64-row
# slices, norm-relative per output: both float32, summing up to 131072
# terms in other orders (the first key tile's dk and dv sum over every
# query).  A late row's o and dq average ~1e5 terms and are small, so
# gaps of a few 1e-7 read as up to 6.6e-6 there on an H100; a wrong index
# or mask reads O(1).  lse by its largest gap, as in phase 7 (TOL_F32)
TOL_LONG_VS_PLAIN = 3e-5
# GRU kernels vs plain versions, float32: h, the gates, dx and dh0 are O(1)
# and both sides sum dot products of H or 3H terms in other orders; dW sums
# T * B such terms (up to ~1e2 at the training shape), so its bound is
# relative to its largest entry
TOL_GRU = 1e-4
TOL_GRU_PARAM_REL = 1e-5
# one seq2seq step, card vs CPU: the transformer step's bounds and reasons,
# except for mt_enc_proj_b.  That bias adds d_t . b to every attention score
# of target step t, which the softmax over the source steps cancels, so its
# gradient is zero but for rounding on both sides: a norm-relative gap of
# two rounding noises says nothing (it read 1.09 on an H100), and Adam
# turns either noise into steps of about lr.  Its gradient is held instead
# to a norm below TOL_S2S_ZERO_GRAD times that of its weight's gradient
# (float32 rounding of the cancelling sums sits near 1e-7 of their terms)
S2S_ZERO_GRAD = {'mt_enc_proj_b': 'mt_enc_proj_w'}
TOL_S2S_ZERO_GRAD = 1e-4
# the RNN route's cases: a hidden width that is not a multiple of 4, which
# the kernels run padded to 32, and widths past the LSTM's and the GRU's
# backward caps (1139 and 1816 at 8 rows a block), which the ops send to
# their eager scan
ROUTE_H = 30
ROUTE_PAST_CAPS = dict(lstm=1140, gru=1820)
# bench.py:165-166 and :189-199 (ResNet-50, 1000 classes, 224x224, batch
# 64, Momentum lr 0.1 mu 0.9) in float32 NCHW (bench.py's default is
# bfloat16 NHWC: AMP is a later slice); one batch of default_rng(0)
# normal images and integer labels staged on the card (bench.py:222-224)
# and run by run_steps.  lr 0.1 on one repeated batch spikes the loss
# first (at B=32, 112x112 on the CPU: 7.75 -> 11.35 at step 5, below the
# first again at step 22), so the run goes on past the timed steps to 40
RESNET = dict(B=64, hw=224, depth=50, classes=1000, lr=0.1, mu=0.9,
              steps=8, total_steps=40, parity_B=2)
# one ResNet-50 step at B=2, card vs CPU.  Each bound sits between what
# sound steps read and what faulty ones do, by
# tests/torch_resnet_parity_controls.py on an H100 (three seeds in two
# processes, then TF32 and three batch-norm faults planted on the card).
# The forward is well conditioned: the loss reads <= 2.6e-5 sound and
# 1.7e-2 under TF32 or a forward normalised by the unbiased variance,
# held to 1e-3; the running statistics after one step (0.9 * init + 0.1
# * the batch statistics) read <= 1.1e-5 norm-relative per layer sound,
# 5.1e-3 and 8.8e-3 under those faults, held to 1e-3.  The gradients are
# not: at the random init the backward through 53 batch norms (each
# subtracting its batch means of dy and dy * xhat) amplifies float32
# rounding from the head down, so two float32 implementations of the
# same step on one CPU already differ by 1.5e-5 norm-relative at the fc,
# 0.7% at the last conv and 2.7% at worst at B=2, the reference on XLA
# against the port on torch (tests/torch_resnet_conditioning.py), and
# the card against the CPU reads 2.2-3.1% at worst.  A batch-norm
# backward that divides its sums by N - 1 reads 8.2%, one that drops its
# s2 term 62%, TF32 93%: the gradients are held to 0.05, near the
# geometric middle of 3.1% and 8.2%.  After one Momentum step the
# velocity is the gradient and the update -lr times it: the same bound,
# no amplifier.  The 53 conv biases (lr 0, each before a batch_norm that
# subtracts its channel's mean) have a gradient that is zero but for
# rounding on both sides, held instead by its norm against its conv
# weight's gradient (1e-7 sound, 6.5e-3 with the N - 1 fault), and
# their update must be 0
TOL_RESNET_LOSS = 1e-3
TOL_RESNET_STATS = 1e-3
TOL_RESNET_GRAD = 0.05
TOL_RESNET_ZERO_GRAD = 1e-4
# the book's MNIST convnet on the card: Adam 0.003, batches of 64 of the
# synthetic set through batch and DataFeeder (tests/book/
# test_recognize_digits.py)
MNIST = dict(B=64, steps=20, lr=0.003)


def _zero_counts():
    fa.launches = fa.bwd_launches = du.launches = 0
    fa.dkv_launches = fa.dq_launches = 0
    lk.launches = lk.fwd_cluster_launches = 0
    lk.bwd_launches = lk.bwd_cluster_launches = 0
    gk.launches = gk.fwd_cluster_launches = 0
    gk.bwd_launches = gk.bwd_cluster_launches = 0
    tu.launches = 0


def _counts():
    return dict(flash_attention_fwd=fa.launches,
                flash_attention_bwd=fa.bwd_launches,
                dense_update=du.launches, lstm_fwd=lk.launches,
                lstm_bwd=lk.bwd_launches, table_update=tu.launches,
                gru_fwd=gk.launches, gru_bwd=gk.bwd_launches,
                flash_attention_bwd_dkv=fa.dkv_launches,
                flash_attention_bwd_dq=fa.dq_launches)


def _want(**nonzero):
    """Launches per step: 0 for every kernel but those named."""
    return {k: float(nonzero.get(k, 0)) for k in KERNELS}


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


def _bound(nbytes, flops, dtype=torch.float32, peak=None):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def _tc_bound(nbytes, flops, dtype=torch.float32):
    """``_bound`` on the tensor cores: float32 at 3xTF32's rate, bf16 at
    its own."""
    return _bound(nbytes, flops, dtype,
                  PEAK_3XTF32 if dtype == torch.float32 else None)


def _flash_bound(nbytes, flops, dtype=torch.float32):
    """A flash kernel's ``bound_ms`` / ``bound_by`` on the tensor cores,
    where #1-#4 compute (3xTF32), and its bound on the CUDA cores beside
    it as ``cuda_core_bound_ms``."""
    tc = _tc_bound(nbytes, flops, dtype)
    return dict(bound_ms=tc[0], bound_by=tc[1],
                cuda_core_bound_ms=_bound(nbytes, flops, dtype)[0])


def _live_pairs(tq, tk, causal, q_offset, k_offset):
    """(q, k) pairs the mask leaves alive, per head."""
    if not causal:
        return tq * tk
    qpos = q_offset + np.arange(tq)
    return int(np.clip(qpos - k_offset + 1, 0, tk).sum())


def _flash_bounds(bh, tq, tk, d, causal, qo, ko, item):
    """{kernel: (bytes, flops)} of #1, #2, #3 and #4 on [bh, t, d] inputs
    of ``item`` bytes: each input read once, each output written once;
    4, 10, 8 and 6 * d flops per live (q, k) pair."""
    pairs = bh * _live_pairs(tq, tk, causal, qo, ko)
    q_, kv_, rows = bh * tq * d * item, bh * tk * d * item, bh * tq * 4
    return {'fwd': (2 * q_ + 2 * kv_ + rows, 4 * d * pairs),
            'fused': (3 * q_ + 4 * kv_ + 2 * rows, 10 * d * pairs),
            'dkv': (2 * q_ + 4 * kv_ + 2 * rows, 8 * d * pairs),
            'dq': (3 * q_ + 2 * kv_ + 2 * rows, 6 * d * pairs)}


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


def _short_function(mangled):
    """A kernel's mangled name cut to its name and template arguments,
    e.g. 'fa_bwd_dq_kernelIfLi128' (float, 128), for printing."""
    tail = re.sub(r'^\d+', '', mangled.split('_cu_')[-1][8:])
    return re.split(r'E+[vPil]', tail)[0]


def phase_build():
    t0 = time.perf_counter()
    build.load_all(SOURCES)
    secs = time.perf_counter() - t0
    print("built %s in %.2f s (parallel nvcc)" % (', '.join(SOURCES), secs))
    for name in SOURCES:
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
                if 'lstm_fwd_chain_kernel' in fn and \
                        re.search(r'\b[1-9]\d* bytes spill', spill):
                    raise SystemExit("#7's cluster chain spills: %s"
                                     % spill)
    # tensor-core instructions in each kernel function's SASS: #1-#4, the
    # cluster chains of #7, #8, #9 and #10 and the cluster path's dW of #8
    # and #10 compute their products there (3xTF32), the other kernels on
    # the CUDA cores
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()),
                             'cuobjdump')
    mma = {}
    for name in SOURCES:
        sass = subprocess.run([cuobjdump, '-sass', build.library_path(name)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            if 'Function : ' in line:
                fn = line.split('Function : ')[1].strip()
                mma.setdefault(name, {})[fn] = 0
            elif fn and ('HMMA' in line or 'HGMMA' in line):
                mma[name][fn] += 1
    by_lib = {name: sum(fns.values()) for name, fns in mma.items()}
    print("tensor-core instructions (HMMA/HGMMA) in the SASS, by library: "
          "%s" % json.dumps(by_lib))
    print("by kernel function: %s" % json.dumps(
        {name: {_short_function(f): n for f, n in fns.items()}
         for name, fns in mma.items() if by_lib[name]}))

    def of(lib, kernel):
        return [n for f, n in mma.get(lib, {}).items() if kernel in f]
    need = dict(lstm_fwd_chain=of('lstm_fwd', 'lstm_fwd_chain_kernel'),
                lstm_bwd_chain=of('lstm_bwd', 'lstm_chain_kernel'),
                lstm_bwd_dw=of('lstm_bwd', 'lstm_dw_tc_kernel'),
                gru_fwd_chain=of('gru_fwd', 'gru_fwd_chain_kernel'),
                gru_bwd_chain=of('gru_bwd', 'gru_chain_kernel'),
                gru_bwd_dw=of('gru_bwd', 'gru_dw_kernel'),
                flash_attention_fwd=of('flash_attention_fwd',
                                       'fa_fwd_kernel'),
                flash_attention_bwd=of('flash_attention_bwd',
                                       'fa_bwd_kernel'),
                flash_attention_bwd_dkv=of('flash_attention_bwd_split',
                                           'fa_bwd_dkv_kernel'),
                flash_attention_bwd_dq=of('flash_attention_bwd_split',
                                          'fa_bwd_dq_kernel'))
    bad = [k for k, counts in need.items() if not counts or not all(counts)]
    if bad:
        raise SystemExit("tensor-core instructions: every instance of #1, "
                         "#2, #3, #4, #7's, #8's, #9's and #10's chains and "
                         "#8's and #10's dW must show some; failing %s"
                         % bad)
    return mma


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
        nbytes, flops = _flash_bounds(bh, tq, tk, d, causal, qo, ko,
                                      q.element_size())['fwd']
        rows.append(dict(
            case=name, tq=tq, tk=tk, causal=causal,
            dtype=str(dtype).replace('torch.', ''), q_offset=qo,
            k_offset=ko, err_o=err_o, err_lse=err_lse, tol_o=tol_o,
            tol_lse=TOL_F32, bytes=nbytes, flops=flops, ok=ok,
            **_flash_bound(nbytes, flops, dtype), **times))
        print("kernel %-24s err o %.3g lse %.3g (tol %.3g/%.3g) %s | "
              "device ms: kernel %.4f plain %.4f sdpa %.4f bound %.6f (%s)"
              " cuda-core bound %.6f | per call ms: kernel %.4f plain %.4f "
              "sdpa %.4f"
              % (name, err_o, err_lse, tol_o, TOL_F32,
                 'ok' if ok else 'FAIL', times['ms'], times['plain_ms'],
                 times['library_ms'], rows[-1]['bound_ms'],
                 rows[-1]['bound_by'], rows[-1]['cuda_core_bound_ms'],
                 times['call_ms'], times['plain_call_ms'],
                 times['library_call_ms']))
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
        got = fa._fa_backward_fused(q, k, v, lse, do, di, causal, scale, qo,
                                    ko)
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
            fns = {'': lambda: fa._fa_backward_fused(q, k, v, lse, do, di,
                                                     causal, scale, qo, ko),
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
            bounds = _flash_bounds(bh, tq, tk, d, causal, qo, ko,
                                   q.element_size())
            row['bytes'], row['flops'] = bounds['fused']
            row.update(_flash_bound(*bounds['fused']))
            # kernel #1 at the training shape
            f = {'ms': lambda: fa._fa_forward(q, k, v, causal, scale),
                 'plain_ms': lambda: fa._plain_forward(q, k, v, causal,
                                                       scale),
                 'library_ms': lambda: F.scaled_dot_product_attention(
                     q4.detach(), k4.detach(), v4.detach(), is_causal=True,
                     scale=scale)}
            fwd_train = {key: _device_ms(fn, iters=10, replays=3)
                         for key, fn in f.items()}
            fwd_train.update(_flash_bound(*bounds['fwd']))
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
                 "bound %.4f (%s) cuda-core bound %.4f | per call ms: kernel "
                 "%.4f plain %.4f sdpa bwd %.4f"
                 % (row['ms'], row['plain_ms'], row['library_ms'],
                    row['bound_ms'], row['bound_by'],
                    row['cuda_core_bound_ms'],
                    row['call_ms'],
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


def _resnet_programs(c=RESNET):
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        _, _, _, cost, _ = resnet.build_imagenet(
            depth=c['depth'], num_classes=c['classes'],
            image_shape=(3, c['hw'], c['hw']))
        tfl.optimizer.MomentumOptimizer(learning_rate=c['lr'],
                                        momentum=c['mu']).minimize(cost)
    return main, startup, cost


def _resnet_shapes():
    """The distinct parameter shapes of ResNet-50: 4-D OIHW filters from
    64x3x7x7 to 2048x512x1x1, the 1-D conv biases and BN vectors, the fc's
    2048 x 1000 and 1000."""
    main, _, _ = _resnet_programs()
    return sorted({tuple(p.shape) for p in main.all_parameters()})


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
    for shape in _resnet_shapes():
        p, m, g = (torch.randn(shape, generator=gen, device='cuda')
                   for _ in range(3))
        for rule in ('momentum', 'nesterov'):
            want = _dense_call(rule, p, m, None, g, lr, plain=True)
            got = _dense_call(rule, p.clone(), m.clone(), None, g, lr,
                              plain=False)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            worst = max(worst, max(float((a - b).abs().max())
                                   for a, b in zip(got, want)))
            results.append(dict(shape=list(shape), rule=rule,
                                bitwise=same, model='resnet50'))
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
    t['resnet_momentum'] = _momentum_timing(gen, lr)
    print("dense kernel timing: %s" % json.dumps(t))
    return dict(worst=worst, cases=results, **t)


def _momentum_timing(gen, lr, copies=4):
    """The momentum rule at ResNet-50's largest conv filter (512 x 512 x
    3 x 3), beside ``torch.optim.SGD(momentum=0.9, fused=True)`` (the
    same rule: v = mu v + g, p -= lr v; a yardstick only).  Each timed
    call takes the next of ``copies`` sets of (param, velocity, grad),
    188 MB in all, so that a call finds its 47 MB cold in the 50 MB L2,
    as a training step's applies do."""
    shape = (512, 512, 3, 3)
    sets = [[torch.randn(shape, generator=gen, device='cuda') * 1e-2
             for _ in range(3)] for _ in range(copies)]

    def cycling(fn):
        turn = [0]

        def call():
            fn(*sets[turn[0] % copies])
            turn[0] += 1
        return call
    t = dict(
        shape='momentum 512 x 512 x 3 x 3 float32, %d copies in turn'
        % copies,
        ms=_device_ms(cycling(lambda p, m, g: du.dense_apply_momentum(
            p, m, g, lr, 0.9))),
        plain_ms=_device_ms(cycling(lambda p, m, g: du.plain_momentum(
            p, m, g, lr, 0.9))),
        call_ms=_call_ms(cycling(lambda p, m, g: du.dense_apply_momentum(
            p, m, g, lr, 0.9))))
    opts = []
    for p, _, g in sets:
        lib_p = torch.nn.Parameter(p.clone())
        lib_p.grad = g.clone()
        opts.append(torch.optim.SGD([lib_p], lr=1e-3, momentum=0.9,
                                    fused=True))
    turn = [0]

    def lib_step():
        opts[turn[0] % copies].step()
        turn[0] += 1
    t['library_ms'] = _device_ms(lib_step)
    n = sets[0][0].numel()
    # reads p, v, g; writes p, v; 4 flops an element (mu v + g, p - lr v)
    t['bound_ms'], t['bound_by'] = _bound(20 * n, 4 * n)
    return t


def _train_programs(c=TRAIN):
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        _, _, cost = ttr.build(vocab_size=c['V'], seq_len=c['T'],
                               n_layers=c['L'], d_model=c['D'],
                               n_heads=c['H'])
        tfl.optimizer.AdamOptimizer(learning_rate=c['lr']).minimize(cost)
    return main, startup, cost


def _train_feed(batch, seed, c=TRAIN):
    src = np.random.default_rng(seed).integers(
        1, c['V'], (batch, c['T'])).astype(np.int64)
    return {'src': src, 'target': np.roll(src, -1, axis=1)[..., None]}


def phase_training(c=TRAIN, label='training', seed=SEED + 5,
                   bwd_kernels=('flash_attention_bwd',)):
    """The transformer of config ``c`` trained through the port's
    Executor; each step must launch #1 and each of ``bwd_kernels`` once
    per layer and the dense update once per parameter."""
    main, startup, cost = _train_programs(c)
    n_adam = sum(op.type == 'adam' for op in main.global_block().ops)
    exe = tfl.Executor()
    scope = tfl.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    n_params = sum(scope.get(p.name).numel() for p in main.all_parameters())
    feed = _train_feed(c['B'], seed, c)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()
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
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               memory_allocated_at_start=allocated_at_start)
    print("%s: %s" % (label, json.dumps(res)))
    want = _want(flash_attention_fwd=c['L'], dense_update=n_adam,
                 **{k: c['L'] for k in bwd_kernels})
    if n_adam != 2 + 12 * c['L'] + 4:
        raise SystemExit("program has %d adam ops" % n_adam)
    if per_step != want:
        raise SystemExit("launches per step %s, want %s" % (per_step, want))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit("loss not finite or not falling: %s" % losses)
    return dict(main=main, startup=startup, cost=cost, scope=scope,
                exe=exe, feed=feed, counts=counts, n_adam=n_adam, **res)


def _norm_rel(a, b):
    """||a - b|| / ||b|| (0 when both are zero); NaN stays NaN."""
    gap = float(np.linalg.norm((a - b).ravel()))
    ref = float(np.linalg.norm(b.ravel()))
    return gap / ref if ref > 0 else gap


def phase_train_parity(tr, label='training parity'):
    """One step at B=2 on the card (kernels) and on the CPU (plain
    versions) from the same state: the loss, every gradient, and every
    parameter's Adam state after the step (both moments and the update
    p_new - p_old).  Any non-finite value fails.  The card step's kernel
    launches are counted."""
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
    _zero_counts()
    card = tr['exe'].run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    counts = _counts()
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
               seconds=secs, tol=tol, launches=counts)
    print("%s: %s" % (label, json.dumps(res)))
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


def phase_train_profile(tr, label='training profile'):
    """A traced training step, apart from the timed ones."""
    def step():
        tr['exe'].run(tr['main'], feed=tr['feed'], fetch_list=[tr['cost']],
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
               flash_bwd_dkv_ms=by('fa_bwd_dkv_kernel'),
               flash_bwd_dq_ms=by('fa_bwd_dq_kernel'),
               dense_update_ms=by('dense_update_kernel'),
               gemm_ms=by('gemm'),   # cuBLAS and CUTLASS sgemm
               top=[dict(kernel=k[:80], ms=ms, count=n) for k, ms, n in top])
    print("%s: %s" % (label, json.dumps(out)))
    return out


LSTM_CASES = (
    # name, T, B, H, peepholes, cotangent of the cells
    ('lm_T128_B256_H256', 128, 256, 256, True, False),
    ('sentiment_T120_B32_H128', 120, 32, 128, True, True),
    ('no_peepholes_T64_B64_H256', 64, 64, 256, False, True),
    ('B13_T33_H256', 33, 13, 256, True, True),
    ('H32_T12_B5', 12, 5, 32, True, False),          # a cluster of 1 block
    ('H100_T20_B40', 20, 40, 100, True, True),       # units past H in a block
    ('B13_T33_H128', 33, 13, 128, True, True),
    ('cap_T16_B64_H416', 16, 64, 416, True, True),   # the widest cluster
    ('wide_T16_B64_H420', 16, 64, 420, True, True),  # the wide paths
)
LSTM_MAIN = 'lm_T128_B256_H256'   # the LM's two layers run this shape
LSTM_WIDE = 'wide_T16_B64_H420'
# #7's and #8's cluster chains called many times on one input, every call
# bitwise equal to the first: H=32 (a cluster of one block, where half of
# #8's eight K shares have no slice and reach the shares' reduction first,
# and #7's K shares are one slice and none) and the cap (H=416, each
# block's own slices read last), both over many clusters
LSTM_REPEAT_CASES = (
    # name, T, B, H, calls
    ('repeat_H32_T64_B512', 64, 512, 32, 200),
    ('repeat_cap_T32_B256_H416', 32, 256, 416, 100),
)
# widths at which #7's and #8's path rule (lk.cluster_size) is held
# against the libraries': the smallest, phase 21b's padded 30, H=100, the
# sentiment net's and the LM's widths, the cluster's cap, the first width
# past it, the wide path up to the cap
LSTM_RULE_WIDTHS = (4, 32, 100, 128, 256, 416, 420, 1024, 1136)
# #7's kernel functions (the cluster path's, the wide path's); #8's by the
# part of the call they compute (the cluster path's, then the wide
# path's)
LSTM_FWD_KERNELS = ('lstm_fwd_chain_kernel', 'lstm_fwd_kernel')
LSTM_BWD_PARTS = (('lstm_chain_kernel', 'chain'),
                  ('lstm_bptt_kernel', 'chain'),
                  ('lstm_dw_tc_kernel', 'dw'), ('lstm_dw_kernel', 'dw'),
                  ('lstm_bwd_finish_kernel', 'finish'),
                  ('transpose_kernel', 'transpose'))


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def _lstm_bounds(t, b, h, with_ct_c):
    """(fwd, bwd) bounds, ``_flash_bound`` dicts on the tensor cores, where
    #7's and #8's cluster chains and #8's dW compute (3xTF32), each with
    its CUDA-core bound beside it; the backward's chain and dW bounds
    apart.  Inputs read once, outputs written once; the forward's h W and
    the backward's dh chain and dW, 2 * T*B*H*4H FMAs' worth of float32
    operations each."""
    f = 4
    prod = 2 * t * b * h * 4 * h
    fwd_bytes = f * (t * b * 4 * h + 4 * h * h + 3 * h      # x, w, pw
                     + 2 * t * b * h + t * b * 4 * h)       # h, c, gates
    cts = (2 if with_ct_c else 1) * t * b * h
    bwd_bytes = f * (t * b * 4 * h + 2 * t * b * h          # gates, h, c
                     + cts                                  # cotangents
                     + 4 * h * h + 3 * h                    # w, pw
                     + t * b * 4 * h + 4 * h * h + 3 * h)   # dx, dw, dpw
    # the chain alone: gates, c, cotangents, w and pw in, dx and dpw out;
    # dW alone: h and dx in, dw out
    chain_bytes = f * (t * b * 4 * h + t * b * h + cts + 4 * h * h + 3 * h
                       + t * b * 4 * h + 3 * h)
    dw_bytes = f * (t * b * h + t * b * 4 * h + 4 * h * h)
    bwd = _flash_bound(bwd_bytes, 2 * prod)
    bwd['chain_bound_ms'] = _tc_bound(chain_bytes, prod)[0]
    bwd['dw_bound_ms'] = _tc_bound(dw_bytes, prod)[0]
    return _flash_bound(fwd_bytes, prod), bwd


def _split_by(fn, parts, calls=5):
    """{part: device ms per call} of the call ``fn`` by kernel function
    (``parts``: (function, part) pairs), from torch.profiler over
    ``calls`` calls: each function's device time over the launches the
    trace holds."""
    fn()
    _, rows = _device_kernels(lambda: [fn() for _ in range(calls)])
    out = {}
    for key, ms, n in rows:
        part = next((p for k, p in parts if k in key), None)
        if part is not None:
            out[part] = out.get(part, 0.0) + ms / max(1, n)
    return out


def _lstm_path_rule():
    """#7's and #8's path rule, decided without a build
    (``lk.cluster_size``), against the libraries'
    (``paddle_lstm_fwd_cluster_size``, ``paddle_lstm_bwd_cluster_size``)."""
    fwd, bwd = lk._lib('lstm_fwd'), lk._lib('lstm_bwd')
    return {h: (lk.cluster_size(h), fwd.paddle_lstm_fwd_cluster_size(h),
                bwd.paddle_lstm_bwd_cluster_size(h))
            for h in LSTM_RULE_WIDTHS}


def _lstm_op_case(b=11, t=40, h=128):
    """A ragged, reversed batch through the ``lstm`` op: the kernel path
    (the scan past the kernels' caps) on the card against the same op on
    the CPU (plain versions), outputs and the gradients of Input, Weight
    and Bias."""
    gen = torch.Generator().manual_seed(SEED + 9)
    ins = {'Input': torch.randn((b, t, 4 * h), generator=gen),
           'Weight': torch.randn((h, 4 * h), generator=gen) * h ** -0.5,
           'Bias': torch.randn((1, 7 * h), generator=gen) * 0.3,
           'XLen': torch.randint(1, t + 1, (b,), generator=gen,
                                 dtype=torch.int32)}
    ins['XLen'][0] = t
    ct = torch.randn((b, t, h), generator=gen)
    attrs = {'use_peepholes': True, 'is_reverse': True, 'use_pallas': True}
    res = {}
    for dev in ('cuda', 'cpu'):
        staged = {k: [v.to(dev).requires_grad_(k != 'XLen')]
                  for k, v in ins.items()}
        outs = get_op_impl('lstm').compute(None, staged, attrs)
        wrt = [staged[k][0] for k in ('Input', 'Weight', 'Bias')]
        grads = torch.autograd.grad(
            (outs['Hidden'][0] * ct.to(dev)).sum(), wrt)
        res[dev] = [outs['Hidden'][0].detach(), outs['Cell'][0].detach()] \
            + list(grads)
    torch.cuda.synchronize()
    errs = [_max_err(a.cpu(), b_) for a, b_ in zip(res['cuda'], res['cpu'])]
    tols = [TOL_LSTM] * 3 + [TOL_LSTM_PARAM_REL * max(1.0, float(
        r.abs().max())) for r in res['cpu'][3:]]
    finite = all(bool(torch.isfinite(a).all()) for a in res['cuda'])
    row = dict(case='op_ragged_reversed_B%d_T%d_H%d' % (b, t, h),
               errs=dict(zip(('hidden', 'cell', 'd_input', 'd_weight',
                              'd_bias'), errs)),
               tols=tols, finite=finite,
               ok=finite and all(e <= tol for e, tol in zip(errs, tols)))
    print("lstm op %s" % json.dumps(row))
    return row


def phase_lstm_kernel():
    """Kernels #7 and #8 against their plain versions on the same inputs,
    #7 twice with its gates and once without, #8 twice (bitwise equal);
    at the LM shape also their times, #7's as first built, #8's split,
    the bounds and the layer-pair yardstick; both on their wide paths
    timed at LSTM_WIDE."""
    rule = _lstm_path_rule()
    print("lstm path rule (route, fwd library, bwd library) by width: %s"
          % json.dumps(rule))
    if any(len(set(v)) != 1 for v in rule.values()):
        raise SystemExit("#7's or #8's path rule differs from the "
                         "library's: %s" % rule)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 8)
    rows, timing, wide = [], None, None
    for name, t, b, h, peep, with_ct_c in LSTM_CASES:
        def rnd(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device='cuda') * scale
        x = rnd(t, b, 4 * h)
        w = rnd(h, 4 * h, scale=h ** -0.5)
        pw = rnd(3, h, scale=0.3) if peep else torch.zeros(
            (3, h), device='cuda')
        ct_h = rnd(t, b, h)
        ct_c = rnd(t, b, h) if with_ct_c else None
        got = lk._lstm_forward(x, w, pw, with_gates=True)
        fagain = lk._lstm_forward(x, w, pw, with_gates=True)
        bare = lk._lstm_forward(x, w, pw, with_gates=False)
        ref = lk._plain_lstm_forward(x, w, pw)
        dgot = lk._lstm_backward(w, pw, *ref, ct_h, ct_c)
        again = lk._lstm_backward(w, pw, *ref, ct_h, ct_c)
        dref = lk._plain_lstm_backward(w, pw, *ref, ct_h, ct_c)
        torch.cuda.synchronize()
        fwd_bitwise = all(torch.equal(a, r) for a, r in zip(got, fagain))
        no_gates = bare[2] is None and all(
            torch.equal(a, r) for a, r in zip(bare[:2], got[:2]))
        bitwise = all(torch.equal(a, r) for a, r in zip(dgot, again))
        fwd_err = dict(zip(('h', 'c', 'gates'),
                           (_max_err(a, r) for a, r in zip(got, ref))))
        bwd_err = dict(zip(('dx', 'dw', 'dpw'),
                           (_max_err(a, r) for a, r in zip(dgot, dref))))
        bwd_tol = dict(dx=TOL_LSTM, **{
            k: TOL_LSTM_PARAM_REL * max(1.0, float(r.abs().max()))
            for k, r in zip(('dw', 'dpw'), dref[1:])})
        finite = all(bool(torch.isfinite(a).all())
                     for a in list(got) + list(dgot))
        ok = (finite and fwd_bitwise and no_gates and bitwise and
              max(fwd_err.values()) <= TOL_LSTM and
              all(bwd_err[k] <= bwd_tol[k] for k in bwd_err))
        row = dict(case=name, T=t, B=b, H=h, peepholes=peep,
                   ct_c=with_ct_c, fwd_err=fwd_err, fwd_tol=TOL_LSTM,
                   fwd_bitwise_repeat=fwd_bitwise,
                   fwd_no_gates_bitwise=no_gates, bwd_err=bwd_err,
                   bwd_tol=bwd_tol, bwd_bitwise_repeat=bitwise,
                   finite=finite, ok=ok, fwd_plan=lk.fwd_plan(t, b, h),
                   bwd_plan=lk.bwd_plan(t, b, h))
        if name == LSTM_MAIN:
            timing = _lstm_timing(x, w, pw, ref, ct_h, ct_c)
            row.update(timing)
        if name == LSTM_WIDE:
            wide = dict(
                fwd_ms=_device_ms(lambda: lk._lstm_forward(x, w, pw, True),
                                  iters=5, replays=3),
                bwd_ms=_device_ms(
                    lambda: lk._lstm_backward(w, pw, *ref, ct_h, ct_c),
                    iters=5, replays=3))
            row.update(wide)
        rows.append(row)
        print("lstm kernels %s" % json.dumps(row))
    rows.append(_lstm_op_case())
    rows += [_lstm_repeat_case(gen, *c) for c in LSTM_REPEAT_CASES]
    rows += [_lstm_fwd_repeat_case(gen, *c) for c in LSTM_REPEAT_CASES]
    bad = [r['case'] for r in rows if not r['ok']]
    if bad:
        raise SystemExit("LSTM kernel disagrees with its plain version, is "
                         "not finite or not deterministic: %s" % bad)
    paths = {'%s %s' % (k, r['case']): r[k + '_plan']['path']
             for r in rows for k in ('fwd', 'bwd') if k + '_plan' in r}
    want = {k: 'wide' if k.endswith(' ' + LSTM_WIDE) else 'cluster'
            for k in paths}
    if paths != want:
        raise SystemExit("#7 or #8 took the wrong path: %s" % paths)
    for k in ('fwd', 'bwd'):
        timing[k + '_ms_by_path'] = dict(cluster=timing[k + '_ms'],
                                         wide=wide[k + '_ms'],
                                         wide_shape=LSTM_WIDE)
    timing['path_rule'] = {str(k): v[0] for k, v in rule.items()}
    return rows, timing


def _lstm_repeat_case(gen, name, t, b, h, calls):
    """#8 ``calls`` times on one seeded input (peepholes, both
    cotangents): the first call within phase 13's bounds of the plain
    version, and every call bitwise equal to the first, so that a race in
    the cluster chain's exchange or reduction shows as a call that
    differs."""
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device='cuda') * scale
    x, w = rnd(t, b, 4 * h), rnd(h, 4 * h, scale=h ** -0.5)
    pw, ct_h, ct_c = rnd(3, h, scale=0.3), rnd(t, b, h), rnd(t, b, h)
    ref = lk._plain_lstm_forward(x, w, pw)
    first = lk._lstm_backward(w, pw, *ref, ct_h, ct_c)
    dref = lk._plain_lstm_backward(w, pw, *ref, ct_h, ct_c)
    differing = 0
    for _ in range(calls - 1):
        again = lk._lstm_backward(w, pw, *ref, ct_h, ct_c)
        differing += not all(torch.equal(a, r) for a, r in zip(first, again))
    torch.cuda.synchronize()
    bwd_err = dict(zip(('dx', 'dw', 'dpw'),
                       (_max_err(a, r) for a, r in zip(first, dref))))
    bwd_tol = dict(dx=TOL_LSTM, **{
        k: TOL_LSTM_PARAM_REL * max(1.0, float(r.abs().max()))
        for k, r in zip(('dw', 'dpw'), dref[1:])})
    finite = all(bool(torch.isfinite(a).all()) for a in first)
    row = dict(case=name, T=t, B=b, H=h, calls=calls,
               calls_differing_from_the_first=differing, bwd_err=bwd_err,
               bwd_tol=bwd_tol, finite=finite,
               ok=finite and differing == 0 and all(
                   bwd_err[k] <= bwd_tol[k] for k in bwd_err),
               bwd_plan=lk.bwd_plan(t, b, h))
    print("lstm bwd repeats %s" % json.dumps(row))
    return row


def _lstm_fwd_repeat_case(gen, name, t, b, h, calls):
    """#7 ``calls`` times on one seeded input (peepholes, the gates
    written): the first call within TOL_LSTM of the plain version, and
    every call bitwise equal to the first, so that a race in the cluster
    chain's exchange or the gates' meet shows as a call that differs."""
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device='cuda') * scale
    x, w = rnd(t, b, 4 * h), rnd(h, 4 * h, scale=h ** -0.5)
    pw = rnd(3, h, scale=0.3)
    first = lk._lstm_forward(x, w, pw, with_gates=True)
    ref = lk._plain_lstm_forward(x, w, pw)
    differing = 0
    for _ in range(calls - 1):
        again = lk._lstm_forward(x, w, pw, with_gates=True)
        differing += not all(torch.equal(a, r) for a, r in zip(first, again))
    torch.cuda.synchronize()
    fwd_err = dict(zip(('h', 'c', 'gates'),
                       (_max_err(a, r) for a, r in zip(first, ref))))
    finite = all(bool(torch.isfinite(a).all()) for a in first)
    row = dict(case='fwd_' + name, T=t, B=b, H=h, calls=calls,
               calls_differing_from_the_first=differing, fwd_err=fwd_err,
               fwd_tol=TOL_LSTM, finite=finite,
               ok=finite and differing == 0 and
               max(fwd_err.values()) <= TOL_LSTM,
               fwd_plan=lk.fwd_plan(t, b, h))
    print("lstm fwd repeats %s" % json.dumps(row))
    return row


def _row_tiled_fwd_ms(x, w, pw):
    """Device ms of #7 as first built, the row-tiled loop that is now its
    wide path, at x's shape: lstm_fwd_probe.py's ``row_tiled`` build of
    csrc/lstm_fwd.cu (the cluster rule's cap set to 0), called through the
    wrapper; the shipped library and the launch counts are put back."""
    from paddle_tpu_torch.ops.kernels import lstm_fwd_probe
    lib = lstm_fwd_probe.row_tiled_library()
    shipped = build._libs['lstm_fwd']
    counts = (lk.launches, lk.fwd_cluster_launches)
    try:
        build._libs['lstm_fwd'] = lib
        return _device_ms(lambda: lk._lstm_forward(x, w, pw, True),
                          iters=5, replays=3)
    finally:
        build._libs['lstm_fwd'] = shipped
        lk.launches, lk.fwd_cluster_launches = counts


def _lstm_timing(x, w, pw, ref, ct_h, ct_c):
    t, b, four_h = x.shape
    h = four_h // 4
    fwd, bwd = _lstm_bounds(t, b, h, ct_c is not None)

    def bwd_call():
        return lk._lstm_backward(w, pw, *ref, ct_h, ct_c)
    out = dict(
        fwd_ms=_device_ms(lambda: lk._lstm_forward(x, w, pw, True),
                          iters=5, replays=3),
        fwd_row_tiled_ms=_row_tiled_fwd_ms(x, w, pw),
        fwd_plain_ms=_device_ms(lambda: lk._plain_lstm_forward(x, w, pw),
                                iters=2, replays=2),
        fwd_bound_ms=fwd['bound_ms'], fwd_bound_by=fwd['bound_by'],
        fwd_cuda_core_bound_ms=fwd['cuda_core_bound_ms'],
        bwd_ms=_device_ms(bwd_call, iters=5, replays=3),
        bwd_ms_by_part=_split_by(bwd_call, LSTM_BWD_PARTS),
        bwd_plain_ms=_device_ms(lambda: lk._plain_lstm_backward(
            w, pw, *ref, ct_h, ct_c), iters=2, replays=2),
        bwd_bound_ms=bwd['bound_ms'], bwd_bound_by=bwd['bound_by'],
        bwd_cuda_core_bound_ms=bwd['cuda_core_bound_ms'],
        bwd_chain_bound_ms=bwd['chain_bound_ms'],
        bwd_dw_bound_ms=bwd['dw_bound_ms'])
    out['fwd_call_ms'] = _call_ms(lambda: lk._lstm_forward(x, w, pw, True),
                                  iters=5)
    out['bwd_call_ms'] = _call_ms(bwd_call, iters=5)
    out['layer_pair'] = _layer_pair_yardstick(t, b, h)
    return out


def _layer_pair_yardstick(t, b, h):
    """fc + lstm without peepholes at the LM's second layer (input width
    H): the port's mul + bias add + kernel #7 (and its backward: #8 plus
    the fc's products) against ``torch.nn.LSTM`` (cuDNN) computing x W_ih
    + b + h W_hh with zero initial state, both in device time.  The
    backward is each side's forward and backward in one graph less its
    forward."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 10)
    x = torch.randn((t, b, h), generator=gen, device='cuda')
    ct = torch.randn((t, b, h), generator=gen, device='cuda')
    w_ih = (torch.randn((h, 4 * h), generator=gen, device='cuda')
            * h ** -0.5).requires_grad_(True)
    bias = torch.zeros((4 * h,), device='cuda', requires_grad=True)
    w_hh = (torch.randn((h, 4 * h), generator=gen, device='cuda')
            * h ** -0.5).requires_grad_(True)
    xg = x.clone().requires_grad_(True)

    def port_fwd():
        with torch.no_grad():
            g = (torch.matmul(x.reshape(-1, h), w_ih) + bias)
            return lk.lstm_scan(g.reshape(t, b, 4 * h), w_hh)

    def port_fwd_bwd():
        g = torch.matmul(xg.reshape(-1, h), w_ih) + bias
        hs, _ = lk.lstm_scan(g.reshape(t, b, 4 * h), w_hh)
        return torch.autograd.grad(hs, (xg, w_ih, bias, w_hh), ct)

    cudnn = torch.nn.LSTM(h, h).cuda()
    params = [xg] + list(cudnn.parameters())

    def cudnn_fwd():
        with torch.no_grad():
            return cudnn(x)

    def cudnn_fwd_bwd():
        hs, _ = cudnn(xg)
        return torch.autograd.grad(hs, params, ct)

    res = dict(note='fc + lstm without peepholes, T=%d B=%d in=H=%d; '
               'cuDNN computes no peepholes, so it is not the kernels\' '
               'function' % (t, b, h))
    for key, fwd, both in (('port', port_fwd, port_fwd_bwd),
                           ('cudnn', cudnn_fwd, cudnn_fwd_bwd)):
        res[key + '_fwd_ms'] = _device_ms(fwd, iters=5, replays=3)
        res[key + '_bwd_ms'] = _device_ms(both, iters=5, replays=3) \
            - res[key + '_fwd_ms']
    return res


def _lm_programs(hidden=LM['H']):
    c = LM
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        _, _, cost = rnn_lm.build(vocab_size=c['V'], emb_dim=c['E'],
                                  hidden_dim=hidden, num_layers=c['L'])
        tfl.optimizer.AdagradOptimizer(c['lr']).minimize(cost)
    return main, startup, cost


def _zipf_ids(rng, shape, vocab):
    """Token ids in [1, vocab) with natural text's Zipf frequencies, as the
    repo's synthetic corpora draw them (datasets/common.py zipf_seq)."""
    return 1 + (rng.zipf(1.3, size=shape) - 1) % (vocab - 1)


def _lm_feed(batch, seed, ragged):
    """(data, lengths) tuples for src and target, target being src shifted
    by one step (rnn_lm.build); full lengths, or ragged with row 0 full.
    Uniform ids, as bench_lstm_lm.py feeds, would leave nothing to learn
    but memorising them: their loss cannot fall below log V."""
    c = LM
    rng = np.random.default_rng(seed)
    ln = np.full((batch,), c['T'], np.int32)
    if ragged:
        ln = rng.integers(1, c['T'] + 1, batch).astype(np.int32)
        ln[0] = c['T']
    seq = _zipf_ids(rng, (batch, c['T'] + 1, 1), c['V'])
    return {'src': (seq[:, :-1], ln), 'target': (seq[:, 1:], ln)}


def _train_steps(exe, main, scope, feed, fetch, steps):
    """1 + steps runs of ``main``; (fetches per run, ms per run)."""
    outs, ms = [], []
    for _ in range(1 + steps):
        t0 = time.perf_counter()
        outs.append(exe.run(main, feed=feed, fetch_list=fetch, scope=scope))
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


def _cluster_counts():
    """#7's and #8's launches on their cluster paths since the counts were
    set to 0."""
    return dict(lstm_fwd=lk.fwd_cluster_launches,
                lstm_bwd=lk.bwd_cluster_launches)


def _all_on_cluster_path(label, counts, cluster):
    """Fails unless #7 and #8 launched and every launch took its cluster
    path (``cluster``: ``_cluster_counts()`` read with ``counts``)."""
    for k, n in (('lstm_fwd', '#7'), ('lstm_bwd', '#8')):
        if not counts[k] or cluster[k] != counts[k]:
            raise SystemExit("%s: %s launched %d times, %d of them on its "
                             "cluster path" % (label, n, counts[k],
                                               cluster[k]))


def phase_lm_training():
    c = LM
    main, startup, cost = _lm_programs()
    n_adagrad = sum(op.type == 'adagrad' for op in main.global_block().ops)
    exe = tfl.Executor()
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    n_params = sum(scope.get(p.name).numel() for p in main.all_parameters())
    feed = _lm_feed(c['B'], SEED + 11, ragged=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    outs, step_ms = _train_steps(exe, main, scope, feed, [cost], c['steps'])
    outs += _train_steps(exe, main, scope, feed, [cost],
                         c['total_steps'] - c['steps'] - 2)[0]
    counts = _counts()
    cluster = _cluster_counts()
    losses = [float(o[0][0]) for o in outs]
    per_step = {k: n / c['total_steps'] for k, n in counts.items()}
    p50 = float(np.median(step_ms[1:]))
    res = dict(config='B=%d T=%d V=%d E=%d H=%d L=%d float32 Adagrad lr %g'
               % (c['B'], c['T'], c['V'], c['E'], c['H'], c['L'], c['lr']),
               params=n_params, adagrad_ops=n_adagrad, losses=losses,
               step_ms=step_ms, step_ms_p50=p50,
               tokens_per_s=c['B'] * c['T'] / (p50 / 1e3),
               launches=counts, launches_per_step=per_step,
               cluster_launches=cluster,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    print("lm training: %s" % json.dumps(res))
    want = _want(lstm_fwd=c['L'], lstm_bwd=c['L'])
    if per_step != want:
        raise SystemExit("launches per step %s, want %s" % (per_step, want))
    _all_on_cluster_path('lm training', counts, cluster)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit("LM loss not finite or last not below first: %s"
                         % losses)
    return dict(main=main, startup=startup, cost=cost, scope=scope, exe=exe,
                counts=counts, **res)


def phase_lm_parity(lm, title='lm parity'):
    """One step at B=4 with ragged lengths on the card (kernels) and on
    the CPU (plain versions) from the same state: the loss, every
    gradient, Adagrad's moment and the update p_new - p_old, each
    norm-relative per parameter.  Any non-finite value fails."""
    main, cost = lm['main'], lm['cost']
    card_scope = tfl.Scope()
    lm['exe'].run(lm['startup'], scope=card_scope)
    names = [p.name for p in main.all_parameters()]
    moment = {op.input('Param')[0]: op.input('Moment')[0]
              for op in main.global_block().ops if op.type == 'adagrad'}
    if sorted(moment) != sorted(names):
        raise SystemExit("adagrad ops do not cover the parameters")
    cpu_scope = tfl.Scope()
    for v in main.list_vars():
        if v.persistable and card_scope.has(v.name):
            cpu_scope.set(v.name, card_scope.get(v.name).to('cpu',
                                                             copy=True))
    before = {n: cpu_scope.get_numpy(n).copy() for n in names}
    feed = _lm_feed(LM['parity_B'], SEED + 12, ragged=True)
    fetch = [cost.name] + [n + '@GRAD' for n in names]
    _zero_counts()
    card = lm['exe'].run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    _all_on_cluster_path(title, _counts(), _cluster_counts())
    cpu = tfl.Executor('cpu').run(main, feed=feed, fetch_list=fetch,
                                  scope=cpu_scope)
    nonfinite = [n for n, a in zip(fetch, card) if not np.isfinite(a).all()]
    gaps = {'grad': [], 'moment': [], 'update': []}
    for n, g_card, g_cpu in zip(names, card[1:], cpu[1:]):
        gaps['grad'].append((_norm_rel(g_card, g_cpu), n))
        a = card_scope.get_numpy(moment[n])
        gaps['moment'].append((_norm_rel(a, cpu_scope.get_numpy(moment[n])),
                               n))
        p = card_scope.get_numpy(n)
        if not (np.isfinite(a).all() and np.isfinite(p).all()):
            nonfinite.append(n)
        gaps['update'].append((_norm_rel(p - before[n],
                                         cpu_scope.get_numpy(n) - before[n]),
                               n))
    loss_err = abs(float(card[0][0]) - float(cpu[0][0]))
    tol = dict(loss=TOL_TRAIN_LOSS, grad=TOL_TRAIN_GRAD,
               moment=TOL_LM_MOMENT, update=TOL_TRAIN_UPDATE)
    worst = {k: max(v, key=lambda x: (np.nan_to_num(x[0], nan=np.inf), x[1]))
             for k, v in gaps.items()}
    bad = [k for k, (e, _) in worst.items() if not e <= tol[k]]
    if not loss_err <= TOL_TRAIN_LOSS:
        bad.append('loss')
    res = dict(batch=LM['parity_B'], lengths=feed['src'][1].tolist(),
               loss_card=float(card[0][0]), loss_cpu=float(cpu[0][0]),
               loss_err=loss_err,
               norm_rel_err={k: e for k, (e, _) in worst.items()},
               largest_gaps={k: [dict(param=n, norm_rel=e) for e, n in
                                 sorted(v, reverse=True)[:3]]
                             for k, v in gaps.items()},
               nonfinite=nonfinite, tol=tol)
    print("%s: %s" % (title, json.dumps(res)))
    if nonfinite or bad:
        raise SystemExit("LM step on the card disagrees with the CPU (%s) "
                         "or is not finite (%s)" % (bad, nonfinite))
    return res


def phase_sentiment():
    c = SENT
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        data = tfl.layers.data(name='words', shape=[1], dtype='int64',
                               lod_level=1)
        label = tfl.layers.data(name='label', shape=[1], dtype='int64')
        cost, acc, _ = sentiment.stacked_lstm_net(
            data, label, c['V'], emb_dim=c['emb'], hid_dim=c['hid'],
            stacked_num=c['stacked'])
        tfl.optimizer.AdagradOptimizer(c['lr']).minimize(cost)
    exe = tfl.Executor()
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(SEED + 13)
    ln = rng.integers(c['min_len'], c['T'] + 1, c['B']).astype(np.int32)
    ln[0] = c['T']
    feed = {'words': (_zipf_ids(rng, (c['B'], c['T'], 1), c['V']), ln),
            'label': rng.integers(0, 2, (c['B'], 1))}
    torch.cuda.synchronize()
    _zero_counts()
    outs, step_ms = _train_steps(exe, main, scope, feed, [cost, acc],
                                 c['steps'])
    counts = _counts()
    cluster = _cluster_counts()
    per_step = {k: n / (1 + c['steps']) for k, n in counts.items()}
    losses = [float(o[0][0]) for o in outs]
    res = dict(config='stacked_lstm_net emb %d hid %d (H=%d) %d layers, '
               'V=%d B=%d T=%d ragged %d-%d, Adagrad lr %g'
               % (c['emb'], c['hid'], c['hid'] // 4, c['stacked'], c['V'],
                  c['B'], c['T'], c['min_len'], c['T'], c['lr']),
               losses=losses, accuracy=[float(o[1][0]) for o in outs],
               step_ms=step_ms, step_ms_p50=float(np.median(step_ms[1:])),
               launches=counts, launches_per_step=per_step,
               cluster_launches=cluster)
    print("sentiment training: %s" % json.dumps(res))
    want = _want(lstm_fwd=c['stacked'], lstm_bwd=c['stacked'])
    if per_step != want:
        raise SystemExit("launches per step %s, want %s" % (per_step, want))
    _all_on_cluster_path('sentiment training', counts, cluster)
    if not all(np.isfinite(losses)):
        raise SystemExit("sentiment loss not finite: %s" % losses)
    return dict(counts=counts, **res)


def phase_lm_profile(lm):
    """A traced LM training step, apart from the timed ones."""
    feed = _lm_feed(LM['B'], SEED + 11, ragged=False)

    def step():
        lm['exe'].run(lm['main'], feed=feed, fetch_list=[lm['cost']],
                      scope=lm['scope'])
    wall, rows = _device_kernels(step)
    busy = sum(ms for _, ms, _ in rows)
    top = sorted(rows, key=lambda r: -r[1])[:10]

    def by(*tags):
        return sum(ms for k, ms, _ in rows if any(t in k for t in tags))
    out = dict(wall_ms=wall, device_busy_ms=busy if rows else None,
               idle_share=1.0 - busy / wall if rows else None,
               kernels=sum(n for *_, n in rows),
               lstm_fwd_ms=by(*LSTM_FWD_KERNELS),
               lstm_bwd_ms=by(*[k for k, _ in LSTM_BWD_PARTS]),
               lstm_bwd_ms_by_part={
                   part: by(*[k for k, p in LSTM_BWD_PARTS if p == part])
                   for part in ('chain', 'dw', 'finish', 'transpose')},
               gemm_ms=by('gemm'),
               embedding_bwd_ms=by('indexing_backward'),
               top=[dict(kernel=k[:80], ms=ms, count=n) for k, ms, n in top])
    print("lm training profile: %s" % json.dumps(out))
    return out


def _lstm_lines(rows, timing, lm, sent):
    """The kernels-line entries of #7 and #8."""
    by_path = {k: dict(lm_training=lm['counts'][k],
                       sentiment_training=sent['counts'][k],
                       lm_training_on_cluster_path=lm['cluster_launches'][k],
                       sentiment_training_on_cluster_path=sent[
                           'cluster_launches'][k])
               for k in ('lstm_fwd', 'lstm_bwd')}
    main_row = next(r for r in rows if r['case'] == LSTM_MAIN)
    pair = timing['layer_pair']
    common = dict(route='cuda', library_ms=None,
                  headers=['paddle_tpu_torch/csrc/gru_cluster.cuh',
                           'paddle_tpu_torch/csrc/flash_tf32.cuh'],
                  path_rule=timing['path_rule'],
                  shape='T=128 B=256 H=256 float32 peepholes', cases=rows)

    def launches(k):
        return by_path[k]['lm_training'] + by_path[k]['sentiment_training']
    fwd = dict(
        name='lstm_fwd', source='paddle_tpu_torch/csrc/lstm_fwd.cu',
        replaces='paddle_tpu/ops/pallas/lstm_cell.py:57',
        launches=launches('lstm_fwd'), launches_by_path=by_path['lstm_fwd'],
        max_abs_err=max(max(r['fwd_err'].values()) for r in rows
                        if 'fwd_err' in r),
        ms=timing['fwd_ms'], plain_ms=timing['fwd_plain_ms'],
        bound_ms=timing['fwd_bound_ms'], bound_by=timing['fwd_bound_by'],
        cuda_core_bound_ms=timing['fwd_cuda_core_bound_ms'],
        row_tiled_ms=dict(
            ms=timing['fwd_row_tiled_ms'],
            note='the row-tiled loop (now the wide path) at this '
                 'shape: the kernel this chain replaced'),
        call_ms=timing['fwd_call_ms'], ms_by_path=timing['fwd_ms_by_path'],
        plan=main_row['fwd_plan'],
        layer_pair_yardstick=dict(
            note=pair['note'], port_ms=pair['port_fwd_ms'],
            cudnn_ms=pair['cudnn_fwd_ms']), **common)
    bwd = dict(
        name='lstm_bwd', source='paddle_tpu_torch/csrc/lstm_bwd.cu',
        replaces='paddle_tpu/ops/pallas/lstm_cell.py:90',
        launches=launches('lstm_bwd'), launches_by_path=by_path['lstm_bwd'],
        max_abs_err=max(max(r['bwd_err'].values()) for r in rows
                        if 'bwd_err' in r),
        ms=timing['bwd_ms'], plain_ms=timing['bwd_plain_ms'],
        bound_ms=timing['bwd_bound_ms'], bound_by=timing['bwd_bound_by'],
        cuda_core_bound_ms=timing['bwd_cuda_core_bound_ms'],
        ms_by_part=timing['bwd_ms_by_part'],
        bound_ms_by_part=dict(chain=timing['bwd_chain_bound_ms'],
                              dw=timing['bwd_dw_bound_ms']),
        call_ms=timing['bwd_call_ms'], ms_by_path=timing['bwd_ms_by_path'],
        plan=main_row['bwd_plan'],
        layer_pair_yardstick=dict(
            note=pair['note'], port_ms=pair['port_bwd_ms'],
            cudnn_ms=pair['cudnn_bwd_ms']), **common)
    return [fwd, bwd]


GRU_CASES = (
    # name, T, B, H, h0
    ('train_T64_B512_H512_h0', 64, 512, 512, True),
    ('train_T64_B512_H512', 64, 512, 512, False),
    ('train_T64_B512_H256_h0', 64, 512, 256, True),   # a cluster of 8
    ('T16_B64_H1024_h0', 16, 64, 1024, True),         # the wide paths
    ('B13_T33_H512_h0', 33, 13, 512, True),
)
GRU_MAIN = 'train_T64_B512_H512_h0'   # the decoder's shape and its h0
GRU_WIDE = 'T16_B64_H1024_h0'
# widths at which #9's and #10's path rule (gk.cluster_size) is held
# against the libraries': the smallest, phase 21b's padded 30, H=256, the
# seq2seq width, the first width past the cluster's hold, the wide case,
# the cap
GRU_RULE_WIDTHS = (4, 32, 256, 512, 516, 1024, 1816)
# #9's kernel functions by the path they run
GRU_FWD_PARTS = (('gru_fwd_chain_kernel', 'cluster'),
                 ('gru_fwd_kernel', 'wide'))
# #10's kernel functions by the part of the call they compute
GRU_BWD_PARTS = (('gru_chain_kernel', 'chain'), ('gru_bptt_kernel', 'chain'),
                 ('gru_dw_finish_kernel', 'finish'), ('gru_dw_kernel', 'dw'),
                 ('transpose_kernel', 'transpose'))


def _gru_bounds(t, b, h):
    """(fwd, bwd): ``_flash_bound`` dicts on the tensor cores, where #9's
    and #10's cluster chains and #10's dW compute (3xTF32), with their
    CUDA-core bounds beside them, and the backward's chain and dW bounds
    apart.  Inputs read once, outputs written once; the forward's two
    products and the backward's dh chain and dW, 2 * T*B*H*3H FMAs' worth
    of float32 operations each."""
    f = 4
    prod = 2 * t * b * h * 3 * h
    fwd_bytes = f * (t * b * 3 * h + 3 * h * h + b * h     # x, w, h0
                     + t * b * h + t * b * 3 * h)          # hs, gates
    bwd_bytes = f * (t * b * 3 * h + t * b * h + b * h     # gates, hs, h0
                     + t * b * h + 3 * h * h               # ct, w
                     + t * b * 3 * h + 3 * h * h + b * h)  # dx, dw, dh0
    # the chain alone: gates, hs, h0, ct and w in, dx and dh0 out; dW
    # alone: hs, h0, r and dx in, dw out
    chain_bytes = bwd_bytes - f * 3 * h * h
    dw_bytes = f * (t * b * h + b * h + t * b * h + t * b * 3 * h
                    + 3 * h * h)
    bwd = _flash_bound(bwd_bytes, 2 * prod)
    bwd['chain_bound_ms'] = _tc_bound(chain_bytes, prod)[0]
    bwd['dw_bound_ms'] = _tc_bound(dw_bytes, prod)[0]
    return _flash_bound(fwd_bytes, prod), bwd


def _gru_op_case(name, with_h0, rev, b=11, t=40, h=512):
    """A ragged batch through the ``gru`` op: the kernel path (the scan
    past the kernels' caps) on the card against the same op on the CPU
    (plain versions), the hidden sequence and the gradients of Input,
    Weight, Bias (and H0)."""
    gen = torch.Generator().manual_seed(SEED + 14)
    ins = {'Input': torch.randn((b, t, 3 * h), generator=gen),
           'Weight': torch.randn((h, 3 * h), generator=gen) * h ** -0.5,
           'Bias': torch.randn((1, 3 * h), generator=gen) * 0.3,
           'XLen': torch.randint(1, t + 1, (b,), generator=gen,
                                 dtype=torch.int32)}
    ins['XLen'][0] = t
    if with_h0:
        ins['H0'] = torch.randn((b, h), generator=gen) * 0.5
    wrt = [k for k in ('Input', 'Weight', 'Bias', 'H0') if k in ins]
    ct = torch.randn((b, t, h), generator=gen)
    attrs = {'is_reverse': rev, 'use_pallas': True}
    res = {}
    for dev in ('cuda', 'cpu'):
        staged = {k: [v.to(dev).requires_grad_(k in wrt)]
                  for k, v in ins.items()}
        hid = get_op_impl('gru').compute(None, staged, attrs)['Hidden'][0]
        grads = torch.autograd.grad((hid * ct.to(dev)).sum(),
                                    [staged[k][0] for k in wrt])
        res[dev] = [hid.detach()] + list(grads)
    torch.cuda.synchronize()
    errs = [_max_err(a.cpu(), b_) for a, b_ in zip(res['cuda'], res['cpu'])]
    names = ['hidden'] + ['d_' + k.lower() for k in wrt]
    tols = [TOL_GRU_PARAM_REL * max(1.0, float(r.abs().max()))
            if n in ('d_weight', 'd_bias') else TOL_GRU
            for n, r in zip(names, res['cpu'])]
    finite = all(bool(torch.isfinite(a).all()) for a in res['cuda'])
    row = dict(case=name, errs=dict(zip(names, errs)),
               tols=dict(zip(names, tols)), finite=finite,
               ok=finite and all(e <= tol for e, tol in zip(errs, tols)))
    print("gru op %s" % json.dumps(row))
    return row


def _gru_path_rule():
    """#9's and #10's path rule, decided without a build
    (``gk.cluster_size``), against the libraries'
    (``paddle_gru_fwd_cluster_size``, ``paddle_gru_bwd_cluster_size``)."""
    fwd, bwd = gk._lib('gru_fwd'), gk._lib('gru_bwd')
    return {h: (gk.cluster_size(h), fwd.paddle_gru_fwd_cluster_size(h),
                bwd.paddle_gru_bwd_cluster_size(h))
            for h in GRU_RULE_WIDTHS}


def phase_gru_kernel():
    """Kernels #9 and #10 against their plain versions on the same inputs
    (the backward's come from the plain forward), #9 twice with its gates
    and once without, #10 twice (bitwise equal); at the training shape
    also both kernels' times, #10's split, both bounds and the layer-pair
    yardstick; both on their wide paths timed at GRU_WIDE, #9 at 8 and 16
    rows per block."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 13)
    rule = _gru_path_rule()
    print("gru path rule (route, fwd library, bwd library) by width: %s"
          % json.dumps(rule))
    if any(len(set(v)) != 1 for v in rule.values()):
        raise SystemExit("#9's or #10's path rule differs from the "
                         "library's: %s" % rule)
    rows, timing, wide = [], None, None
    for name, t, b, h, with_h0 in GRU_CASES:
        x = torch.randn((t, b, 3 * h), generator=gen, device='cuda')
        w = torch.randn((h, 3 * h), generator=gen, device='cuda') * h ** -0.5
        h0 = (torch.randn((b, h), generator=gen, device='cuda') * 0.5
              if with_h0 else None)
        ct = torch.randn((t, b, h), generator=gen, device='cuda')
        got = gk._gru_forward(x, w, h0, with_gates=True)
        fagain = gk._gru_forward(x, w, h0, with_gates=True)
        bare = gk._gru_forward(x, w, h0, with_gates=False)
        ref = gk._plain_gru_forward(x, w, h0)
        dgot = gk._gru_backward(w, h0, *ref, ct)
        again = gk._gru_backward(w, h0, *ref, ct)
        dref = gk._plain_gru_backward(w, h0, *ref, ct)
        torch.cuda.synchronize()
        fwd_bitwise = all(torch.equal(a, r) for a, r in zip(got, fagain))
        no_gates = bare[1] is None and torch.equal(bare[0], got[0])
        bitwise = all(torch.equal(a, r) for a, r in zip(dgot, again))
        fwd_err = dict(zip(('h', 'gates'),
                           (_max_err(a, r) for a, r in zip(got, ref))))
        bwd_err = dict(zip(('dx', 'dw', 'dh0'),
                           (_max_err(a, r) for a, r in zip(dgot, dref))))
        bwd_tol = dict(dx=TOL_GRU, dh0=TOL_GRU, dw=TOL_GRU_PARAM_REL * max(
            1.0, float(dref[1].abs().max())))
        finite = all(bool(torch.isfinite(a).all())
                     for a in list(got) + list(dgot))
        ok = (finite and fwd_bitwise and no_gates and bitwise and
              max(fwd_err.values()) <= TOL_GRU and
              all(bwd_err[k] <= bwd_tol[k] for k in bwd_err))
        row = dict(case=name, T=t, B=b, H=h, h0=with_h0, fwd_err=fwd_err,
                   fwd_tol=TOL_GRU, fwd_bitwise_repeat=fwd_bitwise,
                   fwd_no_gates_hs_bitwise=no_gates, bwd_err=bwd_err,
                   bwd_tol=bwd_tol, bwd_bitwise_repeat=bitwise,
                   finite=finite, ok=ok, fwd_plan=gk.fwd_plan(t, b, h),
                   bwd_plan=gk.bwd_plan(t, b, h))
        if name == GRU_MAIN:
            timing = _gru_timing(x, w, h0, ref, ct)
            row.update(timing)
        if name == GRU_WIDE:
            wide = {'fwd_ms_rows%d' % r: _device_ms(
                lambda: gk._gru_forward(x, w, h0, True, rows=r), iters=5,
                replays=3) for r in (8, 16)}
            wide['bwd_ms'] = _device_ms(
                lambda: gk._gru_backward(w, h0, *ref, ct), iters=5,
                replays=3)
            row.update(wide)
        rows.append(row)
        print("gru kernels %s" % json.dumps(row))
    rows.append(_gru_op_case('op_ragged_reversed_B11_T40_H512', False, True))
    rows.append(_gru_op_case('op_ragged_h0_B11_T40_H512', True, False))
    bad = [r['case'] for r in rows if not r['ok']]
    if bad:
        raise SystemExit("GRU kernel disagrees with its plain version, is "
                         "not finite or not deterministic: %s" % bad)
    paths = {r['case']: (r['fwd_plan']['path'], r['bwd_plan']['path'])
             for r in rows if 'bwd_plan' in r}
    if paths[GRU_MAIN] != ('cluster',) * 2 or \
            paths[GRU_WIDE] != ('wide',) * 2:
        raise SystemExit("#9 or #10 took the wrong path: %s" % paths)
    wide_fwd = wide['fwd_ms_rows%d' % gk.ROWS_PER_BLOCK]
    timing['fwd_ms_by_path'] = dict(cluster=timing['fwd_ms'], wide=wide_fwd,
                                    wide_shape=GRU_WIDE)
    timing['fwd_ms_by_rows_per_block'] = dict(
        {r: wide['fwd_ms_rows%d' % r] for r in (8, 16)}, shape=GRU_WIDE)
    timing['bwd_ms_by_path'] = dict(cluster=timing['bwd_ms'],
                                    wide=wide['bwd_ms'], wide_shape=GRU_WIDE)
    timing['path_rule'] = {str(k): v[0] for k, v in rule.items()}
    return rows, timing


def _gru_timing(x, w, h0, ref, ct):
    t, b, three_h = x.shape
    h = three_h // 3
    fwd, bwd = _gru_bounds(t, b, h)
    out = dict(fwd_bound_ms=fwd['bound_ms'], fwd_bound_by=fwd['bound_by'],
               fwd_cuda_core_bound_ms=fwd['cuda_core_bound_ms'],
               bwd_bound_ms=bwd['bound_ms'], bwd_bound_by=bwd['bound_by'],
               bwd_cuda_core_bound_ms=bwd['cuda_core_bound_ms'],
               bwd_chain_bound_ms=bwd['chain_bound_ms'],
               bwd_dw_bound_ms=bwd['dw_bound_ms'],
               rows_per_block=gk.ROWS_PER_BLOCK)
    out['fwd_ms'] = _device_ms(lambda: gk._gru_forward(x, w, h0, True),
                               iters=5, replays=3)
    out['bwd_ms'] = _device_ms(lambda: gk._gru_backward(w, h0, *ref, ct),
                               iters=5, replays=3)
    out['bwd_ms_by_part'] = _split_by(
        lambda: gk._gru_backward(w, h0, *ref, ct), GRU_BWD_PARTS)
    out['fwd_plain_ms'] = _device_ms(lambda: gk._plain_gru_forward(x, w, h0),
                                     iters=2, replays=2)
    out['bwd_plain_ms'] = _device_ms(
        lambda: gk._plain_gru_backward(w, h0, *ref, ct), iters=2, replays=2)
    out['fwd_call_ms'] = _call_ms(lambda: gk._gru_forward(x, w, h0, True),
                                  iters=5)
    out['bwd_call_ms'] = _call_ms(lambda: gk._gru_backward(w, h0, *ref, ct),
                                  iters=5)
    out['layer_pair'] = _gru_layer_pair(t, b, h, S2S['word_dim'])
    return out


def _gru_layer_pair(t, b, h, d_in):
    """fc + gru with h0 at the decoder's widths (input width word_dim): the
    port's mul + bias add + kernel #9 (and its backward: #10 plus the fc's
    products) against ``torch.nn.GRU`` (cuDNN) with the same h0, both in
    device time.  The backward is each side's forward and backward in one
    graph less its forward."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 15)
    x = torch.randn((t, b, d_in), generator=gen, device='cuda')
    h0 = torch.randn((b, h), generator=gen, device='cuda') * 0.5
    ct = torch.randn((t, b, h), generator=gen, device='cuda')
    w_ih = (torch.randn((d_in, 3 * h), generator=gen, device='cuda')
            * d_in ** -0.5).requires_grad_(True)
    bias = torch.zeros((3 * h,), device='cuda', requires_grad=True)
    w_hh = (torch.randn((h, 3 * h), generator=gen, device='cuda')
            * h ** -0.5).requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    h0g = h0.clone().requires_grad_(True)

    def port_fwd():
        with torch.no_grad():
            g = torch.matmul(x.reshape(-1, d_in), w_ih) + bias
            return gk.gru_scan(g.reshape(t, b, 3 * h), w_hh, h0)

    def port_fwd_bwd():
        g = torch.matmul(xg.reshape(-1, d_in), w_ih) + bias
        hs = gk.gru_scan(g.reshape(t, b, 3 * h), w_hh, h0g)
        return torch.autograd.grad(hs, (xg, w_ih, bias, w_hh, h0g), ct)

    cudnn = torch.nn.GRU(d_in, h).cuda()
    params = [xg, h0g] + list(cudnn.parameters())

    def cudnn_fwd():
        with torch.no_grad():
            return cudnn(x, h0[None])

    def cudnn_fwd_bwd():
        # the view of h0 is made inside: an autograd node made before the
        # capture would tie the captured backward to the default stream
        hs, _ = cudnn(xg, h0g[None])
        return torch.autograd.grad(hs, params, ct)

    res = dict(note='fc + gru with h0, T=%d B=%d in=%d H=%d; cuDNN GRU, '
               'reset after the product: not the kernels\' function'
               % (t, b, d_in, h))
    for key, fwd, both in (('port', port_fwd, port_fwd_bwd),
                           ('cudnn', cudnn_fwd, cudnn_fwd_bwd)):
        res[key + '_fwd_ms'] = _device_ms(fwd, iters=5, replays=3)
        res[key + '_bwd_ms'] = _device_ms(both, iters=5, replays=3) \
            - res[key + '_fwd_ms']
    return res


# the state tables each rule updates, as indices into (param, moment1,
# moment2 or Adagrad's moment): Adagrad's moment is a sum of squares
SPARSE_RULES = {'sgd': (0,), 'adagrad': (0, 2), 'adam': (0, 1, 2)}


# run lengths of the 'straddle' ids: each side of every edge of the new
# kernel's design (csrc/table_update.cu): the short path's 32 slots, the
# ring's 32-slot batches and 256-slot depth, the 64-slot scan groups (two
# long runs starting in one group), and a run past all of them
STRADDLE_RUNS = (1, 2, 31, 32, 33, 34, 40, 63, 64, 65, 95, 96, 97, 127, 128,
                 129, 255, 256, 257, 258, 511, 512, 513, 1000, 2049, 4097)
# the straddle case's widths: not a multiple of 4 (4-byte copies, a ragged
# last 32-column slice) and a multiple of 4 but not of 32 (16-byte copies,
# a ragged slice)
STRADDLE_D = (250, 100)


def _sparse_ids(dist, rng, k, height):
    if dist == 'zipf':   # the synthetic WMT14 source ids
        return 3 + wmt14.zipf_seq(rng, k, height - 3)
    if dist == 'uniform':   # bench_seq2seq.py's ids
        return rng.integers(1, height, k)
    if dist == 'single':   # every slot on one id
        return np.full(k, int(rng.integers(0, height)))
    if dist.startswith('straddle'):
        # the lowest ids hold the runs, so that they sort first and in this
        # order: two long runs that start in the first 64-slot group, then
        # STRADDLE_RUNS twice, the second time shifted by 5 slots; the rest
        # uniform on the other ids
        lens = (33, 34) + STRADDLE_RUNS + (5,) + STRADDLE_RUNS
        runs = np.repeat(np.arange(len(lens)), lens)
        rest = rng.integers(len(lens), height, k - len(runs))
        return rng.permutation(np.concatenate([runs, rest]))
    ids = rng.integers(0, height, k)   # duplicates, sentinels, negatives
    ids[:64] = height
    ids[64:96] = height + rng.integers(1, 1000, 32)
    ids[96:224] = -rng.integers(1, height + 1, 128)
    ids[224:1024] = ids[1024:1824]
    return rng.permutation(ids)


def _sparse_call(rule, tables, rows, vals, lr, plain):
    if rule == 'sgd':
        fn = tu.plain_sparse_apply_sgd if plain else tu.sparse_apply_sgd
        return fn(tables[0], rows, vals, lr)
    if rule == 'adagrad':
        fn = (tu.plain_sparse_apply_adagrad if plain
              else tu.sparse_apply_adagrad)
        return fn(tables[0], tables[1], rows, vals, lr, 1e-6)
    fn = tu.plain_sparse_apply_adam if plain else tu.sparse_apply_adam
    return fn(*tables, rows, vals, lr, 0.9, 0.999, 1e-8)


def _sparse_scalars(rule):
    if rule == 'adagrad':
        return dict(a=du._f32(1e-6))
    if rule == 'adam':
        return dict(a=du._f32(0.9), b=du._f32(0.999), c=du._f32(1e-8),
                    d=du._f32(1 - 0.9), e=du._f32(1 - 0.999))
    return {}


def _single_call_ms(fn, iters=10):
    """Median ms of one call between its own CUDA events, the device idle
    before it, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _sparse_library(rule, base, rows, vals, height, d):
    """One PyTorch call computing the rule on a sparse COO gradient with
    the same rows and values (coalesce included): SparseAdam (lazy Adam,
    same bias correction), Adagrad on a sparse gradient, and index_add_
    for sgd.  It cannot be captured in a CUDA graph (coalescing reads the
    row count back to the host), so it is timed as #6's calls are, between
    CUDA events: (ms per call over back-to-back calls, the median ms of
    single calls)."""
    keep = (rows >= 0) & (rows < height)
    r, v = rows[keep], vals[keep]
    if rule == 'sgd':
        p = base[0].clone()
        u = -0.01 * v

        def step():
            p.index_add_(0, r, u)
    else:
        param = torch.nn.Parameter(base[0].clone())
        opt = (torch.optim.SparseAdam([param], lr=1e-3) if rule == 'adam'
               else torch.optim.Adagrad([param], lr=1e-2))
        grad = torch.sparse_coo_tensor(r[None], v, (height, d))

        def step():
            param.grad = grad
            opt.step()
    return _call_ms(step, iters=10), _single_call_ms(step)


def phase_sparse_kernel():
    """Kernel #6 against its plain rules, bitwise, on the same inputs; rows
    no id touches stay bitwise unchanged.  Ids: the training path's Zipf
    ids, the bench's uniform ids, edge ids (sentinels, out-of-range and
    negative), every slot on one id, and runs straddling every edge of the
    kernel's design at two widths (``STRADDLE_RUNS``, ``STRADDLE_D``).
    Times, keyed by ids, then rule: at the Zipf and uniform ids the kernel
    alone, the id sort, the whole call, the plain rules and the library
    call; at the one-id and straddling ids the kernel alone and the whole
    call."""
    height, k = S2S['V'], S2S['B'] * S2S['T']
    gen = torch.Generator(device='cuda').manual_seed(SEED + 16)
    rng = np.random.default_rng(SEED + 16)
    lr = torch.tensor([1e-2], device='cuda')
    rows_out, timing = [], {}
    dists = ['zipf', 'uniform', 'edge', 'single'] + [
        'straddle_d%d' % d for d in STRADDLE_D]
    for dist in dists:
        d = (int(dist.split('_d')[1]) if dist.startswith('straddle')
             else S2S['word_dim'])
        ids = torch.as_tensor(_sparse_ids(dist, rng, k, height),
                              device='cuda')
        vals = torch.randn((k, d), generator=gen, device='cuda')
        base = [torch.randn((height, d), generator=gen, device='cuda'),
                torch.randn((height, d), generator=gen, device='cuda') * 0.1,
                torch.rand((height, d), generator=gen, device='cuda') * 0.1]
        norm = tu.normalize_rows(ids, height)
        touched = torch.zeros((height,), dtype=torch.bool, device='cuda')
        touched[norm[norm < height]] = True
        n_unique = int(touched.sum())
        for rule, which in SPARSE_RULES.items():
            state = [base[i] for i in which]
            n = len(state)
            got = [t.clone() for t in state]
            want = [t.clone() for t in state]
            _sparse_call(rule, got, ids, vals, lr, plain=False)
            _sparse_call(rule, want, ids, vals, lr, plain=True)
            torch.cuda.synchronize()
            row = dict(
                ids=dist, rule=rule, K=k, D=d, n_unique=n_unique,
                bitwise=all(torch.equal(a, b) for a, b in zip(got, want)),
                untouched_unchanged=all(
                    torch.equal(a[~touched], b[~touched])
                    for a, b in zip(got, state)),
                max_abs_err=max(_max_err(a, b) for a, b in zip(got, want)),
                finite=all(bool(torch.isfinite(a).all()) for a in got))
            row['ok'] = (row['bitwise'] and row['untouched_unchanged'] and
                         row['finite'])
            if dist != 'edge':
                srows, order = tu.sort_rows(ids, height)
                tabs = [t.clone() for t in state]
                code, sc = tu.RULES[rule], _sparse_scalars(rule)
                row['ms'] = _device_ms(lambda: tu.launch_sorted(
                    code, tabs, srows, order, vals, lr, **sc))
                row['call_ms'] = _call_ms(lambda: _sparse_call(
                    rule, tabs, ids, vals, lr, plain=False))
                # values, sorted ids (int32) and their order (int64) read
                # once; each touched row of every table read and written
                # once (the runs are summed in registers)
                nbytes = k * d * 4 + k * 4 + k * 8 + n_unique * d * 4 * 2 * n
                row['bound_ms'], row['bound_by'] = _bound(nbytes, 0)
                timing.setdefault(dist, {})[rule] = row
            if dist in ('zipf', 'uniform'):
                row['sort_ms'] = _device_ms(lambda: tu.sort_rows(ids, height))
                row['plain_call_ms'] = _call_ms(lambda: _sparse_call(
                    rule, [t.clone() for t in state], ids, vals, lr,
                    plain=True), iters=2)
                row['library_ms'], row['library_single_call_ms'] = \
                    _sparse_library(rule, state, norm, vals, height, d)
                row['single_call_ms'] = _single_call_ms(lambda: _sparse_call(
                    rule, tabs, ids, vals, lr, plain=False))
            rows_out.append(row)
            print("sparse kernel %s" % json.dumps(row))
    bad = [(r['ids'], r['rule']) for r in rows_out if not r['ok']]
    if bad:
        raise SystemExit("row-sparse kernel differs from its plain rule or "
                         "moved an untouched row: %s" % bad)
    return rows_out, timing


def _s2s_programs(fuse=True, hidden=S2S['H']):
    c = S2S
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        _, _, _, pred, cost = seq2seq.build(
            dict_size=c['V'], word_dim=c['word_dim'], hidden_dim=hidden,
            fuse_vocab_loss=fuse)
        tfl.optimizer.AdamOptimizer(c['lr']).minimize(cost)
    return main, startup, pred, cost


def phase_s2s_training():
    c = S2S
    main, startup, pred, cost = _s2s_programs()
    n_adam = sum(op.type == 'adam' for op in main.global_block().ops)
    exe = tfl.Executor()
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    n_params = sum(scope.get(p.name).numel() for p in main.all_parameters())
    feed = wmt14.batch(np.random.default_rng(SEED + 17), c['V'],
                       [c['T']] * c['B'], c['T'])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    outs, step_ms, skipped = [], [], []
    for _ in range(1 + c['steps']):
        t0 = time.perf_counter()
        outs.append(exe.run(main, feed=feed, fetch_list=[cost], scope=scope))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        skipped.append(sorted({t for _, t in exe.skipped_ops}))
    counts = _counts()
    cluster_launches = dict(gru_fwd=gk.fwd_cluster_launches,
                            gru_bwd=gk.bwd_cluster_launches)
    losses = [float(o[0][0]) for o in outs]
    per_step = {k: n / (1 + c['steps']) for k, n in counts.items()}
    p50 = float(np.median(step_ms[1:]))
    res = dict(config='B=%d T=%d V=%d word_dim=%d H=%d float32 Adam lr %g, '
               'synthetic WMT14 (Zipf source ids)'
               % (c['B'], c['T'], c['V'], c['word_dim'], c['H'], c['lr']),
               params=n_params, adam_ops=n_adam, losses=losses,
               step_ms=step_ms, step_ms_p50=p50,
               target_tokens_per_s=c['B'] * c['T'] / (p50 / 1e3),
               launches=counts, launches_per_step=per_step,
               gru_cluster_launches=cluster_launches,
               skipped_op_types=skipped[-1],
               max_memory_allocated=torch.cuda.max_memory_allocated())
    print("seq2seq training: %s" % json.dumps(res))
    # the two embedding tables' adam ops take #6, the other 20 take #5
    want = _want(gru_fwd=3, gru_bwd=3, table_update=2,
                 dense_update=n_adam - 2)
    if n_adam != 22 or per_step != want:
        raise SystemExit("launches per step %s, want %s (adam ops %d)"
                         % (per_step, want, n_adam))
    if any(n != counts[k] for k, n in cluster_launches.items()):
        raise SystemExit("#9 and #10 launched %s times, %s of them on their "
                         "cluster paths" % ({k: counts[k] for k in
                                             cluster_launches},
                                            cluster_launches))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit("seq2seq loss not finite or not falling: %s"
                         % losses)
    if any('softmax' not in s for s in skipped):
        raise SystemExit("the prediction branch ran: skipped %s" % skipped)
    return dict(main=main, startup=startup, cost=cost, scope=scope, exe=exe,
                feed=feed, counts=counts, **res)


def phase_s2s_parity(s2s, title='seq2seq parity'):
    """One step at B=4 with ragged source and target lengths on the card
    (kernels) and on the CPU (plain versions) from the same state: the
    loss, every gradient (the embeddings' SelectedRows densified), Adam's
    moments and the update p_new - p_old, norm-relative per parameter
    (bounds and reasons as the transformer's parity phase); embedding rows
    no id touches, and their moments, unchanged bitwise on both sides.
    Any non-finite value fails."""
    main, cost = s2s['main'], s2s['cost']
    card_scope = tfl.Scope()
    s2s['exe'].run(s2s['startup'], scope=card_scope)
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
    watched = names + [m for n in names for m in adam[n]]
    before = {n: cpu_scope.get_numpy(n).copy() for n in watched}
    rng = np.random.default_rng(SEED + 18)
    lens = rng.integers(2, S2S['T'] + 1, S2S['parity_B'])
    lens[0] = S2S['T']
    feed = wmt14.batch(rng, S2S['V'], lens, S2S['T'])
    fetch = [cost.name] + [n + '@GRAD' for n in names]
    card = s2s['exe'].run(main, feed=feed, fetch_list=fetch,
                          scope=card_scope)
    cpu = tfl.Executor('cpu').run(main, feed=feed, fetch_list=fetch,
                                  scope=cpu_scope)

    def dense(a):
        return a.item().to_dense() if a.dtype == object else a
    card = [dense(a) for a in card]
    cpu = [dense(a) for a in cpu]
    nonfinite = [n for n, a in zip(fetch, card) if not np.isfinite(a).all()]
    gaps = {'grad': [], 'moment1': [], 'moment2': [], 'update': []}
    grad_of = dict(zip(names, zip(card[1:], cpu[1:])))
    zero_grads = {}
    for n, (g_card, g_cpu) in grad_of.items():
        if n in S2S_ZERO_GRAD:
            w_card, w_cpu = grad_of[S2S_ZERO_GRAD[n]]
            zero_grads[n] = dict(
                card=float(np.linalg.norm(g_card) / np.linalg.norm(w_card)),
                cpu=float(np.linalg.norm(g_cpu) / np.linalg.norm(w_cpu)))
        else:
            gaps['grad'].append((_norm_rel(g_card, g_cpu), n))
        for key, var in zip(('moment1', 'moment2'), adam[n]):
            a, b = card_scope.get_numpy(var), cpu_scope.get_numpy(var)
            if not np.isfinite(a).all():
                nonfinite.append(var)
            if n not in S2S_ZERO_GRAD:
                gaps[key].append((_norm_rel(a, b), n))
        a, b = card_scope.get_numpy(n), cpu_scope.get_numpy(n)
        if not np.isfinite(a).all():
            nonfinite.append(n)
        if n not in S2S_ZERO_GRAD:
            gaps['update'].append((_norm_rel(a - before[n], b - before[n]),
                                   n))
    moved_untouched = []
    for table, ids in (('mt_src_emb', 'src_word_id'),
                       ('mt_trg_emb', 'target_language_word')):
        touched = np.zeros(S2S['V'], bool)
        touched[feed[ids][0].ravel()] = True
        for var in (table,) + adam[table]:
            for label, sc in (('card', card_scope), ('cpu', cpu_scope)):
                now = sc.get_numpy(var)
                if not np.array_equal(now[~touched], before[var][~touched]):
                    moved_untouched.append((label, var))
    loss_err = abs(float(card[0][0]) - float(cpu[0][0]))
    tol = dict(loss=TOL_TRAIN_LOSS, grad=TOL_TRAIN_GRAD,
               moment1=TOL_TRAIN_GRAD, moment2=TOL_TRAIN_MOMENT2,
               update=TOL_TRAIN_UPDATE)
    worst = {k: max(v, key=lambda x: (np.nan_to_num(x[0], nan=np.inf), x[1]))
             for k, v in gaps.items()}
    bad = [k for k, (e, _) in worst.items() if not e <= tol[k]]
    if not loss_err <= TOL_TRAIN_LOSS:
        bad.append('loss')
    bad += [n for n, r in zero_grads.items()
            if not max(r.values()) <= TOL_S2S_ZERO_GRAD]
    res = dict(batch=S2S['parity_B'],
               src_lengths=feed['src_word_id'][1].tolist(),
               trg_lengths=feed['target_language_word'][1].tolist(),
               loss_card=float(card[0][0]), loss_cpu=float(cpu[0][0]),
               loss_err=loss_err,
               norm_rel_err={k: e for k, (e, _) in worst.items()},
               largest_gaps={k: [dict(param=n, norm_rel=e) for e, n in
                                 sorted(v, reverse=True)[:3]]
                             for k, v in gaps.items()},
               zero_grad_norm_over_weight_grad=zero_grads,
               untouched_rows_moved=moved_untouched, nonfinite=nonfinite,
               tol=dict(tol, zero_grad=TOL_S2S_ZERO_GRAD))
    print("%s: %s" % (title, json.dumps(res)))
    if nonfinite or bad or moved_untouched:
        raise SystemExit("seq2seq step on the card disagrees with the CPU "
                         "(%s), moved untouched rows (%s) or is not finite "
                         "(%s)" % (bad, moved_untouched, nonfinite))
    return res


def _route_scan_case(op, t=33, b=13, h=ROUTE_H):
    """``lstm_scan`` / ``gru_scan`` at a width that is not a multiple of 4
    on the card (the kernels, on inputs padded to a multiple of 4) against
    the plain versions at that width on the same tensors: hs (cs) and the
    gradients of x, w and pw (h0), at phase 13's and 18's bounds."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 21)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device='cuda')
                * scale).requires_grad_(True)
    g = 4 if op == 'lstm' else 3
    ins = [rnd(t, b, g * h), rnd(h, g * h, scale=h ** -0.5),
           rnd(3, h, scale=0.3) if op == 'lstm' else rnd(b, h, scale=0.5)]
    cts = [torch.randn((t, b, h), generator=gen, device='cuda')
           for _ in range(g - 2)]
    if op == 'lstm':
        runs = (lk.lstm_scan(*ins), lk._plain_lstm_forward(*ins)[:2])
    else:
        runs = ((gk.gru_scan(*ins),), gk._plain_gru_forward(*ins)[:1])
    res = []
    for outs in runs:
        grads = torch.autograd.grad(
            sum((o * c).sum() for o, c in zip(outs, cts)), ins)
        res.append([o.detach() for o in outs] + list(grads))
    torch.cuda.synchronize()
    names = (['h', 'c'] if op == 'lstm' else ['h']) + ['dx', 'dw'] + \
        (['dpw'] if op == 'lstm' else ['dh0'])
    tol0, rel = ((TOL_LSTM, TOL_LSTM_PARAM_REL) if op == 'lstm'
                 else (TOL_GRU, TOL_GRU_PARAM_REL))
    errs = {n: _max_err(a, r) for n, a, r in zip(names, *res)}
    tols = {n: (rel * max(1.0, float(r.abs().max()))
                if n in ('dw', 'dpw') else tol0)
            for n, r in zip(names, res[1])}
    finite = all(bool(torch.isfinite(a).all()) for a in res[0])
    return dict(case='%s_scan_T%d_B%d_H%d' % (op, t, b, h), errs=errs,
                tols=tols, finite=finite,
                ok=finite and all(errs[n] <= tols[n] for n in names))


def phase_rnn_route():
    """The ``lstm`` and ``gru`` ops' route by hidden width.  At H = 30 (not
    a multiple of 4, which the kernels run padded to 32): #7-#10 through
    ``lstm_scan`` / ``gru_scan`` against their plain versions at H = 30,
    and one step of the LM (phase 15's program, batch, lengths and bounds)
    and of the translator (phase 21's) on the card against the CPU, each
    launching the LSTM or the GRU kernels.  Past the backward kernels'
    caps: a ragged batch through each op, card against CPU, through its
    eager scan with no RNN kernel launched.  And the route's caps
    (``max_hidden`` of ops/kernels/lstm.py and gru.py, which
    ``kernel_takes`` reads without a build) against the built libraries'
    own."""
    caps = {}
    for mod, name, rows in ((lk, 'lstm_fwd', (8,)), (lk, 'lstm_bwd', (8,)),
                            (gk, 'gru_fwd', (8, 16)),
                            (gk, 'gru_bwd', (8, 16))):
        lib_cap = getattr(mod._lib(name), 'paddle_%s_max_hidden' % name)
        for r in rows:
            caps['%s_rows%d' % (name, r)] = (
                mod.max_hidden(name, r), lib_cap(r) if mod is gk
                else lib_cap())
    h = ROUTE_H
    takes = dict(lstm=lk.kernel_takes(h), gru=gk.kernel_takes(h))
    rnn = ('lstm_fwd', 'lstm_bwd', 'gru_fwd', 'gru_bwd')
    _zero_counts()
    scans = [_route_scan_case('lstm'), _route_scan_case('gru')]
    scan_counts = _counts()
    main, startup, cost = _lm_programs(hidden=h)
    _zero_counts()
    lm = phase_lm_parity(dict(main=main, startup=startup, cost=cost,
                              exe=tfl.Executor()), 'route: lm parity H=%d' % h)
    lm_counts = _counts()
    main, startup, _, cost = _s2s_programs(hidden=h)
    _zero_counts()
    s2s = phase_s2s_parity(dict(main=main, startup=startup, cost=cost,
                                exe=tfl.Executor()),
                           'route: seq2seq parity H=%d' % h)
    s2s_counts = _counts()
    past = ROUTE_PAST_CAPS
    past_takes = dict(lstm=lk.kernel_takes(past['lstm']),
                      gru=gk.kernel_takes(past['gru']))
    _zero_counts()
    past_rows = [_lstm_op_case(b=5, t=12, h=past['lstm']),
                 _gru_op_case('op_ragged_h0_B5_T12_H%d' % past['gru'], True,
                              False, b=5, t=12, h=past['gru'])]
    past_counts = _counts()
    launched = dict(
        scan={k: scan_counts[k] for k in rnn},
        lm={k: lm_counts[k] for k in rnn},
        s2s={k: s2s_counts[k] for k in rnn},
        past_caps={k: past_counts[k] for k in rnn})
    res = dict(hidden=h, kernel_takes=takes, caps_route_vs_library=caps,
               scan_vs_plain=scans, rnn_kernel_launches=launched,
               lm_norm_rel_err=lm['norm_rel_err'],
               s2s_norm_rel_err=s2s['norm_rel_err'],
               past_caps=dict(hidden=past, kernel_takes=past_takes,
                              cases=past_rows))
    print("rnn route: %s" % json.dumps(res))
    if any(a != b for a, b in caps.values()):
        raise SystemExit("the route's caps differ from the libraries': %s"
                         % caps)
    bad = [r['case'] for r in scans + past_rows if not r['ok']]
    if bad:
        raise SystemExit("RNN route case disagrees or is not finite: %s"
                         % bad)
    if not all(takes.values()) or any(past_takes.values()):
        raise SystemExit("kernel_takes is wrong at H=%d or past the caps: "
                         "%s" % (h, res))
    want = dict(scan=rnn, lm=rnn[:2], s2s=rnn[2:], past_caps=())
    missed = {path: [k for k in rnn if (launched[path][k] > 0)
                     != (k in names)] for path, names in want.items()}
    if any(missed.values()):
        raise SystemExit("RNN kernel launches off the route: %s (counts %s)"
                         % (missed, launched))
    return res


def phase_s2s_profile(s2s):
    """A traced seq2seq training step, apart from the timed ones."""
    def step():
        s2s['exe'].run(s2s['main'], feed=s2s['feed'],
                       fetch_list=[s2s['cost']], scope=s2s['scope'])
    wall, rows = _device_kernels(step)
    busy = sum(ms for _, ms, _ in rows)
    top = sorted(rows, key=lambda r: -r[1])[:12]

    def by(*tags):
        return sum(ms for k, ms, _ in rows if any(t in k for t in tags))
    out = dict(wall_ms=wall, device_busy_ms=busy if rows else None,
               idle_share=1.0 - busy / wall if rows else None,
               kernels=sum(n for *_, n in rows),
               gru_fwd_ms=by(*[k for k, _ in GRU_FWD_PARTS]),
               gru_fwd_ms_by_path={
                   path: by(*[k for k, p in GRU_FWD_PARTS if p == path])
                   for path in ('cluster', 'wide')},
               gru_bwd_ms=by(*[k for k, _ in GRU_BWD_PARTS]),
               gru_bwd_ms_by_part={
                   part: by(*[k for k, p in GRU_BWD_PARTS if p == part])
                   for part in ('chain', 'dw', 'finish', 'transpose')},
               table_update_ms=by('rowwise_'),
               dense_update_ms=by('dense_update_kernel'),
               gemm_ms=by('gemm', 'Kernel2'),
               sort_ms=by('Sort', 'sort'),
               top=[dict(kernel=k[:80], ms=ms, count=n) for k, ms, n in top])
    print("seq2seq training profile: %s" % json.dumps(out))
    return out


def _s2s_lines(gru_rows, gru_timing, sparse_rows, sparse_timing, s2s):
    """The kernels-line entries of #9, #10 and #6."""
    pair = gru_timing['layer_pair']
    kernel_rows = [r for r in gru_rows if 'fwd_err' in r]
    by_path = {k: dict(seq2seq_training=s2s['counts'][k])
               for k in ('gru_fwd', 'gru_bwd', 'table_update')}
    common = dict(route='cuda', library_ms=None,
                  shape='T=64 B=512 H=512 float32 with h0', cases=gru_rows)
    main_row = next(r for r in gru_rows if r['case'] == GRU_MAIN)
    headers = ['paddle_tpu_torch/csrc/gru_cluster.cuh',
               'paddle_tpu_torch/csrc/flash_tf32.cuh']
    fwd = dict(
        name='gru_fwd', source='paddle_tpu_torch/csrc/gru_fwd.cu',
        headers=headers, replaces='paddle_tpu/ops/pallas/lstm_cell.py:332',
        launches=s2s['counts']['gru_fwd'],
        launches_by_path=dict(
            by_path['gru_fwd'],
            seq2seq_training_on_cluster_path=s2s[
                'gru_cluster_launches']['gru_fwd']),
        max_abs_err=max(max(r['fwd_err'].values()) for r in kernel_rows),
        ms=gru_timing['fwd_ms'], plain_ms=gru_timing['fwd_plain_ms'],
        bound_ms=gru_timing['fwd_bound_ms'],
        bound_by=gru_timing['fwd_bound_by'],
        cuda_core_bound_ms=gru_timing['fwd_cuda_core_bound_ms'],
        call_ms=gru_timing['fwd_call_ms'],
        ms_by_path=gru_timing['fwd_ms_by_path'],
        wide_ms_by_rows_per_block=gru_timing['fwd_ms_by_rows_per_block'],
        plan=main_row['fwd_plan'], path_rule=gru_timing['path_rule'],
        layer_pair_yardstick=dict(
            note=pair['note'], port_ms=pair['port_fwd_ms'],
            cudnn_ms=pair['cudnn_fwd_ms']), **common)
    bwd = dict(
        name='gru_bwd', source='paddle_tpu_torch/csrc/gru_bwd.cu',
        headers=headers, replaces='paddle_tpu/ops/pallas/lstm_cell.py:361',
        launches=s2s['counts']['gru_bwd'],
        launches_by_path=dict(
            by_path['gru_bwd'],
            seq2seq_training_on_cluster_path=s2s[
                'gru_cluster_launches']['gru_bwd']),
        max_abs_err=max(max(r['bwd_err'].values()) for r in kernel_rows),
        ms=gru_timing['bwd_ms'], plain_ms=gru_timing['bwd_plain_ms'],
        bound_ms=gru_timing['bwd_bound_ms'],
        bound_by=gru_timing['bwd_bound_by'],
        cuda_core_bound_ms=gru_timing['bwd_cuda_core_bound_ms'],
        ms_by_part=gru_timing['bwd_ms_by_part'],
        bound_ms_by_part=dict(chain=gru_timing['bwd_chain_bound_ms'],
                              dw=gru_timing['bwd_dw_bound_ms']),
        call_ms=gru_timing['bwd_call_ms'],
        ms_by_path=gru_timing['bwd_ms_by_path'],
        plan=main_row['bwd_plan'], path_rule=gru_timing['path_rule'],
        layer_pair_yardstick=dict(
            note=pair['note'], port_ms=pair['port_bwd_ms'],
            cudnn_ms=pair['cudnn_bwd_ms']), **common)
    adam = sparse_timing['zipf']['adam']
    table = dict(
        name='table_update', route='cuda',
        source='paddle_tpu_torch/csrc/table_update.cu',
        replaces='paddle_tpu/ops/pallas/table_update.py:80',
        launches=s2s['counts']['table_update'],
        launches_by_path=by_path['table_update'],
        max_abs_err=max(r['max_abs_err'] for r in sparse_rows),
        ms=adam['ms'], plain_ms=adam['plain_call_ms'],
        bound_ms=adam['bound_ms'], bound_by=adam['bound_by'],
        library_ms=adam['library_ms'],
        library_single_call_ms=adam['library_single_call_ms'],
        library_note='torch.optim.SparseAdam on a COO gradient, coalesce '
        'included, per call between CUDA events (no graph capture): compare '
        'with call_ms, #6 with its id sort timed the same way',
        sort_ms=adam['sort_ms'], call_ms=adam['call_ms'],
        single_call_ms=adam['single_call_ms'], n_unique=adam['n_unique'],
        shape='lazy adam, table 30000 x 256, K=32768 Zipf ids',
        by_ids_and_rule=sparse_timing, cases=len(sparse_rows))
    return [table, fwd, bwd]


# phase 23's cases past phase 7's head dim 64: the kernels' other head-dim
# tiers (32 and 128), a head dim that is not a multiple of 4 (the kernels
# load its tiles by the threads, not by cp.async), and lengths that are no
# multiple of 32, whose ragged edge falls in the second of the 32-key
# halves #4's warps take of a k tile (keys 160-169 of 128-191; the
# queries at 70-169)
SPLIT_EXTRA_CASES = (
    # name, bh, tq, tk, causal, dtype, q_offset, k_offset, dlse, d
    ('d128_ragged_T200', 4, 200, 200, True, torch.float32, 0, 0, True, 128),
    ('d32_offsets_masked_tiles', 4, 192, 320, True, torch.float32, 0, 128,
     False, 32),
    ('d50_noncausal_T130', 4, 130, 130, False, torch.float32, 0, 0, False,
     50),
    ('bf16_d128_causal_T256', 4, 256, 256, True, torch.bfloat16, 0, 0,
     False, 128),
    ('ragged_q100_over_k170', 4, 100, 170, True, torch.float32, 70, 0, True,
     64))


def phase_split_kernel(bwd_rows):
    """Kernels #3 and #4 against ``_plain_backward_dkv`` /
    ``_plain_backward_dq`` at every case of phase 7 and at
    ``SPLIT_EXTRA_CASES``, through ``_fa_backward_dkv`` /
    ``_fa_backward_dq``; o and lse from the plain forward.  At every case
    #3's dk and dv must be bitwise equal to #2's (``_fa_backward_fused``):
    both run the engine of csrc/flash_bwd_dkv.cuh.
    At the training shape, #3, #4 and #2 timed in this call beside the
    plain versions, SDPA's backward taken from phase 7's row."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 19)
    rows, timing = [], None
    for case in tuple(c + (64,) for c in BWD_CASES) + SPLIT_EXTRA_CASES:
        name, bh, tq, tk, causal, dtype, qo, ko, with_dlse, d = case

        def rnd(t):
            return torch.randn((bh, t, d), generator=gen,
                               device='cuda').to(dtype)
        q, k, v, do = rnd(tq), rnd(tk), rnd(tk), rnd(tq)
        scale = d ** -0.5
        o, lse = fa._plain_forward(q, k, v, causal, scale, qo, ko)
        di = (do.float() * o.float()).sum(-1)
        if with_dlse:
            di = di - torch.randn((bh, tq), generator=gen, device='cuda')
        args = (q, k, v, lse, do, di.contiguous(), causal, scale, qo, ko)
        dk, dv = fa._fa_backward_dkv(*args)
        dq = fa._fa_backward_dq(*args)
        _, fused_dk, fused_dv = fa._fa_backward_fused(*args)
        ref_dk, ref_dv = fa._plain_backward_dkv(*args)
        ref_dq = fa._plain_backward_dq(*args)
        torch.cuda.synchronize()
        err = dict(dq=_max_err(dq, ref_dq), dk=_max_err(dk, ref_dk),
                   dv=_max_err(dv, ref_dv))
        finite = all(bool(torch.isfinite(a).all()) for a in (dq, dk, dv))
        bitwise = bool(torch.equal(dk, fused_dk) and
                       torch.equal(dv, fused_dv))
        tol = TOL_BWD_BF16 if dtype == torch.bfloat16 else TOL_BWD_F32
        row = dict(case=name, bh=bh, tq=tq, tk=tk, d=d, causal=causal,
                   dtype=str(dtype).replace('torch.', ''), q_offset=qo,
                   k_offset=ko, dlse=with_dlse, err=err, tol=tol,
                   finite=finite, dk_dv_bitwise_equal_fused=bitwise,
                   ok=finite and bitwise and max(err.values()) <= tol)
        if name == BWD_MAIN:
            fns = {
                'dkv': lambda: fa._fa_backward_dkv(*args),
                'dq': lambda: fa._fa_backward_dq(*args),
                'fused': lambda: fa._fa_backward_fused(*args),
                'dkv_plain': lambda: fa._plain_backward_dkv(*args),
                'dq_plain': lambda: fa._plain_backward_dq(*args)}
            timing = {key + '_ms': _device_ms(fn, iters=10, replays=3)
                      for key, fn in fns.items()}
            for key in ('dkv', 'dq'):
                timing[key + '_call_ms'] = _call_ms(fns[key], iters=20)
            bounds = _flash_bounds(bh, tq, tk, d, causal, qo, ko, 4)
            for key in ('dkv', 'dq'):
                timing.update((key + '_' + k, v) for k, v in
                              _flash_bound(*bounds[key]).items())
            timing['library_ms'] = next(
                r['library_ms'] for r in bwd_rows if r['case'] == BWD_MAIN)
            timing['library_note'] = ('SDPA backward (phase 7): dq, dk and '
                                      'dv, the pair\'s function')
            timing['shape'] = 'BH=256 T=512 D=64 float32 causal'
            row.update(timing)
        rows.append(row)
        print("split kernels %s" % json.dumps(row))
    bad = [r['case'] for r in rows if not r['ok']]
    if bad:
        raise SystemExit("split backward kernels disagree with their plain "
                         "versions, #3 with #2, or are not finite: %s" % bad)
    return rows, timing


def _once_ms(fn):
    """Device ms of one call between CUDA events (after the caller's
    warm-up): a call that takes seconds needs no graph replay."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _long_slices(t, n=64):
    """Row ranges held against the plain versions at full length: the
    first n, n across the middle (a 64-row tile boundary at 2^16 when t is
    2^17) and the last n."""
    mid = t // 2 - n // 2
    return ((0, n), (mid, mid + n), (t - n, t))


def _long_vs_plain(q, k, v, do, o, lse, di, scale, split, fused):
    """#1's o and lse and #4's and #2's dq on query slices, #3's and #2's
    dk and dv on key slices, against the plain versions on the same rows:
    each slice placed by its offset and run against every key (query).
    The plain backward takes #1's lse, held here too.  Returns each
    output's norm-relative gaps and largest absolute gap, one per slice."""
    gaps = {}

    def note(name, got, want):
        got, want = got.float(), want.float()
        gaps.setdefault(name, dict(norm_rel=[], max_abs=[]))
        gaps[name]['norm_rel'].append(float((got - want).norm() /
                                            want.norm()))
        gaps[name]['max_abs'].append(_max_err(got, want))

    for a, b in _long_slices(q.shape[1]):
        rows = slice(a, b)
        po, plse = fa._plain_forward(q[:, rows], k, v, True, scale, a, 0)
        note('fwd_o', o[:, rows], po)
        note('fwd_lse', lse[:, rows], plse)
        del po, plse
        pdq = fa._plain_backward_dq(q[:, rows], k, v, lse[:, rows],
                                    do[:, rows], di[:, rows], True, scale,
                                    a, 0)
        note('dq', split[0][:, rows], pdq)
        note('fused_dq', fused[0][:, rows], pdq)
        del pdq
        pdk, pdv = fa._plain_backward_dkv(q, k[:, rows], v[:, rows], lse, do,
                                          di, True, scale, 0, a)
        note('dk', split[1][:, rows], pdk)
        note('dv', split[2][:, rows], pdv)
        note('fused_dk', fused[1][:, rows], pdk)
        note('fused_dv', fused[2][:, rows], pdv)
        del pdk, pdv
    return gaps


def _float64_probs(q, k, v, do, lse, di, scale, rows, keys):
    """p and ds of the queries ``rows`` against the keys ``keys`` (slices;
    causal, no offsets) in float64 from the float32 inputs, lse and di,
    with the scaled queries and the keys in float64: the exact terms that
    phase 24's float32 kernels and plain versions each sum in their own
    order."""
    qd, kd = q[:, rows].double() * scale, k[:, keys].double()
    p = torch.exp(torch.einsum('btd,bsd->bts', qd, kd)
                  - lse[:, rows].double()[..., None])
    qpos = torch.arange(q.shape[1], device=q.device)[rows]
    kpos = torch.arange(k.shape[1], device=q.device)[keys]
    p = torch.where(qpos[:, None] >= kpos[None, :], p, torch.zeros_like(p))
    ds = p * (torch.einsum('btd,bsd->bts', do[:, rows].double(),
                           v[:, keys].double())
              - di[:, rows].double()[..., None])
    return qd, kd, p, ds


def _float64_dkv(q, k, v, do, lse, di, scale, a, b):
    """dk and dv of keys [a, b) against every query in float64."""
    qd, _, p, ds = _float64_probs(q, k, v, do, lse, di, scale, slice(None),
                                  slice(a, b))
    return (torch.einsum('bts,btd->bsd', ds, qd),
            torch.einsum('bts,btd->bsd', p, do.double()))


def _float64_dq(q, k, v, do, lse, di, scale, a, b):
    """dq of queries [a, b) against every key in float64."""
    _, kd, _, ds = _float64_probs(q, k, v, do, lse, di, scale, slice(a, b),
                                  slice(None))
    return torch.einsum('bts,bsd->btd', ds, kd) * scale


def _long_ok(gaps):
    """Whether every slice's gap is inside TOL_LONG_VS_PLAIN (lse by its
    largest gap, within TOL_F32); a NaN gap fails."""
    return all(g <= TOL_F32 if name == 'fwd_lse' else g <= TOL_LONG_VS_PLAIN
               for name, r in gaps.items()
               for g in r['max_abs' if name == 'fwd_lse' else 'norm_rel'])


def phase_long_kernel():
    """One layer's attention of the long-context run at full length: #1,
    #2, #3 and #4 against their plain versions on row slices
    (``_long_vs_plain``), and the split pair's dq, dk and dv against the
    fused kernel's over the whole length (norm-relative); #1, #3, #4 and
    #2 timed once each after a warm-up, and SDPA's forward and backward
    (efficient-attention backend; forward and backward less forward) as
    their yardsticks."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    c = LONG
    bh, t, d = c['H'] * c['B'], c['T'], c['D'] // c['H']
    gen = torch.Generator(device='cuda').manual_seed(SEED + 21)
    q, k, v, do = (torch.randn((bh, t, d), generator=gen, device='cuda')
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = fa._fa_forward(q, k, v, True, scale)
    di = (do * o).sum(-1).contiguous()
    args = (q, k, v, lse, do, di, True, scale)
    dk, dv = fa._fa_backward_dkv(*args)
    split = (fa._fa_backward_dq(*args), dk, dv)
    fused = fa._fa_backward_fused(*args)
    torch.cuda.synchronize()
    gaps = {n: float((a - b).norm() / b.norm())
            for n, a, b in zip(('dq', 'dk', 'dv'), split, fused)}
    finite = all(bool(torch.isfinite(a).all())
                 for a in (o, lse) + split + fused)
    bitwise_dkv = bool(torch.equal(split[1], fused[1]) and
                       torch.equal(split[2], fused[2]))
    vs_plain = _long_vs_plain(q, k, v, do, o, lse, di, scale, split, fused)
    # which side of the split-vs-fused gap carries it: both against the
    # float64 sums on the first key tile, whose dk, dv sum over every
    # query, and on the last query tile, whose dq sums over every key
    # (reported, not gated)
    exact = _float64_dkv(q, k, v, do, lse, di, scale, 0, 64)
    vs_float64 = {
        '%s_%s' % (side, n): float((got[:, :64].double() - want).norm()
                                   / want.norm())
        for side, grads in (('split', split), ('fused', fused))
        for n, got, want in zip(('dk', 'dv'), grads[1:], exact)}
    exact = _float64_dq(q, k, v, do, lse, di, scale, t - 64, t)
    dq_vs_float64 = {
        side: float((grads[0][:, t - 64:].double() - exact).norm()
                    / exact.norm())
        for side, grads in (('split', split), ('fused', fused))}
    del split, fused, dk, dv, o, exact
    ms = dict(fwd=_once_ms(lambda: fa._fa_forward(q, k, v, True, scale)),
              dkv=_once_ms(lambda: fa._fa_backward_dkv(*args)),
              dq=_once_ms(lambda: fa._fa_backward_dq(*args)),
              fused=_once_ms(lambda: fa._fa_backward_fused(*args)))
    q4, k4, v4 = (x.view(1, bh, t, d).clone().requires_grad_(True)
                  for x in (q, k, v))
    do4 = do.view(1, bh, t, d)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                  scale=scale)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa(), (q4, k4, v4), do4)
        sdpa_fwd_bwd()
        lib_fwd = _once_ms(lambda: sdpa().detach())
        lib_both = _once_ms(sdpa_fwd_bwd)
    del q4, k4, v4
    res = dict(shape='BH=%d T=%d D=%d float32 causal' % (bh, t, d),
               norm_rel_split_vs_fused=gaps, tol=TOL_SPLIT_VS_FUSED,
               vs_plain=vs_plain, slices=_long_slices(t),
               tol_vs_plain=TOL_LONG_VS_PLAIN, tol_lse=TOL_F32,
               dk_dv_bitwise_equal_fused=bitwise_dkv, finite=finite,
               first_key_tile_vs_float64=vs_float64,
               last_query_tile_dq_vs_float64=dq_vs_float64,
               library_fwd_ms=lib_fwd, library_bwd_ms=lib_both - lib_fwd,
               library_note='F.scaled_dot_product_attention, efficient-'
               'attention backend; backward = forward and backward less '
               'forward')
    for key, (nbytes, flops) in _flash_bounds(bh, t, t, d, True, 0, 0,
                                              4).items():
        res[key] = dict(ms=ms[key], bytes=nbytes, flops=flops)
        res[key].update(_flash_bound(nbytes, flops))
    print("long kernels: %s" % json.dumps(res))
    if not finite or not max(gaps.values()) <= TOL_SPLIT_VS_FUSED or \
            not bitwise_dkv:
        raise SystemExit("split pair disagrees with the fused kernel at "
                         "full length (dk, dv bitwise equal: %s) or is not "
                         "finite: %s" % (bitwise_dkv, gaps))
    if not _long_ok(vs_plain):
        raise SystemExit("flash kernels disagree with their plain versions "
                         "at full length: %s" % vs_plain)
    return res


def phase_long_parity(tr):
    """Phase 10 with the fused kernel's cap lowered to 0 (restored after),
    so the card's step takes #3 and #4 in every layer."""
    saved = fa._FUSED_DQ_BYTES
    fa._FUSED_DQ_BYTES = 0
    try:
        res = phase_train_parity(tr, 'long-context parity')
    finally:
        fa._FUSED_DQ_BYTES = saved
    want = _want(flash_attention_fwd=TRAIN['L'], dense_update=tr['n_adam'],
                 flash_attention_bwd_dkv=TRAIN['L'],
                 flash_attention_bwd_dq=TRAIN['L'])
    if {k: float(n) for k, n in res['launches'].items()} != want:
        raise SystemExit("long-context parity step launched %s, want %s"
                         % (res['launches'], want))
    return res


def _long_err(long_k, names):
    """The largest absolute gap of ``names`` against the plain versions
    on phase 24's full-length slices, and the largest norm-relative one."""
    res = long_k['vs_plain']
    return (max(g for n in names for g in res[n]['max_abs']),
            max(g for n in names for g in res[n]['norm_rel']))


def _split_lines(split_rows, split_timing, long_k, long_tr, parity, tr):
    """The kernels-line entries of #3 and #4: ``ms`` and ``bound_ms`` at
    the long-context run's shape; plain, call and training-shape times at
    the training shape (the plain versions cannot hold [T, T] at T =
    131072); ``library_ms`` SDPA's backward, which computes the pair's
    function (dq, dk, dv)."""
    lines = []
    for name, key, line in (('flash_attention_bwd_dkv', 'dkv', 364),
                            ('flash_attention_bwd_dq', 'dq', 413)):
        grads = ('dk', 'dv') if key == 'dkv' else ('dq',)
        long_abs, long_rel = _long_err(long_k, grads)
        lines.append(dict(
            name=name, route='cuda',
            source='paddle_tpu_torch/csrc/flash_attention_bwd_split.cu',
            replaces='paddle_tpu/ops/pallas/flash_attention.py:%d' % line,
            launches=long_tr['counts'][name],
            launches_by_path=dict(long_context_training=long_tr['counts'][
                name], long_context_parity=parity['launches'][name],
                training=tr['counts'][name]),
            max_abs_err=max([r['err'][g] for r in split_rows
                             if r['dtype'] == 'float32' for g in grads]
                            + [long_abs]),
            long_context_vs_plain=dict(max_abs_err=long_abs,
                                       norm_rel=long_rel),
            norm_rel_vs_fused=max(long_k['norm_rel_split_vs_fused'][g]
                                  for g in grads),
            ms=long_k[key]['ms'], bound_ms=long_k[key]['bound_ms'],
            bound_by=long_k[key]['bound_by'],
            cuda_core_bound_ms=long_k[key]['cuda_core_bound_ms'],
            plain_ms=split_timing[key + '_plain_ms'],
            library_ms=long_k['library_bwd_ms'],
            library_note='SDPA backward (efficient attention) at the same '
            'shape: dq, dk and dv, the pair\'s function',
            call_ms=split_timing[key + '_call_ms'],
            shape=long_k['shape'],
            plain_shape=split_timing['shape'],
            training_shape=dict(
                shape=split_timing['shape'], ms=split_timing[key + '_ms'],
                bound_ms=split_timing[key + '_bound_ms'],
                bound_by=split_timing[key + '_bound_by'],
                cuda_core_bound_ms=split_timing[
                    key + '_cuda_core_bound_ms'],
                plain_ms=split_timing[key + '_plain_ms'],
                call_ms=split_timing[key + '_call_ms'],
                fused_ms=split_timing['fused_ms'],
                library_ms=split_timing['library_ms']),
            cases=split_rows))
    return lines


def _resnet_feed(batch, seed, c=RESNET):
    """bench.py:222-224: normal images and integer labels from
    default_rng(seed), as host arrays."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(batch, 3, c['hw'], c['hw'])).astype(
        np.float32)
    labels = rng.integers(0, c['classes'], size=(batch, 1)).astype(np.int32)
    return {'img': images, 'label': labels}


def _resnet_flops(main, batch):
    """Float32 flops of one step's convs and fc from the program's
    shapes: 2 * B * C_out * H_out * W_out * C_in/groups * kh * kw a conv
    forward (2 * B * K * N the fc), the backward twice that (dx and dW),
    but for the stem's dx, which the image does not need."""
    blk = main.global_block()
    fwd = stem = 0
    for op in blk.ops:
        if op.type == 'conv2d':
            w = blk.var(op.input('Filter')[0]).shape
            o = blk.var(op.output('Output')[0]).shape
            f = 2 * batch * o[1] * o[2] * o[3] * w[1] * w[2] * w[3]
            fwd += f
            if op.input('Input')[0] == 'img':
                stem += f
        elif op.type == 'mul':
            k, n = blk.var(op.input('Y')[0]).shape
            fwd += 2 * batch * k * n
    return dict(forward=fwd, step=3 * fwd - stem)


def phase_resnet_training(c=RESNET):
    """ResNet-50 at bench.py's width trained through run_steps on one
    batch staged on the card: a warm-up step, 8 timed single-step calls,
    one 8-step call, then steps to 40 in all; each step must launch the
    dense update once per parameter (214) and no other kernel."""
    main, startup, cost = _resnet_programs(c)
    n_mom = sum(op.type == 'momentum' for op in main.global_block().ops)
    exe = tfl.Executor()
    scope = tfl.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    n_params = sum(scope.get(p.name).numel() for p in main.all_parameters())
    feed = {k: torch.from_numpy(v).cuda()
            for k, v in _resnet_feed(c['B'], 0, c).items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()

    def steps(k):
        t0 = time.perf_counter()
        out, = exe.run_steps(main, feed=feed, fetch_list=[cost],
                             scope=scope, repeat=k)
        return (time.perf_counter() - t0) * 1e3, out.ravel().tolist()

    _zero_counts()
    warm_ms, losses = steps(1)
    step_ms = []
    for _ in range(c['steps']):
        ms, loss = steps(1)
        step_ms.append(ms)
        losses += loss
    run_ms, loss = steps(c['steps'])
    losses += loss
    rest_ms, loss = steps(c['total_steps'] - 1 - 2 * c['steps'])
    losses += loss
    counts = _counts()
    per_step = {k: n / len(losses) for k, n in counts.items()}
    p50 = float(np.median(step_ms))
    flops = _resnet_flops(main, c['B'])
    bound_ms, bound_by = _bound(0, flops['step'])
    res = dict(
        config='ResNet-50 B=%d %dx%d NCHW float32 Momentum lr %g mu %g, '
        'run_steps on one staged batch' % (c['B'], c['hw'], c['hw'],
                                           c['lr'], c['mu']),
        params=n_params, momentum_ops=n_mom, startup_s=startup_s,
        warmup_ms=warm_ms, step_ms=step_ms, step_ms_p50=p50,
        img_per_s=c['B'] / (p50 / 1e3),
        run_steps_8_ms_per_step=run_ms / c['steps'],
        img_per_s_run_steps_8=c['B'] / (run_ms / c['steps'] / 1e3),
        steps=len(losses), losses=losses, launches=counts,
        launches_per_step=per_step, conv_fc_tflop=flops['step'] / 1e12,
        conv_fc_forward_tflop=flops['forward'] / 1e12,
        conv_fc_bound_ms=bound_ms, conv_fc_bound_by=bound_by,
        bound_share_of_p50=bound_ms / p50,
        cudnn_benchmark=torch.backends.cudnn.benchmark,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        memory_allocated_at_start=allocated_at_start)
    print("resnet50 training: %s" % json.dumps(res))
    if n_mom != 214:
        raise SystemExit("program has %d momentum ops, want 214" % n_mom)
    if per_step != _want(dense_update=n_mom):
        raise SystemExit("launches per step %s, want 214 dense updates"
                         % per_step)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit("loss not finite or not falling: %s" % losses)
    return dict(main=main, startup=startup, cost=cost, scope=scope,
                exe=exe, feed=feed, counts=counts, **res)


def resnet_parity(rn, c=RESNET, seed=SEED + 30):
    """One ResNet-50 step at B=2 on the card and on the CPU from the same
    state, on the images of ``seed``: the loss, every gradient, every
    velocity and update, and the BN running statistics, held to
    ``TOL_RESNET_*``.  Returns the readings, with the quantities that
    broke their bound under ``bad`` and the non-finite ones under
    ``nonfinite``; ``check_resnet_parity`` judges them."""
    main, cost = rn['main'], rn['cost']
    card_scope = tfl.Scope()
    rn['exe'].run(rn['startup'], scope=card_scope)
    params = [p.name for p in main.all_parameters()]
    zero = {p.name for p in main.all_parameters()
            if p.optimize_attr['learning_rate'] == 0.0}
    velocity = {op.input('Param')[0]: op.input('Velocity')[0]
                for op in main.global_block().ops if op.type == 'momentum'}
    stats = [v.name for v in main.list_vars() if v.persistable and
             v.name.endswith(('.mean', '.var'))]
    if sorted(velocity) != sorted(params) or len(zero) != 53 or \
            len(stats) != 106:
        raise SystemExit("momentum ops, lr-0 biases or BN statistics "
                         "are not ResNet-50's")
    cpu_scope = tfl.Scope()
    for v in main.list_vars():
        if v.persistable and card_scope.has(v.name):
            cpu_scope.set(v.name, card_scope.get(v.name).to('cpu',
                                                             copy=True))
    before = {n: cpu_scope.get_numpy(n).copy() for n in params}
    feed = _resnet_feed(c['parity_B'], seed, c)
    fetch = [cost.name] + [n + '@GRAD' for n in params]
    t0 = time.perf_counter()
    _zero_counts()
    card = rn['exe'].run(main, feed=feed, fetch_list=fetch,
                         scope=card_scope)
    counts = _counts()
    cpu = tfl.Executor('cpu').run(main, feed=feed, fetch_list=fetch,
                                  scope=cpu_scope)
    secs = time.perf_counter() - t0
    grads_card = dict(zip(params, card[1:]))
    grads_cpu = dict(zip(params, cpu[1:]))
    nonfinite = [n for n, a in zip(['loss'] + fetch[1:], card)
                 if not np.isfinite(a).all()]
    gaps = {'grad': [], 'velocity': [], 'update': [], 'running_stats': []}
    zero_ratio = []
    for n in params:
        v_card = card_scope.get_numpy(velocity[n])
        v_cpu = cpu_scope.get_numpy(velocity[n])
        p_card, p_cpu = card_scope.get_numpy(n), cpu_scope.get_numpy(n)
        for name, a in ((velocity[n], v_card), (n, p_card)):
            if not np.isfinite(a).all():
                nonfinite.append(name)
        if n in zero:
            w = n[:-len('b_0')] + 'w_0'
            ref = float(max(np.linalg.norm(grads_card[w]),
                            np.linalg.norm(grads_cpu[w])))
            for g in (grads_card[n], grads_cpu[n], v_card, v_cpu):
                zero_ratio.append((float(np.linalg.norm(g)) / ref, n))
            if not (np.array_equal(p_card, before[n]) and
                    np.array_equal(p_cpu, before[n])):
                zero_ratio.append((np.inf, n + ' moved'))
            continue
        gaps['grad'].append((_norm_rel(grads_card[n], grads_cpu[n]), n))
        gaps['velocity'].append((_norm_rel(v_card, v_cpu), n))
        gaps['update'].append((_norm_rel(p_card - before[n],
                                         p_cpu - before[n]), n))
    for n in stats:
        a, b = card_scope.get_numpy(n), cpu_scope.get_numpy(n)
        if not np.isfinite(a).all():
            nonfinite.append(n)
        gaps['running_stats'].append((_norm_rel(a, b), n))
    loss_err = abs(float(card[0][0]) - float(cpu[0][0]))
    worst = {k: max(v, key=lambda x: (np.nan_to_num(x[0], nan=np.inf), x[1]))
             for k, v in gaps.items()}
    worst_zero = max(zero_ratio,
                     key=lambda x: (np.nan_to_num(x[0], nan=np.inf), x[1]))
    tol = dict(grad=TOL_RESNET_GRAD, velocity=TOL_RESNET_GRAD,
               update=TOL_RESNET_GRAD, running_stats=TOL_RESNET_STATS)
    bad = [k for k, (e, _) in worst.items() if not e <= tol[k]]
    if not loss_err <= TOL_RESNET_LOSS:
        bad.append('loss')
    if not worst_zero[0] <= TOL_RESNET_ZERO_GRAD:
        bad.append('zero-lr biases')
    res = dict(batch=c['parity_B'], seed=seed, loss_card=float(card[0][0]),
               loss_cpu=float(cpu[0][0]), loss_err=loss_err,
               norm_rel_err={k: e for k, (e, _) in worst.items()},
               largest_gaps={k: [dict(name=n, norm_rel=e) for e, n in
                                 sorted(v, reverse=True)[:3]]
                             for k, v in gaps.items()},
               zero_lr_bias_grad_ratio=dict(value=worst_zero[0],
                                            name=worst_zero[1]),
               nonfinite=nonfinite, seconds=secs,
               median_norm_rel={k: float(np.median([e for e, _ in v]))
                                for k, v in gaps.items()},
               tol=dict(tol, loss=TOL_RESNET_LOSS,
                        zero_lr_bias_grad_ratio=TOL_RESNET_ZERO_GRAD),
               launches=counts, bad=bad)
    print("resnet50 parity: %s" % json.dumps(res))
    return res


def check_resnet_parity(res):
    """Fails unless every reading of ``resnet_parity`` is finite and within
    its bound, and the card's step launched the dense update 214 times."""
    if res['nonfinite'] or res['bad']:
        raise SystemExit("ResNet-50 step on the card disagrees with the CPU "
                         "(%s) or is not finite (%s)"
                         % (res['bad'], res['nonfinite']))
    if {k: float(n) for k, n in res['launches'].items()} != _want(
            dense_update=214):
        raise SystemExit("parity step launched %s" % res['launches'])


def phase_resnet_parity(rn, c=RESNET):
    res = resnet_parity(rn, c)
    check_resnet_parity(res)
    return res


def phase_resnet_profile(rn):
    """A traced ResNet-50 step (run_steps, one step), apart from the timed
    ones: device time by kernel, grouped by name: cuDNN's and cuBLAS's
    convolution and GEMM kernels, the dense update (#5), the pooling
    kernels, torch's reductions (the batch norms' statistics and backward
    sums, the loss), elementwise kernels (the batch norms' passes, bias
    adds, relus, residual adds, copies, fills), and the rest under
    ``other``.  The convs' and fc's rate is their flops over the matched
    conv and GEMM time alone."""
    def step():
        rn['exe'].run_steps(rn['main'], feed=rn['feed'],
                            fetch_list=[rn['cost']], scope=rn['scope'],
                            repeat=1)
    wall, rows = _device_kernels(step)
    busy = sum(ms for _, ms, _ in rows)
    groups = {'conv_and_gemm': 0.0, 'dense_update': 0.0, 'pooling': 0.0,
              'reduction': 0.0, 'elementwise': 0.0, 'other': 0.0}
    other = []
    for k, ms, n in rows:
        if 'dense_update_kernel' in k:
            groups['dense_update'] += ms
        elif 'pool' in k:
            groups['pooling'] += ms
        elif re.search(r'xmma|gemm|cudnn|wgrad|dgrad|fprop|cutlass|convolve',
                       k):
            groups['conv_and_gemm'] += ms
        elif 'reduce_kernel' in k:
            groups['reduction'] += ms
        elif 'elementwise' in k or 'CatArray' in k or 'fill' in k.lower() \
                or 'copy' in k.lower():
            groups['elementwise'] += ms
        else:
            groups['other'] += ms
            other.append((k, ms, n))
    top = sorted(rows, key=lambda r: -r[1])[:15]
    out = dict(wall_ms=wall, device_busy_ms=busy if rows else None,
               idle_share=1.0 - busy / wall if rows else None,
               kernels=sum(n for *_, n in rows), by_group_ms=groups,
               conv_fc_tflop_per_s=(rn['conv_fc_tflop'] /
                                    (groups['conv_and_gemm'] / 1e3)
                                    if groups['conv_and_gemm'] else None),
               dense_update_launches=sum(
                   n for k, _, n in rows if 'dense_update_kernel' in k),
               other=[dict(kernel=k[:100], ms=ms, count=n) for k, ms, n in
                      sorted(other, key=lambda r: -r[1])[:8]],
               top=[dict(kernel=k[:100], ms=ms, count=n)
                    for k, ms, n in top])
    print("resnet50 profile: %s" % json.dumps(out))
    return out


def phase_mnist_training(c=MNIST):
    """The book's MNIST convnet on the card: Adam through ``batch`` and
    ``DataFeeder`` on the synthetic set; the loss must be finite and fall,
    and each step must launch the dense update once per parameter."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        img, label, _, avg_cost, acc = mnist.build('conv')
        tfl.optimizer.AdamOptimizer(learning_rate=c['lr']).minimize(
            avg_cost)
    n_adam = sum(op.type == 'adam' for op in main.global_block().ops)
    exe = tfl.Executor()
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    feeder = tfl.DataFeeder(feed_list=[img, label], place=exe.place,
                            program=main)
    reader = tfl.batch(tfl.reader.firstn(mnist_data.train(),
                                         c['B'] * c['steps']), c['B'])
    losses, accs = [], []
    t0 = time.perf_counter()
    _zero_counts()
    for data in reader():
        loss, a = exe.run(main, feed=feeder.feed(data),
                          fetch_list=[avg_cost, acc], scope=scope)
        losses.append(float(loss[0]))
        accs.append(float(a[0]))
    secs = time.perf_counter() - t0
    counts = _counts()
    per_step = {k: n / len(losses) for k, n in counts.items()}
    res = dict(config='MNIST convnet, Adam lr %g, batch %d, synthetic set'
               % (c['lr'], c['B']), steps=len(losses), losses=losses,
               accuracy=accs, seconds=secs, adam_ops=n_adam,
               launches=counts)
    print("mnist training: %s" % json.dumps(res))
    if n_adam != 6 or per_step != _want(dense_update=n_adam):
        raise SystemExit("mnist launches per step %s" % per_step)
    if not all(np.isfinite(losses)) or \
            not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise SystemExit("mnist loss not finite or not falling: %s"
                         % losses)
    return res


def _image_phases():
    """Phases 28-31, timed together."""
    t0 = time.perf_counter()
    rn = phase_resnet_training()
    phase_resnet_parity(rn)
    phase_resnet_profile(rn)
    mn = phase_mnist_training()
    print("phases 28-31 (ResNet-50, MNIST): %.1f s"
          % (time.perf_counter() - t0))
    return rn, mn


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = phase_environment()
    if sys.argv[1:] == ['--long-step']:
        phase_training(LONG, 'long-context training', SEED + 20,
                       ('flash_attention_bwd_dkv', 'flash_attention_bwd_dq'))
        return 0
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
    lstm_rows, lstm_timing = phase_lstm_kernel()
    lm = phase_lm_training()
    phase_lm_parity(lm)
    sent = phase_sentiment()
    phase_lm_profile(lm)
    gru_rows, gru_timing = phase_gru_kernel()
    sparse_rows, sparse_timing = phase_sparse_kernel()
    s2s = phase_s2s_training()
    phase_s2s_parity(s2s)
    phase_rnn_route()
    phase_s2s_profile(s2s)
    split_rows, split_timing = phase_split_kernel(bwd_rows)
    long_k = phase_long_kernel()
    parity = phase_long_parity(tr)
    del tr['scope'], lm['scope'], s2s['scope']   # free the card for LONG
    long_tr = phase_training(LONG, 'long-context training', SEED + 20,
                             ('flash_attention_bwd_dkv',
                              'flash_attention_bwd_dq'))
    phase_train_profile(long_tr, 'long-context training profile')
    del long_tr['scope'], long_tr['exe']   # free the card for ResNet-50
    torch.cuda.empty_cache()
    rn, mn = _image_phases()
    counts = tr['counts']
    main_row = next(r for r in rows if r['case'] == MAIN_CASE)
    fwd = dict(
        name='flash_attention_fwd', route='cuda',
        source='paddle_tpu_torch/csrc/flash_attention_fwd.cu',
        replaces='paddle_tpu/ops/pallas/flash_attention.py:56',
        launches=(serve_launches + counts['flash_attention_fwd'] +
                  long_tr['counts']['flash_attention_fwd']),
        launches_by_path=dict(
            serving=serve_launches, training=counts['flash_attention_fwd'],
            long_context_training=long_tr['counts']['flash_attention_fwd']),
        max_abs_err=max(
            [max(r['err_o'], r['err_lse']) for r in rows
             if r['dtype'] == 'float32']
            + [max(r['fwd_err_o'], r['fwd_err_lse']) for r in bwd_rows
               if r['dtype'] == 'float32']),
        ms=main_row['ms'], plain_ms=main_row['plain_ms'],
        bound_ms=main_row['bound_ms'], bound_by=main_row['bound_by'],
        cuda_core_bound_ms=main_row['cuda_core_bound_ms'],
        library_ms=main_row['library_ms'],
        call_ms=main_row['call_ms'],
        plain_call_ms=main_row['plain_call_ms'],
        library_call_ms=main_row['library_call_ms'],
        shape='BH=8 T=256 D=64 float32 causal', training_shape=fwd_train,
        long_context_shape=dict(shape=long_k['shape'],
                                library_ms=long_k['library_fwd_ms'],
                                **long_k['fwd']),
        cases=rows)
    fwd_long = _long_err(long_k, ('fwd_o', 'fwd_lse'))
    fwd['max_abs_err'] = max(fwd['max_abs_err'], fwd_long[0])
    fwd['long_context_shape']['vs_plain'] = dict(
        max_abs_err=fwd_long[0],
        norm_rel=_long_err(long_k, ('fwd_o',))[1])
    bwd_long = _long_err(long_k, ('fused_dq', 'fused_dk', 'fused_dv'))
    bmain = next(r for r in bwd_rows if r['case'] == BWD_MAIN)
    bwd = dict(
        name='flash_attention_bwd', route='cuda',
        source='paddle_tpu_torch/csrc/flash_attention_bwd.cu',
        replaces='paddle_tpu/ops/pallas/flash_attention.py:454',
        launches=counts['flash_attention_bwd'],
        launches_by_path=dict(training=counts['flash_attention_bwd']),
        max_abs_err=max([r['max_abs_err'] for r in bwd_rows
                         if r['dtype'] == 'float32'] + [bwd_long[0]]),
        ms=bmain['ms'], plain_ms=bmain['plain_ms'],
        bound_ms=bmain['bound_ms'], bound_by=bmain['bound_by'],
        cuda_core_bound_ms=bmain['cuda_core_bound_ms'],
        library_ms=bmain['library_ms'], call_ms=bmain['call_ms'],
        plain_call_ms=bmain['plain_call_ms'],
        library_call_ms=bmain['library_call_ms'],
        shape='BH=256 T=512 D=64 float32 causal',
        long_context_shape=dict(shape=long_k['shape'],
                                library_ms=long_k['library_bwd_ms'],
                                vs_plain=dict(max_abs_err=bwd_long[0],
                                              norm_rel=bwd_long[1]),
                                **long_k['fused']),
        cases=bwd_rows)
    dense_line = dict(
        name='dense_update', route='cuda',
        source='paddle_tpu_torch/csrc/dense_update.cu',
        replaces='paddle_tpu/ops/pallas/dense_update.py:109',
        launches=(counts['dense_update'] + s2s['counts']['dense_update'] +
                  rn['counts']['dense_update'] +
                  mn['launches']['dense_update']),
        launches_by_path=dict(
            training=counts['dense_update'],
            seq2seq_training=s2s['counts']['dense_update'],
            resnet50_training=rn['counts']['dense_update'],
            mnist_training=mn['launches']['dense_update']),
        max_abs_err=dense['worst'],
        ms=dense['ms'], plain_ms=dense['plain_ms'],
        bound_ms=dense['bound_ms'], bound_by=dense['bound_by'],
        library_ms=dense['library_ms'], call_ms=dense['call_ms'],
        library_call_ms=dense['library_call_ms'], shape=dense['shape'],
        resnet_momentum=dense['resnet_momentum'],
        cases=len(dense['cases']))
    print(json.dumps({'kernels': [fwd, bwd, dense_line] + _lstm_lines(
        lstm_rows, lstm_timing, lm, sent) + _s2s_lines(
            gru_rows, gru_timing, sparse_rows, sparse_timing, s2s)
        + _split_lines(split_rows, split_timing, long_k, long_tr, parity,
                       tr)}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
