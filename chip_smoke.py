"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --long-step   # phase 26 alone, see below
    python3 chip_smoke.py --flash       # phases 1-3, 7 and 23 alone
    python3 chip_smoke.py --amp-step    # phases 44 and 46 alone
    python3 chip_smoke.py --ceiling     # phases 1, 2 (#1, #11), 62, 63
    python3 chip_smoke.py --m4          # phases 1, #5's build, 67-77
    python3 chip_smoke.py --serve       # phases 1, #1's build, 78-82
    python3 chip_smoke.py --dispatch    # phases 1, 3 and 5 alone, see below

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (nvcc).  It drives ``paddle_tpu_torch`` only (no JAX, nothing
of ``paddle_tpu``), in phases; any failure exits non-zero before the last
line:

1. environment: torch/CUDA versions, the card's name and power limit;
   TF32 is switched off for matmuls and cuDNN so float32 means float32.
2. kernel build: the ten kernel sources of the checkout (eleven kernels:
   #3 and #4 share one), one nvcc each, all started together; ptxas's
   register and spill lines; the count of tensor-core instructions (HMMA,
   HGMMA) in each kernel function's SASS (``cuobjdump -sass``), which must
   not be 0 in any instance of #1, #2, #3, #4 and #11, nor in the cluster
   chains of #7, #8, #9 and #10, nor in #8's and #10's dW kernels; #7's
   cluster chain must not spill.  The bfloat16 and float16 instances of
   #1, #2 and #3 and the bfloat16 ones of #11 (their 16-bit engines) must
   show 16-bit products (HMMA.16816) and no TF32 ones, their float32
   instances TF32 ones.
3. flash forward vs its plain version on the card at the prefill's
   shapes (BH = 8, D = 64; float32, and the causal, non-causal, ragged,
   offset and fully-masked-row cases in bfloat16 and float16), with the
   kernel, the plain version and
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
   non-causal, offset, fully-masked-row and dlse cases, each also in
   bfloat16 and float16 (and the training shape on bf16 and f16 q/k/v,
   timed beside SDPA on the same inputs and the 16-bit bounds); the
   backward's inputs (o, lse) come from the plain forward.  Both kernels
   timed at the training shape; the backward's library yardstick is the
   backward of ``F.scaled_dot_product_attention`` in device time (its
   forward and backward in one CUDA graph, less its forward; the port
   never calls it).
8. dense update vs its plain rules, bitwise, at the model's parameter
   shapes and N = 1,000,003, every rule, and the momentum rule with and
   without Nesterov at ResNet-50's 28 parameter shapes (OIHW filters from
   64x3x7x7 to 2048x512x1x1, the 1-D biases and BN vectors, the fc) and
   VGG-16's 17 (its filters, fc1's 25088 x 4096, the biases), and the
   sgd rule at SRL's 12 trainable shapes (mark_emb's 2x5 to 512x512) at
   both of its rates (0.01, and crfw's 0.01 x 1e-3); timed at
   30000 x 512 beside ``torch.optim.Adam(fused=True)`` (a yardstick
   only), both in device time and per call, and the momentum rule at
   ResNet-50's largest filter (512x512x3x3, four sets in turn so each
   call finds its data cold in L2) and at VGG-16's fc1 (1.23 GB a call)
   beside ``torch.optim.SGD(momentum=0.9, fused=True)`` (a yardstick
   only).
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
   100); then at widths 1, 8, 16 and 32 (DeepFM's 1- and 16-column
   tables among them) on uniform and Zipf ids over 1,000,003 rows (K =
   32768), on a 2-row table (the recommender's gender table: two runs of
   ~K/2), and on a 2074-row table read by four lookups, its SelectedRows
   assembled by the ``sparse_grad_assemble`` op; rows not touched must
   stay bitwise unchanged.  Timed: the kernel
   alone in device time and the whole call (sort and kernel) per call;
   at the Zipf and uniform ids also the id sort, the plain rules, and
   the whole call and ``torch.optim.SparseAdam`` / ``Adagrad`` on a
   sparse gradient and ``index_add_`` (yardsticks only, which cannot be
   captured in a CUDA graph) between CUDA events, per call over
   back-to-back calls and as the median single call; at DeepFM's tables
   (uniform ids, D=16 and D=1) the same for Adagrad alone.
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
   at every case of phase 7 and at head dims 32, 50 and 128, float32,
   bfloat16 and float16, and at lengths that are no multiple of #4's
   32-key warp halves, through their wrappers ``_fa_backward_dkv`` and
   ``_fa_backward_dq``; #3's dk and dv bitwise equal to #2's at every
   case; at every case also #2's dq and #1's o and lse against their
   plain versions (phase 7's bounds; the head-dim tiers, and in 16 bits
   the thread-staged tiles at D = 50); #3, #4 and #2 timed at the
   training shape beside the plain versions (SDPA's backward from phase
   7).
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
32. VGG-16 training at ``benchmarks/bench_vgg.py``'s float32 row
   (:35-36, :40-66, :85-89: vgg_imagenet depth 16, 1000 classes,
   224x224 NHWC, batch 128, Momentum lr 0.01 mu 0.9), uncut, through
   ``Executor.run_steps`` on one seeded batch staged on the card: a
   warm-up step, 8 timed single-step calls (p50, img/s), one 8-step call,
   then steps to 24 in all; every loss finite, the mean of the last 4
   below the mean of the first 4 (dropout 0.5 makes single losses
   noisy), and each step must launch the dense update 32 times (once per
   parameter) and no other kernel.  Reported as in phase 28.
33. VGG-16 parity at B=2, 224x224: one step on the card against the same
   program and state on the CPU, at phase 10's bounds (the loss, every
   gradient, velocity and update); the card step's dropout masks are
   fetched and handed to the CPU step, whose dropout op is replaced for
   this phase only.  Then the dropout op alone on the card at p = 0.3,
   0.4 and 0.5: the keep rate within 5 binomial deviations on 2^24
   draws, Out == X * Mask bitwise, a replay of one (step, op) drawing
   the same mask, ``is_test`` giving X * (1 - p) bitwise.
34. profile: a traced VGG-16 step, grouped as phase 30.
35. the book's VGG (``vgg16_bn_drop``, Adam 0.001) on the synthetic
   CIFAR-10 at batch 128 through ``batch`` and ``DataFeeder``, 3 epochs
   of 32 batches: each step must launch the dense update 60 times, the
   last epoch's mean loss must be below the first's, and its
   ``clone(for_test=True)`` program on the card must give the CPU's cost
   from the trained state; the clone's cost after each epoch is reported
   (at this batch it rises after the first epoch, in the reference too:
   ``BOOK_VGG``).
36. the training recipes, card against CPU at a small width (a 64 ->
   128 -> 1 net, batch 32): SGD with L2Decay (folded into the sgd op's
   weight decay: every dense update launch is that arm, and the first
   update equals the plain rule's bitwise), L1Decay (woven), the three
   gradient clips, an error clip, and each of the seven decay schedules
   driving Momentum for 12 steps, the card's rate equal to its closed
   form; each recipe's dense update launches counted.  Phases 32-36 take
   about 20 s on an H100.
   Phase 33 runs four more times: with the card's relu signs handed to
   the CPU step, with its relu signs and max-pool choices handed over
   (the gap then reads the arithmetic alone: 9.7e-6 on an H100, against
   0.86% plain), under ``torch.backends.cudnn.deterministic`` and with
   cuDNN off (``phase_vgg_parity_controls``).
37. DeepFM at ``benchmarks/bench_ctr.py``'s Criteo-class width (:318-330,
   :47-78; B=32768, 26 slots of 1,000,003-row tables, embed 16, hidden
   (128, 128), 13 dense features, Adagrad 0.01), uncut, through
   ``Executor.run_steps`` on one batch of default_rng(0) ids staged on
   the card: a warm-up step, 8 timed single-step calls (p50,
   examples/s), one 8-step call, then steps to 24; every loss finite,
   the last 4's mean below the first 4's, and each step must launch #6
   52 times (once per table) and no other kernel.  Reported: peak memory
   beside the tables' and moments' bytes.
38. profile: a traced DeepFM step, device time by group (#6, the id
   sorts, GEMMs, reductions, elementwise, the rest), idle share and #6's
   share of busy time.
39. DeepFM parity at B=256 with 100,003-row tables: one step on the card
   against the same program, state and feed on the CPU: the loss, every
   dense gradient, the tables' touched rows and Adagrad moments after
   the step (``TOL_CTR_ROWS``), untouched rows bitwise unchanged.
40. the table-height sweep of ``bench_ctr.py``:348-398 (B=16384, 8
   slots, embed 8; 100,003, 1,000,003 and 10,000,019 rows): step p50 and
   the peak less the tables' and moments' bytes at each height, which
   must not grow by more than ``CTR_SWEEP_FLAT``: no dense [height, D]
   gradient exists.
41. the book's CTR-family tests on the card through ``batch`` and
   ``DataFeeder`` with their gates: test_ctr's two archs (Adam 0.003),
   test_word2vec (SGD 0.1; one SelectedRows of four lookups) and
   test_recommender_system (SGD 0.2, ``reader.firstn``); each step must
   launch #6 once per row-sparse table and #5 once per dense parameter.
42. ``calc_gradient`` card vs CPU: with respect to the fed input of an
   fc net and with respect to an intermediate (``TOL_CALC_GRAD``).
   Phases 37-42 take about 40 s on an H100.
44. AMP: ``bench_transformer.py``:67-73's AMP row, TRAIN's float32 build
   through the pass pipeline under ``amp_guard('bf16')``, trained
   through ``run_steps`` on one staged batch (a warm-up step, 8 timed
   single-step calls, one 8-step call, 24 steps in all): the loss finite
   and falling, each step launching #1 and #2 6 times on bfloat16 q/k/v
   (``fa.dtype_launches``) and #5 78 times, the parameters float32
   masters; the pipeline's report (casts, ops lowered, pass wall).
45. AMP parity at B=2: one bf16 step on the card against the CPU's bf16
   step from the same state (``TOL_AMP_*``), the CPU's float32 step
   beside it, and a planted fault (attention's scale 1.25x on the card)
   that must read above the gradient bound.
46. profile: a traced bf16 step (GEMMs named nvjet on an H100).
47. f16 with dynamic loss scaling (``AMP_F16``): 8 clean steps (the
   scale must double), #1 and #2 on float16 q/k/v; a planted overflow
   step (the scale set to 2^31) must leave every parameter, moment and
   counter of the optimizer bitwise as it was, halve the scale and count
   one skipped step; the next clean step must move every parameter.
   Then an ``is_sparse`` 30000 x 256 table under lazy Adam in f16: a step
   whose feed carries inf must launch #6 once with every id swapped to
   the sentinel and leave the table and its moments bitwise unchanged.
48. ResNet-50 at ``bench.py``'s default build (bfloat16 activations,
   NHWC, float32 parameters and batch-norm statistics) as phase 28.
49. profile: a traced bf16 ResNet-50 step, grouped as phase 30.
50. seq2seq in ``bench_seq2seq.py``'s bfloat16 build, as phase 20 (the
   GRU ops compute in float32: #9, #10 3 each, #6 2 a step).
51. the LSTM LM in ``bench_lstm_lm.py``'s bfloat16 build, as phase 14.
   Phases 44-51 take about 15 s on an H100.
53. the remat matrix (``REMAT``; ``benchmarks/memory_report.py``:29-62
   on the port): ``bench.py``'s default ResNet-50 (bf16 NHWC) at B = 64,
   128, 256 under ``memory_optimize`` levels None, 'dots' and 'full',
   each cell a warm-up step and 3 timed single-step ``run_steps`` calls:
   the measured peak (``max_memory_allocated``), the modelled peak and
   watermark op and the modelled FLOPs a step (``last_step_report``),
   step p50, img/s, achieved TFLOP/s, #5's launches (214 a step).  At
   every batch the peak under 'full' must be below None's and under
   'dots' at most None's; first, one B=64 step under each level from
   the same state under ``cudnn.deterministic``, the loss and every
   gradient of 'dots' and 'full' against None's (ResNet-50's bounds,
   bitwise equality printed).
54. checkpoint, resume and export (``CKPT``): TRAIN's transformer with a
   logits head beside its loss, under ``memory_optimize``'s default
   'dots': 8 steps (#1, #2 6 and #5 78 a step), ``io.save_checkpoint``,
   4 more; a second uninterrupted run of 12; a fresh scope and executor
   ``load_checkpoint`` (step 8, every persistable bitwise, on the card)
   and resume 4 steps, within ``CKPT_DRIFT`` times the two uninterrupted
   runs' gap (``TOL_CKPT_FLOOR`` below); one step under None and 'full'
   (#1 6 and 12 times); ``save_inference_model`` / ``load_inference_model``
   into a fresh scope: a B=4 forward bitwise the test clone's, and the
   decode server's greedy tokens from the reloaded weights equal to the
   in-memory ones.
55. the book's MNIST convnet from record files (``RECORD_MNIST``):
   ``datasets.common.convert`` writes the synthetic train set in 8
   files, ``reader.creator.recordio`` reads it back bitwise and feeds
   ``batch`` and ``DataFeeder``; the book's gate (mean accuracy of the
   last 10 batches above 0.9 within 3 epochs).
56. the beam decode at ``bench_decode.py``:34's width (``DECODE``: B=64
   sources of length 64, V=30000, word_dim 256, H=512, beam 4, max_len
   32) in phase 20's scope, run right after phase 22 while that scope is
   on the card: ``seq2seq.decode``'s While program through
   ``run_steps(repeat=4)``, 3 timed calls after a warm-up: decode ms
   p50, generated tokens/s (B * max_len a decode) and the beam-expanded
   rate, #9's launches per decode (2, gated), peak memory, the host syncs
   of one decode under ``torch.cuda.set_sync_debug_mode('warn')`` with
   their sites (reported, not gated), a traced decode (busy, idle share,
   kernels per tick, kernels by name) and #9 at the decode's shape (T=64
   B=64 H=512, no h0, no gates) against its plain version.
57. decode parity: 8 sources of ragged lengths decoded on the card and on
   the CPU from the same weights; every hypothesis the card returns,
   rescored teacher-forced by the training program on the CPU
   (``seq2seq.rescoring_feed``), must have a summed cross entropy of
   minus its score within ``TOL_RESCORE`` relative; the share of rows
   whose ids equal the CPU's is reported.
58. the control-flow book tests on the card with their gates (``BOOK_CF``):
   machine translation (train, then decode at K=4 and K=1), the MNIST
   IfElse net, and tests/test_rnn_wrappers.py's cases (StaticRNN,
   DynamicRNN, ConditionalBlock with a nested While, IfElse).  Phases
   56-58 take about 11 s on an H100.
59. SRL training (``SRL``): ``models.srl.build`` at the book's widths
   (word 32, mark 5, hidden 512, depth 4) on the synthetic CoNLL-2005
   dicts (4427 words, 300 verbs, mark 2, 19 labels).  First the book
   test on the card (tests/book/test_label_semantic_roles.py: SGD 0.01,
   ``DataFeeder`` over the first 128 test sentences in batches of 16, 2
   epochs; every loss finite, the mean of the last 4 below 18.0); then
   256 staged sentences (lengths 5-30) through ``run_steps``, a warm-up
   and 20 timed single-step calls: step ms p50, sentences/s, tokens/s
   (the lengths' sum a step), peak memory and a traced step (busy, idle
   share, kernels, the five largest device ops).  Every step must launch
   #5 once per trainable parameter (43; ``word_emb`` is frozen) and #7
   and #8 never: the LSTMs' relu and sigmoid activations take the scan,
   as in the reference.  Then one step on the card and on the CPU from
   the same state: the loss within ``TOL_SRL_LOSS`` relative, and each
   card Viterbi path, scored on the CPU with the CPU's emissions, within
   ``TOL_SRL_VITERBI`` of the CPU's best path's score (the share of
   equal tags reported), each trainable parameter after the step within
   ``TOL_SRL_UPDATE`` of its update and ``word_emb`` bitwise unchanged.
   (Phase 8 holds #5's sgd rule bitwise at SRL's trainable shapes.)
60. the op sweep: the slice's 16 op types on the card against the CPU on
   the CPU tests' inputs (tests/torch_seqlab_cases.py): integer outputs
   exactly, float outputs and the gradients of ``linear_chain_crf``
   (emission, transition) and ``warpctc`` (logits) within
   ``TOL_SRL_OPS``; the host syncs of each case's first card call
   counted (``set_sync_debug_mode('warn')``), none allowed for the CRF,
   CTC and metric ops.
61. ``evaluator.ChunkEvaluator`` (IOB, 9 chunk types) over phase 59's
   model's Viterbi decode of the 1024-sentence test split on the card,
   and over the card's fetched paths on the CPU: precision, recall and
   F1 equal.  Phases 59-61 take about 30 s on an H100.
62. the flash ceiling probe's kernel (#11, ``ops/kernels/
   flash_ceiling.py``) against its plain version: mm, mmT, exp and maxexp
   in float32 and bf16, at logical tiles bq != bk either way, T one tile,
   head dims 128 and 33 (``CEILING_CASES``), then at the probe's default
   shape (BH=128, T=8192, D=64; its inputs, seeded normals, q and k times
   0.1) at 1024 x 1024 and 64 x 64 tiles on three bh slices; norm-relative
   at ``fc.tolerance``: 1e-5 float32, 5e-4 bf16, 1e-2 for bf16 maxexp
   at bk > 64 (its p rounds at the running max); the bf16 readings
   printed beside the earlier 3xTF32 engine's.
63. the probe's entry point (``flash_ceiling_probe.run``) at that shape,
   tiles and both types, and in bf16 at the AMP training shape (B=32,
   H=8, T=512, D=64, 64 x 64 tiles: where #1 runs on bf16 q/k/v): each
   variant and ``full`` (#1, causal) in device time, with the probe's
   ``executed_tflops``, and ``F.scaled_dot_product_attention`` (causal,
   the same bf16 q/k/v, timed as #1; a yardstick only) beside ``full``;
   the stage split (the products, + exp, + the row max, the rest of #1's
   tail; mmT - mm, the transposed k read); #11's bounds; its plain
   version timed at 1024 x 1024.  At 64 x 64 tiles bf16 mm, mmT and exp
   must each take at most 1.10x #1's ``full`` (the variants run #1's
   16-bit engine with less tail).  #11's counts are set to 0 just before
   and read just after (each variant 3 warm-up calls and ``steps``
   captured in a CUDA graph).
64. the book's GAN (tests/book/test_gan.py, ``models/gan.py``: two Adam
   ``minimize`` passes in one program) through ``DataFeeder``: 16 steps
   of B=32, every loss finite, the mean D loss of the last 4 below 1.45
   and below the first 2's; 12 #5 launches a step.
65. one GAN step on the card and on the CPU from the same state: both
   losses, every gradient (G's taken at D's pre-update parameters) and
   every update at phase 10's bounds; 12 #5 launches.
66. the book's fit_a_line (SGD, the last cost below 12.0 and below the
   first; #5 twice a step), then one step under each of Adamax,
   DecayedAdagrad, Adadelta, RMSProp and Ftrl on the card and the CPU
   (eager rules: no kernel launch): the loss and each update at phase
   10's bounds.
67. GoogLeNet (``GOOGLENET``: ``models/googlenet.py``, the image
   benchmarks' Inception-v1, B=128 224x224 float32 NCHW, Momentum 0.01 /
   0.9) through ``run_steps`` on one staged batch, 24 steps: 116 #5
   launches a step and no other kernel, the loss finite and the mean of
   the last 4 below the mean of the first 4 (dropout 0.4).
68. one GoogLeNet step at B=2, card vs CPU from the same state
   (``image_step_parity``, the card's dropout masks handed over): as it
   is, at phase 10's bounds; with the card's relu signs and max-pool
   choices handed over too, at ``TOL_M4_*``; and under each planted
   fault of ``M4_FAULTS`` (TF32 on the card; its first conv filter 0.1%
   off), which must break ``TOL_M4_*``.
69. its profile: a traced step's device time by kernel group, the top
   kernels and the idle share.
70-75. AlexNet (``ALEXNET``: B=128 224x224, 16 #5 launches a step) and
   SmallNet (``SMALLNET``: B=64 32x32, 10 classes, 10 launches) the same
   way: training, parity and profile.
76. the op library sweep: the 54 op types of the dense op library and
   the repaired ``clip`` on the card against the CPU on the CPU tests'
   inputs (tests/torch_op_library_cases.py), outputs and gradients at
   ``TOL_LIB_OPS``; ``nce`` and ``random_crop`` by their draws; no host
   sync in ``detection_output``, ``roi_pool``, ``unpool`` or the losses.
77. ``detection_output`` at SSD300's shape (8732 priors, 21 classes,
   nms_top_k 400, keep_top_k 200, batch 8): timed, no host sync, and
   equal to the CPU's output.
78. #1 as the operator ``torch.ops.paddle_tpu_torch.flash_fwd`` (what
   ``torch.export`` records) against the direct launch
   (``fa._launch_forward``), bitwise, at phase 3's serving shape and
   phase 7's training shape in float32, bf16 and f16: one launch each,
   both held against the plain version at phase 3's bounds, and the
   host time per call of each.
79. ResNet-50 serving at ``benchmarks/bench_serving.py``:40-63's width
   (``RN_SERVE``: depth 50, 224x224, 1000 classes, bf16 activations
   NHWC): ``inference.export_inference`` at batch 1, 8 and 64 (the
   prediction and, beside it, the head's logits: the softmax saturates
   at this random init), ``InferenceServer``: export, load and
   first-call seconds, latency p50 over 30 ``predict`` calls (b1, b8),
   ``predict_stacked`` img/s over a chain of 30 (b8, b64), pipelined
   ``predict_async`` img/s (b64, chain 10) and a traced pipelined chain
   (busy ms a batch, idle share).  Each artifact's outputs must equal
   ``Executor.run`` of the same pruned inference program bitwise, and
   the b1 artifact's logits the CPU artifact's within
   ``TOL_RN_SERVE_CPU``.
80. the CTR tower (``CTR_SERVE``: bench_serving.py's
   ``_build_ctr_tower``, 26 slots of 10000 x 16, 13 dense, fc
   256-128-1) behind ``BatchingInferenceServer.from_program`` at
   ``dynamic_scenario``'s settings (max_batch 64, max_wait_ms 10,
   linger_ms 0.3): closed loop (8 clients at depth 8, 960 requests,
   three rounds each beside the single-``predict`` baseline) and
   Poisson arrivals at 0.5, 1 and 2 times the baseline: req/s, speed-up,
   occupancy, p50/p99 latency (exact, over each request stamped from
   its submit to its completion; the closed loop's over its three
   rounds, with the server's histogram reading beside it), warmup s.
   ``compiles_after_warmup`` must be 0, every bucket-exact request's
   answer bitwise the unbatched predict on its bucket, every other
   answer within ``TOL_CTR_ROW_REL`` of its row's bucket-1 answer.  Then ``amp_scenario``: bucket 8
   exported at amp '0' and 'bf16', preds/s, the bf16 answers within
   ``TOL_CTR_AMP`` of the float32 ones.
81. #1 inside an artifact: the transformer LM's ``build_logits`` at the
   serving width (``LM_SERVE``: L=6, D=512, H=8, V=30000, B=8, T=512)
   exported and served: 6 launches of #1 a predict, the logits bitwise
   ``Executor.run``'s, ms a predict; and the export on the card of a
   program whose op launches a kernel through ctypes (``lstm``, #7)
   refused with a message naming the op.
82. the 24 requests of phase 4 with ``paged_attention`` reached through
   the op registry (counted) against the same requests with its body
   swapped for a direct call of its math: equal greedy tokens, and equal
   to phase 4's in the whole script; the chunked prefill through
   ``chunked_prefill_attention`` (counted) against the monolithic
   prefill's last logits at ``TOL_PATH``; the composed attention
   (``use_flash=False``, float32, TF32 off) against flash at phase 7's
   training shape within ``TOL_COMPOSED`` norm-relative.  Phases 78-82
   take about 160 s on an H100.
52. a ``{"kernels": [...]}`` line (eleven kernels, each with its launches
   by path; ``bound_ms`` at the rate of the units a kernel computes on:
   the tensor cores at 3xTF32 for #1-#4, #11 and #7-#10 (at the 16-bit
   rate for #11's bf16 rows), with their CUDA-core
   float32 bound beside it as ``cuda_core_bound_ms``; the CUDA cores for
   the rest; #1 and #2 also at the training shape on bf16 and f16 q/k/v,
   ``amp_training_shape``, with SDPA on the same inputs and the bounds
   at the 3xTF32 and the 16-bit tensor-core rates; the launches of
   phases 53-59 in ``launches_by_path``, #7's and #8's 0 on SRL among
   them; #9's time at the decode's shape as ``decode_shape``; #11's
   probe runs, its launches by variant and its plain times; the GAN's
   and fit_a_line's #5 launches; those of phases 67, 70 and 73; #1's
   inside phase 81's artifact and in phase 82's decode), printed after
   phase 82, then
   the card's line, and last ``{"ok": true, "device": {...}}``.

With ``--long-step`` the script runs phase 26 alone, in a process that
has allocated nothing before the step, and prints its record (step
times, peak memory): copied into another checkout and run there too in
the same call, it compares two trees' 128K step on one card.
"""
import contextlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import paddle_tpu_torch as tfl  # noqa: E402
from paddle_tpu_torch.inference.decode import (  # noqa: E402
    DecodeEngine, DecodeServer, _forward, extract_params)
from paddle_tpu_torch import learning_rate_decay as lrd  # noqa: E402
from paddle_tpu_torch.core import datatypes, registry  # noqa: E402
from paddle_tpu_torch.core.executor import ExecutionContext  # noqa: E402
from paddle_tpu_torch.core.registry import get_op_impl  # noqa: E402
from paddle_tpu_torch.datasets import cifar as cifar_data  # noqa: E402
from paddle_tpu_torch.datasets import mnist as mnist_data  # noqa: E402
from paddle_tpu_torch.datasets import wmt14  # noqa: E402
from paddle_tpu_torch.datasets import common as data_common  # noqa: E402
from paddle_tpu_torch.datasets import imikolov, movielens  # noqa: E402
from paddle_tpu_torch.datasets import conll05  # noqa: E402
from paddle_tpu_torch.datasets import uci_housing  # noqa: E402
from paddle_tpu_torch.models import ctr, recommender, word2vec  # noqa: E402
from paddle_tpu_torch.models import mnist, resnet, vgg  # noqa: E402
from paddle_tpu_torch.models import rnn_lm, sentiment  # noqa: E402
from paddle_tpu_torch.models import seq2seq, srl  # noqa: E402
from paddle_tpu_torch.models import fit_a_line, gan  # noqa: E402
from paddle_tpu_torch.models import alexnet, googlenet  # noqa: E402
from paddle_tpu_torch.models import smallnet  # noqa: E402
from paddle_tpu_torch.ops import loss as tloss  # noqa: E402
from paddle_tpu_torch.models import transformer as ttr  # noqa: E402
from paddle_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig, init_params)
from paddle_tpu_torch.ops.kernels import build  # noqa: E402
from paddle_tpu_torch.ops.kernels import dense_update as du  # noqa: E402
from paddle_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops.kernels import flash_ceiling as fc  # noqa: E402
from paddle_tpu_torch.ops.kernels import (  # noqa: E402
    flash_ceiling_probe as fc_probe)
from paddle_tpu_torch.ops.kernels import gru as gk  # noqa: E402
from paddle_tpu_torch.ops.kernels import lstm as lk  # noqa: E402
from paddle_tpu_torch.ops.kernels import table_update as tu  # noqa: E402
from paddle_tpu_torch.flags import ENV_PREFIX, FLAGS  # noqa: E402
from paddle_tpu_torch.transpiler import amp  # noqa: E402
from paddle_tpu_torch.core import program as tprog  # noqa: E402

SEED = 20
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s; float32 on
# the CUDA cores and bf16 on the tensor cores, FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.float16: 989e12}
# float32 at float32 accuracy on the tensor cores: 3xTF32, three TF32
# products (495 TFLOP/s) for each float32 product, as the flash kernels
# #1-#4 compute
PEAK_3XTF32 = 495e12 / 3
# kernel vs plain version: both accumulate in float32, in other orders
TOL_F32 = 1e-4
# bf16 outputs: both round the same float32 value to bf16; a different
# last float32 bit can flip one bf16 ulp (2^-7 relative at |o| < 4)
TOL_BF16_O = 3.2e-2
# float16 outputs, its counterpart: one float16 ulp at |o| < 8 (2^-8)
TOL_F16_O = 3.91e-3
# engine logits, card (kernel, cuBLAS) vs CPU (plain, CPU BLAS), float32
TOL_PATH = 1e-3
# backward kernel vs plain version, float32: dq sums by atomics in a
# run-dependent order; bf16: one bf16 ulp of an O(1) gradient
TOL_BWD_F32 = 1e-4
TOL_BWD_BF16 = 3.2e-2
TOL_BWD_F16 = 3.91e-3
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
           'flash_attention_bwd_dkv', 'flash_attention_bwd_dq',
           'flash_ceiling')
# the csrc/*.cu sources: #3 (dkv) and #4 (dq) share one
SOURCES = ('flash_attention_fwd', 'flash_attention_bwd', 'dense_update',
           'lstm_fwd', 'lstm_bwd', 'table_update', 'gru_fwd', 'gru_bwd',
           'flash_attention_bwd_split', 'flash_ceiling')
# --flash: the flash kernels #1-#4 and #11
FLASH_SOURCES = ('flash_attention_fwd', 'flash_attention_bwd',
                 'flash_attention_bwd_split', 'flash_ceiling')

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
# benchmarks/bench_vgg.py's float32 row (:85-89, build(cast_bf16=False),
# the reference's "true f32 baseline"), uncut: vgg_imagenet depth 16, 1000
# classes, 224x224x3 NHWC, batch 128, Momentum lr 0.01 mu 0.9 (:35-36,
# :40-58); one batch of default_rng(0) normal images and integer labels
# (:60-66) staged on the card and run by run_steps.  Dropout 0.5 after
# both 4096-wide fcs makes single losses noisy, so the loss check compares
# the mean of the first 4 steps with the mean of the last 4 of 24
# (tests/torch_vgg_probe.py loss: the same program on the CPU over 24
# steps fell from 6.56 to 4.87 at B=32 64x64 and from 6.91 to 5.23 at
# B=128 32x32; at B=4 224x224 every relu died at step 3, in the reference
# too, a batch 32 times smaller scaling each step's logit moves; on an
# H100 at B=128 224x224 it fell from 7.02 to 5.81; PERF.md section 6)
VGG = dict(B=128, hw=224, depth=16, classes=1000, lr=0.01, mu=0.9,
           layout='NHWC', steps=8, total_steps=24, parity_B=2)
# the book's VGG (tests/book/test_image_classification.py's vgg16_bn_drop,
# Adam 0.001) at the book's batch 128 on the synthetic CIFAR-10's 4096
# samples, 3 epochs.  That test asks its test clone's cost (dropout off,
# batch norm on the running statistics) to fall, at batch 32 over 24
# steps; at batch 128 it rises in the reference too (paddle_tpu on the
# CPU: 2.3026 -> 2.3109 -> 2.4480 -> 4.0561 after each epoch; dropout
# ahead of each batch norm trains the running variance on masked inputs,
# which the test clone does not see; PERF.md section 6).  So here the
# training loss must fall (the mean of the last epoch below the first's)
# and the card's test clone must give the CPU's cost on the trained state
# (``eval_batches`` of them, to TOL_TRAIN_LOSS); the clone's cost after
# each epoch is reported
BOOK_VGG = dict(B=128, batches=32, epochs=3, lr=0.001, eval_batches=4)
# the dropout op on the card: a keep rate within 5 binomial deviations of
# 1 - p on 2^24 draws
DROPOUT = dict(n=1 << 24, probs=(0.3, 0.4, 0.5), sigmas=5.0)
# the training recipes, card against CPU: a two-layer net (D -> H relu
# -> 1, square error) at batch B; 3 steps each, 12 under a decay
# schedule (tests/test_lr_decay.py's length).  The bounds are phase 10's
# (the loss at TOL_TRAIN_LOSS, parameters norm-relative at
# TOL_TRAIN_GRAD); a scheduled rate must equal its closed form to
# TOL_LR (the reference test's 1e-5: float32 pow, exp and division of
# one element)
RECIPE = dict(B=32, D=64, H=128, steps=3, decay_steps=12, lr=0.1)
TOL_LR = 1e-5


def _tol_o(dtype):
    return {torch.bfloat16: TOL_BF16_O, torch.float16: TOL_F16_O}.get(
        dtype, TOL_F32)


def _tol_bwd(dtype):
    return {torch.bfloat16: TOL_BWD_BF16, torch.float16: TOL_BWD_F16}.get(
        dtype, TOL_BWD_F32)


def _zero_counts():
    fa.dtype_launches.clear()
    fa.launches = fa.bwd_launches = du.launches = 0
    fa.dkv_launches = fa.dq_launches = 0
    lk.launches = lk.fwd_cluster_launches = 0
    lk.bwd_launches = lk.bwd_cluster_launches = 0
    gk.launches = gk.fwd_cluster_launches = 0
    gk.bwd_launches = gk.bwd_cluster_launches = 0
    tu.launches = fc.launches = 0
    fc.variant_launches.clear()


def _counts():
    return dict(flash_attention_fwd=fa.launches,
                flash_attention_bwd=fa.bwd_launches,
                dense_update=du.launches, lstm_fwd=lk.launches,
                lstm_bwd=lk.bwd_launches, table_update=tu.launches,
                gru_fwd=gk.launches, gru_bwd=gk.bwd_launches,
                flash_attention_bwd_dkv=fa.dkv_launches,
                flash_attention_bwd_dq=fa.dq_launches,
                flash_ceiling=fc.launches)


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
    [(kernel name, device ms, count)] for every CUDA kernel, copy and fill
    it ran, device busy ms: the time at least one of them ran, so kernels
    that overlap, as cuDNN's on its own streams do, count once)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA):
        if end is None or a >= end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    return wall, rows, busy / 1e3


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


def _hmma_kinds(sass):
    """{function: {'hmma': n, 'hmma_16bit': n, 'hmma_tf32': n}} of a
    library's ``cuobjdump -sass`` text: its tensor-core instructions
    (HMMA, HGMMA), of them the 16-bit m16n8k16 ones (HMMA.16816) and the
    TF32 ones."""
    out, fn = {}, None
    for line in sass.splitlines():
        if 'Function : ' in line:
            fn = line.split('Function : ')[1].strip()
            out[fn] = dict(hmma=0, hmma_16bit=0, hmma_tf32=0)
        elif fn and ('HMMA' in line or 'HGMMA' in line):
            out[fn]['hmma'] += 1
            out[fn]['hmma_16bit'] += 'HMMA.16816' in line
            out[fn]['hmma_tf32'] += 'TF32' in line
    return out


# the flash kernels with a 16-bit engine: their bfloat16 and float16
# instances must run 16-bit products (HMMA.16816) and no TF32 ones, their
# float32 instances the 3xTF32 engine
FLASH_16BIT = (('flash_attention_fwd', 'fa_fwd_kernel'),
               ('flash_attention_bwd', 'fa_bwd_kernel'),
               ('flash_attention_bwd_split', 'fa_bwd_dkv_kernel'),
               ('flash_ceiling', 'flash_ceiling_kernel'))


def _check_16bit_engines(kinds):
    """The instances of FLASH_16BIT by element type, and the ones that
    break the rule: a 16-bit instance (``13__nv_bfloat16``, ``6__half``
    in its mangled name) with a TF32 product or no 16-bit one, a float32
    instance (``If``) with no TF32 product."""
    rows, bad = [], []
    for lib, kernel in FLASH_16BIT:
        for fn, n in kinds.get(lib, {}).items():
            if kernel + 'I' not in fn:
                continue
            args = fn.split(kernel + 'I', 1)[1]
            dtype = ('bfloat16' if args.startswith('13__nv_bfloat16') else
                     'float16' if args.startswith('6__half') else
                     'float32' if args.startswith('f') else '?')
            rows.append(dict(kernel=_short_function(fn), dtype=dtype, **n))
            if dtype == 'float32':
                ok = n['hmma_tf32'] > 0
            else:
                ok = (dtype != '?' and n['hmma_16bit'] > 0 and
                      n['hmma_tf32'] == 0)
            if not ok:
                bad.append(rows[-1]['kernel'])
    return rows, bad


def phase_build(sources=SOURCES):
    t0 = time.perf_counter()
    build.load_all(sources)
    secs = time.perf_counter() - t0
    print("built %s in %.2f s (parallel nvcc)" % (', '.join(sources), secs))
    for name in sources:
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
    kinds = {name: _hmma_kinds(subprocess.run(
        [cuobjdump, '-sass', build.library_path(name)], capture_output=True,
        text=True, timeout=300, check=True).stdout) for name in sources}
    mma = {name: {fn: n['hmma'] for fn, n in fns.items()}
           for name, fns in kinds.items()}
    by_lib = {name: sum(fns.values()) for name, fns in mma.items()}
    print("tensor-core instructions (HMMA/HGMMA) in the SASS, by library: "
          "%s" % json.dumps(by_lib))
    print("by kernel function: %s" % json.dumps(
        {name: {_short_function(f): n for f, n in fns.items()}
         for name, fns in mma.items() if by_lib[name]}))

    def of(lib, kernel):
        return [n for f, n in mma.get(lib, {}).items() if kernel in f]
    need = {key: of(lib, kernel) for key, (lib, kernel) in dict(
        lstm_fwd_chain=('lstm_fwd', 'lstm_fwd_chain_kernel'),
        lstm_bwd_chain=('lstm_bwd', 'lstm_chain_kernel'),
        lstm_bwd_dw=('lstm_bwd', 'lstm_dw_tc_kernel'),
        gru_fwd_chain=('gru_fwd', 'gru_fwd_chain_kernel'),
        gru_bwd_chain=('gru_bwd', 'gru_chain_kernel'),
        gru_bwd_dw=('gru_bwd', 'gru_dw_kernel'),
        flash_attention_fwd=('flash_attention_fwd', 'fa_fwd_kernel'),
        flash_attention_bwd=('flash_attention_bwd', 'fa_bwd_kernel'),
        flash_attention_bwd_dkv=('flash_attention_bwd_split',
                                 'fa_bwd_dkv_kernel'),
        flash_attention_bwd_dq=('flash_attention_bwd_split',
                                'fa_bwd_dq_kernel'),
        flash_ceiling=('flash_ceiling', 'flash_ceiling_kernel')).items()
        if lib in sources}
    bad = [k for k, counts in need.items() if not counts or not all(counts)]
    if bad:
        raise SystemExit("tensor-core instructions: every instance of #1, "
                         "#2, #3, #4, #11, #7's, #8's, #9's and #10's chains "
                         "and #8's and #10's dW must show some; failing %s"
                         % bad)
    engines, bad = _check_16bit_engines(kinds)
    print("flash engines by element type (16-bit: HMMA.16816, no TF32; "
          "float32: 3xTF32): %s" % json.dumps(engines))
    if bad:
        raise SystemExit("a 16-bit flash instance runs TF32 products or no "
                         "16-bit ones, or a float32 one no TF32 ones: %s"
                         % bad)
    return mma


KERNEL_CASES = (
    # name, tq, tk, causal, dtype, q_offset, k_offset
    [('causal_T%d' % t, t, t, True, torch.float32, 0, 0)
     for t in (16, 32, 64, 128, 256)]
    + [('noncausal_T256', 256, 256, False, torch.float32, 0, 0),
       ('ragged_T200', 200, 200, True, torch.float32, 0, 0),
       ('offsets_q128_over_k256', 128, 256, True, torch.float32, 128, 0),
       ('offsets_masked_rows', 128, 128, True, torch.float32, 0, 64)]
    # #1's 16-bit engine at the same cases, in both 16-bit types
    + [(prefix + name, tq, tk, causal, dtype, qo, ko)
       for prefix, dtype in (('bf16_', torch.bfloat16),
                             ('f16_', torch.float16))
       for name, tq, tk, causal, qo, ko in (
           ('causal_T256', 256, 256, True, 0, 0),
           ('noncausal_T256', 256, 256, False, 0, 0),
           ('ragged_T200', 200, 200, True, 0, 0),
           ('offsets_q128_over_k256', 128, 256, True, 128, 0),
           ('offsets_masked_rows', 128, 128, True, 0, 64))])
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
        tol_o = _tol_o(dtype)
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
    outs = [list(st.result(timeout=1.0)) for st in streams]
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
    return eng, params, launches, outs, res


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
        wall, rows, busy = _device_kernels(fn)
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
    # #1's and #2's 16-bit engines at the same cases, in both 16-bit types
    *[(prefix + name, 8, tq, tk, causal, dtype, qo, ko, dlse)
      for prefix, dtype in (('bf16_', torch.bfloat16),
                            ('f16_', torch.float16))
      for name, tq, tk, causal, qo, ko, dlse in (
          ('causal_T256', 256, 256, True, 0, 0, False),
          ('causal_T64', 64, 64, True, 0, 0, False),
          ('ragged_T200', 200, 200, True, 0, 0, False),
          ('noncausal_T256', 256, 256, False, 0, 0, False),
          ('offsets_q128_over_k256', 128, 256, True, 128, 0, False),
          ('offsets_masked_rows_k64', 128, 128, True, 0, 64, False),
          ('dlse_causal_T128', 128, 128, True, 0, 0, True))],
    # the AMP training step's attention (phases 44-45): bf16 and f16 q/k/v
    ('train_causal_T512_BH256_bf16', 256, 512, 512, True, torch.bfloat16,
     0, 0, False),
    ('train_causal_T512_BH256_f16', 256, 512, 512, True, torch.float16, 0,
     0, False))
BWD_MAIN = 'train_causal_T512_BH256'


def _flash_16bit_timing(q, k, v, lse, do, di, scale):
    """#1 and #2 at the training shape on 16-bit q/k/v (the AMP step's
    attention) in device time, beside SDPA's forward and backward on the
    same inputs (yardsticks only), with the bounds at the 3xTF32 rate
    the kernels compute at and at the 16-bit tensor-core rate."""
    bh, tq, d = q.shape
    q4, k4, v4 = (x.view(1, bh, -1, d).clone().requires_grad_(True)
                  for x in (q, k, v))
    do4 = do.view(1, bh, tq, d)

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              scale=scale)
    both = _device_ms(lambda: torch.autograd.grad(sdpa(), (q4, k4, v4),
                                                  do4), iters=10, replays=3)
    out = dict(
        fwd_ms=_device_ms(lambda: fa._fa_forward(q, k, v, True, scale),
                          iters=10, replays=3),
        ms=_device_ms(lambda: fa._fa_backward_fused(q, k, v, lse, do, di,
                                                    True, scale),
                      iters=10, replays=3),
        library_fwd_ms=_device_ms(sdpa, iters=10, replays=3))
    out['library_ms'] = both - out['library_fwd_ms']
    bounds = _flash_bounds(bh, tq, tq, d, True, 0, 0, q.element_size())
    for key, part in (('fwd_', 'fwd'), ('', 'fused')):
        out[key + 'bound_3xtf32_ms'] = _bound(*bounds[part],
                                              peak=PEAK_3XTF32)[0]
        out[key + 'bound_16bit_tc_ms'] = _bound(*bounds[part], q.dtype)[0]
    return out


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
        tol_o = _tol_o(dtype)
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
        tol = _tol_bwd(dtype)
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
        elif name.startswith('train_'):
            row.update(_flash_16bit_timing(q, k, v, lse, do, di, scale))
            print("flash kernels on %s q/k/v at the training shape: %s"
                  % (row['dtype'], json.dumps(
                      {k: v for k, v in row.items() if k.endswith('ms')})))
        rows.append(row)
        print("fwd kernel %-26s err o %.3g lse %.3g (tol %.3g/%.3g) finite "
              "%s | bwd kernel err %.3g (tol %.3g) finite %s | %s%s"
              % (name, err_o, err_lse, tol_o, TOL_F32, fwd_finite, err, tol,
                 finite, 'ok' if row['ok'] else 'FAIL',
                 '' if 'plain_ms' not in row else
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
    layout = c.get('layout', 'NCHW')
    with tfl.program_guard(main, startup):
        _, _, _, cost, _ = resnet.build_imagenet(
            depth=c['depth'], num_classes=c['classes'],
            image_shape=((c['hw'], c['hw'], 3) if layout == 'NHWC'
                         else (3, c['hw'], c['hw'])),
            dtype=c.get('dtype', 'float32'), layout=layout)
        tfl.optimizer.MomentumOptimizer(learning_rate=c['lr'],
                                        momentum=c['mu']).minimize(cost)
    return main, startup, cost


def _vgg_programs(c=VGG):
    """bench_vgg.py's build(cast_bf16=False): vgg_imagenet NHWC, the mean
    cross entropy, Momentum."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        img = tfl.layers.data(name='img', shape=[c['hw'], c['hw'], 3],
                              dtype='float32')
        label = tfl.layers.data(name='label', shape=[1], dtype='int64')
        pred = vgg.vgg_imagenet(img, num_classes=c['classes'],
                                depth=c['depth'], layout=c['layout'])
        cost = tfl.layers.mean(x=tfl.layers.cross_entropy(input=pred,
                                                          label=label))
        tfl.optimizer.MomentumOptimizer(c['lr'], c['mu']).minimize(cost)
    return main, startup, cost


def _param_shapes(programs):
    """The distinct parameter shapes of a model: ResNet-50's 28 (4-D OIHW
    filters from 64x3x7x7 to 2048x512x1x1, the 1-D conv biases and BN
    vectors, the fc's 2048 x 1000 and 1000); VGG-16's 21 (its 13 filters
    from 64x3x3x3 to 512x512x3x3, fc1's 25088 x 4096, fc2's 4096 x 4096,
    the head's 4096 x 1000, the biases)."""
    main, _, _ = programs()
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
    for model, programs in (('resnet50', _resnet_programs),
                            ('vgg16', _vgg_programs)):
        for shape in _param_shapes(programs):
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
                                    bitwise=same, model=model))
            del p, m, g, want, got
    # SRL's trainable shapes (mark_emb's 2 x 5 to the LSTMs' 512 x 2048)
    # under its sgd rule at both of its rates: SGD 0.01, and crfw's 0.01
    # scaled by mix_hidden_lr on the card, as the scale op makes it
    srl_lr = torch.tensor([SRL['lr']], device='cuda')
    for shape in _srl_trainable_shapes():
        p, g = (torch.randn(shape, generator=gen, device='cuda')
                for _ in range(2))
        for rate in (srl_lr, srl_lr * srl.mix_hidden_lr):
            want = _dense_call('sgd', p, None, None, g, rate, plain=True)
            got = _dense_call('sgd', p.clone(), None, None, g, rate,
                              plain=False)
            torch.cuda.synchronize()
            same = torch.equal(got[0], want[0])
            worst = max(worst, float((got[0] - want[0]).abs().max()))
            results.append(dict(shape=list(shape), rule='sgd',
                                lr=float(rate), bitwise=same, model='srl'))
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
    # fc1 of VGG-16 (25088 x 4096): 1.23 GB a call, cold in L2 by itself
    t['vgg_fc1_momentum'] = _momentum_timing(gen, lr, (25088, 4096), 1)
    print("dense kernel timing: %s" % json.dumps(t))
    return dict(worst=worst, cases=results, **t)


def _momentum_timing(gen, lr, shape=(512, 512, 3, 3), copies=4):
    """The momentum rule at ``shape`` (ResNet-50's largest conv filter,
    512 x 512 x 3 x 3, by default), beside ``torch.optim.SGD(momentum=0.9,
    fused=True)`` (the same rule: v = mu v + g, p -= lr v; a yardstick
    only).  Each timed call takes the next of ``copies`` sets of (param,
    velocity, grad) (four of ResNet-50's filter, 188 MB in all), so that
    a call finds its data cold in the 50 MB L2, as a training step's
    applies do."""
    sets = [[torch.randn(shape, generator=gen, device='cuda') * 1e-2
             for _ in range(3)] for _ in range(copies)]

    def cycling(fn):
        turn = [0]

        def call():
            fn(*sets[turn[0] % copies])
            turn[0] += 1
        return call
    t = dict(
        shape='momentum %s float32, %d copies in turn'
        % (' x '.join(map(str, shape)), copies),
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
    wall, rows, busy = _device_kernels(step)
    top = sorted(rows, key=lambda r: -r[1])[:10]

    def by(tag):
        return sum(ms for k, ms, _ in rows if re.search(tag, k))
    out = dict(wall_ms=wall, device_busy_ms=busy if rows else None,
               idle_share=1.0 - busy / wall if rows else None,
               kernels=sum(n for *_, n in rows),
               flash_fwd_ms=by('fa_fwd_kernel'),
               flash_bwd_ms=by('fa_bwd_kernel') + by('fa_bwd_dq_finish'),
               flash_bwd_dkv_ms=by('fa_bwd_dkv_kernel'),
               flash_bwd_dq_ms=by('fa_bwd_dq_kernel'),
               dense_update_ms=by('dense_update_kernel'),
               # cuBLAS's GEMMs: sgemm and CUTLASS kernels, and the bf16
               # ones named nvjet on an H100
               gemm_ms=by('gemm|nvjet|cutlass'),
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
    _, rows, _ = _device_kernels(lambda: [fn() for _ in range(calls)])
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


def _lm_programs(hidden=LM['H'], dtype='float32'):
    c = LM
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        _, _, cost = rnn_lm.build(vocab_size=c['V'], emb_dim=c['E'],
                                  hidden_dim=hidden, num_layers=c['L'],
                                  dtype=dtype)
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


def phase_lm_training(dtype='float32', label='lm training'):
    c = LM
    main, startup, cost = _lm_programs(dtype=dtype)
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
    res = dict(config='B=%d T=%d V=%d E=%d H=%d L=%d %s Adagrad lr %g'
               % (c['B'], c['T'], c['V'], c['E'], c['H'], c['L'], dtype,
                  c['lr']),
               params=n_params, adagrad_ops=n_adagrad, losses=losses,
               step_ms=step_ms, step_ms_p50=p50,
               tokens_per_s=c['B'] * c['T'] / (p50 / 1e3),
               launches=counts, launches_per_step=per_step,
               cluster_launches=cluster,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    print("%s: %s" % (label, json.dumps(res)))
    want = _want(lstm_fwd=c['L'], lstm_bwd=c['L'])
    if per_step != want:
        raise SystemExit("launches per step %s, want %s" % (per_step, want))
    _all_on_cluster_path(label, counts, cluster)
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
    wall, rows, busy = _device_kernels(step)
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
# phase 19's cases at the CTR family's widths (DeepFM's 1- and 16-column
# tables, 8, and the recommender's 32) on DeepFM's uniform ids over its
# 1,000,003 rows, on Zipf ids over them, on the recommender's 2-row
# gender table (every slot on one of two ids: two runs of ~K/2), and on
# word2vec's shared table (dict 2074) read by four lookups, its
# SelectedRows assembled by the sparse_grad_assemble op from four (ids,
# gradient) pairs
NARROW_D = (1, 8, 16, 32)
NARROW_IDS = dict(uniform=(1000003, 32768), zipf=(1000003, 32768),
                  gender=(2, 4096), shared=(2074, 4 * 8192))


def _sparse_inputs(dist, rng, gen, k, height, d):
    """(ids, values) of one case of phase 19; the shared table's come from
    the sparse_grad_assemble op over four lookups' ids and output
    gradients."""
    if dist == 'shared':
        parts = [torch.as_tensor(data_common.zipf_seq(rng, k // 4, height)
                                 .reshape(-1, 1), device='cuda')
                 for _ in range(4)]
        grads = [torch.randn((k // 4, 1, d), generator=gen, device='cuda')
                 for _ in range(4)]
        sr = get_op_impl('sparse_grad_assemble').compute(
            None, {'Ids': parts, 'OutGrad': grads}, {'height': height})
        return sr['Out'][0].rows, sr['Out'][0].values
    ids = torch.as_tensor(_sparse_ids(dist, rng, k, height), device='cuda')
    return ids, torch.randn((k, d), generator=gen, device='cuda')


def _sparse_ids(dist, rng, k, height):
    if dist == 'zipf':   # the synthetic WMT14 source ids
        return 3 + wmt14.zipf_seq(rng, k, height - 3)
    if dist == 'uniform':   # bench_seq2seq.py's and bench_ctr.py's ids
        return rng.integers(1, height, k)
    if dist == 'single':   # every slot on one id
        return np.full(k, int(rng.integers(0, height)))
    if dist == 'gender':   # the recommender's 2-row table
        return rng.integers(0, height, k)
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


def _sparse_cases():
    """(label, ids, height, K, D, timed rules, full timing) of phase 19:
    seq2seq's table at its ids, the straddling ids at their widths, and
    the CTR family's widths (``NARROW_D``) at its ids (``NARROW_IDS``),
    timed at DeepFM's tables (uniform ids, Adagrad, D=16 and D=1)."""
    s2s = (S2S['V'], S2S['B'] * S2S['T'])
    rules = tuple(SPARSE_RULES)
    cases = [(dist, dist) + s2s + (S2S['word_dim'],
                                   () if dist == 'edge' else rules,
                                   dist in ('zipf', 'uniform'))
             for dist in ('zipf', 'uniform', 'edge', 'single')]
    cases += [('straddle_d%d' % d, 'straddle') + s2s + (d, rules, False)
              for d in STRADDLE_D]
    for d in NARROW_D:
        for dist, (height, k) in NARROW_IDS.items():
            timed = dist == 'uniform' and d in (1, 16)
            cases.append(('ctr_%s_d%d' % (dist, d), dist, height, k, d,
                          ('adagrad',) if timed else (), timed))
    return cases


def phase_sparse_kernel():
    """Kernel #6 against its plain rules, bitwise, on the same inputs; rows
    no id touches stay bitwise unchanged.  Ids: the training path's Zipf
    ids, the bench's uniform ids, edge ids (sentinels, out-of-range and
    negative), every slot on one id, and runs straddling every edge of the
    kernel's design at two widths (``STRADDLE_RUNS``, ``STRADDLE_D``); and
    at the CTR family's widths, its uniform and Zipf ids, its 2-row table
    and its shared table (``_sparse_cases``).  Times, keyed by case, then
    rule: the kernel alone and the whole call, and where the timing is
    full the id sort, the plain rules and the library call too."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 16)
    rng = np.random.default_rng(SEED + 16)
    lr = torch.tensor([1e-2], device='cuda')
    rows_out, timing = [], {}
    for label, dist, height, k, d, timed, full in _sparse_cases():
        ids, vals = _sparse_inputs(dist, rng, gen, k, height, d)
        k = int(ids.numel())
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
                ids=label, rule=rule, K=k, D=d, height=height,
                n_unique=n_unique,
                bitwise=all(torch.equal(a, b) for a, b in zip(got, want)),
                untouched_unchanged=all(
                    torch.equal(a[~touched], b[~touched])
                    for a, b in zip(got, state)),
                max_abs_err=max(_max_err(a, b) for a, b in zip(got, want)),
                finite=all(bool(torch.isfinite(a).all()) for a in got))
            row['ok'] = (row['bitwise'] and row['untouched_unchanged'] and
                         row['finite'])
            if rule in timed:
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
                timing.setdefault(label, {})[rule] = row
            if rule in timed and full:
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


def _s2s_programs(fuse=True, hidden=S2S['H'], dtype='float32'):
    c = S2S
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        _, _, _, pred, cost = seq2seq.build(
            dict_size=c['V'], word_dim=c['word_dim'], hidden_dim=hidden,
            fuse_vocab_loss=fuse, dtype=dtype)
        tfl.optimizer.AdamOptimizer(c['lr']).minimize(cost)
    return main, startup, pred, cost


def phase_s2s_training(dtype='float32', label='seq2seq training'):
    c = S2S
    main, startup, pred, cost = _s2s_programs(dtype=dtype)
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
    res = dict(config='B=%d T=%d V=%d word_dim=%d H=%d %s Adam lr %g, '
               'synthetic WMT14 (Zipf source ids)'
               % (c['B'], c['T'], c['V'], c['word_dim'], c['H'], dtype,
                  c['lr']),
               params=n_params, adam_ops=n_adam, losses=losses,
               step_ms=step_ms, step_ms_p50=p50,
               target_tokens_per_s=c['B'] * c['T'] / (p50 / 1e3),
               launches=counts, launches_per_step=per_step,
               gru_cluster_launches=cluster_launches,
               skipped_op_types=skipped[-1],
               max_memory_allocated=torch.cuda.max_memory_allocated())
    print("%s: %s" % (label, json.dumps(res)))
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
    wall, rows, busy = _device_kernels(step)
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
    ('f16_d128_causal_T256', 4, 256, 256, True, torch.float16, 0, 0,
     False, 128),
    # the 16-bit engines' other head-dim tiers and their thread-staged
    # tiles (D = 50: rows of 100 bytes, no 16-byte cp.async)
    *[(prefix + name, 4, tq, tk, causal, dtype, qo, ko, dlse, d)
      for prefix, dtype in (('bf16_', torch.bfloat16),
                            ('f16_', torch.float16))
      for name, tq, tk, causal, qo, ko, dlse, d in (
          ('d128_ragged_T200', 200, 200, True, 0, 0, True, 128),
          ('d32_offsets_masked_tiles', 192, 320, True, 0, 128, False, 32),
          ('d50_noncausal_T130', 130, 130, False, 0, 0, False, 50),
          ('d50_causal_dlse_T200', 200, 200, True, 0, 0, True, 50),
          ('ragged_q100_over_k170', 100, 170, True, 70, 0, True, 64))],
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
        fused_dq, fused_dk, fused_dv = fa._fa_backward_fused(*args)
        ref_dk, ref_dv = fa._plain_backward_dkv(*args)
        ref_dq = fa._plain_backward_dq(*args)
        # #1 at the same case (its head-dim tiers and, in 16 bits, its
        # thread-staged tiles at D = 50)
        o_k, lse_k = fa._fa_forward(q, k, v, causal, scale, qo, ko)
        torch.cuda.synchronize()
        err = dict(dq=_max_err(dq, ref_dq), dk=_max_err(dk, ref_dk),
                   dv=_max_err(dv, ref_dv),
                   fused_dq=_max_err(fused_dq, ref_dq))
        fwd_err = dict(o=_max_err(o_k, o), lse=_max_err(lse_k, lse))
        tol_o = _tol_o(dtype)
        finite = all(bool(torch.isfinite(a).all())
                     for a in (dq, dk, dv, fused_dq, o_k))
        bitwise = bool(torch.equal(dk, fused_dk) and
                       torch.equal(dv, fused_dv))
        tol = _tol_bwd(dtype)
        row = dict(case=name, bh=bh, tq=tq, tk=tk, d=d, causal=causal,
                   dtype=str(dtype).replace('torch.', ''), q_offset=qo,
                   k_offset=ko, dlse=with_dlse, err=err, tol=tol,
                   fwd_err=fwd_err, fwd_tol=dict(o=tol_o, lse=TOL_F32),
                   finite=finite, dk_dv_bitwise_equal_fused=bitwise,
                   ok=(finite and bitwise and max(err.values()) <= tol and
                       fwd_err['o'] <= tol_o and fwd_err['lse'] <= TOL_F32))
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


def _image_feed(batch, seed, c=RESNET):
    """bench.py:222-224 and bench_vgg.py:60-66: normal images and integer
    labels from default_rng(seed), as host arrays, in ``c``'s layout."""
    rng = np.random.default_rng(seed)
    hw = c['hw']
    shape = (batch, hw, hw, 3) if c.get('layout') == 'NHWC' else \
        (batch, 3, hw, hw)
    images = rng.normal(size=shape).astype(np.float32)
    labels = rng.integers(0, c['classes'], size=(batch, 1)).astype(np.int32)
    return {'img': images, 'label': labels}


def _conv_fc_flops(main, batch):
    """Float32 flops of one step's convs and fcs from the program's
    shapes: 2 * B * C_out * H_out * W_out * C_in/groups * kh * kw a conv
    forward (2 * B * K * N an fc), the backward twice that (dx and dW),
    but for the first conv's dx, which the image does not need."""
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


def _image_training(c, programs, config):
    """Train ``programs()`` at ``c``'s batch through run_steps on one batch
    staged on the card: a warm-up step, ``c['steps']`` timed single-step
    calls, one ``c['steps']``-step call, then steps to ``total_steps`` in
    all.  Returns the readings, the program, executor and scope; the
    phases judge them."""
    main, startup, cost = programs(c)
    n_apply = sum(op.type in ('momentum', 'adam', 'sgd')
                  for op in main.global_block().ops)
    exe = tfl.Executor()
    scope = tfl.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    n_params = sum(scope.get(p.name).numel() for p in main.all_parameters())
    feed = {k: torch.from_numpy(v).cuda()
            for k, v in _image_feed(c['B'], 0, c).items()}
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
    p50 = float(np.median(step_ms))
    flops = _conv_fc_flops(main, c['B'])
    bound_ms, bound_by = _bound(0, flops['step'], datatypes.as_torch_dtype(
        c.get('dtype', 'float32')))
    res = dict(
        config=config, params=n_params, apply_ops=n_apply,
        startup_s=startup_s, warmup_ms=warm_ms, step_ms=step_ms,
        step_ms_p50=p50, img_per_s=c['B'] / (p50 / 1e3),
        run_steps_8_ms_per_step=run_ms / c['steps'],
        img_per_s_run_steps_8=c['B'] / (run_ms / c['steps'] / 1e3),
        steps=len(losses), losses=losses, launches=counts,
        launches_per_step={k: n / len(losses) for k, n in counts.items()},
        conv_fc_tflop=flops['step'] / 1e12,
        conv_fc_forward_tflop=flops['forward'] / 1e12,
        conv_fc_bound_ms=bound_ms, conv_fc_bound_by=bound_by,
        bound_share_of_p50=bound_ms / p50,
        cudnn_benchmark=torch.backends.cudnn.benchmark,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        memory_allocated_at_start=allocated_at_start)
    return dict(main=main, startup=startup, cost=cost, scope=scope,
                exe=exe, feed=feed, counts=counts, **res)


def _printable(res):
    return {k: v for k, v in res.items()
            if k not in ('main', 'startup', 'cost', 'scope', 'exe', 'feed',
                         'counts')}


def phase_resnet_training(c=RESNET, label='resnet50 training'):
    """ResNet-50 at bench.py's width trained through run_steps on one
    batch staged on the card (``_image_training``, 40 steps); each step
    must launch the dense update once per parameter (214) and no other
    kernel, and the last loss must be below the first."""
    rn = _image_training(
        c, _resnet_programs,
        'ResNet-50 B=%d %dx%d %s %s Momentum lr %g mu %g, run_steps on '
        'one staged batch' % (c['B'], c['hw'], c['hw'],
                              c.get('layout', 'NCHW'),
                              c.get('dtype', 'float32'), c['lr'], c['mu']))
    print("%s: %s" % (label, json.dumps(_printable(rn))))
    losses = rn['losses']
    if rn['apply_ops'] != 214:
        raise SystemExit("program has %d momentum ops, want 214"
                         % rn['apply_ops'])
    if rn['launches_per_step'] != _want(dense_update=214):
        raise SystemExit("launches per step %s, want 214 dense updates"
                         % rn['launches_per_step'])
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit("loss not finite or not falling: %s" % losses)
    return rn


def phase_vgg_training(c=VGG):
    """VGG-16 at bench_vgg.py's float32 row trained through run_steps on
    one batch staged on the card (``_image_training``, 24 steps); each
    step must launch the dense update once per parameter (32: 16 weights,
    16 biases) and no other kernel; every loss finite, the mean of the
    last 4 below the mean of the first 4 (dropout makes single losses
    noisy)."""
    vg = _image_training(
        c, _vgg_programs,
        'VGG-16 B=%d %dx%d NHWC float32 Momentum lr %g mu %g, run_steps '
        'on one staged batch' % (c['B'], c['hw'], c['hw'], c['lr'],
                                 c['mu']))
    n_params = len(vg['main'].all_parameters())
    vg['first4_mean'] = float(np.mean(vg['losses'][:4]))
    vg['last4_mean'] = float(np.mean(vg['losses'][-4:]))
    print("vgg16 training: %s" % json.dumps(_printable(vg)))
    if n_params != 32 or vg['apply_ops'] != n_params:
        raise SystemExit("VGG-16 has %d parameters and %d momentum ops, "
                         "want 32 each" % (n_params, vg['apply_ops']))
    if vg['launches_per_step'] != _want(dense_update=n_params):
        raise SystemExit("launches per step %s, want 32 dense updates"
                         % vg['launches_per_step'])
    if not all(np.isfinite(vg['losses'])) or \
            not vg['last4_mean'] < vg['first4_mean']:
        raise SystemExit("VGG-16 loss not finite or not falling: %s"
                         % vg['losses'])
    return vg


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
    feed = _image_feed(c['parity_B'], seed, c)
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


def phase_image_profile(rn, label='resnet50 profile'):
    """A traced step of an image model (run_steps, one step), apart from
    the timed ones: device time by kernel, grouped by name: cuDNN's and
    cuBLAS's convolution and GEMM kernels, the dense update (#5), the
    pooling kernels, torch's reductions (the batch norms' statistics and
    backward sums, the loss), elementwise kernels (the batch norms'
    passes, bias adds, relus, residual adds, dropout's masks and
    products, copies, fills), and the rest under ``other``.  The convs'
    and fcs' rate is their flops over the matched conv and GEMM time
    alone."""
    def step():
        rn['exe'].run_steps(rn['main'], feed=rn['feed'],
                            fetch_list=[rn['cost']], scope=rn['scope'],
                            repeat=1)
    wall, rows, busy = _device_kernels(step)
    groups = {'conv_and_gemm': 0.0, 'dense_update': 0.0, 'pooling': 0.0,
              'reduction': 0.0, 'elementwise': 0.0, 'other': 0.0}
    other = []
    for k, ms, n in rows:
        if 'dense_update_kernel' in k:
            groups['dense_update'] += ms
        elif 'pool' in k:
            groups['pooling'] += ms
        elif re.search(r'xmma|gemm|cudnn|wgrad|dgrad|fprop|cutlass|convolve'
                       r'|fft|complex|flip_filter', k):
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
               kernel_ms_sum=sum(ms for _, ms, _ in rows),
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
    print("%s: %s" % (label, json.dumps(out)))
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


def _dropout_masks(main):
    """{op position: Mask name} of a program's dropout ops."""
    return {i: op.output('Mask')[0]
            for i, op in enumerate(main.global_block().ops)
            if op.type == 'dropout'}


def phase_vgg_parity(vg, c=VGG, seed=SEED + 40, label='vgg16 parity',
                     handoff=()):
    """One VGG-16 step at B=2, 224x224, on the card and on the CPU from the
    same state (``image_step_parity``): the loss, every gradient, velocity
    and update, held to phase 10's bounds."""
    res = image_step_parity(vg, c, seed, handoff)
    print("%s: %s" % (label, json.dumps(res)))
    if res['nonfinite'] or res['bad']:
        raise SystemExit("VGG-16 step on the card disagrees with the CPU "
                         "(%s) or is not finite (%s)"
                         % (res['bad'], res['nonfinite']))
    if {k: float(n) for k, n in res['launches'].items()} != _want(
            dense_update=res['params']):
        raise SystemExit("VGG-16 parity step launched %s"
                         % res['launches'])
    return res


@contextlib.contextmanager
def _card_fault(fault, card_scope, main):
    """A fault planted in the card's side of a parity step only, to show
    what a bound separates: 'tf32' runs the card's convolutions and
    products in TF32; 'filter_1e-3' scales the card's first conv filter
    by 1 + 1e-3 before the step (a state 0.1% off in one parameter)."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if fault == 'tf32':
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    elif fault == 'filter_1e-3':
        w = next(op.input('Filter')[0] for op in main.global_block().ops
                 if op.type == 'conv2d')
        card_scope.set(w, card_scope.get(w) * (1 + 1e-3))
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def image_step_parity(vg, c, seed, handoff=(), fault=None,
                      tol_grad=TOL_TRAIN_GRAD, tol_loss=TOL_TRAIN_LOSS):
    """One step of an image model (``vg``: an ``_image_training`` run) at
    B = c['parity_B'] on the card and on the CPU from the same state: the
    loss, every gradient, velocity and update, held to ``tol_grad`` and
    ``tol_loss``; returns the readings, the quantities past their bound
    under ``bad``.  The two devices' generators draw different masks,
    so the card step's ``Mask`` outputs are fetched and the CPU step's
    dropout op is replaced, for this step only, by one that applies
    them.  Reported: the relu inputs whose sign differs between the two
    sides (``relu_flips``, by relu).  ``handoff`` names the gating ops
    whose card decisions the CPU step takes too: 'relu' gates its input
    with the card's signs (x * (card's x > 0)); 'pool2d' takes each max
    of a max pool from the position the card's max came from
    (``F.max_pool2d``'s indices on the card's input; average pools
    decide nothing and run as they are).  With both, the two sides
    decide alike wherever their inputs differ by rounding, and the gap
    left is the arithmetic's alone.  ``fault`` plants a fault in the
    card's side (``_card_fault``)."""
    main, cost = vg['main'], vg['cost']
    card_scope = tfl.Scope()
    vg['exe'].run(vg['startup'], scope=card_scope)
    params = [p.name for p in main.all_parameters()]
    velocity = {op.input('Param')[0]: op.input('Velocity')[0]
                for op in main.global_block().ops if op.type == 'momentum'}
    cpu_scope = tfl.Scope()
    for v in main.list_vars():
        if v.persistable and card_scope.has(v.name):
            cpu_scope.set(v.name, card_scope.get(v.name).to('cpu',
                                                             copy=True))
    before = {n: cpu_scope.get_numpy(n).copy() for n in params}
    feed = _image_feed(c['parity_B'], seed, c)
    fetch = [cost.name] + [n + '@GRAD' for n in params]
    masks = _dropout_masks(main)
    # each relu's input: where the two sides' signs differ the relu gates
    # differently, and every gradient below it moves (PR 15's finding)
    relus = {i: op.input('X')[0]
             for i, op in enumerate(main.global_block().ops)
             if op.type == 'relu'}
    pools = {i: op for i, op in enumerate(main.global_block().ops)
             if op.type == 'pool2d' and
             op.attrs.get('pooling_type', 'max') == 'max' and
             not op.attrs.get('global_pooling')}
    gates = list(relus.values())
    pool_ins = [op.input('X')[0] for op in pools.values()]
    t0 = time.perf_counter()
    with _card_fault(fault, card_scope, main):
        _zero_counts()
        card = vg['exe'].run(main, feed=feed,
                             fetch_list=fetch + list(masks.values()) +
                             gates + pool_ins, scope=card_scope)
        counts = _counts()
    drawn = {i: torch.from_numpy(m) for i, m in
             zip(masks, card[len(fetch):len(fetch) + len(masks)])}
    card_gates = card[len(fetch) + len(masks):][:len(gates)]
    signs = {i: torch.from_numpy(g > 0) for i, g in zip(relus, card_gates)}
    argmax = {}
    for (i, op), x in zip(pools.items(), card[len(fetch) + len(masks)
                                              + len(gates):]):
        xn = torch.from_numpy(x)
        if op.attrs.get('data_format', 'NCHW') == 'NHWC':
            xn = xn.permute(0, 3, 1, 2)
        argmax[i] = F.max_pool2d(xn, op.attrs['ksize'], op.attrs['strides'],
                                 op.attrs['paddings'],
                                 return_indices=True)[1]
    impl = get_op_impl('dropout')
    relu_impl, pool_impl = get_op_impl('relu'), get_op_impl('pool2d')
    plain, plain_relu, plain_pool = (impl.compute, relu_impl.compute,
                                     pool_impl.compute)

    def replay(ctx, ins, attrs):
        x = ins['X'][0]
        m = drawn[ctx.op_index].to(x.device, x.dtype)
        return {'Out': [x * m], 'Mask': [m]}

    def card_gated_relu(ctx, ins, attrs):
        x = ins['X'][0]
        return {'Out': [x * signs[ctx.op_index].to(x.device, x.dtype)]}

    def card_argmax_pool(ctx, ins, attrs):
        if ctx.op_index not in argmax:
            return plain_pool(ctx, ins, attrs)
        x, idx = ins['X'][0], argmax[ctx.op_index]
        nhwc = attrs.get('data_format', 'NCHW') == 'NHWC'
        xn = x.permute(0, 3, 1, 2) if nhwc else x
        y = xn.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        return {'Out': [y.permute(0, 2, 3, 1) if nhwc else y]}

    impl.compute = replay
    if 'relu' in handoff:
        relu_impl.compute = card_gated_relu
    if 'pool2d' in handoff:
        pool_impl.compute = card_argmax_pool
    try:
        cpu = tfl.Executor('cpu').run(main, feed=feed,
                                      fetch_list=fetch + gates,
                                      scope=cpu_scope)
    finally:
        impl.compute, relu_impl.compute, pool_impl.compute = (
            plain, plain_relu, plain_pool)
    secs = time.perf_counter() - t0
    flips = [int(((a > 0) != (b > 0)).sum()) for a, b in
             zip(card_gates, cpu[len(fetch):])]
    nonfinite = [n for n, a in zip(['loss'] + fetch[1:], card)
                 if not np.isfinite(a).all()]
    gaps = {'grad': [], 'velocity': [], 'update': []}
    for n, g_card, g_cpu in zip(params, card[1:], cpu[1:]):
        v_card = card_scope.get_numpy(velocity[n])
        p_card = card_scope.get_numpy(n)
        for name, a in ((velocity[n], v_card), (n, p_card)):
            if not np.isfinite(a).all():
                nonfinite.append(name)
        gaps['grad'].append((_norm_rel(g_card, g_cpu), n))
        gaps['velocity'].append((_norm_rel(
            v_card, cpu_scope.get_numpy(velocity[n])), n))
        gaps['update'].append((_norm_rel(
            p_card - before[n], cpu_scope.get_numpy(n) - before[n]), n))
    loss_err = abs(float(card[0][0]) - float(cpu[0][0]))
    worst = {k: max(v, key=lambda x: (np.nan_to_num(x[0], nan=np.inf), x[1]))
             for k, v in gaps.items()}
    bad = [k for k, (e, _) in worst.items() if not e <= tol_grad]
    if not loss_err <= tol_loss:
        bad.append('loss')
    res = dict(batch=c['parity_B'], seed=seed, handoff=list(handoff),
               fault=fault, params=len(params),
               loss_card=float(card[0][0]),
               loss_cpu=float(cpu[0][0]), loss_err=loss_err,
               norm_rel_err={k: e for k, (e, _) in worst.items()},
               median_norm_rel={k: float(np.median([e for e, _ in v]))
                                for k, v in gaps.items()},
               largest_gaps={k: [dict(name=n, norm_rel=e) for e, n in
                                 sorted(v, reverse=True)[:3]]
                             for k, v in gaps.items()},
               masks={masks[i]: float(m.float().mean())
                      for i, m in drawn.items()},
               relu_flips=flips, relu_inputs=sum(
                   int(a.size) for a in cpu[len(fetch):]),
               nonfinite=nonfinite, seconds=secs, launches=counts,
               tol=dict(loss=tol_loss, grad=tol_grad, velocity=tol_grad,
                        update=tol_grad),
               bad=bad)
    return res


def phase_vgg_parity_controls(vg):
    """Phase 33's parity step again, once under
    ``torch.backends.cudnn.deterministic`` and once with cuDNN off (the
    convs on torch's own CUDA kernels), flags restored after: which of
    cuDNN's choices the card-vs-CPU gap comes from."""
    out = {}
    flags = torch.backends.cudnn
    for name, attr in (('cudnn_deterministic', 'deterministic'),
                       ('cudnn_disabled', 'enabled')):
        old = getattr(flags, attr)
        setattr(flags, attr, attr == 'deterministic')
        try:
            res = phase_vgg_parity(vg, label='vgg16 parity, ' + name)
        finally:
            setattr(flags, attr, old)
        out[name] = dict(norm_rel_err=res['norm_rel_err'],
                         median_norm_rel=res['median_norm_rel'],
                         loss_err=res['loss_err'],
                         relu_flips=res['relu_flips'])
    return out


def phase_dropout_op(c=DROPOUT):
    """The dropout op alone on the card: at each p the keep rate within
    ``sigmas`` binomial deviations of 1 - p, Out == X * Mask bitwise and
    Mask 0 or 1, a replay of the same (step, op) drawing the same mask
    bitwise and the next step another; ``is_test`` gives X * (1 - p)
    bitwise and a Mask of ones."""
    compute = get_op_impl('dropout').compute
    prog = tfl.Program()
    gen = torch.Generator(device='cuda').manual_seed(SEED + 41)
    x = torch.randn(c['n'], generator=gen, device='cuda')
    rows, bad = [], []

    def run(p, step, is_test=False):
        ctx = ExecutionContext(prog, prog.global_block(),
                               torch.device('cuda'), SEED, step)
        ctx.op_index = 7
        outs = compute(ctx, {'X': [x]}, {'dropout_prob': p,
                                         'is_test': is_test, 'seed': 0})
        return outs['Out'][0], outs['Mask'][0]

    for p in c['probs']:
        out, mask = run(p, 0)
        keep = float(mask.mean())
        sigma = (p * (1 - p) / c['n']) ** 0.5
        row = dict(p=p, keep_rate=keep, deviations=(keep - (1 - p)) / sigma,
                   out_is_x_times_mask=bool(torch.equal(out, x * mask)),
                   mask_binary=bool(((mask == 0) | (mask == 1)).all()),
                   replay_same=bool(torch.equal(mask, run(p, 0)[1])),
                   next_step_other=not torch.equal(mask, run(p, 1)[1]))
        t_out, t_mask = run(p, 0, is_test=True)
        row['is_test_bitwise'] = bool(torch.equal(t_out, x * (1.0 - p)) and
                                      bool((t_mask == 1).all()))
        rows.append(row)
        if abs(row['deviations']) > c['sigmas'] or not all(
                v for k, v in row.items() if isinstance(v, bool)):
            bad.append(p)
    print("dropout op: %s" % json.dumps(rows))
    if bad:
        raise SystemExit("dropout op on the card is wrong at p = %s" % bad)
    return rows


def book_vgg(c=BOOK_VGG, place=None):
    """The book's VGG (vgg16_bn_drop, Adam) on the synthetic CIFAR-10
    through ``batch`` and ``DataFeeder`` on ``place`` (None: the card):
    the cost of its ``clone(for_test=True)`` program (dropout off, batch
    norm on the running statistics) over the training batches before
    training and after each epoch, the training losses, the dense
    update's launches over the training, and what a caller needs to run
    the test clone again (executor, scope, feeder, batches)."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        images = tfl.layers.data(name='pixel', shape=[3, 32, 32],
                                 dtype='float32')
        label = tfl.layers.data(name='label', shape=[1], dtype='int64')
        predict = vgg.vgg16_bn_drop(images)
        avg_cost = tfl.layers.mean(
            x=tfl.layers.cross_entropy(input=predict, label=label))
        test_prog = main.clone(for_test=True)
        tfl.optimizer.AdamOptimizer(learning_rate=c['lr']).minimize(
            avg_cost)
    n_adam = sum(op.type == 'adam' for op in main.global_block().ops)
    exe, scope = tfl.Executor(place), tfl.Scope()
    exe.run(startup, scope=scope)
    feeder = tfl.DataFeeder(feed_list=[images, label], place=exe.place,
                            program=main)
    batches = list(tfl.batch(tfl.reader.firstn(
        cifar_data.train10(), c['B'] * c['batches']), c['B'],
        drop_last=True)())

    def eval_cost():
        return float(np.mean([
            exe.run(test_prog, feed=feeder.feed(b), fetch_list=[avg_cost],
                    scope=scope)[0][0] for b in batches]))

    t0 = time.perf_counter()
    evals, losses = [eval_cost()], []
    _zero_counts()
    for _ in range(c['epochs']):
        losses += [float(exe.run(main, feed=feeder.feed(b),
                                 fetch_list=[avg_cost], scope=scope)[0][0])
                   for b in batches]
        evals.append(eval_cost())   # the test clone launches no kernel
    return dict(config='vgg16_bn_drop, Adam lr %g, batch %d, synthetic '
                'CIFAR-10, %d batches x %d epochs' % (
                    c['lr'], c['B'], c['batches'], c['epochs']),
                adam_ops=n_adam, losses=losses, eval_costs=evals,
                launches=_counts(), seconds=time.perf_counter() - t0,
                persistables=[v.name for v in main.list_vars()
                              if v.persistable and scope.has(v.name)],
                scope=scope, exe=exe, test=test_prog, feeder=feeder,
                cost=avg_cost, batches=batches)


def phase_book_vgg(c=BOOK_VGG):
    """The book's VGG on the card (``book_vgg``): each step must launch
    the dense update once per parameter (60), every training loss must be
    finite and the last epoch's mean below the first's, and the test
    clone on the card must give the CPU's cost from the trained state on
    ``eval_batches`` batches."""
    res = book_vgg(c)
    steps = len(res['losses'])
    per_step = {k: n / steps for k, n in res['launches'].items()}
    epochs = np.array(res['losses']).reshape(c['epochs'], -1).mean(axis=1)
    res['epoch_mean_losses'] = epochs.tolist()
    cpu_scope = tfl.Scope()
    for n in res['persistables']:
        cpu_scope.set(n, res['scope'].get(n).to('cpu', copy=True))
    gaps = []
    cpu_exe = tfl.Executor('cpu')
    for b in res['batches'][:c['eval_batches']]:
        card, = res['exe'].run(res['test'], feed=res['feeder'].feed(b),
                               fetch_list=[res['cost']], scope=res['scope'])
        cpu, = cpu_exe.run(res['test'], feed=res['feeder'].feed(b),
                           fetch_list=[res['cost']], scope=cpu_scope)
        gaps.append(abs(float(card[0]) - float(cpu[0])))
    res['test_clone_card_vs_cpu'] = max(gaps)
    print("book vgg training: %s" % json.dumps(
        {k: v for k, v in res.items() if k not in (
            'persistables', 'scope', 'exe', 'test', 'feeder', 'cost',
            'batches')}))
    if res['adam_ops'] != 60 or per_step != _want(
            dense_update=res['adam_ops']):
        raise SystemExit("book VGG launches per step %s" % per_step)
    if not all(np.isfinite(res['losses'])) or not epochs[-1] < epochs[0]:
        raise SystemExit("book VGG loss not finite or not falling: %s"
                         % epochs.tolist())
    if not res['test_clone_card_vs_cpu'] <= TOL_TRAIN_LOSS:
        raise SystemExit("book VGG test clone on the card disagrees with "
                         "the CPU: %g" % res['test_clone_card_vs_cpu'])
    return res


def _lr_closed_form(name, step, base=1.0, decay_steps=5, rate=0.5):
    """The rate of ``_RECIPE_SCHEDULES[name]`` at ``step`` (from 1), as
    tests/test_lr_decay.py writes it."""
    d = step / decay_steps
    if name == 'exponential':
        return base * rate ** d
    if name == 'exponential_staircase':
        return base * rate ** np.floor(d)
    if name == 'natural_exp':
        return base * np.exp(-rate * d)
    if name == 'inverse_time':
        return base / (1 + rate * d)
    if name in ('polynomial', 'polynomial_cycle'):
        frac = (step / (max(1.0, np.ceil(d)) * decay_steps)
                if name == 'polynomial_cycle'
                else min(step, decay_steps) / decay_steps)
        return (base - 0.1) * (1 - frac) ** 2.0 + 0.1
    return 1.0 if step < 3 else 0.5 if step < 7 else 0.1


# tests/test_lr_decay.py's schedules: base 1.0, 5 decay steps, rate 0.5;
# polynomial to 0.1 at power 2; piecewise 1.0 / 0.5 / 0.1 at 3 and 7
_RECIPE_SCHEDULES = {
    'exponential': lambda: lrd.exponential_decay(1.0, 5, 0.5),
    'exponential_staircase': lambda: lrd.exponential_decay(1.0, 5, 0.5,
                                                           True),
    'natural_exp': lambda: lrd.natural_exp_decay(1.0, 5, 0.5),
    'inverse_time': lambda: lrd.inverse_time_decay(1.0, 5, 0.5),
    'polynomial': lambda: lrd.polynomial_decay(1.0, 5, 0.1, 2.0),
    'polynomial_cycle': lambda: lrd.polynomial_decay(1.0, 5, 0.1, 2.0,
                                                     True),
    'piecewise': lambda: lrd.piecewise_decay([3, 7], [1.0, 0.5, 0.1]),
}


def _recipe_programs(kind, c=RECIPE):
    """A two-layer net (D -> H relu -> 1, mean square error) under one
    training recipe: 'sgd_l2' (SGD, L2Decay: folded into the sgd op's
    weight_decay), 'sgd_l1' (SGD, L1Decay: woven), 'clip_value',
    'clip_norm', 'clip_global_norm' (Momentum under a gradient clip),
    'error_clip' (SGD, an ErrorClipByValue on the hidden activation), or
    a decay schedule of ``_RECIPE_SCHEDULES`` driving Momentum (its rate
    scaled by lr).  Returns (main, startup, loss, rate or None)."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    rate = None
    with tfl.program_guard(main, startup):
        x = tfl.layers.data(name='x', shape=[c['D']], dtype='float32')
        y = tfl.layers.data(name='y', shape=[1], dtype='float32')
        h = tfl.layers.fc(input=x, size=c['H'], act='relu')
        loss = tfl.layers.mean(x=tfl.layers.square_error_cost(
            input=tfl.layers.fc(input=h, size=1), label=y))
        clips = {'clip_value': lambda: tfl.clip.GradientClipByValue(0.01),
                 'clip_norm': lambda: tfl.clip.GradientClipByNorm(0.05),
                 'clip_global_norm':
                 lambda: tfl.clip.GradientClipByGlobalNorm(0.1)}
        if kind in _RECIPE_SCHEDULES:
            rate = _RECIPE_SCHEDULES[kind]()
            opt = tfl.optimizer.MomentumOptimizer(
                tfl.layers.scale(rate, scale=c['lr']), 0.9)
        elif kind in clips:
            tfl.clip.set_gradient_clip(clips[kind]())
            opt = tfl.optimizer.MomentumOptimizer(c['lr'], 0.9)
        else:
            reg = {'sgd_l2': tfl.regularizer.L2Decay(1e-2),
                   'sgd_l1': tfl.regularizer.L1Decay(1e-3)}.get(kind)
            if kind == 'error_clip':
                h.error_clip = tfl.clip.ErrorClipByValue(1e-3)
            opt = tfl.optimizer.SGDOptimizer(c['lr'], regularization=reg)
        try:
            opt.minimize(loss)
        finally:
            tfl.clip.set_gradient_clip(None)
    return main, startup, loss, rate


def _recipe_case(kind, c=RECIPE):
    """One recipe on the card and on the CPU from the same state over its
    steps: the loss each step and every parameter after, held to phase
    10's bounds; the card's launches; under a schedule, the card's rate
    each step against its closed form; under 'sgd_l2', each #5 launch is
    the sgd rule's weight-decay arm, and the first step's update equals
    the plain rule's on the card's own gradient bitwise."""
    main, startup, loss, rate = _recipe_programs(kind, c)
    ops = main.global_block().ops
    params = [p.name for p in main.all_parameters()]
    exe, card_scope = tfl.Executor(), tfl.Scope()
    exe.run(startup, scope=card_scope)
    cpu_scope = tfl.Scope()
    for v in main.list_vars():
        if v.persistable and card_scope.has(v.name):
            cpu_scope.set(v.name, card_scope.get(v.name).to('cpu',
                                                             copy=True))
    rng = np.random.default_rng(SEED + 50)
    steps = c['decay_steps'] if rate is not None else c['steps']
    feeds = [{'x': rng.standard_normal((c['B'], c['D'])).astype(np.float32),
              'y': (3.0 * rng.standard_normal((c['B'], 1))).astype(
                  np.float32)} for _ in range(steps)]
    fetch = [loss.name] + ([rate.name] if rate is not None else [])
    cpu_exe = tfl.Executor('cpu')
    res = dict(kind=kind, steps=steps, loss_err=0.0, rate_err=0.0)
    ok = True
    _zero_counts()
    for i, feed in enumerate(feeds):
        if kind == 'sgd_l2' and i == 0:
            w0 = card_scope.get(params[0]).clone()
            lr = card_scope.get(next(
                op.input('LearningRate')[0] for op in ops
                if op.type == 'sgd'))
            card = exe.run(main, feed=feed, fetch_list=fetch + [
                params[0] + '@GRAD'], scope=card_scope,
                return_numpy=False)
            wd = next(op.attrs['weight_decay'] for op in ops
                      if op.type == 'sgd' and
                      op.input('Param')[0] == params[0])
            want = du.plain_sgd(w0, card[-1], lr, wd)
            res['fold_bitwise'] = bool(torch.equal(
                card_scope.get(params[0]), want))
            ok &= res['fold_bitwise']
            card = [t.cpu().numpy() for t in card[:len(fetch)]]
        else:
            card = exe.run(main, feed=feed, fetch_list=fetch,
                           scope=card_scope)
        cpu = cpu_exe.run(main, feed=feed, fetch_list=fetch,
                          scope=cpu_scope)
        res['loss_err'] = max(res['loss_err'],
                              abs(float(card[0][0]) - float(cpu[0][0])))
        if rate is not None:
            want = _lr_closed_form(kind, i + 1)
            res['rate_err'] = max(res['rate_err'],
                                  abs(float(card[1][0]) - want) / want,
                                  abs(float(cpu[1][0]) - want) / want)
    counts = _counts()
    res['param_norm_rel'] = max(_norm_rel(card_scope.get_numpy(n),
                                          cpu_scope.get_numpy(n))
                                for n in params)
    res['launches'] = counts['dense_update']
    res['other_launches'] = sum(v for k, v in counts.items()
                                if k != 'dense_update')
    sgd_wd = [op for op in ops if op.type == 'sgd' and
              op.attrs.get('weight_decay')]
    res['sgd_weight_decay_ops'] = len(sgd_wd)
    res['woven_sums'] = sum(op.type == 'sum' for op in ops)
    ok &= (res['loss_err'] <= TOL_TRAIN_LOSS and
           res['param_norm_rel'] <= TOL_TRAIN_GRAD and
           res['rate_err'] <= TOL_LR and
           res['launches'] == len(params) * steps and
           res['other_launches'] == 0)
    if kind == 'sgd_l2':
        ok &= len(sgd_wd) == len(params) and res['woven_sums'] == 0
    elif kind == 'sgd_l1':
        ok &= not sgd_wd and res['woven_sums'] == len(params)
    res['ok'] = bool(ok)
    return res


def phase_recipes():
    """The training recipes on the card against the CPU at a small width
    (``_recipe_case``): SGD with L2Decay (the fold: #5's sgd rule with its
    weight-decay arm, counted, and checked against the plain rule
    bitwise), L1Decay (woven), each of the three gradient clips and an
    error clip, and each decay schedule driving Momentum over 12 steps."""
    t0 = time.perf_counter()
    rows = [_recipe_case(kind) for kind in
            ['sgd_l2', 'sgd_l1', 'clip_value', 'clip_norm',
             'clip_global_norm', 'error_clip'] + list(_RECIPE_SCHEDULES)]
    res = dict(cases=rows, seconds=time.perf_counter() - t0,
               sgd_weight_decay_launches=rows[0]['launches'],
               launches=sum(r['launches'] for r in rows))
    print("training recipes: %s" % json.dumps(res))
    bad = [r['kind'] for r in rows if not r['ok']]
    if bad:
        raise SystemExit("training recipes fail on the card: %s" % bad)
    return res


# benchmarks/bench_ctr.py's Criteo-class headline (:318-330, the build of
# :47-61, the feed of :64-78), uncut: DeepFM, 26 slots of 1,000,003-row
# tables, embed 16, hidden (128, 128), 13 dense features, batch 32768,
# Adagrad 0.01; one int32 id a slot a sample from default_rng(0), staged
# on the card once and run by run_steps.  The labels are random, so the
# loss falls only as the 1M-row tables learn the repeated batch: the run
# compares the mean of the last 4 of 24 steps with the first 4's
CTR = dict(B=32768, slots=26, rows=1000003, embed=16, lr=0.01, steps=8,
           total_steps=24)
# one DeepFM step card vs CPU: the bench's layout at B=256 and
# 100,003-row tables.  The loss at TOL_TRAIN_LOSS and the dense gradients
# at TOL_TRAIN_GRAD (phase 10's bounds and reasons); the touched table
# rows and their Adagrad moments after the step at TOL_CTR_ROWS absolute:
# each row's update is lr * g / (sqrt(g^2) + 1e-6), which is +-lr but
# where g is within ~1e-6 of 0, and its moment g^2 from a sum of one or a
# few values computed by the same pooled-sum backward on both sides
CTR_PARITY = dict(B=256, slots=26, rows=100003, embed=16, lr=0.01)
TOL_CTR_ROWS = 1e-5
# benchmarks/bench_ctr.py:348-398's table-height sweep: batch 16384, 8
# slots, embed 8, three heights; the step's peak less the tables' and
# their moments' bytes must not grow with the height by more than
# CTR_SWEEP_FLAT bytes (a dense [height, 8] gradient of the 8 tables at
# the largest height would add 2.56 GB, of the 1-column ones 0.32 GB)
CTR_SWEEP = dict(B=16384, slots=8, embed=8, lr=0.01,
                 heights=(100003, 1000003, 10000019), steps=5)
CTR_SWEEP_FLAT = 64 << 20
# the book's CTR tests on the card (tests/book/test_ctr.py,
# test_word2vec.py, test_recommender_system.py) with their gates
BOOK_CTR = dict(ctr_gate=0.35, w2v_gate=7.1, rec_gate=4.8)
# calc_gradient card vs CPU, relative to the largest entry
TOL_CALC_GRAD = 1e-5
def _ctr_programs(c, arch='deepfm'):
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        _, _, cost, auc = ctr.build(arch, sparse_dim=c['rows'],
                                    num_slots=c['slots'],
                                    embed_dim=c['embed'])
        tfl.optimizer.AdagradOptimizer(c['lr']).minimize(cost)
    return main, startup, cost, auc


def _ctr_feed(batch, rows, slots, seed=0):
    """bench_ctr.py's _feed_fn: dense normals, int32 labels and one int32
    id a slot a sample, from default_rng(seed), as tensors on the card
    (each slot's ids [B, 1, 1] and its ``@LEN`` lengths of 1)."""
    rng = np.random.default_rng(seed)
    ln = torch.ones((batch,), dtype=torch.int32, device='cuda')
    feed = {'dense': rng.normal(size=(batch, ctr.DENSE_DIM)).astype(
        np.float32), 'label': rng.integers(0, 2, (batch, 1)).astype(np.int32)}
    feed = {k: torch.from_numpy(v).cuda() for k, v in feed.items()}
    for i in range(slots):
        feed['sparse_%d' % i] = torch.from_numpy(rng.integers(
            0, rows, (batch, 1, 1)).astype(np.int32)).cuda()
        feed['sparse_%d@LEN' % i] = ln
    return feed


def _table_moments(main):
    """{table: its Adagrad moment} for the row-sparse tables."""
    tables = {op.output('Out')[0][:-len('@GRAD')]
              for op in main.global_block().ops
              if op.type == 'sparse_grad_assemble'}
    return {op.input('Param')[0]: op.input('Moment')[0]
            for op in main.global_block().ops
            if op.type == 'adagrad' and op.input('Param')[0] in tables}


def phase_ctr_training(c=CTR):
    """DeepFM at bench_ctr.py's Criteo-class width trained through
    run_steps on one batch staged on the card: a warm-up step, 8 timed
    single-step calls (p50, examples/s), one 8-step call, then steps to
    24 in all; every loss finite and the mean of the last 4 below the
    first 4's; each step must launch #6 once per table (52) and no other
    kernel (the dense Adagrad is eager torch, as the reference leaves it
    to XLA)."""
    main, startup, cost, _ = _ctr_programs(c)
    moments = _table_moments(main)
    exe, scope = tfl.Executor(), tfl.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    table_bytes = sum(scope.get(n).numel() * 4
                      for kv in moments.items() for n in kv)
    feed = _ctr_feed(c['B'], c['rows'], c['slots'])
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
    losses += steps(c['total_steps'] - 1 - 2 * c['steps'])[1]
    counts = _counts()
    p50 = float(np.median(step_ms))
    res = dict(
        config='DeepFM B=%d, %d slots x %d rows x %d, Adagrad lr %g, '
        'run_steps on one staged batch' % (c['B'], c['slots'], c['rows'],
                                           c['embed'], c['lr']),
        tables=len(moments), table_and_moment_bytes=table_bytes,
        startup_s=startup_s, warmup_ms=warm_ms, step_ms=step_ms,
        step_ms_p50=p50, examples_per_s=c['B'] / (p50 / 1e3),
        run_steps_8_ms_per_step=run_ms / c['steps'],
        examples_per_s_run_steps_8=c['B'] / (run_ms / c['steps'] / 1e3),
        steps=len(losses), losses=losses,
        first4_mean=float(np.mean(losses[:4])),
        last4_mean=float(np.mean(losses[-4:])), launches=counts,
        launches_per_step={k: n / len(losses) for k, n in counts.items()},
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        memory_allocated_at_start=allocated_at_start)
    print("deepfm training: %s" % json.dumps(res))
    if len(moments) != 2 * c['slots']:
        raise SystemExit("DeepFM has %d row-sparse tables, want %d"
                         % (len(moments), 2 * c['slots']))
    if res['launches_per_step'] != _want(table_update=len(moments)):
        raise SystemExit("DeepFM launches per step %s, want 52 row-sparse "
                         "updates" % res['launches_per_step'])
    if not all(np.isfinite(losses)) or \
            not res['last4_mean'] < res['first4_mean']:
        raise SystemExit("DeepFM loss not finite or not falling: %s"
                         % losses)
    return dict(main=main, cost=cost, scope=scope, exe=exe, feed=feed,
                counts=counts, **res)


def phase_ctr_profile(fm):
    """A traced DeepFM step: device time by group (#6's row-sparse
    kernels, the id sorts and the rest of #6's call, the GEMMs,
    reductions, elementwise kernels, the rest) and the idle share."""
    def step():
        fm['exe'].run_steps(fm['main'], feed=fm['feed'],
                            fetch_list=[fm['cost']], scope=fm['scope'],
                            repeat=1)
    wall, rows, busy = _device_kernels(step)
    groups = {'table_update': 0.0, 'sort': 0.0, 'gemm': 0.0,
              'reduction': 0.0, 'elementwise': 0.0, 'other': 0.0}
    for k, ms, n in rows:
        if 'rowwise_' in k:
            groups['table_update'] += ms
        elif re.search(r'[Ss]ort|[Rr]adix|cub', k):
            groups['sort'] += ms
        elif re.search(r'gemm|xmma|cutlass', k):
            groups['gemm'] += ms
        elif 'reduce_kernel' in k:
            groups['reduction'] += ms
        elif 'elementwise' in k or 'CatArray' in k or 'fill' in k.lower() \
                or 'copy' in k.lower():
            groups['elementwise'] += ms
        else:
            groups['other'] += ms
    out = dict(wall_ms=wall, device_busy_ms=busy if rows else None,
               idle_share=1.0 - busy / wall if rows else None,
               kernel_ms_sum=sum(ms for _, ms, _ in rows),
               kernels=sum(n for *_, n in rows), by_group_ms=groups,
               table_update_share_of_busy=(groups['table_update'] / busy
                                           if rows else None),
               table_update_launches=sum(
                   n for k, _, n in rows if 'rowwise_short' in k),
               top=[dict(kernel=k[:100], ms=ms, count=n) for k, ms, n in
                    sorted(rows, key=lambda r: -r[1])[:12]])
    print("deepfm profile: %s" % json.dumps(out))
    return out


def phase_ctr_parity(c=CTR_PARITY, seed=SEED + 50):
    """One DeepFM step at B=256 on the card and on the CPU from the same
    state and feed: the loss, every dense gradient, and every table's
    touched rows and Adagrad moments after the step; rows no id touched
    stay bitwise unchanged on both sides."""
    main, startup, cost, _ = _ctr_programs(c)
    moments = _table_moments(main)
    exe = tfl.Executor()
    card_scope = tfl.Scope()
    exe.run(startup, scope=card_scope)
    cpu_scope = tfl.Scope()
    for v in main.list_vars():
        if v.persistable and card_scope.has(v.name):
            cpu_scope.set(v.name, card_scope.get(v.name).to('cpu',
                                                             copy=True))
    before = {n: cpu_scope.get_numpy(n).copy()
              for kv in moments.items() for n in kv}
    dense = [p.name for p in main.all_parameters() if p.name not in moments]
    fetch = [cost.name] + [n + '@GRAD' for n in dense]
    feed = {k: v.cpu() for k, v in _ctr_feed(c['B'], c['rows'], c['slots'],
                                             seed).items()}
    _zero_counts()
    card = exe.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    counts = _counts()
    cpu = tfl.Executor('cpu').run(main, feed=feed, fetch_list=fetch,
                                  scope=cpu_scope)
    ids = {op.input('W')[0]: feed[op.input('Ids')[0]].numpy().ravel()
           for op in main.global_block().ops if op.type == 'lookup_table'}
    grad_gaps = [(_norm_rel(a, b), n) for n, a, b in
                 zip(dense, card[1:], cpu[1:])]
    row_err, moved = 0.0, []
    for table, mom in moments.items():
        touched = np.zeros(c['rows'], bool)
        touched[ids[table]] = True
        for n in (table, mom):
            a, b = card_scope.get_numpy(n), cpu_scope.get_numpy(n)
            row_err = max(row_err, float(np.abs(a[touched] -
                                                b[touched]).max()))
            if not (np.array_equal(a[~touched], before[n][~touched]) and
                    np.array_equal(b[~touched], before[n][~touched])):
                moved.append(n)
    loss_err = abs(float(card[0][0]) - float(cpu[0][0]))
    worst = max(grad_gaps)
    res = dict(batch=c['B'], rows=c['rows'], slots=c['slots'],
               loss_card=float(card[0][0]), loss_cpu=float(cpu[0][0]),
               loss_err=loss_err, dense_grad_norm_rel=worst[0],
               dense_grad_worst=worst[1], touched_rows_max_abs_err=row_err,
               untouched_moved=moved, launches=counts,
               tol=dict(loss=TOL_TRAIN_LOSS, grad=TOL_TRAIN_GRAD,
                        rows=TOL_CTR_ROWS))
    print("deepfm parity: %s" % json.dumps(res))
    nonfinite = [n for n, a in zip(['loss'] + dense, card)
                 if not np.isfinite(a).all()]
    if nonfinite or moved or not loss_err <= TOL_TRAIN_LOSS or \
            not worst[0] <= TOL_TRAIN_GRAD or not row_err <= TOL_CTR_ROWS:
        raise SystemExit("DeepFM step on the card disagrees with the CPU, "
                         "moved an untouched row or is not finite: %s"
                         % json.dumps(res))
    if counts != {k: int(v) for k, v in _want(
            table_update=len(moments)).items()}:
        raise SystemExit("DeepFM parity step launched %s" % counts)
    return res


def phase_ctr_sweep(c=CTR_SWEEP):
    """DeepFM at three table heights (bench_ctr.py's sweep): the step's
    p50 and its peak memory, less the tables' and moments' bytes, at each
    height; that figure must stay flat (``CTR_SWEEP_FLAT``): no dense
    [height, D] gradient is built."""
    rows = []
    for h in c['heights']:
        cc = dict(c, rows=h)
        main, startup, cost, _ = _ctr_programs(cc)
        moments = _table_moments(main)
        exe, scope = tfl.Executor(), tfl.Scope()
        exe.run(startup, scope=scope)
        table_bytes = sum(scope.get(n).numel() * 4
                          for kv in moments.items() for n in kv)
        feed = _ctr_feed(c['B'], h, c['slots'])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        at_start = torch.cuda.memory_allocated()
        ms, losses = [], []
        for _ in range(1 + c['steps']):
            t0 = time.perf_counter()
            out, = exe.run_steps(main, feed=feed, fetch_list=[cost],
                                 scope=scope, repeat=1)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses += out.ravel().tolist()
        peak = torch.cuda.max_memory_allocated()
        rows.append(dict(table_rows=h, step_ms=ms[1:],
                         step_ms_p50=float(np.median(ms[1:])),
                         table_and_moment_bytes=table_bytes,
                         memory_allocated_at_start=at_start,
                         max_memory_allocated=peak,
                         peak_less_tables=peak - table_bytes,
                         losses=losses))
        del scope, exe, feed
        torch.cuda.empty_cache()
    rest = [r['peak_less_tables'] for r in rows]
    res = dict(config='DeepFM B=%d, %d slots, embed %d, Adagrad' % (
        c['B'], c['slots'], c['embed']), sweep=rows,
        peak_less_tables_spread=max(rest) - min(rest))
    print("deepfm table-height sweep: %s" % json.dumps(res))
    if not res['peak_less_tables_spread'] <= CTR_SWEEP_FLAT or not all(
            np.isfinite(r['losses']).all() for r in rows):
        raise SystemExit("the step's memory beside the tables grows with "
                         "the table height, or a loss is not finite: %s"
                         % json.dumps(res))
    return res


def phase_book_ctr(c=BOOK_CTR):
    """The book's CTR-family tests on the card, through ``batch`` and
    ``DataFeeder``, with their gates: test_ctr's two archs (Adam 0.003,
    the first 512 synthetic click samples in batches of 64, 3 epochs:
    the mean of the last 4 losses below 0.35), test_word2vec (SGD 0.1,
    imikolov 5-grams in batches of 64, 2 epochs: the last 20's mean below
    7.1) and test_recommender_system (SGD 0.2, the first 512 MovieLens
    samples in batches of 64, 4 epochs: the last 4's below 4.8).  Each
    step must launch #6 once per row-sparse table and #5 once per dense
    parameter."""
    out = {}
    place = tfl.CUDAPlace(0)

    def program(build, opt):
        main, startup = tfl.Program(), tfl.Program()
        main.random_seed = startup.random_seed = 7
        with tfl.program_guard(main, startup):
            feeds, cost = build()
            opt().minimize(cost)
        exe, scope = tfl.Executor(place), tfl.Scope()
        exe.run(startup, scope=scope)
        feeder = tfl.DataFeeder(feed_list=feeds, place=place, program=main)
        n_sparse = sum(op.type == 'sparse_grad_assemble'
                       for op in main.global_block().ops)
        n_dense = len(main.all_parameters()) - n_sparse
        return main, exe, scope, feeder, cost, n_sparse, n_dense

    word_dict = imikolov.build_dict()
    cases = []
    for arch in ('wide_and_deep', 'deepfm'):
        cases.append((arch, lambda a=arch: (lambda r: (r[0], r[2]))(
            ctr.build(a)), lambda: tfl.optimizer.AdamOptimizer(0.003),
            tfl.batch(tfl.reader.firstn(ctr.synthetic_reader(), 512), 64,
                      drop_last=True), 3, 4, c['ctr_gate']))
    cases.append(('word2vec', lambda: (lambda r: (r[0] + [r[1]], r[3]))(
        word2vec.build(len(word_dict))),
        lambda: tfl.optimizer.SGDOptimizer(0.1),
        tfl.batch(imikolov.train(word_dict, 5), 64, drop_last=True), 2, 20,
        c['w2v_gate']))
    cases.append(('recommender', lambda: (lambda r: (r[0], r[2]))(
        recommender.build()), lambda: tfl.optimizer.SGDOptimizer(0.2),
        tfl.batch(tfl.reader.firstn(movielens.train(), 512), 64,
                  drop_last=True), 4, 4, c['rec_gate']))
    for name, build, opt, reader, epochs, last, gate in cases:
        main, exe, scope, feeder, cost, n_sparse, n_dense = program(build,
                                                                    opt)
        t0 = time.perf_counter()
        _zero_counts()
        losses = [float(exe.run(main, feed=feeder.feed(b), fetch_list=[cost],
                                scope=scope)[0][0])
                  for _ in range(epochs) for b in reader()]
        counts = _counts()
        per_step = {k: n / len(losses) for k, n in counts.items()}
        res = dict(steps=len(losses), seconds=time.perf_counter() - t0,
                   first_mean=float(np.mean(losses[:last])),
                   last_mean=float(np.mean(losses[-last:])), gate=gate,
                   sparse_tables=n_sparse, dense_params=n_dense,
                   launches=counts, launches_per_step=per_step)
        print("book %s on the card: %s" % (name, json.dumps(res)))
        if not all(np.isfinite(losses)) or not res['last_mean'] < gate:
            raise SystemExit("book %s misses its gate: %s" % (name, res))
        if per_step != _want(table_update=n_sparse, dense_update=n_dense):
            raise SystemExit("book %s launches per step %s" % (name,
                                                               per_step))
        out[name] = res
    return out


def _calc_gradient_program(wrt):
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        x = tfl.layers.data(name='x', shape=[64], dtype='float32')
        x.stop_gradient = False
        h1 = tfl.layers.fc(input=x, size=128, act='tanh')
        h2 = tfl.layers.fc(input=h1, size=64, act='relu')
        loss = tfl.layers.mean(x=tfl.layers.square(
            x=tfl.layers.fc(input=h2, size=8)))
        grads = tfl.calc_gradient(loss, {'input': x, 'intermediate': h1}[wrt])
    return main, startup, grads + [h1, loss]


def phase_calc_gradient():
    """calc_gradient on the card against the CPU from one state and input:
    the gradient with respect to the fed input and with respect to an
    intermediate (and that intermediate's forward value), within
    ``TOL_CALC_GRAD`` of the largest entry."""
    out = {}
    x = np.random.default_rng(SEED + 52).standard_normal(
        (256, 64)).astype(np.float32)
    for wrt in ('input', 'intermediate'):
        main, startup, fetch = _calc_gradient_program(wrt)
        card_scope = tfl.Scope()
        tfl.Executor().run(startup, scope=card_scope)
        cpu_scope = tfl.Scope()
        for p in main.all_parameters():
            cpu_scope.set(p.name, card_scope.get(p.name).to('cpu',
                                                             copy=True))
        card = tfl.Executor().run(main, feed={'x': x}, fetch_list=fetch,
                                  scope=card_scope)
        cpu = tfl.Executor('cpu').run(main, feed={'x': x}, fetch_list=fetch,
                                      scope=cpu_scope)
        errs = [float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(card, cpu)]
        out[wrt] = dict(grad_rel_err=errs[0], forward_rel_err=errs[1:],
                        grad_norm=float(np.linalg.norm(card[0])))
    print("calc_gradient: %s" % json.dumps(out))
    bad = [k for k, r in out.items()
           if not max([r['grad_rel_err']] + r['forward_rel_err'])
           <= TOL_CALC_GRAD or not r['grad_norm'] > 0]
    if bad:
        raise SystemExit("calc_gradient on the card disagrees with the "
                         "CPU: %s" % bad)
    return out


def _ctr_table_line(table, res, sparse_timing):
    """#6's kernels-line entry with the CTR family's launches and its
    times at DeepFM's 16- and 1-column tables (phase 19's)."""
    paths = dict(deepfm_training=res['fm']['counts']['table_update'],
                 deepfm_parity=res['parity']['launches']['table_update'],
                 **{'book_%s_training' % k: r['launches']['table_update']
                    for k, r in res['book'].items()})
    table['launches'] += sum(paths.values())
    table['launches_by_path'].update(paths)
    table['deepfm_shapes'] = dict(
        note='sparse Adagrad, uniform ids over 1,000,003 rows, K=32768; '
        'library: torch.optim.Adagrad on a sparse COO gradient, per call '
        'between CUDA events as call_ms',
        **{'D%d' % d: sparse_timing['ctr_uniform_d%d' % d]['adagrad']
           for d in (16, 1)})
    table['deepfm_ms_per_step'] = res['fm']['profile']['by_group_ms'][
        'table_update']


# benchmarks/bench_transformer.py:67-73's AMP row: the float32 build of
# TRAIN (B=32, T=512, V=30000, L=6, D=512, H=8, Adam lr 1e-3) through the
# pass pipeline with amp='bf16', trained through run_steps on one batch
# staged on the card: a warm-up step, 8 timed single-step calls (p50),
# one 8-step call, then steps to 24 in all
AMP_TRAIN = dict(TRAIN, steps=8, total_steps=24)
# the same model in f16 with dynamic loss scaling: the scale must double
# after ``incr_every`` clean steps (PADDLE_TPU_TORCH_AMP_INCR_EVERY_N_STEPS,
# set for the phase) and halve after one overflow (..._DECR_EVERY_N_NAN_OR_
# INF=1).  The overflow is planted by setting the loss scale to 2^31 (the
# cap): the fused head's cotangent, scale / (B * T) = 2^17 times
# (p - onehot), overflows float16 at its cast, so every gradient is
# non-finite.  The token feeds carry no float a batch could plant an inf
# through (the reference's test plants 1e38 images into an MLP).
AMP_F16 = dict(TRAIN, clean_steps=8, incr_every=8, planted_scale=2.0 ** 31)
# one AMP step at B=2, card against CPU, both running the bf16 program
# (the CPU's plain versions round q times the scale, p and ds to bf16 as
# the kernels do).  bf16's own rounding sets the scale: on an H100 the
# card's bf16 gradients read 6.7% (worst parameter, norm-relative; median
# 4.3%) from the CPU's bf16 ones, and the CPU's bf16 step reads 7.0% from
# its own float32 step; the loss 5.0e-5.  A planted fault, attention's
# scale 1.25x its 1/sqrt(d) on the card, read 0.297 and must stay above
# the gradient bound.  The bounds: the loss at phase 10's 1e-3, gradients
# at 0.1
TOL_AMP_LOSS = 1e-3
TOL_AMP_GRAD = 0.1
AMP_FAULT_SCALE = 1.25
# bench.py's default build (:172-178, :189-199): ResNet-50 with bfloat16
# activations, NHWC, batch 64, Momentum 0.1 / 0.9; float32 parameters and
# batch-norm statistics
RESNET_BF16 = dict(RESNET, layout='NHWC', dtype='bfloat16')


def _amp_feed(c, seed):
    """The transformer's feed staged on the card (token ids as int32, the
    executor's narrowing)."""
    return {k: torch.from_numpy(v.astype(np.int32)).cuda()
            for k, v in _train_feed(c['B'], seed, c).items()}


def _pipeline_summary(report):
    a = report['amp']
    return dict(level=report['level'], ops_before=report['ops_before'],
                ops_after=report['ops_after'],
                eliminated=report['eliminated'],
                pass_wall_s=report['pass_wall_s'],
                verify=report['verify'], amp_mode=a['mode'],
                ops_lowered=a['ops_lowered'],
                casts_inserted=a['casts_inserted'],
                loss_scaling=a['loss_scaling'])


def _flash_dtypes(low, layers, steps):
    """Fails unless every #1 and #2 launch since the counts were set to 0
    took ``low`` q/k/v, ``layers`` of each a step."""
    got = dict(fa.dtype_launches)
    want = {('paddle_flash_attention_fwd', low): layers * steps,
            ('paddle_flash_attention_bwd', low): layers * steps}
    if got != want:
        raise SystemExit("flash launches by dtype %s, want %s" % (got, want))
    return {'%s %s' % k: n for k, n in got.items()}


def phase_amp_training(c=AMP_TRAIN, mode='bf16',
                       label='transformer bf16 training'):
    """The transformer's float32 build trained under ``amp_guard(mode)``
    through run_steps: each step must launch #1 and #2 once per layer on
    16-bit q/k/v and the dense update once per parameter, on the float32
    master weights; the loss must be finite and the last below the first.
    Reported: the pipeline's report, p50, tokens/s, peak memory."""
    main, startup, cost = _train_programs(c)
    n_adam = sum(op.type == 'adam' for op in main.global_block().ops)
    exe = tfl.Executor()
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    feed = _amp_feed(c, SEED + 5)
    low = amp.LOW_DTYPE[mode]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def steps(k):
        t0 = time.perf_counter()
        out, = exe.run_steps(main, feed=feed, fetch_list=[cost],
                             scope=scope, repeat=k)
        return (time.perf_counter() - t0) * 1e3, out.ravel().tolist()

    with amp.amp_guard(mode):
        _zero_counts()
        warm_ms, losses = steps(1)
        step_ms = []
        for _ in range(c['steps']):
            ms, loss = steps(1)
            step_ms.append(ms)
            losses += loss
        run_ms, loss = steps(c['steps'])
        losses += loss
        losses += steps(c['total_steps'] - 1 - 2 * c['steps'])[1]
        counts = _counts()
    by_dtype = _flash_dtypes(low, c['L'], len(losses))
    per_step = {k: n / len(losses) for k, n in counts.items()}
    masters = sorted({str(scope.get(p.name).dtype)
                      for p in main.all_parameters()})
    p50 = float(np.median(step_ms))
    res = dict(config='B=%d T=%d V=%d L=%d D=%d H=%d float32 build, AMP %s, '
               'Adam lr %g, run_steps on one staged batch'
               % (c['B'], c['T'], c['V'], c['L'], c['D'], c['H'], mode,
                  c['lr']),
               pipeline=_pipeline_summary(exe.last_graph_opt_report),
               warmup_ms=warm_ms, step_ms=step_ms, step_ms_p50=p50,
               tokens_per_s=c['B'] * c['T'] / (p50 / 1e3),
               run_steps_8_ms_per_step=run_ms / c['steps'],
               losses=losses, launches=counts, launches_per_step=per_step,
               flash_launches_by_dtype=by_dtype, master_dtypes=masters,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    print("%s: %s" % (label, json.dumps(res)))
    want = _want(flash_attention_fwd=c['L'], flash_attention_bwd=c['L'],
                 dense_update=n_adam)
    if n_adam != 78 or per_step != want:
        raise SystemExit("launches per step %s, want %s" % (per_step, want))
    if masters != ['torch.float32']:
        raise SystemExit("master weights are %s" % masters)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit("loss not finite or not falling: %s" % losses)
    return dict(main=main, startup=startup, cost=cost, scope=scope,
                exe=exe, feed=feed, counts=counts, n_adam=n_adam, **res)


def _amp_step(main, cost, scope, feed, device, mode, names):
    exe = tfl.Executor(device)
    with amp.amp_guard(mode):
        out = exe.run(main, feed=feed, scope=scope,
                      fetch_list=[cost.name] + [n + '@GRAD' for n in names])
    return out


def phase_amp_parity(tr, mode='bf16', label='transformer bf16 parity'):
    """One AMP step at B=2 on the card and on the CPU from the same state,
    both running the rewritten program: the loss and every gradient
    (norm-relative, at ``TOL_AMP_*``).  Reported beside them: the card's
    AMP step against the CPU's float32 step, what AMP moves."""
    main, cost = tr['main'], tr['cost']
    names = [p.name for p in main.all_parameters()]
    card_scope = tfl.Scope()
    tr['exe'].run(tr['startup'], scope=card_scope)
    state = {v.name: card_scope.get(v.name).to('cpu', copy=True)
             for v in main.list_vars()
             if v.persistable and card_scope.has(v.name)}

    def cpu_scope():
        s = tfl.Scope()
        for n, t in state.items():
            s.set(n, t.clone())
        return s
    feed = _train_feed(TRAIN['parity_B'], SEED + 6)
    t0 = time.perf_counter()
    _zero_counts()
    card = _amp_step(main, cost, card_scope, feed, None, mode, names)
    counts = _counts()
    cpu = _amp_step(main, cost, cpu_scope(), feed, 'cpu', mode, names)
    cpu32 = _amp_step(main, cost, cpu_scope(), feed, 'cpu', '0', names)
    secs = time.perf_counter() - t0
    impl = get_op_impl('flash_attention')
    plain = impl.compute

    def sharper(ctx, ins, attrs):
        d = ins['Q'][0].shape[-1]
        return plain(ctx, ins, dict(attrs, scale=AMP_FAULT_SCALE * (
            attrs.get('scale') or d ** -0.5)))
    impl.compute = sharper
    try:
        fault_scope = tfl.Scope()
        for n, t in state.items():
            fault_scope.set(n, t.to('cuda'))
        fault = _amp_step(main, cost, fault_scope, feed, None, mode, names)
    finally:
        impl.compute = plain
    fault_gap = max(_norm_rel(a, b) for a, b in zip(fault[1:], cpu[1:]))

    def gaps(other):
        g = sorted(((_norm_rel(a, b), n) for n, a, b in
                    zip(names, card[1:], other[1:])), reverse=True)
        return dict(loss_err=abs(float(card[0][0]) - float(other[0][0])),
                    grad_norm_rel=g[0][0],
                    median_grad_norm_rel=float(np.median([e for e, _ in g])),
                    largest=[dict(param=n, norm_rel=e) for e, n in g[:3]])
    nonfinite = [n for n, a in zip(['loss'] + names, card)
                 if not np.isfinite(a).all()]
    sound, vs_f32 = gaps(cpu), gaps(cpu32)
    cpu_vs_f32 = sorted((_norm_rel(a, b), n) for n, a, b in
                        zip(names, cpu[1:], cpu32[1:]))
    bad = [k for k, tol in (('loss_err', TOL_AMP_LOSS),
                            ('grad_norm_rel', TOL_AMP_GRAD))
           if not sound[k] <= tol]
    res = dict(batch=TRAIN['parity_B'], mode=mode,
               loss_card=float(card[0][0]), loss_cpu=float(cpu[0][0]),
               loss_cpu_float32=float(cpu32[0][0]), card_vs_cpu=sound,
               card_vs_cpu_float32=vs_f32,
               planted_fault=dict(attention_scale=AMP_FAULT_SCALE,
                                  grad_norm_rel=fault_gap),
               cpu_vs_cpu_float32=dict(
                   grad_norm_rel=cpu_vs_f32[-1][0],
                   median_grad_norm_rel=float(np.median(
                       [e for e, _ in cpu_vs_f32]))),
               tol=dict(loss=TOL_AMP_LOSS, grad=TOL_AMP_GRAD),
               nonfinite=nonfinite, seconds=secs, launches=counts,
               flash_launches_by_dtype={'%s %s' % k: n for k, n in
                                        fa.dtype_launches.items()})
    print("%s: %s" % (label, json.dumps(res)))
    if nonfinite or bad:
        raise SystemExit("AMP step on the card disagrees with the CPU's (%s)"
                         " or is not finite (%s)" % (bad, nonfinite))
    if not fault_gap > TOL_AMP_GRAD:
        raise SystemExit("a planted fault reads %.4g, inside the bound %g"
                         % (fault_gap, TOL_AMP_GRAD))
    return res


def phase_amp_f16(c=AMP_F16, label='transformer f16 loss scaling'):
    """The transformer in f16 with dynamic loss scaling: ``clean_steps``
    steps, after which the scale must have doubled once; then a planted
    overflow step (``AMP_F16``), which must leave every parameter and
    Adam moment (every persistable but the scale's counters) bitwise as
    it was, halve the scale and count one skipped step; then a clean step
    must move the parameters again.  #1 and #2 must take float16 q/k/v."""
    env = {ENV_PREFIX + 'AMP_INCR_EVERY_N_STEPS': str(c['incr_every']),
           ENV_PREFIX + 'AMP_DECR_EVERY_N_NAN_OR_INF': '1'}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        main, startup, cost = _train_programs(c)
        exe = tfl.Executor()
        scope = tfl.Scope()
        exe.run(startup, scope=scope)
        feed = _amp_feed(c, SEED + 8)
        init = float(FLAGS.amp_init_loss_scale)

        def state(name):
            return float(scope.get(name).reshape(-1)[0])
        with amp.amp_guard('f16'):
            _zero_counts()
            first, = exe.run_steps(main, feed=feed, fetch_list=[cost],
                                   scope=scope, repeat=1)
            t0 = time.perf_counter()
            losses, = exe.run_steps(main, feed=feed, fetch_list=[cost],
                                    scope=scope,
                                    repeat=c['clean_steps'] - 1)
            clean_ms = ((time.perf_counter() - t0) * 1e3 /
                        (c['clean_steps'] - 1))
            losses = np.concatenate([first, losses])
            counts = _counts()
            by_dtype = _flash_dtypes('float16', c['L'], c['clean_steps'])
            grown = state(amp.LOSS_SCALE_VAR)
            good = state(amp.GOOD_STEPS_VAR)
            keep = [v.name for v in main.list_vars()
                    if v.persistable and scope.has(v.name)]
            before = {n: scope.get(n).clone() for n in keep}
            scope.get(amp.LOSS_SCALE_VAR).fill_(c['planted_scale'])
            bad_loss, = exe.run(main, feed=feed, fetch_list=[cost],
                                scope=scope)
            changed = [n for n in keep
                       if not torch.equal(before[n], scope.get(n))]
            backed_off = state(amp.LOSS_SCALE_VAR)
            skipped = state(amp.SKIPPED_STEPS_VAR)
            scope.get(amp.LOSS_SCALE_VAR).fill_(grown)
            exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
            moved = sum(not torch.equal(before[p.name], scope.get(p.name))
                        for p in main.all_parameters())
        report = exe.last_graph_opt_report
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    losses = losses.ravel().tolist()
    res = dict(config='TRAIN in f16, dynamic loss scaling (init %g, x2 after '
               '%d clean steps, /2 after 1 overflow)'
               % (init, c['incr_every']),
               pipeline=_pipeline_summary(report), losses=losses,
               clean_ms_per_step_after_warmup=clean_ms, launches=counts,
               flash_launches_by_dtype=by_dtype, scale_after_clean=grown,
               good_steps_after_clean=good,
               planted_scale=c['planted_scale'],
               planted_step_loss=float(bad_loss[0]),
               changed_by_planted_step=changed,
               scale_after_overflow=backed_off, skipped_steps=skipped,
               params_moved_by_next_clean_step=moved,
               params=len(main.all_parameters()))
    print("%s: %s" % (label, json.dumps(res)))
    fails = []
    if not all(np.isfinite(losses)):
        fails.append('clean losses not finite')
    if grown != 2 * init or good != 0:
        fails.append('scale %g (good %g) after %d clean steps, want %g'
                     % (grown, good, c['clean_steps'], 2 * init))
    if changed or not keep:
        fails.append('the overflow step changed %s' % changed[:5])
    if backed_off != c['planted_scale'] / 2 or skipped != 1:
        fails.append('scale %g, skipped %g after the overflow'
                     % (backed_off, skipped))
    if moved != len(main.all_parameters()):
        fails.append('%d parameters moved by the next clean step' % moved)
    if fails:
        raise SystemExit("f16 loss scaling: %s" % '; '.join(fails))
    return dict(counts=counts, **res)


def phase_amp_f16_sparse(rows=30000, dim=256, k=4096):
    """The f16 gate on a row-sparse table: an ``is_sparse`` embedding
    (seq2seq's table width) under lazy Adam, a clean step, then a step
    whose float feed carries inf (every gradient is non-finite): #6 must
    launch on that step with every id swapped to the sentinel and leave
    the table and both moments bitwise as they were, with no copy of the
    table (the gate swaps the ids, ``core/executor.py _gate``)."""
    env = {ENV_PREFIX + 'AMP_DECR_EVERY_N_NAN_OR_INF': '1'}
    old = {n: os.environ.get(n) for n in env}
    os.environ.update(env)
    try:
        main, startup = tfl.Program(), tfl.Program()
        main.random_seed = startup.random_seed = SEED
        with tfl.program_guard(main, startup):
            ids = tfl.layers.data(name='ids', shape=[1], dtype='int64')
            emb = tfl.layers.embedding(input=ids, size=[rows, dim],
                                       is_sparse=True)
            y = tfl.layers.data(name='y', shape=[dim], dtype='float32')
            cost = tfl.layers.mean(
                x=tfl.layers.square_error_cost(input=emb, label=y))
            tfl.optimizer.AdamOptimizer(1e-3).minimize(cost)
        exe, scope = tfl.Executor(), tfl.Scope()
        exe.run(startup, scope=scope)
        rng = np.random.default_rng(SEED)
        feed = {'ids': rng.integers(0, rows, (k, 1)),
                'y': rng.normal(size=(k, dim)).astype(np.float32)}
        state = [v.name for v in main.list_vars()
                 if v.persistable and scope.has(v.name)]
        with amp.amp_guard('f16'):
            exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
            before = {n: scope.get(n).clone() for n in state}
            _zero_counts()
            exe.run(main, feed=dict(feed, y=np.full_like(feed['y'],
                                                          np.inf)),
                    fetch_list=[cost], scope=scope)
            counts = _counts()
            changed = [n for n in state
                       if not torch.equal(before[n], scope.get(n))]
            skipped = float(scope.get(amp.SKIPPED_STEPS_VAR)[0])
    finally:
        for n, v in old.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v
    res = dict(table='%d x %d, K=%d ids, lazy Adam, f16' % (rows, dim, k),
               launches=counts, changed_by_overflow_step=changed,
               skipped_steps=skipped, persistables=len(state))
    print("f16 row-sparse overflow step: %s" % json.dumps(res))
    if changed or skipped != 1 or counts['table_update'] != 1:
        raise SystemExit("f16 sparse gate: %s" % res)
    return res


# benchmarks/memory_report.py:29-62's remat matrix on the port: bench.py's
# default ResNet-50 (RESNET_BF16: bfloat16 NHWC, 224x224, Momentum 0.1 /
# 0.9) at three batch sizes under memory_optimize's three levels, each
# cell a warm-up step and ``steps`` timed single-step run_steps calls on
# one staged batch
REMAT = dict(RESNET_BF16, batches=(64, 128, 256), steps=3, parity_B=64)
REMAT_LEVELS = (None, 'dots', 'full')
# one B=64 step under 'dots' and 'full' against the None step from the
# same state: the loss at TOL_RESNET_LOSS, each gradient norm-relative at
# TOL_RESNET_GRAD (the recompute runs the same kernels on the same
# inputs; under cudnn.deterministic the steps are expected bitwise equal,
# and whether they are is printed)
# the transformer's checkpoint -> resume -> export round trip at TRAIN's
# width (bench_transformer.py:36-37) under memory_optimize's default
# 'dots': 8 steps, a checkpoint, 4 more; a second uninterrupted run; a
# resumed run of 4 steps; a forward of the inference model at B=4
CKPT = dict(TRAIN, save_at=8, resume=4, infer_B=4)
# the resumed losses against the uninterrupted run's: #2 sums dq with
# atomicAdd (csrc/flash_bwd_dkv.cuh:106-113, :349-353), so two runs of the
# same steps from the same state differ in the last bits of dq and drift
# apart; the bound is CKPT_DRIFT times the largest gap between two
# uninterrupted runs over the same steps, plus TOL_CKPT_FLOOR (float32
# noise of an O(10) loss after 4 Adam steps) for a pair of runs that
# happened to agree
CKPT_DRIFT = 4.0
TOL_CKPT_FLOOR = 1e-5
# the book's MNIST convnet (tests/book/test_recognize_digits.py: Adam
# 0.003, batch 64, drop_last, up to 3 epochs, the mean of the last 10
# batches' accuracy above 0.9) fed from record files: the synthetic
# train set (8192 samples) through datasets.common.convert in chunks of
# 1024, read back by reader.creator.recordio
RECORD_MNIST = dict(B=64, lr=0.003, epochs=3, chunk=1024, gate=0.9)


def _remat_cell(exe, main, cost, scope, feed, level, steps):
    """One cell of the remat matrix: ``level`` armed, a warm-up step, then
    ``steps`` timed single-step calls; the measured peak over those, the
    modelled peak, watermark and FLOPs of the step report."""
    tfl.memory_optimize(main, level=level)
    exe.run_steps(main, feed=feed, fetch_list=[cost], scope=scope, repeat=1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    _zero_counts()
    step_ms, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        out, = exe.run_steps(main, feed=feed, fetch_list=[cost],
                             scope=scope, repeat=1)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.ravel()[0]))
    counts = _counts()
    rep = exe.last_step_report
    mem, comp = rep['memory'], rep['phases']['compute']
    wm = mem['watermark_op'] or {}
    p50 = float(np.median(step_ms))
    return dict(
        level=level, measured_peak_bytes=torch.cuda.max_memory_allocated(),
        allocated_at_start=at_start,
        modeled_peak_bytes=mem['modeled_peak_bytes'],
        modeled_persistable_bytes=mem['modeled_persistable_bytes'],
        watermark_op=dict(type=wm.get('type'), index=wm.get('index'),
                          live_bytes=wm.get('live_bytes')),
        remat_level=mem['remat_level'],
        modeled_flops_per_step=comp.get('flops_per_step'),
        achieved_tflop_per_s=comp.get('flops_per_step', 0) / p50 / 1e9,
        step_ms=step_ms, step_ms_p50=p50,
        losses=losses, counts=counts,
        launches_per_step={k: n / steps for k, n in counts.items() if n})


def _remat_parity(exe, main, cost, scope, feed):
    """One B=64 step under each level from the same state, under
    cudnn.deterministic: the loss and every gradient of 'dots' and 'full'
    against None's."""
    params = [p.name for p in main.all_parameters()]
    fetch = [cost.name] + [n + '@GRAD' for n in params]
    state = {v.name: scope.get(v.name).clone() for v in main.list_vars()
             if v.persistable and scope.has(v.name)}
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for level in REMAT_LEVELS:
            for n, t in state.items():
                scope.get(n).copy_(t)
            tfl.memory_optimize(main, level=level)
            out[level] = exe.run(main, feed=feed, fetch_list=fetch,
                                 scope=scope)
    finally:
        torch.backends.cudnn.deterministic = old
        for n, t in state.items():
            scope.get(n).copy_(t)
    res = {}
    for level in ('dots', 'full'):
        loss_err = abs(float(out[level][0][0]) - float(out[None][0][0]))
        gaps = [(_norm_rel(a, b), n) for n, a, b in
                zip(params, out[level][1:], out[None][1:])]
        worst = max(gaps, key=lambda x: (np.nan_to_num(x[0], nan=np.inf),
                                         x[1]))
        res[level] = dict(
            loss=float(out[level][0][0]), loss_none=float(out[None][0][0]),
            loss_err=loss_err, grad_norm_rel_worst=worst[0],
            grad_worst_name=worst[1],
            bitwise=all(np.array_equal(a, b) for a, b in
                        zip(out[level], out[None])),
            finite=all(np.isfinite(a).all() for a in out[level]))
    return res


def phase_remat_matrix(c=REMAT):
    """Phase 53: the remat matrix.  Gates: at every batch size the measured
    peak under 'full' below None's and under 'dots' at most None's; #5
    launched 214 times a step in every cell; at B=64 the 'dots' and 'full'
    steps within the None step's bounds."""
    t0 = time.perf_counter()
    main, startup, cost = _resnet_programs(c)
    exe = tfl.Executor()
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    feed64 = {k: torch.from_numpy(v).cuda()
              for k, v in _image_feed(c['parity_B'], SEED + 60, c).items()}
    parity = _remat_parity(exe, main, cost, scope, feed64)
    del feed64
    rows, paths = [], {}
    for batch in c['batches']:
        feed = {k: torch.from_numpy(v).cuda()
                for k, v in _image_feed(batch, 0, c).items()}
        for level in REMAT_LEVELS:
            row = _remat_cell(exe, main, cost, scope, feed, level,
                              c['steps'])
            row.update(batch=batch,
                       img_per_s=batch / (row['step_ms_p50'] / 1e3))
            paths['resnet50_remat_B%d_%s' % (batch, level)] = \
                row.pop('counts')
            rows.append(row)
        del feed
        torch.cuda.empty_cache()
    res = dict(config='ResNet-50 %s %s %dx%d Momentum lr %g mu %g, '
               'run_steps on one staged batch'
               % (c['layout'], c['dtype'], c['hw'], c['hw'], c['lr'],
                  c['mu']), parity=parity, cells=rows,
               tol=dict(loss=TOL_RESNET_LOSS, grad=TOL_RESNET_GRAD),
               seconds=time.perf_counter() - t0)
    print("remat matrix: %s" % json.dumps(res))
    for row in rows:
        print("remat B=%d %-4s: measured peak %.3f GB, modelled %.3f GB "
              "(watermark %s), step p50 %.2f ms, %.1f img/s, modelled "
              "%.3f TFLOP a step, %.1f TFLOP/s"
              % (row['batch'], row['level'], row['measured_peak_bytes'] /
                 1e9, (row['modeled_peak_bytes'] or 0) / 1e9,
                 row['watermark_op']['type'], row['step_ms_p50'],
                 row['img_per_s'], row['modeled_flops_per_step'] / 1e12,
                 row['achieved_tflop_per_s']))
    peak = {(r['batch'], r['level']): r['measured_peak_bytes']
            for r in rows}
    for batch in c['batches']:
        if not peak[batch, 'full'] < peak[batch, None] or \
                not peak[batch, 'dots'] <= peak[batch, None]:
            raise SystemExit("remat at B=%d: peaks None %d, dots %d, full "
                             "%d" % (batch, peak[batch, None],
                                     peak[batch, 'dots'],
                                     peak[batch, 'full']))
    for level, r in parity.items():
        if not (r['finite'] and r['loss_err'] <= TOL_RESNET_LOSS and
                r['grad_norm_rel_worst'] <= TOL_RESNET_GRAD):
            raise SystemExit("remat step %s disagrees with None's: %s"
                             % (level, r))
    for row in rows:
        if not all(np.isfinite(row['losses'])):
            raise SystemExit("remat cell B=%d %s: losses %s"
                             % (row['batch'], row['level'], row['losses']))
    for row in rows:
        if row['launches_per_step'] != {'dense_update': 214.0}:
            raise SystemExit("launches per step in remat cell B=%d %s: %s"
                             % (row['batch'], row['level'],
                                row['launches_per_step']))
    return dict(rows=rows, paths=paths, parity=parity)


def _ckpt_programs(c=CKPT):
    """TRAIN's transformer with a logits head beside its fused loss (the
    head's ``tr_head_*`` parameters shared, as build_logits shares them),
    its test clone taken before ``minimize`` (the book idiom), and
    ``memory_optimize`` at its default level."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        src, _, cost = ttr.build(vocab_size=c['V'], seq_len=c['T'],
                                 n_layers=c['L'], d_model=c['D'],
                                 n_heads=c['H'])
        head, = [op for op in main.global_block().ops
                 if op.type == 'fused_linear_softmax_ce']
        x = main.global_block().var(head.input('X')[0])
        logits = tfl.layers.fc(
            input=x, size=c['V'], num_flatten_dims=2,
            param_attr=tfl.ParamAttr(name='tr_head_w'),
            bias_attr=tfl.ParamAttr(name='tr_head_b'))
        test = main.clone(for_test=True)
        tfl.optimizer.AdamOptimizer(learning_rate=c['lr']).minimize(cost)
    tfl.memory_optimize(main)
    return main, startup, cost, logits, test


def _fresh_run(startup):
    exe = tfl.Executor()
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    return exe, scope


def _steps(exe, main, cost, scope, feed, k):
    t0 = time.perf_counter()
    out, = exe.run_steps(main, feed=feed, fetch_list=[cost], scope=scope,
                         repeat=k)
    return out.ravel().tolist(), (time.perf_counter() - t0) * 1e3 / k


def _greedy_tokens(scope, c, prompts):
    eng = DecodeEngine(extract_params(scope, c['L']), n_layers=c['L'],
                       n_heads=c['H'], page_size=SERVE['page'],
                       max_streams=SERVE['streams'],
                       prefill_bucket=SERVE['bucket'])
    srv = DecodeServer(eng)
    streams = [srv.submit(p, max_new_tokens=8) for p in prompts]
    drained = srv.drain(timeout=300.0)
    srv.close()
    if not drained:
        raise SystemExit("serving the reloaded weights did not drain")
    return [[int(t) for t in st.result(timeout=1.0)] for st in streams]


def phase_checkpoint(c=CKPT):
    """Phase 54: checkpoint, resume and export of the transformer.  Gates:
    #1, #2 6 and #5 78 launches a step under 'dots'; load_checkpoint into
    a fresh scope and executor returns 8 with every persistable bitwise
    the saved one; the resumed losses within the run-to-run bound; the
    reloaded inference model's forward bitwise the test clone's, and its
    served greedy tokens the in-memory weights'."""
    import tempfile
    t_phase = time.perf_counter()
    main, startup, cost, logits, test = _ckpt_programs(c)
    feed = {k: torch.from_numpy(v).cuda()
            for k, v in _train_feed(c['B'], SEED + 5, c).items()}
    tmp = tempfile.mkdtemp(prefix='chip_smoke_ckpt_')
    d, d2 = os.path.join(tmp, 'ckpt'), os.path.join(tmp, 'model')
    n_steps = c['save_at'] + c['resume']
    # run A: 8 steps, the checkpoint, 4 more
    exe_a, scope_a = _fresh_run(startup)
    _zero_counts()
    losses_a, ms_a = _steps(exe_a, main, cost, scope_a, feed, c['save_at'])
    counts = _counts()
    per_step = {k: n / c['save_at'] for k, n in counts.items() if n}
    persist = [v.name for v in main.list_vars() if v.persistable]
    saved = {n: scope_a.get(n).detach().cpu().clone() for n in persist}
    t0 = time.perf_counter()
    tfl.io.save_checkpoint(exe_a, d, main, step=c['save_at'],
                           scope=scope_a)
    save_s = time.perf_counter() - t0
    ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                     for f in os.listdir(d))
    more, _ = _steps(exe_a, main, cost, scope_a, feed, c['resume'])
    losses_a += more
    # run B: 12 steps uninterrupted, for the run-to-run bound
    exe_b, scope_b = _fresh_run(startup)
    losses_b, ms_b = _steps(exe_b, main, cost, scope_b, feed, n_steps)
    # run R: a fresh scope and executor, the checkpoint, 4 steps
    exe_r, scope_r = tfl.Executor(), tfl.Scope()
    t0 = time.perf_counter()
    step = tfl.io.load_checkpoint(exe_r, d, main, scope=scope_r)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    not_bitwise = [n for n in persist if not scope_r.has(n) or not
                   torch.equal(scope_r.get(n).cpu(), saved[n])]
    on_card = all(scope_r.get(n).is_cuda for n in persist
                  if scope_r.has(n))
    losses_r, _ = _steps(exe_r, main, cost, scope_r, feed, c['resume'])
    tail = slice(c['save_at'], n_steps)
    gap_ab = float(np.max(np.abs(np.subtract(losses_a[tail],
                                             losses_b[tail]))))
    gap_ra = float(np.max(np.abs(np.subtract(losses_r, losses_a[tail]))))
    tol_resume = CKPT_DRIFT * gap_ab + TOL_CKPT_FLOOR
    # #1's launches a step under None and 'full' (one step each, on run
    # B's state, then the program back at 'dots')
    by_level = {'dots': per_step.get('flash_attention_fwd', 0.0)}
    peaks = {}
    for level in (None, 'full', 'dots'):
        tfl.memory_optimize(main, level=level)
        _steps(exe_b, main, cost, scope_b, feed, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        _, ms = _steps(exe_b, main, cost, scope_b, feed, 1)
        by_level[level] = _counts()['flash_attention_fwd']
        peaks[level] = dict(step_ms=ms,
                            peak_bytes=torch.cuda.max_memory_allocated(),
                            modeled_peak_bytes=exe_b.last_step_report[
                                'memory']['modeled_peak_bytes'],
                            modeled_flops_per_step=exe_b.last_step_report[
                                'phases']['compute']['flops_per_step'])
    # the inference model: saved from run A's state, loaded fresh
    with tfl.scope_guard(scope_a):
        tfl.io.save_inference_model(d2, ['src'], [logits], exe_a, main)
    exe_i, scope_i = tfl.Executor(), tfl.Scope()
    with tfl.scope_guard(scope_i):
        prog, feeds, fetches = tfl.io.load_inference_model(d2, exe_i)
    src = _train_feed(c['infer_B'], SEED + 70, c)['src']
    _zero_counts()
    got, = exe_i.run(prog, feed={'src': src}, fetch_list=fetches,
                     scope=scope_i)
    infer_counts = _counts()
    want, = exe_a.run(test, feed={'src': src}, fetch_list=[logits],
                      scope=scope_a)
    fwd_bitwise = bool(np.array_equal(got, want))
    prompts = _serving_prompts(np.random.default_rng(SEED + 71), 10,
                               c['V'])[:6]
    tokens_mem = _greedy_tokens(scope_a, c, prompts)
    tokens_disk = _greedy_tokens(scope_i, c, prompts)
    shutil.rmtree(tmp, ignore_errors=True)
    res = dict(
        config='B=%d T=%d V=%d L=%d D=%d H=%d float32 Adam lr %g, '
        "memory_optimize level 'dots'" % (c['B'], c['T'], c['V'], c['L'],
                                           c['D'], c['H'], c['lr']),
        launches_per_step=per_step, step_ms_run_a=ms_a, step_ms_run_b=ms_b,
        flash_fwd_launches_per_step=by_level, remat_levels=peaks,
        checkpoint=dict(step=step, persistables=len(persist),
                        not_bitwise=not_bitwise, on_card=on_card,
                        bytes=ckpt_bytes, save_s=save_s, load_s=load_s),
        losses_a=losses_a, losses_b=losses_b, losses_resumed=losses_r,
        gap_uninterrupted=gap_ab, gap_resumed=gap_ra,
        tol_resumed=tol_resume,
        inference=dict(feeds=feeds, ops=len(prog.global_block().ops),
                       forward_bitwise=fwd_bitwise,
                       max_abs_diff=float(np.abs(got - want).max()),
                       launches=infer_counts,
                       tokens_equal=tokens_mem == tokens_disk,
                       tokens=tokens_disk),
        seconds=time.perf_counter() - t_phase)
    print("checkpoint -> resume -> inference model: %s" % json.dumps(res))
    if step != c['save_at'] or not_bitwise or not on_card:
        raise SystemExit("checkpoint restored step %s, not bitwise: %s"
                         % (step, not_bitwise[:5]))
    if not all(np.isfinite(losses_a + losses_b + losses_r)) or \
            not gap_ra <= tol_resume:
        raise SystemExit("resumed losses %s against %s (bound %g)"
                         % (losses_r, losses_a[tail], tol_resume))
    if not fwd_bitwise or tokens_mem != tokens_disk:
        raise SystemExit("the reloaded inference model disagrees: %s"
                         % res['inference'])
    want_steps = {'flash_attention_fwd': float(c['L']),
                  'flash_attention_bwd': float(c['L']),
                  'dense_update': float(2 + 12 * c['L'] + 4)}
    if per_step != want_steps or infer_counts['flash_attention_fwd'] != \
            c['L']:
        raise SystemExit("launches per step %s, want %s; inference %s"
                         % (per_step, want_steps, infer_counts))
    if by_level[None] != c['L'] or by_level['full'] != 2 * c['L'] or \
            by_level['dots'] != c['L']:
        raise SystemExit("launches per step of #1 by level %s" % by_level)
    return dict(counts=counts, infer_counts=infer_counts, **res)


def phase_record_mnist(c=RECORD_MNIST):
    """Phase 55: the book's MNIST convnet trained from record files:
    ``datasets.common.convert`` writes the synthetic train set, and
    ``reader.creator.recordio`` -> ``batch`` -> ``DataFeeder`` feeds the
    steps.  Gates: the samples read back bitwise the reader's; the book's
    accuracy gate; #5 once per parameter a step."""
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix='chip_smoke_rec_')
    data_common.convert(tmp, mnist_data.train(), c['chunk'], 'mnist')
    paths = sorted(os.path.join(tmp, f) for f in os.listdir(tmp))
    back = list(tfl.reader.creator.recordio(paths)())
    want = list(mnist_data.train()())
    same = len(back) == len(want) and all(
        np.array_equal(a[0], b[0]) and a[1] == b[1]
        for a, b in zip(back, want))
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
    reader = tfl.batch(tfl.reader.creator.recordio(paths), c['B'],
                       drop_last=True)
    accs, losses = [], []
    _zero_counts()
    for _ in range(c['epochs']):
        for data in reader():
            loss, a = exe.run(main, feed=feeder.feed(data),
                              fetch_list=[avg_cost, acc], scope=scope)
            losses.append(float(loss[0]))
            accs.append(float(a[0]))
        if np.mean(accs[-10:]) > c['gate']:
            break
    counts = _counts()
    shutil.rmtree(tmp, ignore_errors=True)
    res = dict(config='MNIST convnet from %d record files, Adam lr %g, '
               'batch %d' % (len(paths), c['lr'], c['B']),
               samples=len(back), read_back_bitwise=same, steps=len(accs),
               last10_accuracy=float(np.mean(accs[-10:])),
               first_loss=losses[0], last_loss=losses[-1],
               launches=counts, seconds=time.perf_counter() - t0)
    print("mnist from record files: %s" % json.dumps(res))
    if not same or len(paths) != 8:
        raise SystemExit("record files did not read back the samples")
    if not res['last10_accuracy'] > c['gate']:
        raise SystemExit("mnist from record files: accuracy %.3f"
                         % res['last10_accuracy'])
    if {k: n / len(accs) for k, n in counts.items()} != _want(
            dense_update=n_adam):
        raise SystemExit("mnist from record files launched %s" % counts)
    return dict(counts=counts, **res)


# benchmarks/bench_decode.py:34's on_tpu row, uncut: B=64 sources of
# length 64 (ids 1..V-1 from default_rng(0), as :52-54), V=30000,
# word_dim = dim // 2 = 256, H = dim = 512, beam 4, max_len 32; the
# decode runs in the scope phase 20 trained (the same mt_* parameters at
# the same widths) through run_steps(repeat=reps), as bench_decode.py
# drives it (its chain is 50 on a TPU; ``reps`` here), timed over
# ``rounds`` calls
DECODE = dict(B=64, T=64, V=S2S['V'], word_dim=S2S['word_dim'], H=S2S['H'],
              K=4, max_len=32, reps=4, rounds=3, parity_B=8)
# a card hypothesis rescored on the CPU: the training program's summed
# cross entropy of its teacher-forced tokens against minus its score,
# relative.  Both sum up to max_len float32 log-probs; the decode takes
# log(softmax) where the training program takes the fused log-softmax,
# ~1e-7 relative a token apart (8.2e-8 measured in the reference on the
# CPU at V=60, K=3, max_len=6)
TOL_RESCORE = 1e-4
# the book's control-flow tests on the card, at their own sizes and
# gates: tests/book/test_machine_translation.py (dict 1000, 3 epochs of
# 16 batches of 16, Adam 0.002, the mean of the last 8 sum-pooled costs
# under 110, then decode at K=4 and K=1 with max_len 8),
# tests/book/test_mnist_if_else.py (1024 samples, batch 64, 4 epochs,
# Adam 5e-3, the mean accuracy of the last 10 batches above 0.9) and
# tests/test_rnn_wrappers.py's cases
BOOK_CF = dict(mt_dict=1000, mt_samples=256, mt_B=16, mt_epochs=3,
               mt_lr=0.002, mt_gate=110.0, mt_max_len=8,
               ie_samples=1024, ie_B=64, ie_epochs=4, ie_lr=5e-3,
               ie_gate=0.9)


def _decode_program(c, beam):
    """seq2seq's beam decode program at ``c``'s widths: (main, ids,
    scores)."""
    main = tfl.Program()
    with tfl.program_guard(main, tfl.Program()):
        src = tfl.layers.data(name='src_word_id', shape=[1], dtype='int64',
                              lod_level=1)
        ids, scores = seq2seq.decode(
            src, c['V'], word_dim=c['word_dim'], hidden_dim=c['H'],
            beam_size=beam, max_len=c['max_len'])
    return main, ids, scores


def _staged_decode_feed(ids, lens):
    """A decode feed staged on the card: the ids and their ``@LEN``
    column as device tensors, so a run copies nothing from the host."""
    return {'src_word_id': torch.from_numpy(ids).cuda(),
            'src_word_id@LEN': torch.from_numpy(
                np.asarray(lens, np.int32)).cuda()}


def _check_decode_out(ids, scores, b, k, max_len, what):
    if tuple(ids.shape) != (b, k, max_len) or \
            tuple(scores.shape) != (b, k):
        raise SystemExit("%s: ids %s, scores %s" % (what, tuple(ids.shape),
                                                     tuple(scores.shape)))
    if not np.isfinite(scores).all() or \
            not np.all(np.diff(scores, axis=1) <= 1e-5):
        raise SystemExit("%s: scores not finite or not best-first: %s"
                         % (what, scores[:2]))


def _is_host_sync(message):
    """torch's words for a host sync under ``set_sync_debug_mode('warn')``.
    The mode's first setting in a process also warns, from the setter,
    that the mode is a prototype: that notice is no sync."""
    return 'called a synchronizing' in str(message).lower()


def phase_decode(s2s, c=DECODE):
    """Phase 56: the beam decode at bench_decode.py's width in phase 20's
    scope.  Decode ms p50 over ``rounds`` run_steps calls of ``reps``
    decodes (host clock, each call ending in the ids' copy to the host),
    generated tokens/s (B * max_len a decode) and the beam-expanded rate
    (x K); #9's launches per decode (2: the encoder's two GRUs; the
    decoder's gru_unit step is eager torch, as the reference's is XLA);
    #9's device time at the decode's shape; peak memory; the host syncs of
    one decode (``set_sync_debug_mode('warn')``: reported, not gated); a
    traced decode's busy and idle share and its kernels by name."""
    exe, scope = s2s['exe'], s2s['scope']
    main, ids, scores = _decode_program(c, c['K'])
    bad = [(p.name, p.shape) for p in main.all_parameters()
           if not scope.has(p.name) or
           tuple(scope.get(p.name).shape) != tuple(p.shape)]
    if bad:
        raise SystemExit("decode parameters missing from or unlike phase "
                         "20's scope: %s" % bad)
    rng = np.random.default_rng(0)
    src = rng.integers(1, c['V'], (c['B'], c['T'], 1)).astype(np.int32)
    feed = _staged_decode_feed(src, np.full((c['B'],), c['T']))
    fetch = [ids, scores]

    def decode_steps():
        out = exe.run_steps(main, feed=feed, fetch_list=fetch,
                            scope=scope, repeat=c['reps'],
                            return_numpy=False)
        return [o.cpu().numpy() for o in out]

    t0 = time.perf_counter()
    decode_steps()   # plans the program; the first decodes
    first_call_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    walls, outs = [], None
    for _ in range(c['rounds']):
        t0 = time.perf_counter()
        outs = decode_steps()
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = _counts()
    n_dec = c['rounds'] * c['reps']
    per_decode = {k: n / n_dec for k, n in counts.items()}
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(walls)) / c['reps']
    tok_s = c['B'] * c['max_len'] / (ms / 1e3)
    # one decode through run: its wall, and its host syncs
    t0 = time.perf_counter()
    single = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    single_ms = (time.perf_counter() - t0) * 1e3
    sync_sites = {}

    def note_sync(message, *args, **kwargs):
        # the innermost frame of the port or of this script names the site
        if not _is_host_sync(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if 'paddle_tpu_torch' in f.filename or
                  f.filename.endswith('chip_smoke.py')]
        f = frames[-1] if frames else traceback.extract_stack()[-2]
        site = '%s:%d %s' % (os.path.relpath(f.filename), f.lineno, f.line)
        sync_sites[site] = sync_sites.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter('always')
        warnings.showwarning = note_sync
        torch.cuda.set_sync_debug_mode('warn')
        try:
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                          return_numpy=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum(sync_sites.values())
    out = [o.cpu().numpy() for o in out]
    for got in (single, out):
        if not (np.array_equal(got[0], outs[0][-1]) and
                np.array_equal(got[1], outs[1][-1])):
            raise SystemExit("two decodes of one feed differ")
    _check_decode_out(out[0], out[1], c['B'], c['K'], c['max_len'],
                      'decode')

    def one():
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                return_numpy=False)
    wall, rows, busy = _device_kernels(one)
    top = sorted(rows, key=lambda r: -r[1])[:12]

    def by(*tags):
        return sum(ms_ for k, ms_, _ in rows if any(t in k for t in tags))
    n_kernels = sum(n for *_, n in rows)
    profile_ = dict(
        wall_ms=wall, device_busy_ms=busy if rows else None,
        idle_share=1.0 - busy / wall if rows else None,
        kernels=n_kernels, kernels_per_tick=n_kernels / c['max_len'],
        gru_fwd_ms=by(*[k for k, _ in GRU_FWD_PARTS]),
        gemm_ms=by('gemm', 'Kernel2'), sort_ms=by('Sort', 'sort'),
        top=[dict(kernel=k[:80], ms=m, count=n) for k, m, n in top])
    # #9 at the decode's shape: the encoder's GRUs, no h0, no gates (the
    # no-grad path), against its plain version
    t, b, h = c['T'], c['B'], c['H']
    gen = torch.Generator().manual_seed(SEED + 56)
    x = torch.randn((t, b, 3 * h), generator=gen).cuda()
    w = (torch.randn((h, 3 * h), generator=gen) * h ** -0.5).cuda()
    hs, _ = gk._gru_forward(x, w, None, False)
    hs_plain, _ = gk._plain_gru_forward(x, w, None)
    nbytes = 4 * (t * b * 3 * h + 3 * h * h + t * b * h)
    kernel = dict(
        shape='T=%d B=%d H=%d float32, no h0, no gates (the decode\'s '
              'encoder)' % (t, b, h),
        max_abs_err=float((hs - hs_plain).abs().max()),
        ms=_device_ms(lambda: gk._gru_forward(x, w, None, False), iters=5,
                      replays=3),
        plain_ms=_device_ms(lambda: gk._plain_gru_forward(x, w, None),
                            iters=2, replays=2),
        call_ms=_call_ms(lambda: gk._gru_forward(x, w, None, False),
                         iters=5),
        **_flash_bound(nbytes, 2 * t * b * h * 3 * h))
    res = dict(
        config='bench_decode.py:34: B=%d sources of length %d, V=%d '
               'word_dim=%d H=%d beam %d max_len %d, float32, phase 20\'s '
               'weights; run_steps(repeat=%d) x %d'
               % (c['B'], c['T'], c['V'], c['word_dim'], h, c['K'],
                  c['max_len'], c['reps'], c['rounds']),
        first_call_s=first_call_s, walls_ms=walls, decode_ms_p50=ms,
        single_run_ms=single_ms, generated_tokens_per_s=tok_s,
        beam_expanded_tokens_per_s=tok_s * c['K'],
        launches=counts, launches_per_decode=per_decode,
        peak_memory_bytes=peak, host_syncs_per_decode=syncs,
        host_sync_sites=sync_sites, profile=profile_, gru_fwd=kernel,
        ids_head=out[0][0, 0, :8].tolist(), scores_head=out[1][0].tolist())
    print("seq2seq decode: %s" % json.dumps(res))
    if per_decode != _want(gru_fwd=2):
        raise SystemExit("decode launches per decode %s, want #9 twice"
                         % per_decode)
    if not kernel['max_abs_err'] <= TOL_GRU:
        raise SystemExit("#9 at the decode's shape: %s" % kernel)
    return dict(main=main, ids=ids, scores=scores, counts=counts, **res)


def _rescoring_program(c):
    """The training program's forward (seq2seq.build at phase 20's widths,
    no optimizer): (main, the per-row summed cross entropy's name)."""
    main = tfl.Program()
    with tfl.program_guard(main, tfl.Program()):
        seq2seq.build(c['V'], word_dim=c['word_dim'], hidden_dim=c['H'])
    row_ce, = [op.output('Out')[0] for op in main.global_block().ops
               if op.type == 'sequence_pool' and
               op.attrs['pooltype'] == 'SUM']
    return main, row_ce


def phase_decode_parity(s2s, dec, c=DECODE):
    """Phase 57: the decode on the card and on the CPU (plain versions)
    from phase 20's weights, on ``parity_B`` sources of ragged lengths.
    Gated: every hypothesis the card returns, fed teacher-forced to the
    training program on the CPU, has a summed cross entropy of minus its
    score within TOL_RESCORE relative.  Reported: the share of (b, k) rows
    whose ids equal the CPU's (after 8 training steps the logits are near
    uniform, so near-ties between candidates are expected) and the
    largest score gap."""
    rng = np.random.default_rng(SEED + 57)
    b = c['parity_B']
    lens = rng.integers(c['T'] // 4, c['T'] + 1, b)
    lens[0] = c['T']
    src = np.zeros((b, c['T'], 1), np.int32)
    for r in range(b):
        src[r, :lens[r], 0] = rng.integers(3, c['V'], lens[r])
    feed = {'src_word_id': (src, lens.astype(np.int32))}
    main, fetch = dec['main'], [dec['ids'], dec['scores']]
    card = s2s['exe'].run(main, feed=feed, fetch_list=fetch,
                          scope=s2s['scope'])
    cpu_scope = tfl.Scope()
    for p in main.all_parameters():
        cpu_scope.set(p.name, s2s['scope'].get(p.name).to('cpu', copy=True))
    cpu_exe = tfl.Executor('cpu')
    t0 = time.perf_counter()
    cpu = cpu_exe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    _check_decode_out(card[0], card[1], b, c['K'], c['max_len'],
                      'card decode')
    rescore, row_ce = _rescoring_program(c)
    tf = seq2seq.rescoring_feed(src, lens, card[0])
    ce, = cpu_exe.run(rescore, feed=tf, fetch_list=[row_ce],
                      scope=cpu_scope)
    want = -card[1].reshape(-1)
    rel = np.abs(ce.reshape(-1) - want) / np.abs(want)
    same = (card[0] == cpu[0]).all(axis=2)
    res = dict(sources=b, src_lengths=lens.tolist(),
               rescoring_rel_err_max=float(rel.max()),
               rescoring_rel_err_median=float(np.median(rel)),
               hypothesis_lengths=tf['target_language_next_word'][1].tolist(),
               ids_equal_share=float(same.mean()),
               ids_equal_share_best_beam=float(same[:, 0].mean()),
               score_gap_max=float(np.abs(card[1] - cpu[1]).max()),
               cpu_decode_s=cpu_s, tol=TOL_RESCORE)
    print("seq2seq decode parity: %s" % json.dumps(res))
    if not rel.max() <= TOL_RESCORE:
        raise SystemExit("card hypotheses rescored on the CPU disagree "
                         "with their scores: %s" % res)
    return res


def _book_mt(c=BOOK_CF):
    """tests/book/test_machine_translation.py on the card."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = 7
    with tfl.program_guard(main, startup):
        src, trg, label, _, avg_cost = seq2seq.build(c['mt_dict'])
        tfl.optimizer.AdamOptimizer(learning_rate=c['mt_lr']).minimize(
            avg_cost)
    exe = tfl.Executor()
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    feeder = tfl.DataFeeder(place=exe.place, feed_list=[src, trg, label],
                            program=main)
    reader = tfl.batch(tfl.reader.firstn(wmt14.train(c['mt_dict']),
                                         c['mt_samples']),
                       batch_size=c['mt_B'], drop_last=True)
    _zero_counts()
    costs = []
    t0 = time.perf_counter()
    for _ in range(c['mt_epochs']):
        for batch in reader():
            cost, = exe.run(main, feed=feeder.feed(batch),
                            fetch_list=[avg_cost], scope=scope)
            costs.append(float(np.ravel(cost)[0]))
    train_s = time.perf_counter() - t0
    train_counts = _counts()
    src_batch = [([2, 3, 4, 5],), ([6, 7],), ([8, 9, 10],)]
    decodes = {}
    _zero_counts()
    for beam in (4, 1):
        prog, ids, scores = _decode_program(
            dict(V=c['mt_dict'], word_dim=32, H=32,
                 max_len=c['mt_max_len']), beam)
        dec_feeder = tfl.DataFeeder(place=exe.place,
                                    feed_list=[prog.global_block().var(
                                        'src_word_id')], program=prog)
        got = exe.run(prog, feed=dec_feeder.feed(src_batch),
                      fetch_list=[ids, scores], scope=scope)
        _check_decode_out(got[0], got[1], 3, beam, c['mt_max_len'],
                          'book decode K=%d' % beam)
        decodes['K%d' % beam] = dict(ids=got[0][:, 0].tolist(),
                                     scores=got[1][:, 0].tolist())
    res = dict(steps=len(costs), first8=float(np.mean(costs[:8])),
               last8=float(np.mean(costs[-8:])), train_s=train_s,
               launches=train_counts, decode_launches=_counts(),
               decodes=decodes, gate=c['mt_gate'])
    if not all(np.isfinite(costs)) or not res['last8'] < c['mt_gate']:
        raise SystemExit("book machine translation: %s" % res)
    return res


def _book_mnist_if_else(c=BOOK_CF):
    """tests/book/test_mnist_if_else.py on the card: rows routed by
    IfElse on label < 5, both branches trained through the merge."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = 11
    layers = tfl.layers
    with tfl.program_guard(main, startup):
        image = layers.data(name='x', shape=[784], dtype='float32')
        label = layers.data(name='y', shape=[1], dtype='int64')
        limit = layers.fill_constant_batch_size_like(
            input=label, shape=[-1, 1], dtype='int64', value=5)
        ie = layers.IfElse(layers.less_than(x=label, y=limit))
        for branch in (ie.true_block, ie.false_block):
            with branch():
                hidden = layers.fc(input=ie.input(image), size=64,
                                   act='tanh')
                ie.output(layers.fc(input=hidden, size=10, act='softmax'))
        prob = ie()
        acc = layers.accuracy(input=prob, label=label)
        loss = layers.mean(x=layers.cross_entropy(input=prob, label=label))
        tfl.optimizer.AdamOptimizer(learning_rate=c['ie_lr']).minimize(loss)
    exe = tfl.Executor()
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    feeder = tfl.DataFeeder(place=exe.place, feed_list=[image, label],
                            program=main)
    reader = tfl.batch(tfl.reader.firstn(mnist_data.train(),
                                         c['ie_samples']), c['ie_B'])
    costs, accs = [], []
    for _ in range(c['ie_epochs']):
        for batch in reader():
            cost, a = exe.run(main, feed=feeder.feed(batch),
                              fetch_list=[loss, acc], scope=scope)
            costs.append(float(np.ravel(cost)[0]))
            accs.append(float(np.ravel(a)[0]))
    res = dict(steps=len(costs), first_cost=costs[0], last_cost=costs[-1],
               last10_accuracy=float(np.mean(accs[-10:])),
               gate=c['ie_gate'])
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0] or \
            not res['last10_accuracy'] > c['ie_gate']:
        raise SystemExit("book mnist if-else: %s" % res)
    return res


def _rnn_wrapper_cases():
    """tests/test_rnn_wrappers.py's cases on the card, with its checks."""
    layers = tfl.layers
    out = {}

    def run(build, feeds, steps=1, seed=5):
        main, startup = tfl.Program(), tfl.Program()
        main.random_seed = startup.random_seed = seed
        with tfl.program_guard(main, startup):
            fetch = build()
        exe, scope = tfl.Executor(), tfl.Scope()
        exe.run(startup, scope=scope)
        return [exe.run(main, feed=feeds(k), fetch_list=fetch, scope=scope)
                for k in range(steps)]

    def static_acc():
        x = layers.data(name='x', shape=[5, 3], dtype='float32')
        rnn = layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(shape=[-1, 3], batch_ref=x)
            acc = layers.elementwise_add(x=mem, y=xt)
            rnn.update_memory(mem, acc)
            rnn.step_output(acc)
        return [rnn()]
    xv = np.random.RandomState(0).randn(2, 5, 3).astype('float32')
    got, = run(static_acc, lambda k: {'x': xv})
    out['static_rnn_accumulator_err'] = float(
        np.abs(got[0] - np.cumsum(xv, axis=1)).max())

    def static_train():
        x = layers.data(name='x', shape=[6, 4], dtype='float32')
        y = layers.data(name='y', shape=[1], dtype='float32')
        rnn = layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(shape=[-1, 8], batch_ref=x)
            h = layers.fc(input=[xt, mem], size=8, act='tanh')
            rnn.update_memory(mem, h)
            rnn.step_output(h)
        pred = layers.fc(input=layers.sequence_last_step(input=rnn()),
                         size=1)
        loss = layers.mean(x=layers.square_error_cost(input=pred, label=y))
        tfl.optimizer.AdamOptimizer(0.01).minimize(loss)
        return [loss]
    r = np.random.RandomState(1)
    feed = {'x': r.randn(4, 6, 4).astype('float32'),
            'y': r.randn(4, 1).astype('float32')}
    ls = [float(np.ravel(g[0])[0])
          for g in run(static_train, lambda k: feed, steps=10)]
    out['static_rnn_losses'] = [ls[0], ls[-1]]

    def dynamic():
        x = layers.data(name='x', shape=[2], dtype='float32', lod_level=1)
        drnn = layers.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(x)
            mem = drnn.memory(shape=[2])
            acc = layers.elementwise_add(x=mem, y=xt)
            drnn.update_memory(mem, acc)
            drnn.output(acc)
        o = drnn()
        return [o, layers.sequence_last_step(input=o)]
    (o, last), = run(dynamic, lambda k: {'x': (np.ones((2, 4, 2), 'f4'),
                                              np.array([4, 2], 'int32'))})
    out['dynamic_rnn'] = dict(row0=o[0, :, 0].tolist(),
                              row1=o[1, :, 0].tolist(),
                              last=last[:, 0].tolist())

    def cond(with_fc, nested=False):
        def build():
            x = layers.data(name='x', shape=[4], dtype='float32')
            flag = layers.data(name='flag', shape=[1], dtype='float32')
            y = layers.data(name='y', shape=[1], dtype='float32')
            zero = layers.fill_constant(shape=[1], dtype='float32',
                                        value=0.0)
            cb = layers.ConditionalBlock([layers.less_than(x=zero, y=flag)])
            with cb.block():
                if nested:
                    i = layers.fill_constant(shape=[1], dtype='float32',
                                             value=0.0)
                    limit = layers.fill_constant(shape=[1], dtype='float32',
                                                 value=3.0)
                    h = layers.fill_constant(shape=[1], dtype='float32',
                                             value=0.0)
                    wcond = layers.less_than(x=i, y=limit)
                    with layers.While(cond=wcond, max_iters=3).block():
                        layers.increment(x=h, value=1.0, in_place=True)
                        layers.increment(x=i, value=1.0, in_place=True)
                        layers.less_than(x=i, y=limit, cond=wcond)
                elif with_fc:
                    h = layers.fc(input=x, size=8, act='relu')
                else:
                    h = layers.scale(x=x, scale=2.0)
            if not with_fc:
                return [h]
            pred = layers.fc(input=h, size=1)
            loss = layers.mean(x=layers.square_error_cost(input=pred,
                                                          label=y))
            tfl.optimizer.SGDOptimizer(0.05).minimize(loss)
            return [loss, h]
        return build
    xv = np.array([[1.0, 3.0, -2.0, 0.5]], 'float32')
    for flag in (1.0, 0.0):
        f = {'x': xv, 'flag': np.full((1, 1), flag, 'f4'),
             'y': np.zeros((1, 1), 'f4')}
        (h,), = run(cond(False), lambda k: f)
        (n,), = run(cond(False, nested=True), lambda k: f)
        out['conditional_block_flag%d' % flag] = dict(
            doubled_err=float(np.abs(h - 2 * flag * xv).max()),
            nested_while=float(np.ravel(n)[0]))
    r = np.random.RandomState(0)
    wt = r.randn(4, 1).astype('float32')
    feeds = []
    for _ in range(30):
        xb = r.randn(8, 4).astype('float32')
        feeds.append({'x': xb, 'flag': np.ones((1, 1), 'f4'), 'y': xb @ wt})
    ls = [float(np.ravel(g[0])[0])
          for g in run(cond(True), lambda k: feeds[k], steps=30, seed=11)]
    out['conditional_block_losses'] = [ls[0], ls[-1]]

    def ifelse():
        x = layers.data(name='x', shape=[1], dtype='float32')
        zero = layers.fill_constant(shape=[1], dtype='float32', value=0.0)
        ie = layers.IfElse(layers.less_than(x=x, y=zero))
        with ie.true_block():
            ie.output(layers.scale(x=ie.input(x), scale=-1.0))
        with ie.false_block():
            ie.output(layers.scale(x=ie.input(x), scale=1.0))
        return [ie()]
    xv = np.array([[-2.0], [3.0], [-0.5], [4.0]], 'float32')
    (got,), = run(ifelse, lambda k: {'x': xv})
    out['ifelse_err'] = float(np.abs(got - np.abs(xv)).max())
    ok = (out['static_rnn_accumulator_err'] <= 1e-5 and
          ls[-1] < ls[0] * 0.5 and
          out['static_rnn_losses'][1] < out['static_rnn_losses'][0] * 0.7
          and out['dynamic_rnn'] == dict(row0=[1, 2, 3, 4],
                                         row1=[1, 2, 0, 0],
                                         last=[4, 2]) and
          out['conditional_block_flag1']['doubled_err'] <= 1e-6 and
          out['conditional_block_flag0']['doubled_err'] == 0 and
          out['conditional_block_flag1']['nested_while'] == 3.0 and
          out['conditional_block_flag0']['nested_while'] == 0.0 and
          out['ifelse_err'] == 0)
    if not ok:
        raise SystemExit("rnn wrapper cases on the card: %s" % out)
    return out


def phase_control_flow_books():
    """Phase 58: the control-flow book tests on the card, each with its
    gate."""
    t0 = time.perf_counter()
    res = dict(machine_translation=_book_mt(),
               mnist_if_else=_book_mnist_if_else(),
               rnn_wrappers=_rnn_wrapper_cases())
    res['seconds'] = time.perf_counter() - t0
    print("control-flow book tests: %s" % json.dumps(res))
    return res


# the SRL BiLSTM-CRF (models/srl.py at the book's widths: word 32, mark
# 5, hidden 512, depth 4) on the synthetic CoNLL-2005 dicts (4427 words,
# 300 verbs, mark 2, 19 labels).  The book gate is tests/book/
# test_label_semantic_roles.py's: SGD 0.01, the first 128 test sentences
# in batches of 16 (drop_last), 2 epochs, every loss finite and the mean
# of the last 4 below 18.0.  The timed run stages the first 256 test
# sentences (lengths 5-30, as the reader draws them) once and takes 20
# single-step run_steps calls after a warm-up; the parity step takes the
# next 16.  The evaluator pass walks the 1024-sentence split in 4
# batches.
SRL = dict(B=256, steps=20, lr=0.01, book_samples=128, book_B=16,
           book_epochs=2, book_gate=18.0, parity_B=16, eval_B=256,
           chunk_types=9)
# card vs CPU, one SGD step from the same state: the mean CRF NLL,
# relative (a sum over up to 30 steps of log-sum-exps of float32
# emissions that went through 4 LSTM layers of 512 units; the two
# devices' GEMMs sum in other orders, ~1e-6 relative a layer)
TOL_SRL_LOSS = 1e-4
# a card Viterbi path scored in float64 with the CPU's emissions and the
# transition, against the CPU's best path's score, relative: equal but
# for near-ties (two paths within the emissions' card-vs-CPU gap)
TOL_SRL_VITERBI = 1e-5
# card vs CPU, the same SGD step from the same state: each trainable
# parameter's gap after the step, relative to its largest update on the
# CPU.  A skipped apply or a wrong rate (crfw's 1e-3 scale lost) is a gap
# near 1; the gradients' float32 summation orders differ by ~1e-5 of it
TOL_SRL_UPDATE = 1e-3
# the op sweep: float outputs and gradients of the card against the CPU,
# relative to max(1, |CPU value|) (O(1-20) values from float32
# log-sum-exps and sums of at most 9 steps); integer outputs exact
TOL_SRL_OPS = 1e-5


def _srl_program(seed, optimizer=True, chunk_eval=False, c=SRL):
    """models.srl.build at the book's widths, names reset so every build
    names its parameters alike: (main, startup, feeds, feature_out,
    crf_decode, avg_cost, evaluator or None)."""
    word_dict, verb_dict, label_dict = conll05.get_dict()
    with tprog.reset_unique_name_guard():
        main, startup = tfl.Program(), tfl.Program()
        main.random_seed = startup.random_seed = seed
        with tfl.program_guard(main, startup):
            feeds, feature_out, decode, cost = srl.build(
                len(word_dict), len(verb_dict), 2, len(label_dict))
            if optimizer:
                tfl.optimizer.SGDOptimizer(c['lr']).minimize(cost)
            ev = tfl.evaluator.ChunkEvaluator(
                decode, feeds[-1], 'IOB', c['chunk_types']) \
                if chunk_eval else None
    return main, startup, feeds, feature_out, decode, cost, ev


def _trainable(main):
    return [p.name for p in main.all_parameters() if p.trainable]


def _srl_trainable_shapes():
    """The distinct shapes of SRL's trainable parameters at the book's
    widths."""
    main = _srl_program(SEED)[0]
    return sorted({tuple(p.shape) for p in main.all_parameters()
                   if p.trainable})


def _staged(feed):
    """A DataFeeder's feed as int32 tensors on the card, each ragged
    name's lengths as ``name@LEN``."""
    out = {}
    for n, v in feed.items():
        out[n] = torch.from_numpy(np.ascontiguousarray(
            v.padded()).astype(np.int32)).cuda()
        out[n + '@LEN'] = torch.tensor(v.lengths(),
                                       dtype=torch.int32).cuda()
    return out


def _book_srl(c=SRL):
    """tests/book/test_label_semantic_roles.py on the card, its gate
    unchanged; #5 must launch once per trainable parameter a step, #7
    and #8 never (the relu / sigmoid LSTMs take the scan)."""
    main, startup, feeds, _, _, cost, _ = _srl_program(7)
    place = tfl.CUDAPlace(0)
    exe, scope = tfl.Executor(place), tfl.Scope()
    exe.run(startup, scope=scope)
    feeder = tfl.DataFeeder(feed_list=feeds, place=place, program=main)
    reader = tfl.batch(tfl.reader.firstn(conll05.test(), c['book_samples']),
                       c['book_B'], drop_last=True)
    t0 = time.perf_counter()
    _zero_counts()
    losses = [float(exe.run(main, feed=feeder.feed(b), fetch_list=[cost],
                            scope=scope)[0][0])
              for _ in range(c['book_epochs']) for b in reader()]
    counts = _counts()
    per_step = {k: n / len(losses) for k, n in counts.items()}
    res = dict(steps=len(losses), seconds=time.perf_counter() - t0,
               losses=losses, first4_mean=float(np.mean(losses[:4])),
               last4_mean=float(np.mean(losses[-4:])), gate=c['book_gate'],
               trainable_params=len(_trainable(main)), launches=counts,
               launches_per_step=per_step)
    print("book label_semantic_roles on the card: %s" % json.dumps(res))
    if not all(np.isfinite(losses)) or not res['last4_mean'] < c['book_gate']:
        raise SystemExit("book SRL misses its gate: %s" % res)
    if per_step != _want(dense_update=len(_trainable(main))):
        raise SystemExit("book SRL launches per step %s" % per_step)
    return res


def _path_scores(emission, transition, paths, lengths):
    """float64 score of each row's path: start + emissions + transitions
    + end over the row's length."""
    e = emission.astype(np.float64)
    tr = transition.astype(np.float64)
    out = []
    for b, ln in enumerate(lengths):
        p = paths[b, :ln]
        out.append(tr[0, p[0]] + tr[1, p[-1]] + e[b, np.arange(ln), p].sum()
                   + tr[2:][p[:-1], p[1:]].sum())
    return np.asarray(out)


def _srl_parity(tr, samples, c=SRL):
    """One SGD step from the trained state on the card and on the CPU
    (plain versions): the loss within TOL_SRL_LOSS relative; each card
    Viterbi path (crf_decoding of the step's forward) scored with the
    CPU's emissions within TOL_SRL_VITERBI relative of the CPU path's
    score; the share of equal tags reported; each trainable parameter
    after the step (#5's sgd apply) within TOL_SRL_UPDATE of its update,
    and the frozen word_emb bitwise unchanged on both."""
    main, scope = tr['main'], tr['scope']
    cpu_scope = tfl.Scope()
    for v in main.list_vars():
        if v.persistable and scope.has(v.name):
            cpu_scope.set(v.name, scope.get(v.name).to('cpu', copy=True))
    crfw = cpu_scope.get_numpy('crfw').copy()
    names = _trainable(main)
    before = {n: cpu_scope.get_numpy(n).copy()
              for n in names + ['word_emb']}
    feed = tfl.DataFeeder(feed_list=tr['feeds'], place=tfl.CPUPlace(),
                          program=main).feed(samples)
    lengths = np.asarray(feed['word_data'].lengths())
    fetch = [tr['cost'], tr['feature_out'], tr['decode']]
    _zero_counts()
    card = tr['exe'].run(main, feed=feed, fetch_list=fetch, scope=scope)
    counts = _counts()
    cpu = tfl.Executor('cpu').run(main, feed=feed, fetch_list=fetch,
                                  scope=cpu_scope)
    loss_rel = abs(float(card[0][0]) - float(cpu[0][0])) / \
        abs(float(cpu[0][0]))
    card_paths, cpu_paths = card[2][..., 0], cpu[2][..., 0]
    want = _path_scores(cpu[1], crfw, cpu_paths, lengths)
    got = _path_scores(cpu[1], crfw, card_paths, lengths)
    rescore = np.abs(got - want) / np.abs(want)
    valid = np.arange(card_paths.shape[1])[None, :] < lengths[:, None]
    params = {}
    for n in names:
        got = scope.get(n).cpu().numpy()
        want = cpu_scope.get_numpy(n)
        update = float(np.abs(want - before[n]).max())
        gap = float(np.abs(got - want).max())
        params[n] = dict(max_abs_gap=gap, max_update=update,
                         rel=gap / update if update else float(gap > 0))
    frozen = dict(card=bool(np.array_equal(scope.get('word_emb').cpu().numpy(),
                                           before['word_emb'])),
                  cpu=bool(np.array_equal(cpu_scope.get_numpy('word_emb'),
                                          before['word_emb'])))
    worst = max(params, key=lambda n: params[n]['rel'])
    res = dict(sentences=len(samples), tokens=int(lengths.sum()),
               loss_card=float(card[0][0]), loss_cpu=float(cpu[0][0]),
               loss_rel_err=loss_rel,
               emission_max_abs_gap=float(np.abs(card[1] - cpu[1]).max()),
               viterbi_rescore_rel_err_max=float(rescore.max()),
               viterbi_tags_equal_share=float(
                   (card_paths == cpu_paths)[valid].mean()),
               viterbi_rows_equal_share=float(np.mean(
                   [(card_paths[b] == cpu_paths[b]).all()
                    for b in range(len(lengths))])),
               params_checked=len(params),
               param_worst=dict(params[worst], name=worst),
               param_max_abs_gap=max(r['max_abs_gap']
                                     for r in params.values()),
               word_emb_unchanged=frozen, launches=counts,
               tol=dict(loss=TOL_SRL_LOSS, viterbi=TOL_SRL_VITERBI,
                        update=TOL_SRL_UPDATE))
    print("srl parity: %s" % json.dumps(res))
    if not np.isfinite(card[0]).all() or not loss_rel <= TOL_SRL_LOSS:
        raise SystemExit("the SRL step on the card disagrees with the CPU: "
                         "%s" % res)
    if not rescore.max() <= TOL_SRL_VITERBI:
        raise SystemExit("a card Viterbi path scores below the CPU's best: "
                         "%s" % res)
    if not params[worst]['rel'] <= TOL_SRL_UPDATE or \
            not all(frozen.values()):
        raise SystemExit("the SRL step's parameters on the card disagree "
                         "with the CPU's: %s" % res)
    if counts != {k: int(v) for k, v in _want(
            dense_update=len(_trainable(main))).items()}:
        raise SystemExit("SRL parity step launched %s" % counts)
    return res


def phase_srl_training(c=SRL):
    """Phase 59: the book gate, then the timed run at the book's widths
    on 256 staged sentences (step ms p50, sentences/s, tokens/s, peak
    memory, a traced step), #5 once per trainable parameter a step and #7
    and #8 never, and the parity step."""
    book = _book_srl(c)
    main, startup, feeds, feature_out, decode, cost, _ = _srl_program(SEED)
    n_train = len(_trainable(main))
    exe, scope = tfl.Executor(), tfl.Scope()
    exe.run(startup, scope=scope)
    samples = list(conll05.test()())
    batch = samples[:c['B']]
    host = tfl.DataFeeder(feed_list=feeds, place=tfl.CPUPlace(),
                          program=main).feed(batch)
    lengths = np.asarray(host['word_data'].lengths())
    feed = _staged(host)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def step():
        out, = exe.run_steps(main, feed=feed, fetch_list=[cost],
                             scope=scope, repeat=1)
        return out.ravel().tolist()

    _zero_counts()
    losses = step()
    step_ms = []
    for _ in range(c['steps']):
        t0 = time.perf_counter()
        losses += step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    wall, rows, busy = _device_kernels(step)
    p50 = float(np.median(step_ms))
    per_step = {k: n / len(losses) for k, n in counts.items()}
    res = dict(
        config='SRL db_lstm word %d mark %d hidden %d depth %d, 19 '
        'labels, SGD %g, B=%d staged, run_steps(repeat=1)' % (
            srl.word_dim, srl.mark_dim, srl.hidden_dim, srl.depth, c['lr'],
            c['B']),
        sentences=c['B'], tokens_per_step=int(lengths.sum()),
        max_len=int(lengths.max()), step_ms=step_ms, step_ms_p50=p50,
        sentences_per_s=c['B'] / (p50 / 1e3),
        tokens_per_s=float(lengths.sum()) / (p50 / 1e3),
        max_memory_allocated=peak, steps=len(losses), losses=losses,
        trainable_params=n_train, launches=counts,
        launches_per_step=per_step,
        profile=dict(wall_ms=wall, device_busy_ms=busy,
                     idle_share=1.0 - busy / wall,
                     kernels=sum(n for *_, n in rows),
                     top5=[dict(kernel=k[:100], ms=ms, count=n)
                           for k, ms, n in sorted(rows,
                                                  key=lambda r: -r[1])[:5]]))
    print("srl training: %s" % json.dumps(res))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit("SRL loss not finite or not falling: %s" % losses)
    if per_step != _want(dense_update=n_train):
        raise SystemExit("SRL launches per step %s, want %d dense updates "
                         "and no LSTM kernel" % (per_step, n_train))
    tr = dict(main=main, scope=scope, exe=exe, feeds=feeds, cost=cost,
              feature_out=feature_out, decode=decode)
    res['parity'] = _srl_parity(tr, samples[c['B']:c['B'] + c['parity_B']],
                                c)
    res['book'] = book
    return tr, res


def _sweep_ins(ins, device):
    return {k: [torch.from_numpy(v.astype(np.int32) if v.dtype == np.int64
                                 else v).to(device) for v in vs]
            for k, vs in ins.items()}


def _sweep_gap(a, b):
    """(exact, gap): integer outputs compared exactly, floats relative to
    max(1, |b|), equal values (infinities too) a gap of 0."""
    a, b = a.detach().cpu(), b.detach()
    if not b.dtype.is_floating_point:
        return True, float(torch.ne(a, b).sum())
    diff = torch.where(a == b, torch.zeros_like(b), (a - b).abs())
    gap = (diff / b.abs().clamp(min=1.0)).max() if b.numel() \
        else torch.zeros(())
    return False, float(gap)


# ops that must not stop for the host: the CRF, the CTC loss and the
# metrics (the reference computes them on the device)
SRL_NO_SYNC_OPS = ('linear_chain_crf', 'crf_decoding', 'warpctc',
                   'chunk_eval', 'edit_distance', 'precision_recall',
                   'positive_negative_pair')


def _tests_module(name):
    """tests/<name>.py, the CPU tests' shared cases (numpy only)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'tests', name + '.py')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _host_syncs(fn):
    """(fn(), [file:line of each host sync torch reports while it runs]),
    under ``set_sync_debug_mode('warn')``: a copy to the host, a blocking
    copy from it, a stream or device synchronise."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, ['%s:%d' % (os.path.relpath(w.filename), w.lineno)
                 for w in caught if _is_host_sync(w.message)]


def phase_srl_op_sweep():
    """Phase 60: each of the sequence-labelling slice's 16 op types on
    the card on the CPU tests' inputs (tests/torch_seqlab_cases.py),
    against the same op on the CPU: integer outputs (paths, chunk counts,
    lengths) exactly, float outputs within TOL_SRL_OPS; the gradients of
    linear_chain_crf (emission, transition) and warpctc (logits) too.
    The host syncs of each case's first card call are counted; the CRF,
    CTC and metric ops (SRL_NO_SYNC_OPS) must make none: nothing of
    theirs goes to the host.  (``lod_reset`` makes one: its
    ``target_lod`` attr is copied to the card, as the reference's
    ``jnp.asarray`` puts it on the device.)"""
    cases = _tests_module('torch_seqlab_cases').sweep_cases()
    worst, types, bad, syncs = {}, set(), [], {}
    for name, op, ins, attrs in cases:
        impl = get_op_impl(op)
        staged = _sweep_ins(ins, 'cuda')
        card, sites = _host_syncs(
            lambda: impl.compute(None, staged, dict(attrs)))
        syncs[op] = syncs.get(op, 0) + len(sites)
        if sites and op in SRL_NO_SYNC_OPS:
            bad.append((name, 'host syncs', sites))
        cpu = impl.compute(None, _sweep_ins(ins, 'cpu'), dict(attrs))
        types.add(op)
        for slot in cpu:
            a, b = card[slot][0], cpu[slot][0]
            if a.device.type != 'cuda' or a.shape != b.shape or \
                    a.dtype != b.dtype:
                bad.append((name, slot, str(a.device), str(a.dtype)))
                continue
            exact, gap = _sweep_gap(a, b)
            worst[op] = max(worst.get(op, 0.0), gap)
            if (exact and gap) or (not exact and not gap <= TOL_SRL_OPS):
                bad.append((name, slot, gap))
    grads = {}
    for name, op, ins, attrs in cases:
        wrt = {'linear_chain_crf': ('Emission', 'Transition'),
               'warpctc': ('Logits',)}.get(op)
        if not wrt:
            continue
        outs = []
        for device in ('cuda', 'cpu'):
            t = _sweep_ins(ins, device)
            leaves = [t[s][0].requires_grad_(True) for s in wrt]
            y = get_op_impl(op).compute(None, t, dict(attrs))
            y = y['LogLikelihood' if op == 'linear_chain_crf' else 'Loss'][0]
            ct = torch.linspace(-1, 1, y.numel()).reshape(y.shape).to(
                y.device)
            outs.append(torch.autograd.grad(y, leaves, ct))
        gap = max(_sweep_gap(a, b)[1] for a, b in zip(*outs))
        grads[name] = gap
        if not gap <= TOL_SRL_OPS:
            bad.append((name, 'grad', gap))
    res = dict(cases=len(cases), op_types=sorted(types),
               worst_gap_by_op=worst, grad_gaps=grads, tol=TOL_SRL_OPS,
               host_syncs_by_op=syncs, failures=bad)
    print("srl op sweep: %s" % json.dumps(res))
    if bad or len(types) != 16:
        raise SystemExit("the op sweep failed on the card: %s" % res)
    return res


def phase_srl_chunk_eval(tr, c=SRL):
    """Phase 61: ChunkEvaluator over phase 59's trained model's Viterbi
    decode of the 1024-sentence test split on the card (an evaluation
    build of models.srl, its parameters from phase 59's scope), then the
    same evaluator on the CPU over the card's fetched paths: precision,
    recall and F1 must be equal."""
    main, _, feeds, _, decode, _, ev = _srl_program(
        SEED, optimizer=False, chunk_eval=True)
    exe, scope = tr['exe'], tr['scope']
    place = tfl.CUDAPlace(0)
    feeder = tfl.DataFeeder(feed_list=feeds, place=place, program=main)
    reader = tfl.batch(conll05.test(), c['eval_B'])
    t0 = time.perf_counter()
    fetched = []
    with tfl.scope_guard(scope):
        ev.reset(exe)   # creates the states; the parameters are trained
        for b in reader():
            f = feeder.feed(b)
            out = exe.run(main, feed=f, fetch_list=[decode] + ev.metrics)
            fetched.append((out[0].reshape(len(b), -1),
                            f['word_data'].lengths(),
                            np.asarray(f['target'].padded()).reshape(
                                len(b), -1)))
        card = ev.eval(exe)
    card_s = time.perf_counter() - t0
    cmain, cstartup = tfl.Program(), tfl.Program()
    with tfl.program_guard(cmain, cstartup):
        inf = tfl.layers.data(name='inf', shape=[1], dtype='int64',
                              lod_level=1)
        lab = tfl.layers.data(name='lab', shape=[1], dtype='int64',
                              lod_level=1)
        cev = tfl.evaluator.ChunkEvaluator(inf, lab, 'IOB',
                                           c['chunk_types'])
    cexe = tfl.Executor('cpu')
    with tfl.scope_guard(tfl.Scope()):
        cexe.run(cstartup)
        cev.reset(cexe)
        for paths, lengths, labels in fetched:
            cexe.run(cmain, feed={'inf': (paths[..., None], lengths),
                                  'lab': (labels[..., None], lengths)},
                     fetch_list=cev.metrics)
        cpu = cev.eval(cexe)
    res = dict(sentences=sum(len(f[1]) for f in fetched),
               batches=len(fetched), card_seconds=card_s,
               card=dict(precision=float(card[0]), recall=float(card[1]),
                         f1=float(card[2])),
               cpu=dict(precision=float(cpu[0]), recall=float(cpu[1]),
                        f1=float(cpu[2])))
    print("srl chunk evaluator: %s" % json.dumps(res))
    if not np.array_equal(card, cpu) or not np.isfinite(card).all():
        raise SystemExit("ChunkEvaluator on the card and on the CPU "
                         "disagree: %s" % res)
    return res


def _srl_phases():
    """Phases 59-61, timed together."""
    t0 = time.perf_counter()
    tr, res = phase_srl_training()
    res['op_sweep'] = phase_srl_op_sweep()
    res['chunk_eval'] = phase_srl_chunk_eval(tr)
    print("phases 59-61 (SRL training, the op sweep, ChunkEvaluator): "
          "%.1f s" % (time.perf_counter() - t0))
    return res


def _decode_phases(s2s):
    """Phases 56-58, timed together; they run right after phase 22, while
    phase 20's scope is still on the card."""
    t0 = time.perf_counter()
    dec = phase_decode(s2s)
    dec['parity'] = phase_decode_parity(s2s, dec)
    books = phase_control_flow_books()
    print("phases 56-58 (seq2seq beam decode, its parity, the "
          "control-flow books): %.1f s" % (time.perf_counter() - t0))
    return dec, books


def _persistence_phases():
    """Phases 53-55, timed together."""
    t0 = time.perf_counter()
    remat = phase_remat_matrix()
    torch.cuda.empty_cache()
    ckpt = phase_checkpoint()
    torch.cuda.empty_cache()
    rec = phase_record_mnist()
    print("phases 53-55 (the remat matrix, checkpoint/resume/export, "
          "record files): %.1f s" % (time.perf_counter() - t0))
    return dict(remat=remat, ckpt=ckpt, rec=rec)


# the probe's kernel (#11) against its plain version: every variant in
# float32 and bf16 at edge cases (bq != bk either way, T one tile, the
# 128 head-dim tier, a head dim that is no multiple of 4 and so loaded by
# the threads), norm-relative at fc.tolerance (ops/kernels/
# flash_ceiling.py gives the reasons); then the probe's default shape (BH=128, T=8192,
# D=64) at its 1024 x 1024 tiles and at #1's 64 x 64, where the plain
# version sees a few bh slices only (a full T x T score tensor would be
# 34 GB)
CEILING_CASES = (
    # bh, t, d, bq, bk
    (4, 512, 64, 128, 64), (4, 512, 64, 64, 128), (3, 1024, 64, 256, 512),
    (2, 64, 64, 64, 64), (2, 256, 64, 256, 256), (2, 512, 128, 128, 64),
    (2, 512, 33, 64, 128))
CEILING = dict(B=16, T=8192, H=8, D=64, steps=5, slices=(0, 77, 127),
               tiles=((1024, 1024), (64, 64)))
# the AMP training shape (TRAIN's B, H and T, head dim 64), where #1 runs
# on bf16 q/k/v, at #1's 64 x 64 tiles; a variant there takes tens of us,
# so more calls a graph
CEILING_AMP = dict(B=32, T=512, H=8, D=64, bq=64, bk=64, steps=20)
# at 64 x 64 tiles a bf16 variant short of the row max runs #1's 16-bit
# walk with less tail: mm, mmT and exp each at most this times #1's full
CEILING_STAGE_SLACK = 1.10
# the bf16 readings of phase 62 on the earlier engine, which ran bf16 as
# 3xTF32 (an H100 80GB HBM3 at 700 W): (least, largest) at 5e-4, and of
# maxexp at bk > 64 at 1e-2
CEILING_3XTF32_BF16 = {5e-4: (1.3e-5, 1.2e-4), 1e-2: (1.6e-3, 2.3e-3)}
# the book's GAN on the card (tests/book/test_gan.py): the synthetic
# MNIST's first 256 images in batches of 32 (drop_last), 2 epochs (16
# steps), noise from default_rng(0); every loss finite, the mean D loss of
# the last 4 steps below 1.45 and below the mean of the first 2; 12 dense
# Adam applies a step (D's 6 parameters, then G's).  One step card vs
# CPU from the same state at phase 10's bounds
GAN = dict(B=32, samples=256, epochs=2, gate=1.45, seed=11)
# the book's fit_a_line on the card (tests/book/test_fit_a_line.py: SGD
# 0.01, batches of 32 of the shuffled synthetic train set, up to 12
# epochs, the last cost below 12.0 and below the first), and one step of
# it under each of the five optimizers the slice adds, card vs CPU at
# phase 10's bounds
FIT = dict(B=32, epochs=12, gate=12.0, lr=0.01)
FIT_OPTIMIZERS = {
    'adamax': lambda: tfl.optimizer.AdamaxOptimizer(learning_rate=0.01),
    'decayed_adagrad': lambda: tfl.optimizer.DecayedAdagradOptimizer(
        learning_rate=0.05),
    'adadelta': lambda: tfl.optimizer.AdadeltaOptimizer(learning_rate=1.0),
    'rmsprop': lambda: tfl.optimizer.RMSPropOptimizer(learning_rate=0.01,
                                                      momentum=0.5),
    'ftrl': lambda: tfl.optimizer.FtrlOptimizer(learning_rate=0.05,
                                                l1=0.01, l2=0.01),
}


def _ceiling_case(q, k, v, variant, bq, bk, rows=None):
    """#11 against its plain version on q, k, v (or on their bh
    ``rows``): (norm-relative gap, largest absolute gap)."""
    kk = k.transpose(1, 2).contiguous() if variant == 'mmT' else k
    o = fc.flash_ceiling(q, kk, v, variant, bq, bk)
    torch.cuda.synchronize()
    if rows is not None:
        q, kk, v, o = (x[list(rows)].contiguous() for x in (q, kk, v, o))
    ref = fc._plain_ceiling(q, kk, v, variant, bq, bk)
    gap = (o.float() - ref.float())
    return (gap.norm() / ref.float().norm()).item(), gap.abs().max().item()


def phase_ceiling_kernel(inputs):
    """Phase 62: #11 against its plain version, each variant in float32
    and bf16, at the edge cases and the probe's default shape
    (``inputs``: {dtype: the probe's q, k, v})."""
    t0 = time.perf_counter()
    gen = torch.Generator(device='cuda').manual_seed(SEED + 60)
    rows = []
    for bh, t, d, bq, bk in CEILING_CASES:
        for dtype in fc.DTYPES:
            q, k, v = ((torch.randn((bh, t, d), generator=gen,
                                    device='cuda') * mul).to(dtype)
                       for mul in (0.1, 0.1, 1.0))
            for variant in fc.VARIANTS:
                rel, err = _ceiling_case(q, k, v, variant, bq, bk)
                tol = fc.tolerance(dtype, variant, bk)
                rows.append(dict(case='bh%d_t%d_d%d_bq%d_bk%d' % (
                    bh, t, d, bq, bk), dtype=str(dtype)[6:],
                    variant=variant, norm_rel=rel, max_abs_err=err,
                    tol=tol, ok=rel <= tol))
    c = CEILING
    bh = c['B'] * c['H']
    for dtype, (q, k, v) in inputs.items():
        for bq, bk in c['tiles']:
            for variant in fc.VARIANTS:
                rel, err = _ceiling_case(q, k, v, variant, bq, bk,
                                         c['slices'])
                tol = fc.tolerance(dtype, variant, bk)
                rows.append(dict(case='probe_bq%d_bk%d' % (bq, bk),
                                 dtype=str(dtype)[6:], variant=variant,
                                 slices=list(c['slices']), norm_rel=rel,
                                 max_abs_err=err, tol=tol, ok=rel <= tol))
    for r in rows:
        print("ceiling %-24s %-8s %-6s norm-rel %.3g (tol %.0e) max abs "
              "%.3g %s" % (r['case'], r['dtype'], r['variant'], r['norm_rel'],
                           r['tol'], r['max_abs_err'],
                           'ok' if r['ok'] else 'FAIL'))
    for tol, (lo, hi) in CEILING_3XTF32_BF16.items():
        got = [r['norm_rel'] for r in rows
               if r['dtype'] == 'bfloat16' and r['tol'] == tol]
        print("ceiling bf16 norm-rel at tol %.0e: %.3g to %.3g over %d "
              "cases (16-bit engine); the 3xTF32 engine read %.2g to %.2g"
              % (tol, min(got), max(got), len(got), lo, hi))
    print("phase 62 (#11 vs its plain version): %.1f s"
          % (time.perf_counter() - t0))
    bad = [(r['case'], r['dtype'], r['variant']) for r in rows
           if not r['ok']]
    if bad:
        raise SystemExit("#11 disagrees with its plain version: %s" % bad)
    return rows


def _ceiling_bound(bh, t, d, bq, bk, dtype):
    """#11's (bytes, flops) and bounds: q, k, v read once and o written
    once; the probe's ``executed``, 4 * D flops a pair of the live
    logical tiles (#1's formula).  ``bound_ms`` at the rate of the
    tensor-core products the kernel runs for the inputs' type: 3xTF32's
    for float32, the 16-bit rate for bf16 (one m16n8k16 product, no
    split); the float32 CUDA cores' as ``cuda_core_bound_ms``."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * bh * t * d * item
    flops = fc.executed_flops(bh, t, d, bq, bk)
    tc = _tc_bound(nbytes, flops, dtype)
    return dict(bytes=nbytes, flops=flops, bound_ms=tc[0], bound_by=tc[1],
                cuda_core_bound_ms=_bound(nbytes, flops)[0])


def _ceiling_stages(out):
    """A probe run's split of #1's time: the two products (mm), then what
    exp adds, the row max adds (maxexp, which also keeps the logical
    tile's sum) and the rest of #1's tail (the mask, l, the rescaled
    accumulator and the normalised store) adds; mmT - mm is the cost of
    reading k's fragments transposed."""
    ms = {k: out[k]['ms'] for k in fc.VARIANTS + ('full',)}
    return dict(products=ms['mm'], transposed_k=ms['mmT'] - ms['mm'],
                exp=ms['exp'] - ms['mm'], max=ms['maxexp'] - ms['exp'],
                rest_of_full=ms['full'] - ms['maxexp'],
                mm_over_full=ms['mm'] / ms['full'],
                mmT_over_full=ms['mmT'] / ms['full'],
                exp_over_full=ms['exp'] / ms['full'])


def phase_ceiling_probe(inputs):
    """Phase 63: the probe's entry point (``flash_ceiling_probe.run``, the
    port of benchmarks/exp_flash_ceiling.py) at its default shape, its
    1024 x 1024 tiles and #1's 64 x 64, in bf16 (the TPU probe's type)
    and float32, and in bf16 at the AMP training shape (``CEILING_AMP``):
    each variant and ``full`` (#1, causal) in device time, SDPA beside
    ``full`` on the bf16 runs, and the stage split.  #11's counts are set
    to 0 just before and read just after: the probe's calls are the
    kernel's main path.  The plain version is timed at the 1024 x 1024
    tiles (36 logical tiles a bh; at 64 x 64 it would walk 8256 in
    Python)."""
    t0 = time.perf_counter()
    c, a = CEILING, CEILING_AMP
    # (B, T, H, D, bq, bk, steps, dtype), q, k, v
    jobs = [((c['B'], c['T'], c['H'], c['D'], bq, bk, c['steps'], dtype),
             inputs[dtype])
            for dtype in (torch.bfloat16, torch.float32)
            for bq, bk in c['tiles']]
    jobs.append(((a['B'], a['T'], a['H'], a['D'], a['bq'], a['bk'],
                  a['steps'], torch.bfloat16),
                 fc_probe.probe_inputs(a['B'] * a['H'], a['T'], a['D'],
                                       torch.bfloat16)))
    _zero_counts()
    runs = [fc_probe.run(*args, inputs=qkv) for args, qkv in jobs]
    counts = _counts()
    by_variant = dict(fc.variant_launches)
    plain = {}
    bq, bk = c['tiles'][0]
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = inputs[dtype]
        for variant in ('mm', 'maxexp'):
            plain['%s_%s' % (variant, str(dtype)[6:])] = _device_ms(
                lambda: fc._plain_ceiling(q, k, v, variant, bq, bk),
                iters=1, replays=2)
        torch.cuda.empty_cache()
    slow = []
    for out, (_, qkv) in zip(runs, jobs):
        cfg = out['config']
        dtype = getattr(torch, cfg['dtype'])
        bh = cfg['B'] * cfg['H']
        if dtype == torch.bfloat16:
            q, k, v = (x.view(cfg['B'], cfg['H'], cfg['T'], cfg['D'])
                       for x in qkv)
            out['sdpa'] = {'ms': fc_probe.device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True),
                iters=cfg['steps'])}
        out['bound'] = _ceiling_bound(bh, cfg['T'], cfg['D'], cfg['bq'],
                                      cfg['bk'], dtype)
        out['stages'] = _ceiling_stages(out)
        print("ceiling probe %s: %s" % (cfg['dtype'], json.dumps(out)))
        print("ceiling stages %s BH=%d T=%d D=%d %dx%d (ms): mm %.4f mmT "
              "%.4f exp %.4f maxexp %.4f full %.4f%s | products %.4f, "
              "+exp %.4f, +max %.4f, rest of #1's tail %.4f; mmT - mm %.4f"
              % (cfg['dtype'], bh, cfg['T'], cfg['D'], cfg['bq'], cfg['bk'],
                 out['mm']['ms'], out['mmT']['ms'], out['exp']['ms'],
                 out['maxexp']['ms'], out['full']['ms'],
                 ' (SDPA %.4f)' % out['sdpa']['ms'] if 'sdpa' in out else '',
                 out['stages']['products'], out['stages']['exp'],
                 out['stages']['max'], out['stages']['rest_of_full'],
                 out['stages']['transposed_k']))
        if dtype == torch.bfloat16 and cfg['bq'] == cfg['bk'] == 64:
            slow += ['%s at T=%d' % (variant, cfg['T'])
                     for variant in ('mm', 'mmT', 'exp')
                     if out['stages'][variant + '_over_full'] >
                     CEILING_STAGE_SLACK]
    res = dict(runs=runs, counts=counts, variant_launches={
        '%s/%s' % key: n for key, n in by_variant.items()},
        plain_ms=plain, seconds=time.perf_counter() - t0)
    print("phase 63 (the ceiling probe beside #1): %s" % json.dumps(
        {k: v for k, v in res.items() if k != 'runs'}))
    # each variant's device_ms: 3 warm-up calls, one capture of `steps`
    # and its replays run inside the graph (not counted)
    calls = sum(3 + out['config']['steps'] for out in runs)
    want = len(fc.VARIANTS) * calls
    if counts['flash_ceiling'] != want or \
            counts['flash_attention_fwd'] != calls:
        raise SystemExit("ceiling probe launches %s, want %d of #11"
                         % (counts, want))
    for out in runs:
        if not all(np.isfinite(out[k]['ms']) and out[k]['ms'] > 0
                   for k in fc.VARIANTS + ('full',)):
            raise SystemExit("ceiling probe timing: %s" % out)
    if slow:
        raise SystemExit("bf16 variants at 64 x 64 tiles slower than %.2fx "
                         "#1's full: %s" % (CEILING_STAGE_SLACK, slow))
    return res


def _ceiling_line(rows, probe):
    """#11's entry of the kernels line: the bf16 run at the probe's
    default shape and tiles is the main row (the TPU probe's type)."""
    main = probe['runs'][0]
    assert main['config']['dtype'] == 'bfloat16' and \
        main['config']['bq'] == 1024
    return dict(
        name='flash_ceiling', route='cuda',
        source='paddle_tpu_torch/csrc/flash_ceiling.cu',
        replaces='benchmarks/exp_flash_ceiling.py:106',
        launches=probe['counts']['flash_ceiling'],
        launches_by_path=dict(ceiling_probe=probe['counts'][
            'flash_ceiling']),
        launches_by_variant=probe['variant_launches'],
        max_abs_err=max(r['max_abs_err'] for r in rows
                        if r['dtype'] == 'float32'),
        ms=main['mm']['ms'], plain_ms=probe['plain_ms']['mm_bfloat16'],
        bound_ms=main['bound']['bound_ms'],
        bound_by=main['bound']['bound_by'],
        cuda_core_bound_ms=main['bound']['cuda_core_bound_ms'],
        library_ms=None,
        shape='BH=128 T=8192 D=64 bf16, variant mm, bq = bk = 1024 '
              '(the probe\'s default)',
        runs=probe['runs'], plain_ms_by_case=probe['plain_ms'],
        cases=rows)


def _gan_program(c=GAN):
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = c['seed']
    with tfl.program_guard(main, startup):
        img, noise, d_loss, g_loss, _ = gan.build(img_dim=784)
    return main, startup, img, d_loss, g_loss


def _copy_scope(main, scope, device='cpu'):
    out = tfl.Scope()
    for v in main.list_vars():
        if v.persistable and scope.has(v.name):
            out.set(v.name, scope.get(v.name).to(device, copy=True))
    return out


def phase_gan(c=GAN):
    """Phases 64-65: the book's GAN on the card through ``DataFeeder``,
    its gate and launches; then one step card vs CPU from the same state:
    both losses, every gradient, every Adam update."""
    t0 = time.perf_counter()
    main, startup, img, d_loss, g_loss = _gan_program(c)
    n_adam = sum(op.type == 'adam' for op in main.global_block().ops)
    exe, scope = tfl.Executor(), tfl.Scope()
    exe.run(startup, scope=scope)
    feeder = tfl.DataFeeder(place=exe.place, feed_list=[img], program=main)
    rng = np.random.default_rng(0)
    reader = tfl.batch(tfl.reader.firstn(mnist_data.train(), c['samples']),
                       batch_size=c['B'], drop_last=True)
    d_losses, g_losses, step_s = [], [], []
    _zero_counts()
    for _ in range(c['epochs']):
        for batch in reader():
            feed = feeder.feed([(s[0],) for s in batch])
            feed['noise'] = rng.normal(
                size=(len(batch), gan.NOISE_DIM)).astype(np.float32)
            t1 = time.perf_counter()
            d, g = exe.run(main, feed=feed, fetch_list=[d_loss, g_loss],
                           scope=scope)
            step_s.append(time.perf_counter() - t1)
            d_losses.append(float(d[0]))
            g_losses.append(float(g[0]))
    counts = _counts()
    per_step = {k: n / len(d_losses) for k, n in counts.items()}
    res = dict(config='tests/book/test_gan.py: B=%d, %d steps, Adam 2e-4 '
               'beta1 0.5 twice' % (c['B'], len(d_losses)),
               d_losses=d_losses, g_losses=g_losses,
               step_ms_p50=float(np.median(step_s[2:])) * 1e3,
               d_last4=float(np.mean(d_losses[-4:])),
               d_first2=float(np.mean(d_losses[:2])), adam_ops=n_adam,
               launches=counts)
    print("gan training: %s" % json.dumps(res))
    if n_adam != 12 or per_step != _want(dense_update=n_adam):
        raise SystemExit("gan launches per step %s" % per_step)
    if not (np.isfinite(d_losses).all() and np.isfinite(g_losses).all() and
            res['d_last4'] < c['gate'] and res['d_last4'] < res['d_first2']):
        raise SystemExit("gan book gate fails on the card: %s" % res)
    res['parity'] = _gan_parity(c)
    print("phases 64-65 (the GAN, its parity): %.1f s"
          % (time.perf_counter() - t0))
    return res


def _gan_parity(c=GAN):
    """One GAN step on the card and on the CPU from the card's initial
    state: both losses at TOL_TRAIN_LOSS, each gradient norm-relative at
    TOL_TRAIN_GRAD (G's at D's pre-update parameters on both), each
    update at TOL_TRAIN_UPDATE (phase 10's bounds and reasons)."""
    main, startup, img, d_loss, g_loss = _gan_program(c)
    params = [p.name for p in main.all_parameters()]
    exe, card = tfl.Executor(), tfl.Scope()
    exe.run(startup, scope=card)
    cpu = _copy_scope(main, card)
    before = {n: cpu.get_numpy(n) for n in params}
    rng = np.random.default_rng(c['seed'])
    feed = {'img': np.stack([s[0] for s in tfl.reader.firstn(
        mnist_data.train(), c['B'])()]).astype(np.float32),
            'noise': rng.normal(size=(c['B'], gan.NOISE_DIM)).astype(
                np.float32)}
    fetch = [d_loss.name, g_loss.name] + [p + '@GRAD' for p in params]
    _zero_counts()
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=card)
    launches = _counts()['dense_update']
    want = tfl.Executor('cpu').run(main, feed=feed, fetch_list=fetch,
                                   scope=cpu)
    res = dict(loss_err=max(abs(float(a[0]) - float(b[0]))
                            for a, b in zip(got[:2], want[:2])),
               grad_norm_rel=max(_norm_rel(a, b) for a, b in
                                 zip(got[2:], want[2:])),
               update_norm_rel=max(
                   _norm_rel(card.get_numpy(n) - before[n],
                             cpu.get_numpy(n) - before[n]) for n in params),
               launches=launches)
    print("gan parity: %s" % json.dumps(res))
    if not (res['loss_err'] <= TOL_TRAIN_LOSS and
            res['grad_norm_rel'] <= TOL_TRAIN_GRAD and
            res['update_norm_rel'] <= TOL_TRAIN_UPDATE and launches == 12):
        raise SystemExit("gan step card vs CPU: %s" % res)
    return res


def _fit_program(opt):
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        x, y, _, cost = fit_a_line.build()
        opt().minimize(cost)
    return main, startup, x, y, cost


def phase_fit_a_line(c=FIT):
    """Phase 66: the book's fit_a_line on the card (SGD through
    ``DataFeeder``: #5's sgd rule twice a step), its gate; then one step
    under each of the five new optimizers, card vs CPU from the same
    state: the loss at TOL_TRAIN_LOSS, each parameter's update
    norm-relative at TOL_TRAIN_GRAD (eager rules on both sides, on
    gradients within that bound)."""
    t0 = time.perf_counter()
    main, startup, x, y, cost = _fit_program(
        lambda: tfl.optimizer.SGDOptimizer(learning_rate=c['lr']))
    exe, scope = tfl.Executor(), tfl.Scope()
    exe.run(startup, scope=scope)
    feeder = tfl.DataFeeder(place=exe.place, feed_list=[x, y], program=main)
    reader = tfl.batch(tfl.reader.shuffle(uci_housing.train(), buf_size=256),
                       batch_size=c['B'], drop_last=True)
    costs = []
    _zero_counts()
    for _ in range(c['epochs']):
        for data in reader():
            out, = exe.run(main, feed=feeder.feed(data), fetch_list=[cost],
                           scope=scope)
            costs.append(float(out[0]))
        if costs[-1] < c['gate']:
            break
    counts = _counts()
    res = dict(costs=costs, steps=len(costs), first=costs[0],
               last=costs[-1], launches=counts)
    ok = (np.isfinite(costs).all() and costs[-1] < costs[0] and
          costs[-1] < c['gate'] and
          counts == {k: int(v) for k, v in _want(
              dense_update=2 * len(costs)).items()})
    samples = list(uci_housing.train()())[:c['B']]
    feed = {'x': np.stack([s[0] for s in samples]),
            'y': np.stack([s[1] for s in samples])}
    res['optimizers'] = {}
    for name, opt in FIT_OPTIMIZERS.items():
        main, startup, _, _, cost = _fit_program(opt)
        params = [p.name for p in main.all_parameters()]
        card = tfl.Scope()
        tfl.Executor().run(startup, scope=card)
        cpu = _copy_scope(main, card)
        before = {n: cpu.get_numpy(n) for n in params}
        _zero_counts()
        got, = tfl.Executor().run(main, feed=feed, fetch_list=[cost],
                                  scope=card)
        launches = sum(_counts().values())
        want, = tfl.Executor('cpu').run(main, feed=feed, fetch_list=[cost],
                                        scope=cpu)
        r = dict(loss_rel=abs(float(got[0]) - float(want[0])) /
                 abs(float(want[0])),
                 update_norm_rel=max(
                     _norm_rel(card.get_numpy(n) - before[n],
                               cpu.get_numpy(n) - before[n])
                     for n in params),
                 ops=sum(op.type == name for op in main.global_block().ops),
                 launches=launches)
        r['ok'] = bool(r['loss_rel'] <= TOL_TRAIN_LOSS and
                       r['update_norm_rel'] <= TOL_TRAIN_GRAD and
                       r['ops'] == 2 and launches == 0)
        ok &= r['ok']
        res['optimizers'][name] = r
    res['seconds'] = time.perf_counter() - t0
    print("fit_a_line: %s" % json.dumps(res))
    print("phase 66 (fit_a_line, the five optimizers): %.1f s"
          % res['seconds'])
    if not ok:
        raise SystemExit("fit_a_line or an optimizer fails on the card: %s"
                         % res)
    return res


def _ceiling_inputs(c=CEILING):
    """{dtype: the probe's q, k, v} at its default shape, on the card."""
    return {dtype: fc_probe.probe_inputs(c['B'] * c['H'], c['T'], c['D'],
                                         dtype)
            for dtype in fc.DTYPES}


def _slice13_phases():
    """Phases 62-66, timed together."""
    t0 = time.perf_counter()
    inputs = _ceiling_inputs()
    rows = phase_ceiling_kernel(inputs)
    probe = phase_ceiling_probe(inputs)
    del inputs
    torch.cuda.empty_cache()
    gan_res = phase_gan()
    fit = phase_fit_a_line()
    print("phases 62-66 (#11 and its probe, the GAN, fit_a_line and the "
          "optimizers): %.1f s" % (time.perf_counter() - t0))
    return rows, probe, gan_res, fit


def _add_paths(lines, paths, zeros=()):
    """Adds each path's launches ({path: _counts()}) to the kernel lines'
    ``launches`` and ``launches_by_path``; a kernel in ``zeros`` records
    its count even where it is 0 (a path gated to launch it never)."""
    by_name = {line['name']: line for line in lines}
    for path, counts in paths.items():
        for k, n in counts.items():
            if n or k in zeros:
                by_name[k]['launches'] += n
                by_name[k]['launches_by_path'][path] = n


def _amp_phases():
    """Phases 44-51, timed together: the AMP slice."""
    t0 = time.perf_counter()
    tr = phase_amp_training()
    tr['parity'] = phase_amp_parity(tr)
    with amp.amp_guard('bf16'):
        tr['profile'] = phase_train_profile(tr, 'transformer bf16 profile')
    del tr['scope'], tr['feed'], tr['exe']
    torch.cuda.empty_cache()
    f16 = phase_amp_f16()
    f16['sparse'] = phase_amp_f16_sparse()
    torch.cuda.empty_cache()
    rn = phase_resnet_training(RESNET_BF16, 'resnet50 bf16 training')
    rn['profile'] = phase_image_profile(rn, 'resnet50 bf16 profile')
    del rn['scope'], rn['feed'], rn['exe']
    torch.cuda.empty_cache()
    s2s = phase_s2s_training('bfloat16', 'seq2seq bf16 training')
    del s2s['scope'], s2s['feed'], s2s['exe']
    lm = phase_lm_training('bfloat16', 'lm bf16 training')
    del lm['scope'], lm['exe']
    torch.cuda.empty_cache()
    print("phases 44-51 (AMP: transformer bf16 and f16, ResNet-50, seq2seq "
          "and the LM in bfloat16): %.1f s" % (time.perf_counter() - t0))
    return dict(tr=tr, f16=f16, rn=rn, s2s=s2s, lm=lm)


def _ctr_phases():
    """Phases 37-42, timed together."""
    t0 = time.perf_counter()
    fm = phase_ctr_training()
    fm['profile'] = phase_ctr_profile(fm)
    del fm['scope'], fm['feed'], fm['exe']
    torch.cuda.empty_cache()
    parity = phase_ctr_parity()
    sweep = phase_ctr_sweep()
    book = phase_book_ctr()
    calc = phase_calc_gradient()
    print("phases 37-42 (the CTR family, calc_gradient): %.1f s"
          % (time.perf_counter() - t0))
    return dict(fm=fm, parity=parity, sweep=sweep, book=book, calc=calc)


def _image_phases():
    """Phases 28-36, timed together."""
    t0 = time.perf_counter()
    rn = phase_resnet_training()
    phase_resnet_parity(rn)
    phase_image_profile(rn)
    mn = phase_mnist_training()
    del rn['scope'], rn['feed']
    t1 = time.perf_counter()
    vg = phase_vgg_training()
    vg['parity'] = phase_vgg_parity(vg)
    vg['parity_relu_handoff'] = phase_vgg_parity(
        vg, label='vgg16 parity, card relu gates', handoff=('relu',))
    vg['parity_gates_handoff'] = phase_vgg_parity(
        vg, label='vgg16 parity, card relu gates and max-pool choices',
        handoff=('relu', 'pool2d'))
    vg['parity_controls'] = phase_vgg_parity_controls(vg)
    phase_dropout_op()
    phase_image_profile(vg, 'vgg16 profile')
    del vg['scope'], vg['feed']
    torch.cuda.empty_cache()
    book = phase_book_vgg()
    recipes = phase_recipes()
    t2 = time.perf_counter()
    print("phases 28-31 (ResNet-50, MNIST): %.1f s; phases 32-36 (VGG-16, "
          "the book's VGG, the recipes): %.1f s" % (t1 - t0, t2 - t1))
    return rn, mn, vg, book, recipes


# benchmark/paddle/image/{googlenet,alexnet,smallnet_mnist_cifar}.py through
# models/{googlenet,alexnet,smallnet}.py (SURVEY M4), uncut: GoogLeNet and
# AlexNet at 224x224x3, 1000 classes, batch 128, SmallNet at 32x32x3, 10
# classes, batch 64; float32 NCHW, Momentum lr 0.01 mu 0.9 (bench_vgg.py's
# rate: the repo has no bench file of its own for these three); one batch
# of default_rng(0) normal images and integer labels staged on the card
# and run by run_steps, 24 steps.  GoogLeNet's dropout 0.4 and AlexNet's
# two of 0.5 make single losses noisy, so the loss check compares the mean
# of the first 4 steps with the mean of the last 4 (phase 32's rule)
GOOGLENET = dict(model='googlenet', B=128, hw=224, classes=1000, lr=0.01,
                 mu=0.9, steps=8, total_steps=24, parity_B=2, params=116)
ALEXNET = dict(GOOGLENET, model='alexnet', params=16)
SMALLNET = dict(GOOGLENET, model='smallnet', B=64, hw=32, classes=10,
                params=10)
# one step of each at B=2, card vs CPU from the same state, the card's
# dropout masks handed to the CPU: first as it is, held to phase 10's
# bounds (TOL_TRAIN_*: a relu input within rounding of 0 can gate one way
# on the card and the other on the CPU, and everything below it moves;
# VGG-16 reads 0.86% so); then with the card's relu signs and max-pool
# choices handed over too, so only arithmetic differs, held to the bounds
# below, each set between what the sound step reads and what a planted
# fault reads (image_step_parity's ``fault``).  These nets have no batch
# norm to amplify rounding from the head down: on an H100 80GB HBM3 at
# 700 W (PERF.md section 6) the sound handed-over step read at most 4.1e-6
# norm-relative (an update; gradients 1.5e-6) and a loss gap of 1.9e-6;
# TF32 on the card read 1.0e-3 (AlexNet) to 1.8e-3 (GoogLeNet) and a loss
# gap of 2.8e-5 to 1.2e-3; the first filter 0.1% off 1.2e-3 (a
# gradient), 0.17 (its update) and 4.3e-3 (the loss).  The gradient,
# velocity and update bound sits near the geometric middle of 4.1e-6 and
# 1.0e-3; the loss bound at 5x the sound reading, below TF32's least
TOL_M4_LOSS = 1e-5
TOL_M4_GRAD = 6e-5
M4_FAULTS = ('tf32', 'filter_1e-3')
# the dense op library's sweep on the card against the CPU: float outputs
# and gradients relative to max(1, |CPU|), the CPU tests' bound
TOL_LIB_OPS = 1e-5
# ops that must not stop for the host: the detection pair, unpool and the
# losses (the reference computes them on the device)
LIB_NO_SYNC_OPS = ('detection_output', 'roi_pool', 'unpool', 'smooth_l1',
                   'smooth_l1_loss', 'hinge_loss', 'huber_loss', 'log_loss',
                   'rank_loss', 'margin_rank_loss', 'modified_huber_loss',
                   'nce')
# SSD300 on VOC: 8732 priors, 21 classes, the op's nms_top_k 400 and
# keep_top_k 200, batch 8
SSD300 = dict(B=8, classes=21, nms_top_k=400, keep_top_k=200)


def _m4_programs(c):
    """The model of ``c['model']`` with the mean cross entropy and
    Momentum, as the image benchmarks build it."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    model = {'googlenet': googlenet.googlenet, 'alexnet': alexnet.alexnet,
             'smallnet': smallnet.smallnet}[c['model']]
    with tfl.program_guard(main, startup):
        img = tfl.layers.data(name='img', shape=[3, c['hw'], c['hw']],
                              dtype='float32')
        label = tfl.layers.data(name='label', shape=[1], dtype='int64')
        pred = model(img, c['classes'])
        cost = tfl.layers.mean(x=tfl.layers.cross_entropy(input=pred,
                                                          label=label))
        tfl.optimizer.MomentumOptimizer(c['lr'], c['mu']).minimize(cost)
    return main, startup, cost


def phase_m4_training(c):
    """Phases 67, 70, 73: ``c['model']`` at the image benchmarks' width
    trained through run_steps on one batch staged on the card
    (``_image_training``, 24 steps); each step must launch the dense
    update once per parameter and no other kernel; every loss finite,
    the mean of the last 4 below the mean of the first 4."""
    run = _image_training(
        c, _m4_programs,
        '%s B=%d %dx%d NCHW float32 Momentum lr %g mu %g, run_steps on one '
        'staged batch' % (c['model'], c['B'], c['hw'], c['hw'], c['lr'],
                          c['mu']))
    n_params = len(run['main'].all_parameters())
    run['first4_mean'] = float(np.mean(run['losses'][:4]))
    run['last4_mean'] = float(np.mean(run['losses'][-4:]))
    print("%s training: %s" % (c['model'], json.dumps(_printable(run))))
    if n_params != c['params'] or run['apply_ops'] != n_params:
        raise SystemExit("%s has %d parameters and %d momentum ops, want "
                         "%d each" % (c['model'], n_params,
                                      run['apply_ops'], c['params']))
    if run['launches_per_step'] != _want(dense_update=n_params):
        raise SystemExit("%s launches per step %s, want %d dense updates"
                         % (c['model'], run['launches_per_step'], n_params))
    if not all(np.isfinite(run['losses'])) or \
            not run['last4_mean'] < run['first4_mean']:
        raise SystemExit("%s loss not finite or not falling: %s"
                         % (c['model'], run['losses']))
    return run


def _parity_summary(res):
    return {k: res[k] for k in ('handoff', 'fault', 'loss_err',
                                'norm_rel_err', 'median_norm_rel',
                                'relu_flips', 'bad', 'nonfinite', 'tol')}


def phase_m4_parity(run, c, seed=SEED + 60):
    """Phases 68, 71, 74: one step at B=2 on the card and on the CPU from
    the same state (``image_step_parity``), the card's dropout masks
    handed over: as it is, held to TOL_TRAIN_*; with the card's relu
    signs and max-pool choices handed over too, held to TOL_M4_*; and
    under each planted fault of M4_FAULTS (card side only), which must
    break TOL_M4_*.  Each sound step must launch #5 once per parameter
    and nothing else."""
    gate = ('relu', 'pool2d')
    res = dict(plain=image_step_parity(run, c, seed))
    res['handoff'] = image_step_parity(run, c, seed, gate,
                                       tol_grad=TOL_M4_GRAD,
                                       tol_loss=TOL_M4_LOSS)
    for fault in M4_FAULTS:
        res[fault] = image_step_parity(run, c, seed, gate, fault,
                                       TOL_M4_GRAD, TOL_M4_LOSS)
    print("%s parity: %s" % (c['model'], json.dumps(
        {k: _parity_summary(r) for k, r in res.items()})))
    for k in ('plain', 'handoff'):
        r = res[k]
        if r['nonfinite'] or r['bad']:
            raise SystemExit("%s step on the card disagrees with the CPU "
                             "(%s: %s) or is not finite (%s)"
                             % (c['model'], k, r['bad'], r['nonfinite']))
        if {n: float(v) for n, v in r['launches'].items()} != _want(
                dense_update=c['params']):
            raise SystemExit("%s parity step launched %s"
                             % (c['model'], r['launches']))
    for fault in M4_FAULTS:
        if not res[fault]['bad']:
            raise SystemExit("%s: the planted fault %s stays within "
                             "TOL_M4_*: the bounds separate nothing"
                             % (c['model'], fault))
    return res




class _SweepCtx(object):
    """A random op's context outside a program: its device and a seeded
    generator there."""

    def __init__(self, device, seed=0):
        self.device = torch.device(device)
        self.seed = seed

    def generator(self, extra=0):
        return torch.Generator(device=self.device).manual_seed(
            self.seed * 1000 + extra)


def _float_slots(ins):
    return [(k, i) for k, vs in ins.items() for i, v in enumerate(vs)
            if v.dtype == np.float32]


def _grads(compute, ins, slot, ct, device):
    """Gradients of ``compute``'s ``slot`` output under ``ct`` with respect
    to every float input, on ``device``."""
    t = _sweep_ins(ins, device)
    leaves = []
    for k, i in _float_slots(ins):
        t[k][i] = t[k][i].requires_grad_(True)
        leaves.append(t[k][i])
    y = compute(t, device)[slot][0]
    got = torch.autograd.grad(y, leaves, torch.from_numpy(ct).to(device),
                              allow_unused=True)
    return [torch.zeros_like(leaf) if g is None else g
            for g, leaf in zip(got, leaves)]


def _window_of(x, y):
    """Whether ``y`` is a window of ``x`` over its trailing dims."""
    lead = x.dim() - sum(a != b for a, b in zip(x.shape, y.shape))
    dims = y.shape[lead:]
    for start in np.ndindex(*[a - b + 1 for a, b in
                              zip(x.shape[lead:], dims)]):
        sl = (slice(None),) * lead + tuple(
            slice(s, s + d) for s, d in zip(start, dims))
        if torch.equal(x[sl], y):
            return True
    return False


def phase_op_library_sweep():
    """Phase 76: each op type the dense op library brings, and the
    repaired ``clip``, on the card on the CPU tests' inputs
    (tests/torch_op_library_cases.py), against the same op on the CPU:
    integer outputs exactly, float outputs within TOL_LIB_OPS; the
    gradients of every differentiable case too, under one cotangent.
    ``nce``: the card's draws are the labels, then negatives in range;
    its cost and logits given the card's samples (``loss.nce_cost``)
    against the CPU's, with their gradients.  ``random_crop``: the
    card's output is a window of X.  The host syncs of each case's first
    card call are counted; LIB_NO_SYNC_OPS must make none."""
    lib = _tests_module('torch_op_library_cases')
    worst, types, bad, syncs, grads = {}, set(), [], {}, {}
    cases = dict(lib.CASES, **lib.RANDOM_CASES)
    for name, (op, ins, attrs) in sorted(cases.items()):
        impl = get_op_impl(op)
        staged = _sweep_ins(ins, 'cuda')
        card, sites = _host_syncs(
            lambda: impl.compute(_SweepCtx('cuda'), staged, dict(attrs)))
        syncs[op] = syncs.get(op, 0) + len(sites)
        if sites and op in LIB_NO_SYNC_OPS:
            bad.append((name, 'host syncs', sites))
        types.add(op)
        if op == 'random_crop':
            if not _window_of(staged['X'][0], card['Out'][0]):
                bad.append((name, 'not a window of X'))
            continue
        if op == 'nce':
            samples = card['SampleLabels'][0]
            label = staged['Label'][0]
            if samples.dtype != torch.int32 or not torch.equal(
                    samples[:, :label.shape[1]], label) or not (
                    (samples >= 0) & (samples < attrs['num_total_classes'])
            ).all():
                bad.append((name, 'samples'))

            def compute(t, device, samples=samples.long(),
                        ntrue=label.shape[1], attrs=attrs):
                cost, logits = tloss.nce_cost(
                    t['Input'][0], t['Weight'][0], t['Bias'][0],
                    samples.to(device), ntrue, attrs['num_neg_samples'],
                    attrs['num_total_classes'])
                return {'Cost': [cost], 'SampleLogits': [logits]}
            card = compute(staged, 'cuda')
        else:
            def compute(t, device, impl=impl, attrs=attrs):
                return impl.compute(_SweepCtx(device), t, dict(attrs))
        cpu = compute(_sweep_ins(ins, 'cpu'), 'cpu')
        for slot in cpu:
            a, b = card[slot][0], cpu[slot][0]
            if a.device.type != 'cuda' or a.shape != b.shape or \
                    a.dtype != b.dtype:
                bad.append((name, slot, str(a.device), str(a.dtype)))
                continue
            exact, gap = _sweep_gap(a, b)
            worst[op] = max(worst.get(op, 0.0), gap)
            if (exact and gap) or (not exact and not gap <= TOL_LIB_OPS):
                bad.append((name, slot, gap))
        if op in lib.NO_GRAD or not _float_slots(ins):
            continue
        slot = lib.GRAD_OUT.get(op, 'Out')
        ct = np.random.default_rng(len(name)).standard_normal(
            tuple(cpu[slot][0].shape)).astype(np.float32)
        pair = [_grads(compute, ins, slot, ct, d) for d in ('cuda', 'cpu')]
        gap = max(_sweep_gap(a, b)[1] for a, b in zip(*pair))
        grads[name] = gap
        if not gap <= TOL_LIB_OPS:
            bad.append((name, 'grad', gap))
    want = set(lib.NEW_OPS) | {'clip'}
    res = dict(cases=len(cases), op_types=len(types & want),
               worst_gap_by_op=worst, worst_grad_gap=max(grads.values()),
               grad_cases=len(grads), tol=TOL_LIB_OPS,
               host_syncs_by_op=syncs, failures=bad)
    print("op library sweep: %s" % json.dumps(res))
    if bad or not want <= types:
        raise SystemExit("the op library sweep failed on the card: %s "
                         "(missing %s)" % (bad, sorted(want - types)))
    return res


def phase_ssd300_detection(c=SSD300):
    """Phase 77: detection_output at SSD300's shape on the card (its 8732
    priors, 21 classes, nms_top_k 400, keep_top_k 200, batch 8; the
    inputs of ``ssd300_case``), timed (CUDA events, the mean of 5 calls
    after one warm-up), with no host sync, against the CPU's output on
    the same inputs: labels and boxes equal, scores within TOL_LIB_OPS."""
    lib = _tests_module('torch_op_library_cases')
    ins = lib.ssd300_case(n=c['B'])
    attrs = dict(num_classes=c['classes'], nms_top_k=c['nms_top_k'],
                 keep_top_k=c['keep_top_k'])
    impl = get_op_impl('detection_output')
    staged = _sweep_ins(ins, 'cuda')
    card, sites = _host_syncs(lambda: impl.compute(None, staged, attrs))
    card = card['Out'][0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        impl.compute(None, staged, attrs)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 5
    t0 = time.perf_counter()
    cpu = impl.compute(None, _sweep_ins(ins, 'cpu'), attrs)['Out'][0]
    cpu_s = time.perf_counter() - t0
    a = card.cpu()
    score_gap = (a[..., 1] - cpu[..., 1]).abs()
    rows_equal = (a[..., 0] == cpu[..., 0]) & \
        (a[..., 2:] == cpu[..., 2:]).all(-1) & (score_gap <= TOL_LIB_OPS)
    res = dict(shape=list(card.shape),
               priors=int(ins['PriorBox'][0].shape[0]), ms=ms,
               cpu_seconds=cpu_s, host_syncs=sites,
               detections_card=int((a[..., 0] >= 0).sum()),
               detections_cpu=int((cpu[..., 0] >= 0).sum()),
               rows_equal=int(rows_equal.sum()),
               rows=int(rows_equal.numel()),
               score_gap=float(score_gap.max()), tol=TOL_LIB_OPS, **attrs)
    print("ssd300 detection_output: %s" % json.dumps(res))
    if sites or not bool(rows_equal.all()) or not torch.isfinite(a).all():
        raise SystemExit("detection_output at SSD300's shape: %s" % res)
    return res


def _m4_phases():
    """Phases 67-77, timed together: the image benchmarks' three models,
    the op library sweep and SSD300's detection_output."""
    t0 = time.perf_counter()
    out = {}
    for c in (GOOGLENET, ALEXNET, SMALLNET):
        run = phase_m4_training(c)
        run['parity'] = phase_m4_parity(run, c)
        run['profile'] = phase_image_profile(run, c['model'] + ' profile')
        for k in ('scope', 'feed', 'exe'):
            del run[k]
        out[c['model']] = run
        torch.cuda.empty_cache()
    out['sweep'] = phase_op_library_sweep()
    out['ssd300'] = phase_ssd300_detection()
    print("phases 67-77 (GoogLeNet, AlexNet, SmallNet, the op library "
          "sweep, SSD300's detection_output): %.1f s"
          % (time.perf_counter() - t0))
    return out


# --serve: #1's build, then phases 78-82
SERVE_SOURCES = ('flash_attention_fwd',)
# benchmarks/bench_serving.py:40-63, main()'s TPU row: ResNet-50 at
# 224x224, 1000 classes, bf16 activations NHWC (resnet.build_imagenet
# dtype='bfloat16', layout='NHWC'), exported at batch 1, 8 and 64; 30
# latency calls (b1, b8), a stacked chain of 30 (b8, b64), a pipelined
# chain of 10 (b64)
RN_SERVE = dict(hw=224, depth=50, classes=1000, batches=(1, 8, 64),
                lat_calls=30, chain=30, pipe_chain=10, samples=3)
# benchmarks/bench_serving.py:209-231 (_build_ctr_tower: 26 slots of
# 10000 x 16 tables, 13 dense features, fc 256-128-1, seed 17) behind
# adaptive batching as dynamic_scenario (:1084-1229) runs it on a TPU:
# max_batch 64, max_wait_ms 10, linger_ms 0.3, 960 requests, 8
# closed-loop clients at depth 8 in three rounds, each beside a
# 150-call single-predict baseline, then Poisson arrivals at 0.5, 1 and 2
# times that baseline; amp_scenario (:234-281): bucket 8 at amp '0' and
# 'bf16', 30 predicts a sample, three samples
CTR_SERVE = dict(slots=26, rows=10000, dim=16, seed=17, max_batch=64,
                 max_wait_ms=10.0, linger_ms=0.3, n_req=960, threads=8,
                 depth=8, rounds=3, base_calls=150, loads=(0.5, 1.0, 2.0),
                 amp_bucket=8, amp_calls=30, samples=3)
# phase 81: the transformer LM's inference program (build_logits) at the
# serving width, B=8 T=512, 5 timed predicts
LM_SERVE = dict(L=6, D=512, H=8, V=30000, B=8, T=512, calls=5)
# phase 80: an answer of a request that rode with others, against its
# row's bucket-1 answer (sigmoid outputs near 0.5; cuBLAS takes other
# kernels at other batch sizes, float32 sums of 429 inputs in other
# orders)
TOL_CTR_ROW_REL = 1e-6
# phase 82: the composed attention against flash on the training shape,
# both float32 (TF32 off), norm-relative
TOL_COMPOSED = 1e-5
# phase 79: the card's b1 artifact's logits against the CPU artifact's,
# norm-relative: bf16 activations rounded after each of ResNet-50's
# layers, summed in float32 in other orders on the two sides; read
# 2.59e-3 on an H100 (PERF.md section 6; the logits' std is ~1600 at
# this init, so the softmax is one-hot and equal on both)
TOL_RN_SERVE_CPU = 1e-2
# phase 80: the bf16 tower's answers against the float32 tower's,
# norm-relative: read 1.24e-3 to 1.39e-3 on an H100 (PERF.md section
# 6), a few bf16 roundings (2^-9) of sigmoid outputs near 0.5
TOL_CTR_AMP = 1e-2


def _norm_gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def phase_flash_op():
    """Phase 78: #1 through ``torch.ops.paddle_tpu_torch.flash_fwd``
    against the direct launch (``fa._launch_forward``), bitwise, at the
    serving shape of phase 3 and the training shapes of phase 7, each
    call one launch; the operator's dispatch beside the direct call's in
    host time per call."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 78)
    rows = []
    for name, bh, t, dtype in (('serve_T256_BH8', 8, 256, torch.float32),
                               ('train_T512_BH256', 256, 512, torch.float32),
                               ('train_T512_BH256_bf16', 256, 512,
                                torch.bfloat16),
                               ('train_T512_BH256_f16', 256, 512,
                                torch.float16)):
        q, k, v = (torch.randn((bh, t, 64), generator=gen,
                               device='cuda').to(dtype) for _ in range(3))
        scale = 64 ** -0.5
        _zero_counts()
        o1, l1 = fa._launch_forward(q, k, v, True, scale)
        o2, l2 = torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, True, scale,
                                                      0, 0)
        torch.cuda.synchronize()
        po, pl = fa._plain_forward(q, k, v, True, scale)
        row = dict(
            case=name, launches=fa.launches,
            bitwise=bool(torch.equal(o1, o2) and torch.equal(l1, l2)),
            err_o=(o2.float() - po.float()).abs().max().item(),
            err_lse=(l2 - pl).abs().max().item(), tol_o=_tol_o(dtype),
            direct_call_ms=_call_ms(lambda: fa._launch_forward(
                q, k, v, True, scale), iters=20),
            op_call_ms=_call_ms(lambda: torch.ops.paddle_tpu_torch.flash_fwd(
                q, k, v, True, scale, 0, 0), iters=20))
        row['ok'] = (row['bitwise'] and row['launches'] == 2 and
                     row['err_o'] <= row['tol_o'] and
                     row['err_lse'] <= TOL_F32)
        rows.append(row)
        print("flash op %s" % json.dumps(row))
    bad = [r['case'] for r in rows if not r['ok']]
    if bad:
        raise SystemExit("flash_fwd operator vs direct launch: %s" % bad)
    return rows


def _cpu_scope(scope, names):
    out = tfl.Scope()
    for n in names:
        if scope.has(n):
            out.set(n, scope.get(n).cpu())
    return out


def _median_s(fn, samples):
    walls = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), walls


def phase_resnet_serving(c=RN_SERVE):
    """Phase 79: ResNet-50 exported and served at bench_serving.py's
    width, batch 1, 8 and 64."""
    from paddle_tpu_torch.inference import InferenceServer, export_inference
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        _, _, pred, _, _ = resnet.build_imagenet(
            depth=c['depth'], num_classes=c['classes'],
            image_shape=(c['hw'], c['hw'], 3), dtype='bfloat16',
            layout='NHWC')
    exe, scope = tfl.Executor(), tfl.Scope()
    exe.run(startup, scope=scope)
    infer = main.prune([pred], ['img']).inference_optimize()
    # the head's logits beside the prediction: at this random init the
    # softmax saturates (one class takes all the mass), so the prediction
    # alone would hide a gap
    logits = [op for op in infer.global_block().ops
              if op.type == 'softmax'][-1].inputs['X'][0]
    fetch = [pred, logits]
    d = tempfile.mkdtemp(prefix='chip_smoke_serve_')
    rng = np.random.default_rng(SEED + 79)
    rows, xs = [], {}
    try:
        for b in c['batches']:
            path = os.path.join(d, 'resnet_b%d.pt2' % b)
            t0 = time.perf_counter()
            size = export_inference(path, {'img': (b, c['hw'], c['hw'], 3)},
                                    fetch, executor=exe, main_program=main,
                                    scope=scope)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            srv = InferenceServer(path)
            load_s = time.perf_counter() - t0
            x = xs[b] = rng.normal(size=(b, c['hw'], c['hw'], 3)).astype(
                np.float32)
            t0 = time.perf_counter()
            got = srv.predict({'img': x})
            first_s = time.perf_counter() - t0
            want = [t.float().cpu().numpy() for t in exe.run(
                infer, feed={'img': x}, fetch_list=fetch, scope=scope,
                return_numpy=False)]
            row = dict(batch=b, artifact_mb=size / 1e6, export_s=export_s,
                       load_s=load_s, first_call_s=first_s,
                       bitwise_vs_run=all(np.array_equal(g, w)
                                          for g, w in zip(got, want)),
                       max_abs_vs_run=max(float(np.abs(g - w).max())
                                          for g, w in zip(got, want)),
                       finite=bool(all(np.isfinite(g).all() for g in got)),
                       rows_sum_to_1=float(np.abs(got[0].sum(1) - 1).max()),
                       logits_std=float(got[1].std()),
                       top_prob_mean=float(got[0].max(1).mean()))
            if b == 1:
                row['_out'] = got
            if b in (1, 8):
                times = []
                for _ in range(c['lat_calls']):
                    t0 = time.perf_counter()
                    srv.predict({'img': x})
                    times.append(time.perf_counter() - t0)
                row['latency_ms_p50'] = float(np.median(times)) * 1e3
            if b in (8, 64):
                k = c['chain']
                stacked = {'img': torch.from_numpy(
                    np.stack([x] * k)).cuda()}
                srv.predict_stacked(stacked)
                med, walls = _median_s(lambda: srv.predict_stacked(stacked),
                                       c['samples'])
                row.update(stacked_img_s=b * k / med,
                           stacked_samples_img_s=[b * k / w for w in walls],
                           device_ms_per_batch=med / k * 1e3, chain=k)
            if b == 64:
                k = c['pipe_chain']

                def pipelined():
                    outs = [srv.predict_async({'img': x}) for _ in range(k)]
                    return [o[0].cpu() for o in outs]
                pipelined()
                med, walls = _median_s(pipelined, c['samples'])
                row.update(pipelined_img_s=b * k / med,
                           pipelined_samples_img_s=[b * k / w
                                                    for w in walls],
                           pipe_chain=k)
                wall, krows, busy = _device_kernels(pipelined)
                top = sorted(krows, key=lambda r: -r[1])[:5]
                row['profile'] = dict(
                    wall_ms=wall, device_busy_ms=busy if krows else None,
                    busy_ms_per_batch=busy / k if krows else None,
                    idle_share=1.0 - busy / wall if krows else None,
                    top=[dict(kernel=n[:80], ms=ms, count=cnt)
                         for n, ms, cnt in top])
            rows.append(row)
            print("resnet50 serving b%d: %s" % (b, json.dumps(
                {k_: v for k_, v in row.items() if k_ != '_out'})))
            del srv
            os.remove(path)
        # the CPU's artifact at batch 1, from the same state
        names = [v.name for v in infer.list_vars() if v.persistable]
        cpath = os.path.join(d, 'resnet_b1_cpu.pt2')
        t0 = time.perf_counter()
        export_inference(cpath, {'img': (1, c['hw'], c['hw'], 3)}, fetch,
                         executor=tfl.Executor('cpu'), main_program=main,
                         scope=_cpu_scope(scope, names))
        cpu_out = InferenceServer(cpath, device='cpu').predict(
            {'img': xs[1]})
        card_out = rows[0].pop('_out')
        cpu = dict(logits_norm_rel=_norm_gap(card_out[1], cpu_out[1]),
                   logits_max_abs=float(np.abs(card_out[1]
                                               - cpu_out[1]).max()),
                   prediction_max_abs=float(np.abs(card_out[0]
                                                   - cpu_out[0]).max()),
                   argmax_equal=bool(card_out[0].argmax()
                                     == cpu_out[0].argmax()),
                   tol=TOL_RN_SERVE_CPU, s=time.perf_counter() - t0)
        print("resnet50 serving b1 card vs cpu artifact: %s"
              % json.dumps(cpu))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    bad = [r['batch'] for r in rows
           if not (r['bitwise_vs_run'] and r['finite'])]
    if bad or cpu['logits_norm_rel'] > TOL_RN_SERVE_CPU:
        raise SystemExit("resnet50 serving: artifact vs Executor.run at %s,"
                         " card vs cpu %s" % (bad, cpu))
    return dict(rows=rows, cpu=cpu)


def _ctr_serve_program(c=CTR_SERVE):
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = c['seed']
    with tfl.program_guard(main, startup):
        embs = [tfl.layers.embedding(
            input=tfl.layers.data(name='C%d' % i, shape=[1], dtype='int64'),
            size=[c['rows'], c['dim']]) for i in range(c['slots'])]
        dense = tfl.layers.data(name='I', shape=[13], dtype='float32')
        feat = tfl.layers.concat(embs + [dense], axis=1)
        h = tfl.layers.fc(input=feat, size=256, act='relu')
        h = tfl.layers.fc(input=h, size=128, act='relu')
        pred = tfl.layers.fc(input=h, size=1, act='sigmoid')
    return main, startup, pred


def _ctr_request(rng, rows, c=CTR_SERVE):
    f = {'C%d' % i: rng.integers(0, c['rows'], size=(rows, 1)).astype(
        np.int32) for i in range(c['slots'])}
    f['I'] = rng.normal(size=(rows, 13)).astype(np.float32)
    return f


def _stamp(fut, t0, lat, i):
    """Write into ``lat[i]`` the ms from ``t0`` (taken before the submit)
    to ``fut``'s completion."""
    def cb(_fut):
        lat[i] = (time.perf_counter() - t0) * 1e3
    fut.add_done_callback(cb)
    return fut


def _stamped(lat, timeout=5.0):
    """The stamps of ``lat`` as an array, once every callback has run (a
    Future wakes its waiters before it runs its callbacks)."""
    deadline = time.perf_counter() + timeout
    while any(x is None for x in lat) and time.perf_counter() < deadline:
        time.sleep(0.001)
    return np.array([x for x in lat if x is not None])


def _ctr_closed_loop(srv, rng, c):
    per = c['n_req'] // c['threads']
    feeds = [[_ctr_request(rng, 1) for _ in range(per)]
             for _ in range(c['threads'])]
    answers = [[None] * per for _ in range(c['threads'])]
    lat = [None] * (c['threads'] * per)

    def client(i):
        q = []
        for j in range(per):
            t0 = time.perf_counter()
            q.append((j, _stamp(srv.submit(feeds[i][j]), t0, lat,
                                i * per + j)))
            while len(q) >= c['depth']:
                jj, fut = q.pop(0)
                answers[i][jj] = fut.result()[0]
        for jj, fut in q:
            answers[i][jj] = fut.result()[0]

    ths = [threading.Thread(target=client, args=(i,))
           for i in range(c['threads'])]
    s0 = srv.stats()
    t0 = time.perf_counter()
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    dt = time.perf_counter() - t0
    s1 = srv.stats()
    occ = ((s1['requests_completed'] - s0['requests_completed'])
           / max(s1['batches'] - s0['batches'], 1))
    pairs = [(f, a) for fs, ans in zip(feeds, answers)
             for f, a in zip(fs, ans)]
    return c['threads'] * per / dt, occ, pairs, _stamped(lat)


def _ctr_open_loop(srv, rng, lam, c):
    n = min(c['n_req'], int(max(lam, 50) * 2) + 50)
    feeds = [_ctr_request(rng, 1) for _ in range(n)]
    gaps = rng.exponential(1.0 / lam, size=n)
    lat = [None] * n
    s0 = srv.stats()
    futs = []
    t0 = time.perf_counter()
    for i in range(n):
        delay = t0 + float(np.sum(gaps[:i + 1])) - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        futs.append(_stamp(srv.submit(feeds[i]), time.perf_counter(), lat,
                           i))
    answers = [f.result()[0] for f in futs]
    dt = time.perf_counter() - t0
    lat = _stamped(lat)
    s1 = srv.stats()
    occ = ((s1['requests_completed'] - s0['requests_completed'])
           / max(s1['batches'] - s0['batches'], 1))
    return dict(load=lam, req_s=n / dt, offered_req_s=lam,
                p50_latency_ms=float(np.percentile(lat, 50)),
                p99_latency_ms=float(np.percentile(lat, 99)),
                mean_batch_occupancy=occ, n_requests=n,
                compiles_after_warmup=s1['compiles_after_warmup']), \
        list(zip(feeds, answers))


def _row_gap(ref1, pairs):
    """The largest relative gap of each answer to its row's bucket-1
    answer, the bucket-1 artifact run as one stacked chain."""
    worst = 0.0
    for lo in range(0, len(pairs), 256):
        chunk = pairs[lo:lo + 256]
        stacked = {n: np.stack([f[n] for f, _ in chunk])
                   for n in chunk[0][0]}
        want = ref1.predict_stacked(stacked)[0].cpu().numpy()
        got = np.stack([a for _, a in chunk])
        worst = max(worst, float((np.abs(got - want)
                                  / np.maximum(np.abs(want), 1e-30)).max()))
    return worst


def phase_ctr_batching(c=CTR_SERVE):
    """Phase 80: the CTR tower behind BatchingInferenceServer at
    dynamic_scenario's settings, then amp_scenario."""
    from paddle_tpu_torch.inference import (BatchingInferenceServer,
                                            InferenceServer,
                                            export_bucketed)
    main, startup, pred = _ctr_serve_program(c)
    exe, scope = tfl.Executor(), tfl.Scope()
    exe.run(startup, scope=scope)
    specs = {'C%d' % i: (1,) for i in range(c['slots'])}
    specs['I'] = (13,)
    t0 = time.perf_counter()
    srv = BatchingInferenceServer.from_program(
        specs, [pred], executor=exe, main_program=main, scope=scope,
        max_batch=c['max_batch'], max_wait_ms=c['max_wait_ms'],
        linger_ms=c['linger_ms'])
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 80)
    try:
        ref = srv._servers[1]
        f1 = _ctr_request(rng, 1)
        ref.predict(f1)
        for _ in range(64):
            srv.submit(f1)
        srv.predict(f1)

        def base_rate(n=c['base_calls']):
            t0 = time.perf_counter()
            for _ in range(n):
                ref.predict(f1)
            return n / (time.perf_counter() - t0)

        bases, rates, occs, pairs, lats = [], [], [], [], []
        for _ in range(c['rounds']):
            bases.append(base_rate())
            r, occ, p, lat = _ctr_closed_loop(srv, rng, c)
            rates.append(r)
            occs.append(occ)
            pairs += p
            lats.append(lat)
        lat = np.concatenate(lats)
        base, rate = float(np.median(bases)), float(np.median(rates))
        st = srv.stats()
        closed = dict(req_s=rate, req_s_rounds=rates,
                      single_predict_req_s=base,
                      single_predict_rounds=bases,
                      speedup_vs_single=rate / base,
                      mean_batch_occupancy=float(np.median(occs)),
                      compiles_warmup=st['compiles'],
                      compiles_after_warmup=st['compiles_after_warmup'],
                      warmup_s=warm_s, buckets=st['buckets'],
                      n_requests=c['n_req'], pipeline_depth=c['depth'],
                      p50_latency_ms=float(np.percentile(lat, 50)),
                      p99_latency_ms=float(np.percentile(lat, 99)),
                      p99_latency_ms_rounds=[float(np.percentile(x, 99))
                                             for x in lats],
                      latencies_stamped=int(lat.size),
                      stats_p50_latency_ms=st['p50_latency_ms'],
                      stats_p99_latency_ms=st['p99_latency_ms'],
                      resident_bytes=srv.resident_bytes()['total_bytes'])
        print("ctr batching closed loop: %s" % json.dumps(closed))
        opens = []
        for frac in c['loads']:
            row, p = _ctr_open_loop(srv, rng, base * frac, c)
            row['load_frac'] = frac
            opens.append(row)
            pairs += p
            print("ctr batching poisson %gx: %s" % (frac, json.dumps(row)))
        # bucket-exact requests, each alone, against the unbatched
        # predict on their bucket's artifact
        exact = {}
        for b in srv._buckets:
            f = _ctr_request(rng, b)
            got, = srv.predict(f)
            want, = srv._servers[b].predict(f)
            exact[b] = bool(np.array_equal(got, want))
        row_gap = _row_gap(ref, pairs)
        st = srv.stats()
    finally:
        srv.close()
    # amp_scenario: bucket 8 at full precision and in bf16
    amp_rows, outs = {}, {}
    feed = _ctr_request(rng, c['amp_bucket'])
    for label, mode in (('off', '0'), ('bf16', 'bf16')):
        d = tempfile.mkdtemp(prefix='chip_smoke_amp_')
        try:
            paths = export_bucketed(d, specs, [pred], executor=exe,
                                    main_program=main, scope=scope,
                                    max_batch=c['amp_bucket'], amp=mode)
            one = InferenceServer(paths[c['amp_bucket']])
            outs[label], = one.predict(feed)
            samples = []
            for _ in range(c['samples']):
                t0 = time.perf_counter()
                for _ in range(c['amp_calls']):
                    one.predict(feed)
                samples.append(c['amp_bucket'] * c['amp_calls']
                               / (time.perf_counter() - t0))
            amp_rows[label] = dict(preds_s=float(np.median(samples)),
                                   samples=samples)
        finally:
            shutil.rmtree(d, ignore_errors=True)
    amp_gap = _norm_gap(outs['bf16'], outs['off'])
    amp_res = dict(amp_rows, bf16_vs_f32_norm_rel=amp_gap,
                   bf16_vs_f32_max_abs=float(np.abs(
                       outs['bf16'] - outs['off']).max()), tol=TOL_CTR_AMP)
    print("ctr amp bucket 8: %s" % json.dumps(amp_res))
    checks = dict(compiles_after_warmup=st['compiles_after_warmup'],
                  bucket_exact_bitwise=exact, row_gap_rel=row_gap,
                  row_tol=TOL_CTR_ROW_REL, answers_checked=len(pairs))
    print("ctr batching checks: %s" % json.dumps(checks))
    if st['compiles_after_warmup'] or not all(exact.values()) or \
            row_gap > TOL_CTR_ROW_REL or amp_gap > TOL_CTR_AMP:
        raise SystemExit("ctr batching: %s" % checks)
    return dict(closed=closed, open=opens, amp=amp_res, checks=checks)


def phase_lm_artifact(c=LM_SERVE):
    """Phase 81: #1 inside a torch.export artifact: the transformer LM's
    inference program at the serving width."""
    from paddle_tpu_torch.inference import InferenceServer, export_inference
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = SEED
    with tfl.program_guard(main, startup):
        _, logits = ttr.build_logits(c['V'], seq_len=c['T'],
                                     n_layers=c['L'], d_model=c['D'],
                                     n_heads=c['H'])
    exe, scope = tfl.Executor(), tfl.Scope()
    exe.run(startup, scope=scope)
    d = tempfile.mkdtemp(prefix='chip_smoke_lm_')
    try:
        path = os.path.join(d, 'lm.pt2')
        t0 = time.perf_counter()
        export_inference(path, {'src': (c['B'], c['T'])}, [logits],
                         executor=exe, main_program=main, scope=scope)
        export_s = time.perf_counter() - t0
        srv = InferenceServer(path)
        src = np.random.default_rng(SEED + 81).integers(
            0, c['V'], size=(c['B'], c['T']))
        staged = {'src': torch.from_numpy(src).cuda()}
        srv.predict_async(staged)
        torch.cuda.synchronize()
        _zero_counts()
        got, = srv.predict_async(staged)
        torch.cuda.synchronize()
        per_predict = fa.launches
        infer = main.prune([logits], ['src']).inference_optimize()
        want, = exe.run(infer, feed={'src': src}, fetch_list=[logits],
                        scope=scope, return_numpy=False)
        bitwise = bool(torch.equal(got, want))
        gap = (got - want).abs().max().item()
        del got, want
        _zero_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(c['calls']):
            srv.predict_async(staged)
        end.record()
        torch.cuda.synchronize()
        counts = _counts()
        ms = start.elapsed_time(end) / c['calls']
    finally:
        shutil.rmtree(d, ignore_errors=True)
    res = dict(launches_per_predict=per_predict, bitwise_vs_run=bitwise,
               max_abs_vs_run=gap, ms_per_predict=ms, export_s=export_s,
               shape='B=%d T=%d L=%d D=%d H=%d V=%d' % (
                   c['B'], c['T'], c['L'], c['D'], c['H'], c['V']),
               counts=counts, lstm_export_refused=_lstm_export_refusal())
    print("lm artifact: %s" % json.dumps(res))
    if per_predict != c['L'] or not bitwise or \
            counts['flash_attention_fwd'] != c['L'] * c['calls'] or \
            "op 'lstm'" not in (res['lstm_export_refused'] or '') or \
            'item 8b' not in res['lstm_export_refused']:
        raise SystemExit("#1 inside the artifact: %s" % res)
    return res


def _lstm_export_refusal():
    """The message with which export on the card refuses a program whose
    op launches a kernel through ctypes (#7 through ``lstm``), or None if
    it does not refuse."""
    from paddle_tpu_torch.inference import export_inference
    main, startup = tfl.Program(), tfl.Program()
    with tfl.program_guard(main, startup):
        x = tfl.layers.data(name='x', shape=[3, 16], dtype='float32',
                            lod_level=1)
        h, _ = tfl.layers.dynamic_lstm(input=x, size=16)
    exe, scope = tfl.Executor(), tfl.Scope()
    exe.run(startup, scope=scope)
    d = tempfile.mkdtemp(prefix='chip_smoke_lstm_')
    try:
        export_inference(os.path.join(d, 'lstm.pt2'),
                         {'x': (2, 3, 16), 'x@LEN': (2,)}, [h],
                         executor=exe, main_program=main, scope=scope)
    except NotImplementedError as e:
        return str(e)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return None


def _composed_attention(use_flash, c=TRAIN):
    main = tfl.Program()
    with tfl.program_guard(main, tfl.Program()):
        x = tfl.layers.data(name='x', shape=[c['T'], c['D']],
                            dtype='float32')
        y = tfl.nets.scaled_dot_product_attention(
            x, x, x, num_heads=c['H'], use_flash=use_flash)
    return main, y


def phase_registry_decode(tokens4=None, c=SERVE):
    """Phase 82: the 24 requests of phase 4 with the engine reaching
    ``paged_attention`` through the op registry (as it now always does),
    counted, against the same requests with the op bodies swapped for
    direct calls of their math (the path before the ops were op types);
    the chunked prefill through ``chunked_prefill_attention`` against the
    monolithic prefill; the composed attention against flash."""
    from paddle_tpu_torch.ops import attention as tatt
    cfg = TransformerConfig(vocab_size=c['V'], seq_len=c['T'],
                            n_layers=c['L'], d_model=c['D'],
                            n_heads=c['H'])
    params = init_params(cfg, torch.Generator().manual_seed(SEED))
    prompts = _serving_prompts(np.random.default_rng(SEED), c['n_req'],
                               c['V'])
    impls = {op: get_op_impl(op) for op in ('paged_attention',
                                            'chunked_prefill_attention')}
    real = {op: impl.compute for op, impl in impls.items()}
    calls = dict.fromkeys(impls, 0)

    def counted(op):
        def compute(ctx, ins, attrs):
            calls[op] += 1
            return real[op](ctx, ins, attrs)
        return compute

    def direct_paged(ctx, ins, attrs):
        return {'Out': [tatt.paged_attention_math(
            ins['Q'][0], ins['KPool'][0], ins['VPool'][0], ins['PT'][0],
            ins['CtxLen'][0])]}

    def serve(compute):
        impls['paged_attention'].compute = compute
        try:
            eng = DecodeEngine(params, n_layers=c['L'], n_heads=c['H'],
                               page_size=c['page'], max_streams=c['streams'],
                               prefill_bucket=c['bucket'])
            srv = DecodeServer(eng)
            _zero_counts()
            streams = [srv.submit(p, max_new_tokens=c['max_new'])
                       for p in prompts]
            drained = srv.drain(timeout=600.0)
            counts = _counts()
            srv.close()
            if not drained:
                raise SystemExit("registry decode did not drain")
            return [list(st.result(timeout=1.0)) for st in streams], counts
        finally:
            impls['paged_attention'].compute = real['paged_attention']

    tokens, counts = serve(counted('paged_attention'))
    direct, _ = serve(direct_paged)
    res = dict(paged_calls=calls['paged_attention'],
               tokens_equal_direct=tokens == direct,
               tokens_equal_phase4=(None if tokens4 is None
                                    else tokens == tokens4),
               flash_launches=counts['flash_attention_fwd'])
    # the chunked prefill: registry calls, last-row logits against the
    # monolithic prefill's
    impls['chunked_prefill_attention'].compute = counted(
        'chunked_prefill_attention')
    try:
        mono = DecodeEngine(params, n_layers=c['L'], n_heads=c['H'],
                            page_size=c['page'], max_streams=c['streams'],
                            prefill_bucket=c['bucket'])
        chunked = DecodeEngine(params, n_layers=c['L'], n_heads=c['H'],
                               page_size=c['page'],
                               max_streams=c['streams'],
                               prefill_bucket=c['bucket'],
                               prefill_chunk_tokens=64)
        worst = 0.0
        for p in prompts[:6]:
            n_pages = -(-len(p) // c['page'])
            pages = mono.cache.alloc(n_pages)
            want = mono.prefill_into(p, pages)
            mono.cache.free(pages)
            pages = chunked.cache.alloc(n_pages)
            for lo, hi in chunked.chunk_spans(len(p)):
                got = chunked.prefill_chunk(p[lo:hi], pages, lo)
            chunked.cache.free(pages)
            worst = max(worst, float(np.abs(got - want).max()))
    finally:
        impls['chunked_prefill_attention'].compute = \
            real['chunked_prefill_attention']
    res.update(chunked_calls=calls['chunked_prefill_attention'],
               chunked_vs_monolithic_max_abs=worst, chunked_tol=TOL_PATH)
    # the composed attention against flash at the training shape
    exe = tfl.Executor()
    x = torch.randn((TRAIN['B'], TRAIN['T'], TRAIN['D']),
                    generator=torch.Generator().manual_seed(SEED + 82))
    outs = {}
    for use_flash in (False, True):
        main, y = _composed_attention(use_flash)
        outs[use_flash], = exe.run(main, feed={'x': x}, fetch_list=[y],
                                   scope=tfl.Scope(), return_numpy=False)
    composed_gap = (torch.linalg.vector_norm(outs[False] - outs[True])
                    / torch.linalg.vector_norm(outs[True])).item()
    res.update(composed_vs_flash_norm_rel=composed_gap,
               composed_tol=TOL_COMPOSED,
               composed_shape='B=%d T=%d D=%d H=%d float32' % (
                   TRAIN['B'], TRAIN['T'], TRAIN['D'], TRAIN['H']))
    print("registry decode and composed attention: %s" % json.dumps(res))
    if not (res['paged_calls'] and res['chunked_calls'] and
            res['tokens_equal_direct'] and res['tokens_equal_phase4']
            is not False and worst <= TOL_PATH and
            composed_gap <= TOL_COMPOSED):
        raise SystemExit("registry decode / composed attention: %s" % res)
    res['counts'] = counts
    return res


def _serve_phases(tokens4=None):
    """Phases 78-82, timed together: serving exported programs."""
    t0 = time.perf_counter()
    out = dict(flash_op=phase_flash_op())
    out['resnet'] = phase_resnet_serving()
    torch.cuda.empty_cache()
    out['ctr'] = phase_ctr_batching()
    out['lm'] = phase_lm_artifact()
    torch.cuda.empty_cache()
    out['registry'] = phase_registry_decode(tokens4)
    out['seconds'] = time.perf_counter() - t0
    print("phases 78-82 (the flash operator, ResNet-50 and CTR serving, "
          "#1 inside an artifact, the registry decode and the composed "
          "attention): %.1f s" % out['seconds'])
    return out


def _dispatch_phases():
    """Phases 3 and 5 alone (``--dispatch``): the decode server's TTFT and
    step p50 and the training step's p50, the two main paths that call
    #1 eagerly, in one line.  Copied into another checkout's root, it
    reads that checkout's package the same way, so that two trees'
    dispatch of #1 compare within one call."""
    eng, _, launches, _, srv = phase_serving()
    del eng
    torch.cuda.empty_cache()
    tr = phase_training()
    print("dispatch: %s" % json.dumps(dict(
        package=os.path.dirname(os.path.abspath(tfl.__file__)),
        ttft_ms_p50=srv['ttft_ms_p50'], decode_step_ms_p50=srv['step_ms_p50'],
        decode_wall_s=srv['wall_s'], decode_flash_launches=launches,
        train_step_ms_p50=tr['step_ms_p50'], train_step_ms=tr['step_ms'])))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = phase_environment()
    if sys.argv[1:] == ['--long-step']:
        phase_training(LONG, 'long-context training', SEED + 20,
                       ('flash_attention_bwd_dkv', 'flash_attention_bwd_dq'))
        return 0
    if sys.argv[1:] == ['--amp-step']:
        build.load_all(('flash_attention_fwd', 'flash_attention_bwd',
                        'dense_update'))
        tr = phase_amp_training()
        with amp.amp_guard('bf16'):
            phase_train_profile(tr, 'transformer bf16 profile')
        return 0
    if sys.argv[1:] == ['--ceiling']:
        phase_build(('flash_attention_fwd', 'flash_ceiling'))
        inputs = _ceiling_inputs()
        phase_ceiling_kernel(inputs)
        phase_ceiling_probe(inputs)
        return 0
    if sys.argv[1:] == ['--m4']:
        build.load_all(('dense_update',))
        _m4_phases()
        return 0
    if sys.argv[1:] == ['--serve']:
        phase_build(SERVE_SOURCES)
        res = _serve_phases()
        print(json.dumps({'serve': res}))
        return 0
    if sys.argv[1:] == ['--dispatch']:
        phase_build(('flash_attention_fwd', 'flash_attention_bwd',
                     'dense_update'))
        _dispatch_phases()
        return 0
    if sys.argv[1:] == ['--flash']:
        phase_build(FLASH_SOURCES)
        phase_kernel()
        bwd_rows, _ = phase_bwd_kernel()
        phase_split_kernel(bwd_rows)
        return 0
    phase_build()
    rows = phase_kernel()
    eng, params, serve_launches, serve_tokens, _ = phase_serving()
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
    dec, cf_books = _decode_phases(s2s)
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
    rn, mn, vg, book, recipes = _image_phases()
    ctr_res = _ctr_phases()
    amp_res = _amp_phases()
    torch.cuda.empty_cache()
    pers = _persistence_phases()
    torch.cuda.empty_cache()
    srl_res = _srl_phases()
    torch.cuda.empty_cache()
    ceil_rows, ceil_probe, gan_res, fit = _slice13_phases()
    torch.cuda.empty_cache()
    m4 = _m4_phases()
    torch.cuda.empty_cache()
    serve = _serve_phases(serve_tokens)
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
                  mn['launches']['dense_update'] +
                  vg['counts']['dense_update'] +
                  book['launches']['dense_update'] + recipes['launches'] +
                  sum(r['launches']['dense_update']
                      for r in ctr_res['book'].values())),
        launches_by_path=dict(
            training=counts['dense_update'],
            seq2seq_training=s2s['counts']['dense_update'],
            resnet50_training=rn['counts']['dense_update'],
            mnist_training=mn['launches']['dense_update'],
            vgg16_training=vg['counts']['dense_update'],
            book_vgg_training=book['launches']['dense_update'],
            training_recipes=recipes['launches'],
            sgd_weight_decay=recipes['sgd_weight_decay_launches'],
            **{'book_%s_training' % k: r['launches']['dense_update']
               for k, r in ctr_res['book'].items()}),
        max_abs_err=dense['worst'],
        ms=dense['ms'], plain_ms=dense['plain_ms'],
        bound_ms=dense['bound_ms'], bound_by=dense['bound_by'],
        library_ms=dense['library_ms'], call_ms=dense['call_ms'],
        library_call_ms=dense['library_call_ms'], shape=dense['shape'],
        resnet_momentum=dense['resnet_momentum'],
        vgg_fc1_momentum=dense['vgg_fc1_momentum'],
        cases=len(dense['cases']))
    table, gru_fwd, gru_bwd = _s2s_lines(gru_rows, gru_timing, sparse_rows,
                                         sparse_timing, s2s)
    _ctr_table_line(table, ctr_res, sparse_timing)
    for line in (fwd, bwd):
        line['amp_training_shape'] = [
            {k: r[k] for k in ('case', 'dtype', 'fwd_ms', 'ms',
                               'library_fwd_ms', 'library_ms',
                               'fwd_bound_3xtf32_ms', 'fwd_bound_16bit_tc_ms',
                               'bound_3xtf32_ms', 'bound_16bit_tc_ms',
                               'fwd_err_o', 'max_abs_err')}
            for r in bwd_rows
            if r['case'].startswith('train_causal_T512_BH256_')]
    lines = [fwd, bwd, dense_line] + _lstm_lines(
        lstm_rows, lstm_timing, lm, sent) + [table, gru_fwd, gru_bwd] + \
        _split_lines(split_rows, split_timing, long_k, long_tr, parity, tr)
    _add_paths(lines, {'amp_bf16_training': amp_res['tr']['counts'],
                       'amp_f16_training': amp_res['f16']['counts'],
                       'amp_f16_sparse_overflow_step':
                           amp_res['f16']['sparse']['launches'],
                       'resnet50_bf16_training': amp_res['rn']['counts'],
                       'seq2seq_bf16_training': amp_res['s2s']['counts'],
                       'lm_bf16_training': amp_res['lm']['counts']})
    _add_paths(lines, dict(
        pers['remat']['paths'],
        transformer_checkpoint_training=pers['ckpt']['counts'],
        transformer_inference_model=pers['ckpt']['infer_counts'],
        mnist_record_files_training=pers['rec']['counts']))
    mt = cf_books['machine_translation']
    _add_paths(lines, dict(
        seq2seq_decode=dec['counts'],
        book_machine_translation_training=mt['launches'],
        book_machine_translation_decode=mt['decode_launches']))
    gru_fwd['decode_shape'] = dict(dec['gru_fwd'],
                                   launches_per_decode=2)
    # the relu / sigmoid LSTMs take the scan: #7 and #8 gated at 0
    _add_paths(lines, dict(srl_training=srl_res['launches'],
                           book_srl_training=srl_res['book']['launches']),
               zeros=('lstm_fwd', 'lstm_bwd'))
    lines.append(_ceiling_line(ceil_rows, ceil_probe))
    _add_paths(lines, dict(
        book_gan_training=gan_res['launches'],
        gan_parity_step=dict(dense_update=gan_res['parity']['launches']),
        book_fit_a_line_training=fit['launches']))
    _add_paths(lines, {'%s_training' % k: m4[k]['counts']
                       for k in ('googlenet', 'alexnet', 'smallnet')})
    # #1 inside a torch.export artifact, and the decode path through the
    # op registry (its prefills)
    _add_paths(lines, dict(
        transformer_inference_artifact=serve['lm']['counts'],
        registry_decode_serving=serve['registry']['counts']))
    fwd['artifact_shape'] = dict(
        shape=serve['lm']['shape'],
        ms_per_predict=serve['lm']['ms_per_predict'],
        launches_per_predict=serve['lm']['launches_per_predict'])
    fwd['operator_vs_direct'] = serve['flash_op']
    print(json.dumps({'kernels': lines}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
