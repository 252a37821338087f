"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference each part of the port is
held against; this package imports neither it nor JAX.  Entry points
run on the card (``device=None`` / ``Executor(place=None)`` means CUDA
device 0, and raises without one); the CPU is used only when the caller
passes ``device='cpu'`` or ``CPUPlace()``.

Ported so far:

- the transformer LM's serving path, ``inference.decode.DecodeServer``
  over ``DecodeEngine``, with prefill attention on the hand-written
  flash-attention forward kernel;
- the fluid-style training surface that trains the same model:
  ``Program`` / ``program_guard``, ``layers``, ``nets``, ``optimizer``
  (SGD, Momentum, Adam) and an eager ``Executor`` with a ``Scope``; the
  attention backward runs on the hand-written flash-attention backward
  kernel and every dense optimizer apply on the hand-written dense-update
  kernel (``ops/kernels/``, ``csrc/``);
- the stacked-LSTM language model and the sentiment LSTMs
  (``models/rnn_lm.py``, ``models/sentiment.py``), trained through the
  same surface with ragged (LoD) feeds (``LoDTensor``, or a ``(data,
  lengths)`` tuple) and ``AdagradOptimizer``; every ``lstm`` op's time
  loop and its backward run on the hand-written LSTM kernels;
- the seq2seq attention translator (``models/seq2seq.py``), trained with
  ``AdamOptimizer``: its ``is_sparse`` embeddings' gradients are
  ``SelectedRows`` applied row by row on the hand-written row-sparse
  update kernel, and every ``gru`` op's time loop and its backward run on
  the hand-written GRU kernels;
- the image models: ResNet (``models/resnet.py``: ``build_imagenet`` at
  depth 50, ``bench.py``'s program, and the book's ``resnet_cifar10``)
  and the MNIST nets (``models/mnist.py``), with ``conv2d``, ``pool2d``
  and ``batch_norm`` (its two-pass statistics and hand-written backward
  in one ``torch.autograd.Function``), Normal initializers, trained with
  ``MomentumOptimizer`` or ``AdamOptimizer`` (every dense apply on the
  hand-written dense-update kernel) through ``Executor.run`` or
  ``Executor.run_steps``, and fed through ``DataFeeder``, ``batch``, the
  ``reader`` decorators and the synthetic ``datasets.mnist`` /
  ``datasets.cifar``;
- VGG (``models/vgg.py``: ``vgg_imagenet`` at depth 16 or 19, the
  program ``benchmarks/bench_vgg.py`` trains, and the book's
  ``vgg16_bn_drop``) with ``nets.img_conv_group`` and fluid's
  non-inverted ``dropout``;
- the rest of ``optimizer.minimize``'s pipeline: ``regularizer``
  (``L1Decay``, ``L2Decay``; SGD folds a dense L2 decay into the
  dense-update kernel's ``weight_decay`` arm), ``clip`` (gradient clip by
  value, by norm and by global norm; ``ErrorClipByValue`` in the
  gradient pass), ``learning_rate_decay`` (five schedules on a step
  counter on the card) and ``global_step``;
- the CTR models (``models/ctr.py``: wide&deep and DeepFM, their tables
  ``is_sparse``, trained with ``AdagradOptimizer`` or lazy Adam on the
  row-sparse update kernel), the word2vec N-gram LM and the MovieLens
  recommender (``models/word2vec.py``, ``models/recommender.py``), with
  ``sigmoid``, ``auc``, ``cos_sim``, ``sequence_conv`` and
  ``nets.sequence_conv_pool``, and the synthetic ``datasets.imikolov`` /
  ``datasets.movielens``;
- the executor's liveness (each value dropped after its last use) and
  ``calc_gradient`` (gradients with respect to inputs and
  intermediates);
- the pass pipeline the executor runs once per plan
  (``transpiler/pass_manager.py``: dead-op elimination, constant folding,
  CSE, the static verifier) and automatic mixed precision
  (``transpiler/amp.py``: ``PADDLE_TPU_TORCH_AMP=bf16|f16`` or
  ``transpiler.amp.amp_guard``; f16 with dynamic loss scaling and
  skipped overflow steps), with ``memory_optimize`` / ``release_memory``;
- persistence (``io``: variables, checkpoints with resume and rollback,
  inference models, in the reference's format; record files,
  ``io_recordio``, ``datasets.common.convert``, ``reader.creator.
  recordio``), the cost and memory models (``transpiler.cost_model``,
  ``transpiler.memory_model``, joined with the measured walls in
  ``Executor.last_step_report``) and rematerialization
  (``memory_optimize(level='dots' | 'full')``);
- control flow (``While``, ``StaticRNN``, ``DynamicRNN``, ``IfElse``,
  the tensor arrays) and seq2seq's beam-search decode;
- sequence labelling: the SRL BiLSTM-CRF (``models/srl.py``) on the
  synthetic ``datasets.conll05``, with ``linear_chain_crf``,
  ``crf_decoding``, ``chunk_eval`` and ``evaluator.ChunkEvaluator``, the
  rest of the LoD sequence ops, and ``warpctc`` with ``edit_distance``;
- programs with several ``minimize`` passes (the GAN, ``models/gan.py``:
  each later gradient at program-order values) and fit_a_line
  (``models/fit_a_line.py`` on ``datasets.uci_housing``), the
  optimizers Adamax, DecayedAdagrad, Adadelta, RMSProp and Ftrl, the
  initializers ``TruncatedNormal`` and ``MSRAInitializer``, and
  ``nets.glu``; and the flash inner-loop ceiling probe's kernel
  (``ops/kernels/flash_ceiling.py``, timed by
  ``python3 -m paddle_tpu_torch.ops.kernels.flash_ceiling_probe``).
"""
from . import datasets, initializer, layers, nets, optimizer  # noqa: F401
from . import clip, learning_rate_decay, reader, regularizer  # noqa: F401
from . import evaluator, io, io_recordio, transpiler  # noqa: F401
from .core import backward
from .core.backward import append_backward, calc_gradient
from .core.executor import Executor
from .core.lod import LoDTensor, create_lod_tensor
from .core.place import CPUPlace, CUDAPlace
from .core.program import (Program, default_main_program,
                           default_startup_program, program_guard)
from .core.scope import Scope, global_scope, scope_guard
from .core.selected_rows import SelectedRows
from .data_feeder import DataFeeder
from .optimizer import (AdagradOptimizer, AdamOptimizer, MomentumOptimizer,
                        SGDOptimizer)
from .param_attr import ParamAttr
from .reader.minibatch import batch
from .transpiler import memory_optimize, release_memory

__all__ = ['Program', 'program_guard', 'default_main_program',
           'default_startup_program', 'Executor', 'Scope', 'scope_guard',
           'global_scope', 'CPUPlace', 'CUDAPlace', 'ParamAttr', 'layers',
           'nets', 'optimizer', 'initializer', 'LoDTensor',
           'create_lod_tensor', 'AdagradOptimizer', 'AdamOptimizer',
           'MomentumOptimizer', 'SGDOptimizer', 'SelectedRows', 'DataFeeder',
           'batch', 'reader', 'datasets', 'clip', 'regularizer',
           'learning_rate_decay', 'backward', 'append_backward',
           'calc_gradient', 'transpiler', 'memory_optimize',
           'release_memory', 'io', 'io_recordio', 'evaluator']
