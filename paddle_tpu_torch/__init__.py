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
  kernel (``ops/kernels/``, ``csrc/``).
"""
from . import initializer, layers, nets, optimizer  # noqa: F401
from .core.executor import Executor
from .core.place import CPUPlace, CUDAPlace
from .core.program import (Program, default_main_program,
                           default_startup_program, program_guard)
from .core.scope import Scope, global_scope, scope_guard
from .param_attr import ParamAttr

__all__ = ['Program', 'program_guard', 'default_main_program',
           'default_startup_program', 'Executor', 'Scope', 'scope_guard',
           'global_scope', 'CPUPlace', 'CUDAPlace', 'ParamAttr', 'layers',
           'nets', 'optimizer', 'initializer']
