"""Program rewrites and analyses: the pass pipeline (dead-op elimination,
constant folding, CSE, AMP, the donation analysis, the cost and memory
models), its static verifier, memory_optimize (rematerialization) /
release_memory, and the KV page-pool sizes."""
from .memory_optimize import memory_optimize, release_memory  # noqa: F401
from . import passes  # noqa: F401
from . import pass_manager  # noqa: F401
from .pass_manager import run_pipeline  # noqa: F401
from . import verify  # noqa: F401
from . import cost_model, memory_model  # noqa: F401
from .verify import IRVerificationError  # noqa: F401

__all__ = ['memory_optimize', 'release_memory', 'passes', 'run_pipeline',
           'pass_manager', 'verify', 'IRVerificationError', 'cost_model',
           'memory_model']
