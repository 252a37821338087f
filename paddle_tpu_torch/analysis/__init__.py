"""Static host-code analysis: the concurrency analyzer and the lock
watchdog (port of paddle_tpu/analysis/).

- :mod:`concurrency`: an AST analyzer over ``paddle_tpu_torch/``: thread
  entrypoints, a guarded-by map per lock-owning class, fields written
  under a lock and touched without it on a thread-reachable path, and
  the lock-acquisition order graph with its cycles.  Waivers are
  commented annotations in the source (``# lock: guarded_by(_lock)``,
  ``# lock: unguarded-ok(<reason>)``).  The sweep must report zero
  unwaived findings (``python -m paddle_tpu_torch.tools.check_concurrency``).
- :mod:`lockdebug`: the run-time counterpart
  (``PADDLE_TPU_TORCH_LOCK_DEBUG=1``): the lock factories the serving
  modules create their locks through, which record per-thread
  acquisition stacks and check the static order graph at run time
  (``paddle_tpu_lock_order_violations_total``).  Disarmed, the factories
  return plain ``threading`` primitives.
"""
from . import concurrency, lockdebug

__all__ = ['concurrency', 'lockdebug']
