"""The autotuner (port of paddle_tpu/tuning/): search the hand-set
tunables with static-cost-model priors and measured feedback.

- :mod:`registry`: every tunable (name, bounded domain, default,
  subsystem, env override; pin one by setting its env var yourself).
- :mod:`search`: cost-model-pruned greedy search (:class:`Autotuner`,
  :func:`autotune`).
- :mod:`cache`: winners persist keyed by plan key, device kind and mesh
  (:class:`TuneCache`); a corrupted file is counted and read as a miss.
- :mod:`roofline`: modelled step-time floors and the top-ops report, at
  the H100's peaks for the plan's compute dtype.
- :mod:`runtime`: executor glue: ``PADDLE_TPU_TORCH_TUNE=cached`` applies
  persisted winners before the plan key is computed, so a fresh process
  starts tuned with no search.

``PADDLE_TPU_TORCH_TUNE=off`` (the default) leaves every executor path
bitwise untuned: one env read a call, nothing imported.
"""
from . import registry  # noqa: F401  (registrations run at import)
from .cache import TuneCache  # noqa: F401
from .registry import (Tunable, register_tunable,  # noqa: F401
                       registered_tunables)
from .roofline import modeled_step_s, report  # noqa: F401
from .runtime import (base_plan_key, cache_key_for,  # noqa: F401
                      maybe_apply_cached, model_program)
from .search import Autotuner, SearchResult, autotune  # noqa: F401

__all__ = ['Tunable', 'register_tunable', 'registered_tunables',
           'TuneCache', 'Autotuner', 'SearchResult', 'autotune',
           'modeled_step_s', 'report', 'base_plan_key',
           'cache_key_for', 'maybe_apply_cached', 'model_program']
