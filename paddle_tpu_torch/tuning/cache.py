"""Persistent autotuner winner cache (port of paddle_tpu/tuning/cache.py).

Winners persist as one small JSON file per (plan key, device kind, mesh)
under ``<dir>/paddle_tpu_tuning/``, where ``<dir>`` is
PADDLE_TPU_TORCH_TUNE_CACHE_DIR, falling back to
PADDLE_TPU_TORCH_AOT_CACHE_DIR.  Departure from the reference, which
falls back to its XLA compilation cache dir: the port has no compile
cache, and the serving AOT cache is its nearest counterpart.  Writes
are atomic (tmp + ``os.replace``), so processes may share the dir.

Corruption contract: a file that fails to parse or carries the wrong
schema is COUNTED (``stats()['corrupt']`` and the
``paddle_tpu_tune_cache_corrupt_total`` counter) and read as a miss:
defaults apply, nothing crashes.  An unreadable or unwritable directory
degrades persistence to in-process only.
"""
import hashlib
import json
import os

from .. import observability as _obs

__all__ = ['TuneCache']

_SCHEMA = 1

# process-wide counters mirrored into the observability registry when
# metrics are enabled: tests read the plain dict, dashboards the
# exposition
_STATS = {'hits': 0, 'misses': 0, 'corrupt': 0, 'stores': 0}


def _count(which):
    _STATS[which] += 1
    if not _obs.enabled():
        return
    r = _obs.registry()
    name = {'hits': 'paddle_tpu_tune_cache_hits_total',
            'misses': 'paddle_tpu_tune_cache_misses_total',
            'corrupt': 'paddle_tpu_tune_cache_corrupt_total',
            'stores': 'paddle_tpu_tune_cache_stores_total'}[which]
    r.counter(name, 'autotuner winner-cache %s' % which).inc()


class TuneCache(object):
    """Load/store tuner winners keyed by (plan key, device kind, mesh).

    ``root=None`` resolves the directory from the flags above; an empty
    resolution disables persistence (``enabled()`` False, load always
    None, store a no-op) — the tuner still works, it just re-searches
    per process."""

    def __init__(self, root=None):
        if root is None:
            from ..flags import FLAGS
            root = FLAGS.tune_cache_dir or FLAGS.aot_cache_dir or ''
        self.root = os.path.join(root, 'paddle_tpu_tuning') if root \
            else ''

    def enabled(self):
        return bool(self.root)

    @staticmethod
    def key(plan_key, device_kind, mesh_spec):
        """Stable digest of the three keying components.  ``plan_key``
        is the composite pass-configuration tuple
        (pass_manager.plan_key) computed under the BASE environment
        (registry.base_env), so a tuned process and a fresh one derive
        the same key."""
        blob = repr((_SCHEMA, plan_key, device_kind, mesh_spec))
        return hashlib.sha1(blob.encode()).hexdigest()

    def path(self, key):
        return os.path.join(self.root, 'tune_%s.json' % key) \
            if self.root else None

    @staticmethod
    def stats():
        """Process-wide {'hits','misses','corrupt','stores'} counts."""
        return dict(_STATS)

    def load(self, key):
        """Winners ``{tunable: value}`` for ``key``, or None on miss.
        A corrupted file counts and reads as a miss."""
        p = self.path(key)
        if p is None:
            return None
        try:
            with open(p) as f:
                doc = json.load(f)
        except FileNotFoundError:
            _count('misses')
            return None
        except (OSError, ValueError):
            _count('corrupt')
            return None
        if not isinstance(doc, dict) or doc.get('schema') != _SCHEMA \
                or not isinstance(doc.get('winners'), dict):
            _count('corrupt')
            return None
        _count('hits')
        return dict(doc['winners'])

    def store(self, key, winners, meta=None):
        """Atomically persist ``winners`` under ``key`` (no-op when
        persistence is disabled or the dir is unwritable)."""
        p = self.path(key)
        if p is None:
            return False
        doc = {'schema': _SCHEMA, 'winners': dict(winners),
               'meta': dict(meta or {})}
        try:
            os.makedirs(self.root, exist_ok=True)
            tmp = p + '.tmp.%d' % os.getpid()
            with open(tmp, 'w') as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, p)
        except OSError:
            return False
        _count('stores')
        return True
