"""Multi-tenant serving: SLO classes, quotas and HBM budget admission.

Reference parity: paddle_tpu/inference/tenancy.py, the whole module, a
straight port of its host logic (the port keeps its own copy, as it
imports nothing of the reference):

- **SLO classes** (``gold``/``silver``/``bronze``): a dispatch *weight*
  (the share of the deferred queue's drain a tenant gets under quota
  contention) and a *wait scale* (a multiplier on the batching server's
  ``max_wait_ms`` deadline flush: gold's partial batches flush at half
  the base deadline, bronze's wait 4x longer).  The default class
  ``silver`` is the 1.0 fixed point, so a one-tenant fleet with defaults
  serves as a fleet without tenancy does.
- **Per-tenant quotas** (:class:`TenantRegistry`): a tenant may have at
  most ``quota`` requests outstanding in the replica queues; a submit
  past it is parked on the tenant's pending deque (deferred, never
  dropped) and drained in smooth weighted round-robin order (weights from
  the SLO class) as completions free slots.  Quota 0 disables the gate
  (the default, PADDLE_TPU_TORCH_FLEET_TENANT_QUOTA).
- **Admission control** (:class:`AdmissionError`, :func:`plan_eviction`):
  with ``PADDLE_TPU_TORCH_FLEET_HBM_ADMISSION=enforce`` an over-budget
  ``deploy()`` first evicts cold tenants' warmed buckets, least recently
  used first (the coldest tenant, then its coldest bucket; eviction drops
  the loaded module, never the version directory, so a later request
  re-warms it through the counted path), and is rejected with a typed
  :class:`AdmissionError` before any replica is built when it still does
  not fit.

The registry's state lives under one lock made by
``analysis.lockdebug.make_lock`` under the reference's name
(``TenantRegistry._lock``): a plain ``threading`` lock unless
PADDLE_TPU_TORCH_LOCK_DEBUG arms the watchdog.  Its methods never call
out of the module while holding it.
"""
import time
from collections import deque

from ..analysis import lockdebug as _lkd

__all__ = ['AdmissionError', 'TenantRegistry', 'plan_eviction',
           'effective_quota', 'SLO_CLASSES', 'DEFAULT_SLO_CLASS',
           'DEFAULT_TENANT']

DEFAULT_TENANT = 'default'

# weight: share of deferred-drain bandwidth under quota contention
# (and the quota scale for flag-derived quotas); wait_scale: multiplier
# on the replica servers' max_wait_ms deadline flush.  silver is the
# default class and is the 1.0 fixed point: a default-class tenant's
# servers are configured exactly like a pre-tenancy fleet's.
SLO_CLASSES = {
    'gold': {'weight': 8.0, 'wait_scale': 0.5},
    'silver': {'weight': 4.0, 'wait_scale': 1.0},
    'bronze': {'weight': 1.0, 'wait_scale': 4.0},
}
DEFAULT_SLO_CLASS = 'silver'
_MAX_WEIGHT = max(c['weight'] for c in SLO_CLASSES.values())


class AdmissionError(RuntimeError):
    """A ``deploy()`` the enforcing HBM admission controller rejected:
    even after evicting every cold bucket it may, the projected resident
    bytes exceed the budget.  Raised before any replica is built: the
    rejection costs a directory stat, not a load.  Counted in the fleet's
    ``stats()['admission_rejections']``."""

    def __init__(self, tenant, version, budget_bytes, live_bytes,
                 incoming_bytes, freed_bytes=0):
        self.tenant = tenant
        self.version = version
        self.budget_bytes = int(budget_bytes)
        self.live_bytes = int(live_bytes)
        self.incoming_bytes = int(incoming_bytes)
        self.freed_bytes = int(freed_bytes)
        self.projected_bytes = self.live_bytes + self.incoming_bytes
        super(AdmissionError, self).__init__(
            "deploy of version %r for tenant %r rejected by HBM "
            "admission control: projected resident %d B (live %d B + "
            "incoming ~%d B, after %d B freed by eviction) exceeds "
            "the budget %d B"
            % (version, tenant, self.projected_bytes, self.live_bytes,
               self.incoming_bytes, self.freed_bytes,
               self.budget_bytes))


def slo_params(slo_class):
    """(weight, wait_scale) for a class name, loudly checked."""
    try:
        c = SLO_CLASSES[slo_class]
    except KeyError:
        raise ValueError(
            "unknown SLO class %r; pick one of %s"
            % (slo_class, sorted(SLO_CLASSES)))
    return c['weight'], c['wait_scale']


def effective_quota(quota, slo_class):
    """Resolve a tenant's outstanding-request quota: an explicit
    ``quota`` wins verbatim; otherwise PADDLE_TPU_TORCH_FLEET_TENANT_QUOTA
    is the base, scaled by the class weight (gold keeps the base,
    silver base/2, bronze base/8, floored at 1).  0 = unlimited."""
    if quota is not None:
        return max(0, int(quota))
    from ..flags import FLAGS
    base = int(FLAGS.fleet_tenant_quota or 0)
    if base <= 0:
        return 0
    weight, _ = slo_params(slo_class)
    return max(1, int(round(base * weight / _MAX_WEIGHT)))


def plan_eviction(candidates, need_bytes):
    """Pick the coldest-first eviction set covering ``need_bytes``.

    ``candidates``: iterable of dicts with keys ``tenant``,
    ``tenant_last_used``, ``bucket``, ``bucket_last_used``, ``bytes``
    plus any caller payload (carried through untouched).  Ordering is
    LRU at two levels — coldest *tenant* first, coldest *bucket*
    within it — with larger buckets first among equals so the plan
    stays short.  Returns ``(plan, freed_bytes)``; the plan is the
    shortest such prefix, empty when ``need_bytes <= 0``."""
    need = int(need_bytes)
    if need <= 0:
        return [], 0
    order = sorted(candidates, key=lambda c: (
        c['tenant_last_used'], c['bucket_last_used'], -c['bytes'],
        str(c['tenant']), c['bucket']))
    plan, freed = [], 0
    for c in order:
        if freed >= need:
            break
        plan.append(c)
        freed += int(c['bytes'])
    return plan, freed


class _Tenant(object):
    """Flow-control record for one tenant.  All fields are guarded by
    the owning registry's lock."""
    __slots__ = ('name', 'slo_class', 'weight', 'wait_scale', 'quota',
                 'last_used', 'outstanding', 'pending', 'wrr_credit',
                 'submitted', 'deferred', 'evicted_buckets')

    def __init__(self, name, slo_class, quota):
        self.name = name
        self.slo_class = slo_class
        self.weight, self.wait_scale = slo_params(slo_class)
        self.quota = quota
        self.last_used = time.monotonic()
        self.outstanding = 0
        self.pending = deque()
        self.wrr_credit = 0.0
        self.submitted = 0
        self.deferred = 0
        self.evicted_buckets = 0


class TenantRegistry(object):
    """Per-tenant flow control: quota admission at submit, smooth
    weighted-round-robin drain of deferred work, and the LRU signal
    (last-used stamps) the budget manager's eviction planner reads.

    The registry never dispatches anything itself — :meth:`admit` and
    :meth:`take_deferred` tell the caller (the fleet) what to
    dispatch, outside this lock."""

    def __init__(self):
        self._lock = _lkd.make_lock('TenantRegistry._lock')
        self._tenants = {}  # name -> _Tenant, guarded by _lock

    # -- registration ---------------------------------------------------
    def ensure(self, name, slo_class=None, quota=None):
        """Create or update a tenant; returns
        ``(slo_class, weight, wait_scale, quota)`` as resolved.  An
        existing tenant keeps its class/quota unless new values are
        passed (a re-deploy with ``slo_class=`` re-grades it; a
        class change with no explicit quota re-derives the
        flag-scaled quota for the new class)."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                sc = slo_class if slo_class is not None \
                    else DEFAULT_SLO_CLASS
                t = _Tenant(name, sc, effective_quota(quota, sc))
                self._tenants[name] = t
            else:
                if slo_class is not None and slo_class != t.slo_class:
                    t.weight, t.wait_scale = slo_params(slo_class)
                    t.slo_class = slo_class
                    if quota is None:
                        t.quota = effective_quota(None, slo_class)
                if quota is not None:
                    t.quota = max(0, int(quota))
            return t.slo_class, t.weight, t.wait_scale, t.quota

    def names(self):
        with self._lock:
            return list(self._tenants)

    def info(self, name):
        """Snapshot of one tenant's flow-control state (stats())."""
        with self._lock:
            t = self._tenants[name]
            return {
                'slo_class': t.slo_class, 'weight': t.weight,
                'wait_scale': t.wait_scale, 'quota': t.quota,
                'outstanding': t.outstanding,
                'pending': len(t.pending),
                'submitted': t.submitted, 'deferred': t.deferred,
                'evicted_buckets': t.evicted_buckets,
                'idle_s': time.monotonic() - t.last_used,
            }

    def last_used(self, name):
        with self._lock:
            t = self._tenants.get(name)
            return t.last_used if t is not None else 0.0

    def note_evicted(self, name, n_buckets):
        with self._lock:
            t = self._tenants.get(name)
            if t is not None:
                t.evicted_buckets += int(n_buckets)

    # -- quota flow control ---------------------------------------------
    def admit(self, name, item):
        """One request arrives for ``name``.  True: a slot was taken —
        the caller dispatches ``item`` now.  False: the tenant is at
        quota — ``item`` was parked on its pending deque (drained by
        :meth:`take_deferred` as slots free up; never dropped)."""
        with self._lock:
            t = self._tenants[name]
            t.last_used = time.monotonic()
            t.submitted += 1
            if t.quota and t.outstanding >= t.quota:
                t.pending.append(item)
                t.deferred += 1
                return False
            t.outstanding += 1
            return True

    def release_one(self, name):
        """One of ``name``'s outstanding requests finished."""
        with self._lock:
            t = self._tenants.get(name)
            if t is not None and t.outstanding > 0:
                t.outstanding -= 1

    def take_deferred(self, max_items=64):
        """Pop up to ``max_items`` parked requests that now fit their
        tenant's quota, in smooth-WRR order (each round every eligible
        tenant's credit grows by its weight; the max-credit tenant
        wins and pays the round's total) — gold drains 8 items for
        bronze's 1 under contention, yet bronze is never starved.
        Slots are taken here; the caller dispatches the returned
        ``(name, item)`` pairs outside this lock."""
        out = []
        with self._lock:
            while len(out) < max_items:
                elig = [t for t in self._tenants.values()
                        if t.pending and
                        (not t.quota or t.outstanding < t.quota)]
                if not elig:
                    break
                total = sum(t.weight for t in elig)
                for t in elig:
                    t.wrr_credit += t.weight
                win = max(elig, key=lambda t: (t.wrr_credit, t.name))
                win.wrr_credit -= total
                win.outstanding += 1
                out.append((win.name, win.pending.popleft()))
        return out

    def drain_all(self):
        """Pop EVERY parked request regardless of quota (fleet
        close(): their futures must fail, not hang)."""
        out = []
        with self._lock:
            for t in self._tenants.values():
                while t.pending:
                    out.append((t.name, t.pending.popleft()))
        return out

    def pending_total(self):
        with self._lock:
            return sum(len(t.pending)
                       for t in self._tenants.values())
