"""Serving fleet: N batching replicas behind one dispatcher.

Reference parity: paddle_tpu/inference/fleet.py, its contract:

- **Queue-depth routing**: ``submit()`` goes to the READY replica of the
  request's tenant with the least work outstanding (queued rows plus
  in-flight batches times the ladder top, from each replica's
  ``queue_state``); ties rotate, so an idle fleet does not pile onto
  replica 0.
- **Failure containment**: a dispatch failure is re-dispatched onto a
  different replica (up to ``PADDLE_TPU_TORCH_FLEET_RETRY_LIMIT`` times)
  before the client sees it, and the failing replica collects a strike;
  at ``PADDLE_TPU_TORCH_FLEET_UNROUTABLE_AFTER`` consecutive strikes it is
  UNROUTABLE, and a health loop probes it with a one-row zero request
  and restores it on the first success.
- **Versioned hot-swap**: ``deploy`` resolves a version directory
  (``io.resolve_version_dir``: a bare ``export_bucketed`` directory or a
  base directory of numbered versions), builds and warms a whole replica
  set for it on a background thread at the lowest priority while the old
  set serves (``_run_backgrounded``; the first replica loads the
  buckets, the others share them through ``share_artifacts_with``, and
  a build beside live traffic paces its loads with
  ``warmup_throttle_ms``), flips routing, then drains the old set, so no
  request is dropped: each one's future is bound to the replica that
  took it.  Each deploy records ``{version, dir}`` through
  ``io.write_rollback_json``, whose ``.prev`` archive ``rollback``
  deploys again.  ``add_replica`` / ``remove_replica`` scale a group.
- **Tenants** (inference/tenancy.py): each ``deploy(tenant=...)`` is its
  own replica group with its own version, ``DEPLOY_<tenant>.json`` and
  rollback chain, an SLO class that scales its ``max_wait_ms`` and
  weights its share of the deferred queue, and an optional quota past
  which submits are parked, never dropped.  Without ``tenant=`` there is
  one implicit ``default`` tenant of class ``silver``.
- **HBM budget**: each replica's ``resident_bytes()`` (a shared servable
  counted once) sums to the fleet's resident total, whose watermark
  includes a deploy's overlap moment (the old and the new set both
  resident).  A deploy whose projection (live + the incoming artifacts'
  sizes) exceeds the budget is logged and counted (``warn``), or, under
  ``PADDLE_TPU_TORCH_FLEET_HBM_ADMISSION=enforce``, first evicts other
  tenants' warmed buckets, least recently used first
  (``evict_buckets`` / ``bucket_last_used``; the next request for such a
  bucket re-warms it, counted in ``compiles_after_warmup``), and raises
  :class:`~paddle_tpu_torch.inference.tenancy.AdmissionError` before any
  build when it still does not fit.
- **Decode**: ``attach_decode`` hosts a ``DecodeServer`` under a tenant
  (its KV pools and weights join the resident total), ``generate``
  submits to it.

Telemetry (reference: fleet.py ``_FleetMetrics``, the same series): the
fleet's counters in the process registry labelled ``fleet=<fid>``,
per-replica dispatch, failure and resident series also ``replica`` and
``version``, per-tenant ones ``tenant``; callback gauges read live at
scrape time (queued rows, batches in flight, replicas by state, resident
bytes, quota-parked requests); a /healthz check ``fleet_<fid>``, failing
while some tenant has no routable replica.  ``close()`` retires every
series and the check.  Armed, the timeline records each routing decision
(``fleet.dispatch``, under the request id the replica's spans carry);
a request that finally fails dumps the ring tagged with the fleet (and
the version whose replica failed).

The fleet's two locks come from ``analysis.lockdebug.make_lock`` under the
reference's names (``ServingFleet._lock``, ``ServingFleet._deploy_lock``):
plain ``threading`` locks unless PADDLE_TPU_TORCH_LOCK_DEBUG arms the
watchdog.  Departure from the reference: ``device`` (None: the card) is
where every replica serves.
"""
import itertools
import logging
import os
import re
import tempfile
import threading
import time
from concurrent.futures import Future

import numpy as np

from .. import io as _io
from ..core.place import resolve_device
from .. import observability as _obs
from ..analysis import lockdebug as _lkd
from ..flags import FLAGS
from ..observability import timeline as _tlm
from . import tenancy as _tn
from .batching import BatchingInferenceServer

_log = logging.getLogger(__name__)

__all__ = ['ServingFleet']

_fleet_seq = itertools.count()
_replica_seq = itertools.count()

# tenant names become deploy-record file names and metric label values
_TENANT_RE = re.compile(r'^[A-Za-z0-9._-]+$')

# replica lifecycle states
READY = 'ready'            # routable
UNROUTABLE = 'unroutable'  # out of routing; health loop probes it
DRAINING = 'draining'      # retiring: flushing queued + in-flight work
RETIRED = 'retired'        # closed; kept only in stats history

_STATES = (READY, UNROUTABLE, DRAINING)


def _decode_resident(server):
    """Modeled device residency of an attached decode server: the
    paged KV pools plus the weight set.  Both live for the server's
    whole lifetime — unlike a batching replica's compiled buckets,
    nothing here is evictable, so the whole figure counts against the
    fleet's HBM budget.  Prefix-cache sharing never inflates this: a
    page referenced by N streams and the trie is one physical page of
    the pool, so the pool closed form already counts it exactly once
    (the server's stats()['prefix_cached_bytes'] names the trie-held
    subset inside this figure, not on top of it)."""
    eng = server.engine
    return int(eng.resident_bytes()) + sum(
        int(v.nbytes) for v in eng.params.values())


def _run_backgrounded(fn):
    """Run ``fn`` on a throwaway thread at the lowest scheduling
    priority (per-thread nice 19 on Linux) and return its result,
    re-raising its exception.  A replica's build is CPU-hungry (artifact
    loads, warm calls) and must not take the cores from the serving
    threads mid-rollout; nice can only be raised, so it is applied to a
    thread that is then discarded, never to the caller's.  Where it is
    not permitted the thread runs at normal priority."""
    box = {}

    def work():
        try:
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(),
                           19)
        except (AttributeError, OSError):
            pass  # non-Linux / not permitted: run at normal priority
        try:
            box['result'] = fn()
        except BaseException as e:  # noqa: B036 — re-raised below
            box['error'] = e

    t = threading.Thread(target=work,
                         name='paddle-tpu-torch-fleet-warmup',
                         daemon=True)
    t.start()
    t.join()
    if 'error' in box:
        raise box['error']
    return box['result']


class _Replica(object):
    """One BatchingInferenceServer plus its fleet-side lifecycle."""
    __slots__ = ('rid', 'version', 'version_dir', 'server', 'state',
                 'failures', 'probe_feed', 'warmup_s', 'resident',
                 'tenant', '_res_gen_seen',
                 'm_dispatch', 'm_dispatch_failures', 'm_resident')

    def __init__(self, rid, version, version_dir, server, probe_feed,
                 warmup_s, tenant=_tn.DEFAULT_TENANT):
        self.rid = rid
        self.version = version
        self.version_dir = version_dir
        self.server = server
        self.state = READY
        self.failures = 0
        self.probe_feed = probe_feed
        self.warmup_s = warmup_s
        self.tenant = tenant
        # the server's resident_bytes() snapshot, taken again when the
        # servable's residency generation moves (an eviction, a re-warm)
        self._res_gen_seen = server.residency_generation
        self.resident = server.resident_bytes()
        self.m_dispatch = None           # set by _FleetMetrics.bind
        self.m_dispatch_failures = None
        self.m_resident = None

    def refresh_resident(self):
        """The resident snapshot, read again only when the servable's
        residency generation changed (siblings share the generation, so
        one eviction refreshes every lane)."""
        gen = self.server.residency_generation
        if gen != self._res_gen_seen:
            self._res_gen_seen = gen
            self.resident = self.server.resident_bytes()
            if self.m_resident is not None:
                self.m_resident.set(self.resident['total_bytes'])
        return self.resident


class _TenantGroup(object):
    """One tenant's servable set inside the fleet: its replica list,
    live version, and on-disk deploy record.  Mutated only under the
    fleet's ``_lock``."""
    __slots__ = ('name', 'record_path', 'replicas', 'version',
                 'version_dir', 'slo_class')

    def __init__(self, name, record_path):
        self.name = name
        self.record_path = record_path
        self.replicas = []
        self.version = None
        self.version_dir = None
        self.slo_class = _tn.DEFAULT_SLO_CLASS


class _FleetMetrics(object):
    """Fleet-level handles into the process registry: counters labelled
    ``fleet=<fid>``, per-replica dispatch counters also ``replica`` /
    ``version``, per-tenant counters ``tenant``, and pull-style callback
    gauges for the aggregates (wired to ``fns`` at construction, read live
    at scrape time, outside the metric lock, from the HTTP thread)."""

    def __init__(self, reg, fid, fns):
        L = ('fleet',)
        LR = ('fleet', 'replica', 'version')
        self._reg = reg
        self._fid = fid
        self._families = []
        self._replica_families = []
        self._tenant_kvs = []

        def child(metric):
            self._families.append(metric)
            return metric.labels(fleet=fid)

        self.requests = child(reg.counter(
            'paddle_tpu_fleet_requests_total',
            'requests accepted by the fleet dispatcher', L))
        self.completed = child(reg.counter(
            'paddle_tpu_fleet_requests_completed_total',
            'requests whose results were delivered to clients', L))
        self.failed = child(reg.counter(
            'paddle_tpu_fleet_requests_failed_total',
            'requests whose clients finally saw an error (after all '
            'retries)', L))
        self.retries = child(reg.counter(
            'paddle_tpu_fleet_retries_total',
            'request re-dispatches onto another replica after a '
            'dispatch failure', L))
        self.deploys = child(reg.counter(
            'paddle_tpu_fleet_deploys_total',
            'version deployments (hot-swaps) completed', L))
        # reason-labeled: the controller's automatic rollbacks
        # (live_auc_regression, p99_regression, ...) are
        # distinguishable from an operator's explicit call in /metrics
        self._rollbacks = reg.counter(
            'paddle_tpu_fleet_rollbacks_total',
            'deployments that were rollbacks to the archived previous '
            'version, by reason ("operator" = explicit call; automated '
            'callers pass their trigger, e.g. live_auc_regression)',
            ('fleet', 'reason'))
        self._rollback_reason_kvs = []
        self.unroutable_marks = child(reg.counter(
            'paddle_tpu_fleet_unroutable_marks_total',
            'replica transitions into the unroutable state', L))
        self.probes = child(reg.counter(
            'paddle_tpu_fleet_health_probes_total',
            'health-check probes sent to unroutable replicas', L))
        self.probe_failures = child(reg.counter(
            'paddle_tpu_fleet_health_probe_failures_total',
            'health-check probes that failed (replica stays '
            'unroutable)', L))

        self.budget_precheck_failures = child(reg.counter(
            'paddle_tpu_fleet_hbm_budget_precheck_failures_total',
            'deploys whose projected resident bytes (live servables + '
            'incoming version, deploy-overlap moment) exceeded the '
            'HBM budget — logged in warn mode, handed to the eviction '
            'planner in enforce mode '
            '(PADDLE_TPU_TORCH_FLEET_HBM_ADMISSION)', L))
        self.admission_rejections = child(reg.counter(
            'paddle_tpu_fleet_admission_rejections_total',
            'deploys the enforcing HBM admission controller rejected: '
            'still over budget after LRU-evicting every cold bucket '
            'it may — rejected BEFORE any replica build cost', L))
        self._evictions = reg.counter(
            'paddle_tpu_fleet_evictions_total',
            'compiled buckets LRU-evicted from a tenant servable by '
            'the HBM admission controller (the version dir survives; '
            'a later request re-warms through the counted compile '
            'path)', ('fleet', 'tenant'))
        self._deferred = reg.counter(
            'paddle_tpu_fleet_quota_deferred_total',
            'submits parked on a tenant quota queue (deferred, never '
            'dropped; drained weighted-round-robin as completions '
            'free slots)', ('fleet', 'tenant'))
        self._tenant_requests = reg.counter(
            'paddle_tpu_fleet_tenant_requests_total',
            'requests accepted per tenant and SLO class',
            ('fleet', 'tenant', 'slo_class'))

        self._dispatches = reg.counter(
            'paddle_tpu_fleet_dispatches_total',
            'requests dispatched per replica (version-labeled, so a '
            'rollout reads as one series handing off to another)', LR)
        self._dispatch_failures = reg.counter(
            'paddle_tpu_fleet_dispatch_failures_total',
            'dispatch failures per replica', LR)
        self._resident = reg.gauge(
            'paddle_tpu_serving_resident_bytes',
            'resident bytes of each replica servable (its buckets\' '
            'buffers and warm-call working set, measured on the card; '
            'replicas sharing one servable report the same value)', LR)

        # pull-style aggregates: live fleet state read at scrape time
        self._g_queue = reg.gauge(
            'paddle_tpu_fleet_queued_rows',
            'rows waiting across every routable replica queue '
            '(callback gauge, read live)', L)
        self._families.append(self._g_queue)
        self._g_queue.labels(fleet=fid).set_function(fns['queued_rows'])
        self._g_inflight = reg.gauge(
            'paddle_tpu_fleet_in_flight_batches',
            'batches in flight across every routable replica '
            '(callback gauge, read live)', L)
        self._families.append(self._g_inflight)
        self._g_inflight.labels(fleet=fid).set_function(fns['in_flight'])
        self._g_replicas = reg.gauge(
            'paddle_tpu_fleet_replicas',
            'replica count per lifecycle state (callback gauge)',
            ('fleet', 'state'))
        self._replica_state_labels = []
        for st in _STATES:
            self._g_replicas.labels(fleet=fid, state=st).set_function(
                fns['state_count'](st))
            self._replica_state_labels.append(st)
        self._g_resident = reg.gauge(
            'paddle_tpu_fleet_resident_bytes',
            'modeled resident bytes across live servables, shared '
            'compiled servables counted once (callback gauge, read '
            'live)', L)
        self._families.append(self._g_resident)
        self._g_resident.labels(fleet=fid).set_function(fns['resident'])
        self._g_pending = reg.gauge(
            'paddle_tpu_fleet_quota_pending',
            'requests currently parked across every tenant quota '
            'queue (callback gauge, read live)', L)
        self._families.append(self._g_pending)
        self._g_pending.labels(fleet=fid).set_function(
            fns['quota_pending'])
        self.resident_watermark = child(reg.gauge(
            'paddle_tpu_fleet_resident_bytes_watermark',
            'highest fleet resident-bytes estimate observed, '
            'deploy-overlap moments (old + incoming version both '
            'live) included', L))

    def rollback_inc(self, reason):
        """Count one rollback under its reason label (child tracked so
        close() retires the series)."""
        kv = dict(fleet=self._fid, reason=str(reason))
        self._rollbacks.labels(**kv).inc()
        if kv not in self._rollback_reason_kvs:
            self._rollback_reason_kvs.append(kv)

    def _tenant_child(self, fam, **labels):
        """Per-tenant child, tracked so close() retires the series
        (the metrics-retirement contract: no fleet=<fid> series may
        survive the fleet)."""
        kv = dict(fleet=self._fid, **labels)
        if (fam, kv) not in self._tenant_kvs:
            self._tenant_kvs.append((fam, kv))
        return fam.labels(**kv)

    def evictions(self, tenant):
        return self._tenant_child(self._evictions, tenant=tenant)

    def deferred(self, tenant):
        return self._tenant_child(self._deferred, tenant=tenant)

    def tenant_requests(self, tenant, slo_class):
        return self._tenant_child(self._tenant_requests, tenant=tenant,
                                  slo_class=slo_class)

    def bind(self, rep):
        """Create (and attach) the per-replica counter children."""
        kv = dict(fleet=self._fid, replica=rep.rid, version=rep.version)
        rep.m_dispatch = self._dispatches.labels(**kv)
        rep.m_dispatch_failures = self._dispatch_failures.labels(**kv)
        rep.m_resident = self._resident.labels(**kv)
        rep.m_resident.set(rep.resident['total_bytes'])
        self._replica_families.append((self._dispatches, kv))
        self._replica_families.append((self._dispatch_failures, kv))
        self._replica_families.append((self._resident, kv))

    def unbind(self, rep):
        """Retire a replica's label series (handles stay readable)."""
        kv = dict(fleet=self._fid, replica=rep.rid, version=rep.version)
        for fam in (self._dispatches, self._dispatch_failures,
                    self._resident):
            fam.remove(**kv)
            try:
                self._replica_families.remove((fam, kv))
            except ValueError:
                pass

    def close(self):
        for m in self._families:
            m.remove(fleet=self._fid)
        for fam, kv in self._replica_families:
            fam.remove(**kv)
        self._replica_families = []
        for kv in self._rollback_reason_kvs:
            self._rollbacks.remove(**kv)
        self._rollback_reason_kvs = []
        for fam, kv in self._tenant_kvs:
            fam.remove(**kv)
        self._tenant_kvs = []
        for st in self._replica_state_labels:
            self._g_replicas.remove(fleet=self._fid, state=st)


class ServingFleet(object):
    """N ``BatchingInferenceServer`` replicas behind a queue-depth-aware
    dispatcher, with replica lifecycle management, versioned hot-swap,
    and (opt-in) multi-tenant hosting under one HBM budget.

    ``version_dir`` is an ``export_bucketed`` output directory, or a
    base directory of numbered version subdirectories (highest number
    serves, TF-Serving style); ``version=`` pins a specific subdir.

    - ``submit(feed)`` -> Future (thread-safe); ``predict`` is
      submit + wait.  Requests are routed to the least-loaded READY
      replica of the request's tenant; a dispatch failure is retried
      on another replica before the client ever sees an error.
    - ``deploy(new_version_dir)`` hot-swaps a tenant's model: build +
      warm a fresh replica set for the new version (old version keeps
      serving), atomically flip routing, drain the old replicas.
      ``rollback()`` re-deploys the archived previous version.
    - ``deploy(dir2, tenant='b', slo_class='gold')`` registers a
      SECOND servable next to the first: its own replica group,
      version chain, and SLO class, sharing the fleet's device and
      HBM budget.  ``submit(feed, tenant='b')`` routes to it.
    - ``add_replica()`` / ``remove_replica()`` scale a live group;
      a new replica becomes routable only after its warmup finished.
    - ``stats()`` aggregates per-replica queue/latency/compile stats,
      plus a per-tenant flow-control block.

    ``device`` (None: the card, raising without one) is where every
    replica serves; the artifacts must have been exported there.
    Remaining keyword arguments (``max_wait_ms``, ``linger_ms``,
    ``max_queue``, ...) pass through to every replica's
    ``BatchingInferenceServer``.
    """

    def __init__(self, version_dir, replicas=None, version=None,
                 state_dir=None, unroutable_after=None, retry_limit=None,
                 health_interval_ms=None, drain_timeout_s=None,
                 hbm_budget_bytes=None, tenant=None, slo_class=None,
                 quota=None, hbm_admission=None, device=None,
                 **server_kwargs):
        self._fid = 'f%d' % next(_fleet_seq)
        self.device = resolve_device(device)
        self._lock = _lkd.make_lock('ServingFleet._lock')
        self._deploy_lock = _lkd.make_lock('ServingFleet._deploy_lock')
        self._rr = itertools.count()
        self._req_seq = itertools.count()  # fleet-level request ids
        # HBM budget of deploy()'s resident-bytes admission check; 0 is
        # off.  Defaults to PADDLE_TPU_TORCH_PEAK_HBM_BYTES.  Whether an
        # over-budget deploy warns or evicts and rejects is
        # PADDLE_TPU_TORCH_FLEET_HBM_ADMISSION / hbm_admission=
        self._hbm_budget = int(
            hbm_budget_bytes if hbm_budget_bytes is not None
            else (FLAGS.peak_hbm_bytes or 0))
        self._admission_mode = str(
            hbm_admission if hbm_admission is not None
            else (FLAGS.fleet_hbm_admission or 'warn')).lower()
        if self._admission_mode not in ('warn', 'enforce'):
            raise ValueError(
                "hbm_admission must be 'warn' or 'enforce', got %r"
                % self._admission_mode)
        self._resident_watermark = 0
        self._server_kwargs = dict(server_kwargs, device=self.device)
        self._default_replicas = int(
            replicas if replicas is not None else FLAGS.fleet_replicas)
        if self._default_replicas < 1:
            raise ValueError("a fleet needs at least 1 replica, got %d"
                             % self._default_replicas)
        self._unroutable_after = int(
            unroutable_after if unroutable_after is not None
            else FLAGS.fleet_unroutable_after)
        self._retry_limit = int(
            retry_limit if retry_limit is not None
            else FLAGS.fleet_retry_limit)
        self._health_interval = float(
            health_interval_ms if health_interval_ms is not None
            else FLAGS.fleet_health_interval_ms) / 1e3
        self._drain_timeout = float(
            drain_timeout_s if drain_timeout_s is not None
            else FLAGS.fleet_drain_timeout_s)
        self._probe_timeout = max(5.0, self._health_interval * 4)

        self._groups = {}        # tenant name -> _TenantGroup (_lock)
        self._decode = {}        # tenant name -> DecodeServer (_lock)
        self._tenancy = _tn.TenantRegistry()
        # deferred-queue drain flags: the done-callback chain must not
        # recurse (drain -> dispatch -> instant failure -> callback ->
        # drain), so one iterative drainer runs at a time and later
        # triggers just mark it to go around again (guarded by _lock)
        self._drain_active = False
        self._drain_again = False
        self._deploy_seq = 0
        self._closed = False
        self._rollbacks_by_reason = {}   # reason -> count (stats())
        self._last_deploy_reason = None

        self._owned_state_dir = None
        if state_dir is None:
            state_dir = tempfile.mkdtemp(prefix='paddle_tpu_torch_fleet_')
            self._owned_state_dir = state_dir
        os.makedirs(state_dir, exist_ok=True)
        self._state_dir = state_dir
        self._deploy_record = os.path.join(state_dir, 'DEPLOY.json')

        self._m = _FleetMetrics(_obs.registry(), self._fid, {
            'queued_rows': lambda: self._aggregate('queued_rows'),
            'in_flight': lambda: self._aggregate('in_flight_batches'),
            'state_count': lambda st: (lambda: self._state_count(st)),
            'resident': lambda: self._resident_total(),
            'quota_pending': lambda: self._tenancy.pending_total(),
        })
        if _obs.enabled():
            _obs.maybe_serve_from_env()

        try:
            self.deploy(version_dir, replicas=self._default_replicas,
                        version=version, tenant=tenant,
                        slo_class=slo_class, quota=quota)
        except Exception:
            self._m.close()
            self._rm_owned_state_dir()
            raise
        _obs.register_healthz('fleet_%s' % self._fid, self._healthz)

        self._stop = threading.Event()
        self._health_thread = None
        if self._health_interval > 0:
            self._health_thread = threading.Thread(
                target=self._health_loop,
                name='paddle-tpu-torch-fleet-health', daemon=True)
            self._health_thread.start()

    # -- tenancy plumbing ----------------------------------------------
    @property
    def _replicas(self):
        """Flat replica list across every tenant group (read-only
        snapshot; single-tenant callers see exactly the pre-tenancy
        list)."""
        with self._lock:
            return self._reps_locked()

    def _reps_locked(self):
        """All groups' replicas; caller holds ``_lock``."""
        return [r for g in self._groups.values() for r in g.replicas]

    def _record_path(self, tname):
        """A tenant's deploy-record path.  The default tenant keeps
        the historical ``DEPLOY.json`` name (rollback records written
        before tenancy existed stay readable)."""
        if tname == _tn.DEFAULT_TENANT:
            return self._deploy_record
        return os.path.join(self._state_dir, 'DEPLOY_%s.json' % tname)

    def _resolve_tenant(self, tenant):
        """Normalize ``tenant=``.  None means 'the obvious one': the
        default tenant when it exists (or nothing is deployed yet),
        else the single deployed tenant — ambiguous only when several
        non-default tenants coexist, which demands an explicit name."""
        if tenant is not None:
            name = str(tenant)
            if not _TENANT_RE.match(name):
                raise ValueError(
                    "invalid tenant name %r: use letters, digits, "
                    "'.', '_', '-'" % name)
            return name
        with self._lock:
            if not self._groups or _tn.DEFAULT_TENANT in self._groups:
                return _tn.DEFAULT_TENANT
            if len(self._groups) == 1:
                return next(iter(self._groups))
            names = sorted(self._groups)
        raise ValueError(
            "fleet %s hosts multiple tenants %s — pass tenant="
            % (self._fid, names))

    # -- client surface ------------------------------------------------
    def submit(self, feed, tenant=None):
        """Route one request onto the least-loaded replica of its
        tenant; returns a Future of [output arrays].  The Future only
        carries an exception after the fleet ran out of retry budget
        AND distinct replicas — a single replica failure is invisible
        to clients.  A tenant at its quota gets the request PARKED
        (deferred, never dropped) and dispatched as completions free
        slots.

        Each request gets a monotonic fleet-level ``request_id``, which
        the replica's server takes as its own."""
        tname = self._resolve_tenant(tenant)
        with self._lock:
            if self._closed:
                raise RuntimeError("ServingFleet is closed")
            g = self._groups.get(tname)
        if g is None:
            raise ValueError(
                "no tenant %r in fleet %s — deploy(..., tenant=%r) "
                "first" % (tname, self._fid, tname))
        fut = Future()
        self._m.requests.inc()
        self._m.tenant_requests(tname, g.slo_class).inc()
        rid = next(self._req_seq)
        # the completion hook frees the tenant's quota slot and drains
        # deferred work; attached BEFORE dispatch so every terminal
        # path (including instant failure) releases exactly once
        fut.add_done_callback(
            lambda f, t=tname: self._request_finished(t))
        if self._tenancy.admit(tname, (feed, fut, rid)):
            self._dispatch(tname, feed, fut, frozenset(), 0, None, rid)
        else:
            self._m.deferred(tname).inc()
        return fut

    def predict(self, feed, timeout=None, tenant=None):
        """submit + wait: returns [output arrays] for this request."""
        return self.submit(feed, tenant=tenant).result(timeout)

    def _request_finished(self, tname):
        """Done-callback of every submitted Future: release the quota
        slot, then drain whatever deferred work now fits."""
        self._tenancy.release_one(tname)
        self._drain_deferred()

    def _drain_deferred(self):
        """Dispatch parked requests that now fit their tenant's quota,
        in the registry's weighted-round-robin order.  Iterative and
        single-flight: a dispatch that fails instantly fires the done
        callback on THIS stack, which must not recurse into a second
        drainer — it sets ``_drain_again`` and returns."""
        with self._lock:
            if self._drain_active:
                self._drain_again = True
                return
            self._drain_active = True
        while True:
            batch = self._tenancy.take_deferred()
            for nm, (feed, fut, rid) in batch:
                self._dispatch(nm, feed, fut, frozenset(), 0, None,
                               rid)
            with self._lock:
                if not batch and not self._drain_again:
                    self._drain_active = False
                    return
                self._drain_again = False

    # -- routing -------------------------------------------------------
    def _pick(self, tried, tenant=None):
        """Least-outstanding-work READY replica not in ``tried``:
        score = queued rows + in-flight batches x ladder top (a batch
        on the device occupies up to a full bucket).  Equal scores
        rotate round-robin.  ``tenant`` scopes the candidate pool to
        one group (None: the whole fleet).  Returns None when no
        candidate exists."""
        with self._lock:
            if tenant is None:
                pool = self._reps_locked()
            else:
                g = self._groups.get(tenant)
                pool = list(g.replicas) if g is not None else []
            cands = [r for r in pool
                     if r.state == READY and r.rid not in tried]
            if not cands:
                return None
            offset = next(self._rr)
            best, best_key = None, None
            for i, r in enumerate(cands):
                qs = r.server.queue_state()
                if not qs['accepting']:
                    continue
                score = (qs['queued_rows'] + qs['in_flight_batches']
                         * r.server.max_batch)
                key = (score, (i + offset) % len(cands))
                if best_key is None or key < best_key:
                    best, best_key = r, key
            return best

    def _dispatch(self, tname, feed, fut, tried, attempts, last_exc,
                  rid):
        """Try the tenant's replicas until one accepts the request (its
        Future then drives completion via _on_done) or the retry
        budget is spent."""
        while True:
            t_pick = time.perf_counter()
            rep = self._pick(tried, tenant=tname)
            if rep is None:
                self._m.failed.inc()
                _tlm.maybe_dump_on_error(tag=self._fid)
                fut.set_exception(last_exc or RuntimeError(
                    "ServingFleet %s has no routable replica for "
                    "tenant %r (all unroutable/draining or already "
                    "tried for this request)" % (self._fid, tname)))
                return
            try:
                inner = rep.server.submit(feed, request_id=rid)
            except Exception as e:
                # submit itself failed (replica raced into drain/close,
                # or rejected the request shape).  Validation errors are
                # deterministic — every replica would reject them — so
                # ValueError propagates to the client unretried.
                if isinstance(e, ValueError):
                    fut.set_exception(e)
                    return
                self._note_failure(rep)
                tried = tried | {rep.rid}
                last_exc = e
                if attempts >= self._retry_limit:
                    self._m.failed.inc()
                    _tlm.maybe_dump_on_error(
                        tag='%s_%s' % (self._fid, rep.version))
                    fut.set_exception(e)
                    return
                attempts += 1
                self._m.retries.inc()
                continue
            rep.m_dispatch.inc()
            tl = _tlm.ring_if_armed()
            if tl is not None:
                # the routing decision, under the request id the
                # replica's queue-wait and compute events carry
                tl.record('fleet.dispatch', 'span', t0=t_pick,
                          dur=time.perf_counter() - t_pick,
                          args={'request_id': rid, 'replica': rep.rid,
                                'version': rep.version,
                                'attempt': attempts})
            inner.add_done_callback(
                lambda f, rep=rep, tried=tried, attempts=attempts:
                self._on_done(rep, tname, feed, fut, tried, attempts,
                              f, rid))
            return

    def _on_done(self, rep, tname, feed, fut, tried, attempts, inner,
                 rid):
        """Runs in the replica's collector thread when its Future
        resolves: deliver, or strike the replica and re-dispatch."""
        exc = inner.exception()
        if exc is None:
            self._note_success(rep)
            self._m.completed.inc()
            fut.set_result(inner.result())
            return
        rep.m_dispatch_failures.inc()
        self._note_failure(rep)
        if attempts >= self._retry_limit:
            self._m.failed.inc()
            # tagged with the fleet and the version whose replica failed
            # last; the future carries the original error either way
            _tlm.maybe_dump_on_error(
                tag='%s_%s' % (self._fid, rep.version))
            fut.set_exception(exc)
            return
        self._m.retries.inc()
        self._dispatch(tname, feed, fut, tried | {rep.rid},
                       attempts + 1, exc, rid)

    def _note_failure(self, rep):
        with self._lock:
            if rep.state not in (READY, UNROUTABLE):
                return  # draining/retired replicas aren't struck
            rep.failures += 1
            if rep.failures >= self._unroutable_after \
                    and rep.state == READY:
                rep.state = UNROUTABLE
                self._m.unroutable_marks.inc()

    def _note_success(self, rep):
        with self._lock:
            rep.failures = 0
            if rep.state == UNROUTABLE:
                rep.state = READY

    # -- health --------------------------------------------------------
    def _health_loop(self):
        """Probe unroutable replicas with a synthetic request; restore
        them on the first success.  Probes ride the replica's normal
        serving loop, so a success proves the whole dispatch path."""
        while not self._stop.wait(self._health_interval):
            with self._lock:
                bad = [r for r in self._reps_locked()
                       if r.state == UNROUTABLE]
            for rep in bad:
                self._m.probes.inc()
                try:
                    rep.server.predict(rep.probe_feed,
                                       timeout=self._probe_timeout)
                except Exception:
                    self._m.probe_failures.inc()   # stays unroutable
                else:
                    self._note_success(rep)

    # -- replica lifecycle ---------------------------------------------
    def _new_replica(self, vname, vdir, paths, share_with=None,
                     throttle=False, tenant=_tn.DEFAULT_TENANT,
                     wait_scale=1.0):
        """Build one replica.  ``share_with`` (a sibling replica of the
        SAME version) makes the new server share the sibling's loaded
        and warmed buckets — in-process replicas are dispatch lanes
        over one servable, so a version's warmup cost is paid once, not
        once per replica, and the serving threads are disturbed for one
        build, not N.

        ``wait_scale`` is the tenant's SLO-class multiplier on the
        batching deadline flush: it scales whatever ``max_wait_ms``
        base the fleet was configured with (explicit kwarg or the
        PADDLE_TPU_TORCH_SERVING_MAX_WAIT_MS default).  The 1.0 fixed point
        (silver, the default class) passes the kwargs through
        untouched, keeping default fleets bitwise pre-tenancy.

        ``throttle`` — the caller decided (under ``_lock``, where the
        replica set may be read) that a live set is serving next to
        this build, so bucket loads should be paced.  The decision is
        an argument rather than a replica-set read because this method
        runs on the backgrounded warmup thread, which holds no fleet
        lock."""
        rid = 'r%d' % next(_replica_seq)
        t0 = time.perf_counter()
        kw = dict(self._server_kwargs)
        kw.setdefault('warmup', True)
        if float(wait_scale) != 1.0:
            base = kw.get('max_wait_ms')
            if base is None:
                base = float(FLAGS.serving_max_wait_ms)
            kw['max_wait_ms'] = float(base) * float(wait_scale)
        if share_with is not None:
            kw['share_artifacts_with'] = share_with.server
        elif throttle:
            # building a fresh servable NEXT TO live traffic (deploy,
            # cold add): throttle the bucket compiles so the serving
            # threads get the cores back between bursts
            kw.setdefault('warmup_throttle_ms', 100.0)
        server = BatchingInferenceServer(paths, **kw)
        warmup_s = time.perf_counter() - t0
        probe = {n: np.zeros((1,) + shape, server._dtypes[n])
                 for n, shape in server._example_shapes.items()}
        rep = _Replica(rid, vname, vdir, server, probe, warmup_s,
                       tenant=tenant)
        self._m.bind(rep)
        return rep

    def add_replica(self, tenant=None):
        """Add one routable replica of a tenant's live version.  When a
        live sibling of the same version exists, the new replica shares
        its warmed buckets (serving-ready immediately); a genuinely
        cold build warms first — routing only ever sees the replica
        after warmup, so it pays no load in the serving loop (and, on a
        warm AOT cache, no compile at all).  Returns the replica id."""
        tname = self._resolve_tenant(tenant)
        with self._deploy_lock:
            with self._lock:
                if self._closed:
                    raise RuntimeError("ServingFleet is closed")
                g = self._groups.get(tname)
                if g is None:
                    raise ValueError(
                        "no tenant %r in fleet %s"
                        % (tname, self._fid))
                vname, vdir = g.version, g.version_dir
                share = next(
                    (r for r in g.replicas
                     if r.version == vname
                     and r.state in (READY, UNROUTABLE)), None)
                live = bool(self._reps_locked())
            wait_scale = self._tenancy.ensure(tname)[2]
            paths = _io.bucket_artifacts(vdir)
            rep = _run_backgrounded(
                lambda: self._new_replica(vname, vdir, paths,
                                          share_with=share,
                                          throttle=live, tenant=tname,
                                          wait_scale=wait_scale))
            with self._lock:
                if self._closed:
                    closed = True
                else:
                    closed = False
                    g.replicas.append(rep)
            if closed:
                # close() raced the build: don't leak the replica
                self._retire([rep])
                raise RuntimeError("ServingFleet is closed")
            self._note_resident_watermark()
            return rep.rid

    def remove_replica(self, rid=None, tenant=None):
        """Gracefully retire one replica: take it out of routing, drain
        its queued + in-flight requests (nothing is dropped), close it.
        ``rid=None`` removes the most recently added of ``tenant``'s
        group.  Refuses to remove a group's last replica (use close()).
        Serialized against deploy/add (``_deploy_lock``) so a removal
        can't be silently undone by a concurrent deploy's wholesale
        set swap."""
        tname = self._resolve_tenant(tenant) if rid is None else None
        with self._deploy_lock:
            with self._lock:
                if rid is None:
                    g = self._groups.get(tname)
                    if g is None or not g.replicas:
                        raise ValueError(
                            "no tenant %r in fleet %s"
                            % (tname, self._fid))
                    rep = g.replicas[-1]
                else:
                    g = next((gr for gr in self._groups.values()
                              if any(r.rid == rid
                                     for r in gr.replicas)), None)
                    if g is None:
                        raise ValueError("no replica %r in fleet %s"
                                         % (rid, self._fid))
                    rep = next(r for r in g.replicas if r.rid == rid)
                if len(g.replicas) <= 1:
                    raise ValueError(
                        "cannot remove the last replica of fleet %s "
                        "(tenant %r) — close() the fleet instead"
                        % (self._fid, g.name))
                g.replicas.remove(rep)
                rep.state = DRAINING
            self._retire([rep])
            return rep.rid

    def _retire(self, reps):
        """Drain-then-close a batch of replicas (deploy's old set,
        remove_replica, close).  Queued and in-flight requests all
        complete; only the label series are retired."""
        for rep in reps:
            with self._lock:
                rep.state = DRAINING
            rep.server.drain(timeout=self._drain_timeout)
            rep.server.close()
            with self._lock:
                rep.state = RETIRED
            self._m.unbind(rep)

    # -- versioned deployment ------------------------------------------
    def deploy(self, version_dir, replicas=None, version=None,
               hbm_budget_bytes=None, reason='operator', tenant=None,
               slo_class=None, quota=None):
        """Hot-swap a tenant's model version with zero dropped
        requests:

        1. resolve ``version_dir`` (``io.resolve_version_dir``);
        2. HBM-budget admission check, BEFORE any build cost: project
           the overlap-moment residency — live servables + the
           incoming version (zero when this tenant already serves
           these exact artifacts: a shared servable is counted once,
           as the resident total counts it) — against
           ``hbm_budget_bytes`` (default: the fleet's budget).  In
           ``warn`` mode (default) over budget logs and counts
           ``stats()['hbm_budget_precheck_failures']``; in ``enforce``
           mode cold tenants' buckets are evicted, least recently used
           first, to make room, and a deploy that still cannot fit
           raises :class:`~paddle_tpu_torch.inference.tenancy.AdmissionError`;
        3. build and warm a full replica set for it on a background
           thread — the serving set is untouched, traffic keeps flowing
           (with a warm AOT cache, PADDLE_TPU_TORCH_AOT_CACHE_DIR, the
           buckets are readied from its entries);
        4. atomically flip the tenant's group to the new set;
        5. record the deployment (``io.write_rollback_json`` archives
           the superseded record as ``.prev`` — rollback() reads it);
        6. drain + close the old set (their queued work completes).

        Returns the deployed version name.  Serialized against
        concurrent deploy/add/remove; client submits never block on
        it.  ``reason`` is a short string recorded in the deployment
        record and ``stats()['last_deploy_reason']`` — operator calls
        default to ``'operator'``; automated callers (the online
        controller's promote/rollback) pass their trigger so the
        metrics and the on-disk record say WHY a version flip
        happened.  ``tenant``/``slo_class``/``quota`` register or
        re-grade the tenant this servable belongs to."""
        tname = self._resolve_tenant(tenant)
        with self._deploy_lock:
            vdir, vname = _io.resolve_version_dir(version_dir, version)
            paths = _io.bucket_artifacts(vdir)
            vdir_abs = os.path.abspath(vdir)
            with self._lock:
                if self._closed:
                    raise RuntimeError("ServingFleet is closed")
                g = self._groups.get(tname)
                n = (int(replicas) if replicas is not None
                     else ((len(g.replicas) if g is not None else 0)
                           or self._default_replicas))
                live = any(gr.replicas
                           for gr in self._groups.values())
                # a live replica of this tenant already serving these
                # exact artifacts: the new set shares its compiled
                # servable, so the deploy brings ZERO incoming bytes
                # (and skips deserialize + compile entirely)
                share = None
                if g is not None:
                    share = next(
                        (r for r in g.replicas
                         if r.state in (READY, UNROUTABLE)
                         and os.path.abspath(r.version_dir)
                         == vdir_abs), None)
            self._admission_check(
                tname, vname, paths,
                self._hbm_budget if hbm_budget_bytes is None
                else int(hbm_budget_bytes),
                dedupe=share is not None)
            sc, _weight, wait_scale, _q = self._tenancy.ensure(
                tname, slo_class=slo_class, quota=quota)
            new = []
            try:
                for _ in range(n):
                    # the first replica pays the (cache-backed) warmup
                    # — on a background-priority thread so the live
                    # serving threads keep the cores mid-rollout; its
                    # siblings share the compiled servable
                    new.append(_run_backgrounded(
                        lambda: self._new_replica(
                            vname, vdir, paths,
                            share_with=(new[0] if new else share),
                            throttle=live, tenant=tname,
                            wait_scale=wait_scale)))
            except Exception:
                self._retire(new)
                raise
            # the rollout overlap moment: the incoming set is built
            # and the outgoing set still serves — residency peaks HERE
            self._note_resident_watermark(extra=new)
            with self._lock:
                # re-check under the lock: close() may have raced the
                # (long) build — it retired the old set already, so
                # flipping now would leak live replicas into a fleet
                # that reports closed
                aborted = self._closed
                old = []
                if not aborted:
                    g = self._groups.get(tname)
                    if g is None:
                        g = _TenantGroup(tname,
                                         self._record_path(tname))
                        self._groups[tname] = g
                    old = g.replicas
                    g.replicas = new
                    g.version = vname
                    g.version_dir = vdir
                    g.slo_class = sc
                    self._deploy_seq += 1
                    seq = self._deploy_seq
                    record_path = g.record_path
            if aborted:
                self._retire(new)
                raise RuntimeError("ServingFleet is closed")
            _io.write_rollback_json(record_path, {
                'version': vname, 'dir': os.path.abspath(vdir),
                'replicas': n, 'seq': seq, 'reason': str(reason),
                'tenant': tname, 'slo_class': sc})
            with self._lock:
                self._last_deploy_reason = str(reason)
            self._m.deploys.inc()
            self._retire(old)
            return vname

    def rollback(self, reason='operator', tenant=None):
        """Hot-swap a tenant back to its previous deployment, read
        from the ``.prev`` archive of its deploy record (the io.py
        manifest/``.prev`` protocol).  Two rollbacks in a row toggle
        between the last two versions — each deploy re-archives what
        it replaced.  Returns the restored version name.

        ``reason`` labels the rollback in
        ``stats()['rollbacks_by_reason']`` and the new deployment
        record: ``'operator'`` for a person's explicit call; automated
        callers pass their trigger."""
        tname = self._resolve_tenant(tenant)
        rec = _io.read_rollback_json(self._record_path(tname),
                                     prev=True)
        if rec is None:
            raise RuntimeError(
                "fleet %s has no previous deployment to roll back to "
                "(the deploy record has no .prev archive yet)"
                % self._fid)
        reason = str(reason)
        restored = self.deploy(rec['dir'], replicas=rec.get('replicas'),
                               reason='rollback:%s' % reason,
                               tenant=tname)
        # counted only once the restore serves: a rollback whose deploy
        # failed must not read as a completed recovery
        self._m.rollback_inc(reason)
        with self._lock:
            self._rollbacks_by_reason[reason] = \
                self._rollbacks_by_reason.get(reason, 0) + 1
        return restored

    def deployment(self, prev=False, tenant=None):
        """The on-disk deployment record ({version, dir, replicas,
        seq, reason, tenant, slo_class}), or its ``.prev`` archive —
        the rollback target.  None when the requested record does not
        exist.  Public so retention tooling (``io.gc_versions``) can
        protect exactly the dirs the fleet may still resolve."""
        tname = self._resolve_tenant(tenant)
        return _io.read_rollback_json(self._record_path(tname),
                                      prev=prev)

    def protected_version_dirs(self):
        """Every version dir this fleet may still resolve: each
        tenant's live dir plus its deploy record's current and
        ``.prev`` targets.  This is the ``io.gc_versions`` protect set
        — and, transitively, the AOT cache's: an entry lives exactly as
        long as its source artifact (``AotCache.sweep_orphans``), so
        protecting a version dir protects the entries that make its
        next deploy compile-free."""
        with self._lock:
            dirs = [g.version_dir for g in self._groups.values()
                    if g.version_dir]
            names = list(self._groups)
        for tname in names:
            for prev in (False, True):
                rec = _io.read_rollback_json(self._record_path(tname),
                                             prev=prev)
                if rec and rec.get('dir'):
                    dirs.append(rec['dir'])
        seen, out = set(), []
        for d in dirs:
            a = os.path.abspath(d)
            if a not in seen:
                seen.add(a)
                out.append(d)
        return out

    # -- decode attachment ---------------------------------------------
    def attach_decode(self, server, tenant=None):
        """Host a :class:`~paddle_tpu_torch.inference.decode.DecodeServer`
        under ``tenant``, sharing the fleet's HBM budget: the engine's
        paged KV pools plus its weight set join the fleet residency
        aggregate (and the watermark), so a later ``deploy()``'s
        admission check sees them.  Under ``hbm_admission='enforce'``
        an attach whose projected residency exceeds the budget raises
        :class:`~paddle_tpu_torch.inference.tenancy.AdmissionError` and
        attaches nothing — the engine already allocated its pools (at
        construction), so the caller must drop it; the rejection keeps
        the fleet's accounting and subsequent deploys honest.  Decode
        servers are not replicated or LRU-evicted: a KV pool serving
        in-flight streams is not reclaimable the way a cold compiled
        bucket is.  They ride the fleet for routing (``generate``),
        residency accounting, ``stats()``, and ``close()``."""
        tname = tenant if tenant is not None else _tn.DEFAULT_TENANT
        need = _decode_resident(server)
        live = self._resident_total()
        if (self._hbm_budget
                and self._admission_mode == 'enforce'
                and live + need > self._hbm_budget):
            self._m.admission_rejections.inc()
            raise _tn.AdmissionError(tname, 'decode', self._hbm_budget,
                                     live, need)
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "ServingFleet %s is closed" % self._fid)
            if tname in self._decode:
                raise ValueError(
                    "tenant %r already has a decode server attached"
                    % tname)
            self._decode[tname] = server
        self._note_resident_watermark()
        return server

    def generate(self, prompt, max_new_tokens=16, tenant=None):
        """Submit an autoregressive generation to ``tenant``'s attached
        decode server; returns the ``DecodeStream`` handle (call
        ``.result()`` for the generated tokens)."""
        tname = tenant if tenant is not None else _tn.DEFAULT_TENANT
        with self._lock:
            srv = self._decode.get(tname)
        if srv is None:
            raise ValueError(
                "tenant %r has no decode server; attach one with "
                "fleet.attach_decode(DecodeServer(engine), tenant=%r)"
                % (tname, tname))
        return srv.submit(prompt, max_new_tokens=max_new_tokens)

    # -- resident-bytes accounting -------------------------------------
    def _resident_total(self, extra=()):
        """Modeled resident bytes across live replicas (READY /
        UNROUTABLE / DRAINING — a draining replica's servable is still
        on the device) plus ``extra`` (a freshly built set mid-deploy).
        Replicas sharing one compiled servable
        (``share_artifacts_with``) are counted ONCE, keyed by the
        shared servable identity."""
        with self._lock:
            reps = [r for g in self._groups.values()
                    for r in g.replicas if r.state in _STATES]
            dec = list(self._decode.values())
        seen = set()
        total = 0
        for r in list(reps) + list(extra):
            res = r.refresh_resident()
            key = res.get('servable_key')
            if key in seen:
                continue
            seen.add(key)
            total += res.get('total_bytes', 0)
        total += sum(_decode_resident(s) for s in dec)
        return total

    def _note_resident_watermark(self, extra=()):
        """Advance the fleet resident-bytes watermark.  Called at the
        points residency can peak: after the initial build, after
        add_replica, and at a deploy's overlap moment — the incoming
        set is built and the outgoing set still serves."""
        v = self._resident_total(extra=extra)
        # compare-and-advance under _lock (_resident_total takes it
        # itself, so the critical section starts only here)
        with self._lock:
            if v > self._resident_watermark:
                self._resident_watermark = v
                # published inside the lock: a loser of the compare must
                # not overwrite a higher value
                self._m.resident_watermark.set(v)
        return v

    def _admission_check(self, tname, vname, paths, budget,
                         dedupe=False):
        """Deploy admission: BEFORE paying the replica build, project
        the overlap-moment residency (live servables + the incoming
        version's artifacts, estimated from their file sizes, the
        proxy of the state available before a load) against the
        budget.  ``dedupe`` marks a redeploy of an already-resident
        servable: the new lanes share it, so incoming bytes are zero.

        ``warn`` mode (default): over budget logs + counts, the deploy
        proceeds — the pre-tenancy behavior, bit for bit.  ``enforce``
        mode: LRU-evict cold buckets of OTHER tenants until it fits;
        still over raises AdmissionError, counted, with no build cost
        paid."""
        if not budget or budget <= 0:
            return None
        incoming = 0
        if not dedupe:
            for p in paths.values():
                try:
                    incoming += os.path.getsize(p)
                except OSError:
                    pass
        live = self._resident_total()
        projected = live + incoming
        verdict = {'budget_bytes': int(budget),
                   'live_bytes': int(live),
                   'incoming_bytes': int(incoming),
                   'projected_bytes': int(projected),
                   'over_budget': projected > budget,
                   'admission': self._admission_mode,
                   'freed_bytes': 0, 'evicted': []}
        if not verdict['over_budget']:
            return verdict
        self._m.budget_precheck_failures.inc()
        if self._admission_mode != 'enforce':
            _log.warning(
                "fleet %s deploy of version %r would exceed the HBM "
                "budget at the rollout overlap: live %d B + incoming "
                "~%d B = %d B > budget %d B.  Proceeding anyway "
                "(PADDLE_TPU_TORCH_FLEET_HBM_ADMISSION=warn)", self._fid,
                vname, live, incoming, projected, budget)
            return verdict
        if incoming > budget:
            # eviction frees OTHER tenants' bytes; it can never make
            # an incoming set bigger than the whole budget fit.
            # Reject immediately instead of evicting the fleet cold
            # for a deploy that was doomed from the start
            self._m.admission_rejections.inc()
            raise _tn.AdmissionError(tname, vname, budget, live,
                                     incoming, 0)
        freed, evicted = self._evict_lru(projected - budget,
                                         exclude=tname)
        live = self._resident_total()
        projected = live + incoming
        verdict.update(live_bytes=int(live),
                       projected_bytes=int(projected),
                       freed_bytes=int(freed), evicted=evicted,
                       over_budget=projected > budget)
        if not verdict['over_budget']:
            _log.warning(
                "fleet %s admission: LRU-evicted %d cold bucket(s) "
                "(~%d B) to fit version %r for tenant %r under the "
                "HBM budget %d B", self._fid, len(evicted), freed,
                vname, tname, budget)
            return verdict
        self._m.admission_rejections.inc()
        raise _tn.AdmissionError(tname, vname, budget, live, incoming,
                                 freed)

    def _evict_lru(self, need_bytes, exclude=None):
        """LRU-evict compiled buckets until ``need_bytes`` are freed:
        coldest tenant first (registry last-used), coldest bucket
        within it, skipping ``exclude`` (the deploying tenant — its
        own working set must not be cannibalized to fit its upgrade).
        Eviction drops the warmed module and the loaded artifact,
        NEVER the version dir — a later request re-warms through the
        normal counted compile path.  Returns
        ``(freed_bytes_estimate, [(tenant, bucket), ...])``."""
        with self._lock:
            groups = [g for g in self._groups.values()
                      if g.name != exclude and g.replicas]
        cands, seen = [], set()
        for g in groups:
            t_last = self._tenancy.last_used(g.name)
            for rep in g.replicas:
                res = rep.refresh_resident()
                skey = res.get('servable_key')
                if skey in seen:
                    continue  # shared servable: one set of buckets
                seen.add(skey)
                used = rep.server.bucket_last_used()
                for b, e in (res.get('per_bucket') or {}).items():
                    size = int(e.get('estimate_bytes', 0) or 0)
                    if size <= 0:
                        continue
                    cands.append({'tenant': g.name,
                                  'tenant_last_used': t_last,
                                  'bucket': int(b),
                                  'bucket_last_used':
                                      used.get(b, 0.0),
                                  'bytes': size, 'rep': rep})
        plan, freed = _tn.plan_eviction(cands, need_bytes)
        evicted, by_tenant = [], {}
        for c in plan:
            c['rep'].server.evict_buckets([c['bucket']])
            evicted.append((c['tenant'], c['bucket']))
            by_tenant[c['tenant']] = by_tenant.get(c['tenant'], 0) + 1
        for t, nb in by_tenant.items():
            self._m.evictions(t).inc(nb)
            self._tenancy.note_evicted(t, nb)
        for c in plan:
            c['rep'].refresh_resident()
        return freed, evicted

    # -- introspection -------------------------------------------------
    def _aggregate(self, field):
        with self._lock:
            reps = [r for r in self._reps_locked()
                    if r.state in (READY, UNROUTABLE)]
        return sum(r.server.queue_state()[field] for r in reps)

    def _state_count(self, state):
        with self._lock:
            return sum(1 for r in self._reps_locked()
                       if r.state == state)

    def _healthz(self):
        """The fleet's /healthz check: ok while every tenant has a READY
        replica; the detail counts replicas by state."""
        with self._lock:
            reps = self._reps_locked()
            starved = sorted(name for name, g in self._groups.items()
                             if not any(r.state == READY
                                        for r in g.replicas))
        by_state = {}
        for r in reps:
            by_state[r.state] = by_state.get(r.state, 0) + 1
        return not starved, {'replicas': by_state,
                             'tenants_without_ready_replica': starved}

    @property
    def version(self):
        """The default tenant's live version (or the sole tenant's,
        when only one non-default tenant is deployed)."""
        with self._lock:
            g = self._groups.get(_tn.DEFAULT_TENANT)
            if g is None and self._groups:
                g = next(iter(self._groups.values()))
            return g.version if g is not None else None

    @property
    def replica_ids(self):
        with self._lock:
            return [r.rid for r in self._reps_locked()]

    def tenants(self):
        """Live tenant names, in deploy order."""
        with self._lock:
            return list(self._groups)

    def stats(self):
        """Fleet-wide aggregate + per-replica detail.  The per-replica
        ``server`` sub-dicts are each replica's own ``stats()`` (same
        shapes as the single-server API, queue-wait/compute split
        included), so the routing signal and this dict read the same
        numbers.  ``tenants`` adds each tenant's
        flow-control snapshot (SLO class, quota, pending, evictions)
        next to its group's version + replica ids."""
        with self._lock:
            reps = self._reps_locked()
            groups = {name: (g.version, [r.rid for r in g.replicas])
                      for name, g in self._groups.items()}
            by_reason = dict(self._rollbacks_by_reason)
            last_reason = self._last_deploy_reason
            watermark = self._resident_watermark
            dec = dict(self._decode)
        version = self.version
        per = []
        for r in reps:
            s = r.server.stats()
            per.append({
                'id': r.rid, 'version': r.version, 'state': r.state,
                'tenant': r.tenant,
                'failures': r.failures,
                'warmup_s': round(r.warmup_s, 3),
                'compiles': s['compiles'],
                'compiles_after_warmup': s['compiles_after_warmup'],
                'resident_bytes':
                    r.refresh_resident().get('total_bytes', 0),
                'queue': r.server.queue_state(),
                'server': s,
            })
        tenants = {}
        for name in self._tenancy.names():
            info = self._tenancy.info(name)
            gv = groups.get(name)
            info['version'] = gv[0] if gv else None
            info['replicas'] = gv[1] if gv else []
            tenants[name] = info
        m = self._m
        return {
            'fleet': self._fid,
            'version': version,
            'replicas': per,
            'tenants': tenants,
            'admission_mode': self._admission_mode,
            'ready': sum(1 for p in per if p['state'] == READY),
            'unroutable':
                sum(1 for p in per if p['state'] == UNROUTABLE),
            'queued_rows': sum(p['queue']['queued_rows'] for p in per),
            'in_flight_batches':
                sum(p['queue']['in_flight_batches'] for p in per),
            'requests': int(m.requests.value),
            'completed': int(m.completed.value),
            'failed': int(m.failed.value),
            'retries': int(m.retries.value),
            'deploys': int(m.deploys.value),
            'rollbacks': sum(by_reason.values()),
            'rollbacks_by_reason': by_reason,
            'last_deploy_reason': last_reason,
            'unroutable_marks': int(m.unroutable_marks.value),
            'health_probes': int(m.probes.value),
            'resident_bytes': self._resident_total(),
            'resident_bytes_watermark': watermark,
            'hbm_budget_bytes': self._hbm_budget,
            'hbm_budget_precheck_failures':
                int(m.budget_precheck_failures.value),
            'admission_rejections':
                int(m.admission_rejections.value),
            'evictions': sum(t['evicted_buckets']
                             for t in tenants.values()),
            'quota_pending': self._tenancy.pending_total(),
            'quota_deferred': sum(t['deferred']
                                  for t in tenants.values()),
            'decode': {name: s.stats() for name, s in dec.items()},
        }

    # -- shutdown ------------------------------------------------------
    def _rm_owned_state_dir(self):
        if self._owned_state_dir:
            import shutil
            shutil.rmtree(self._owned_state_dir, ignore_errors=True)

    def close(self):
        """Retire every replica (drain first — queued work completes),
        stop the health loop, fail any quota-parked requests (their
        futures must resolve, not hang), and release the fleet's
        metric series.  Setting ``_closed`` first stops new submits
        and makes any in-flight deploy/add abort at its flip re-check;
        the ``_deploy_lock`` below then waits that operation out, so
        its freshly built replicas are retired (by it) before the
        state dir and metric series go away."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            reps = self._reps_locked()
            for g in self._groups.values():
                g.replicas = []
            dec = list(self._decode.values())
            self._decode = {}
        if self._health_thread is not None:
            self._stop.set()
            self._health_thread.join(
                max(1.0, self._health_interval * 4))
        self._retire(reps)
        for s in dec:
            s.close()
        for nm, (feed, fut, rid) in self._tenancy.drain_all():
            if not fut.done():
                fut.set_exception(RuntimeError(
                    "ServingFleet %s closed while the request was "
                    "parked on tenant %r's quota queue"
                    % (self._fid, nm)))
        with self._deploy_lock:
            pass  # barrier: an in-flight deploy/add finishes aborting
        _obs.unregister_healthz('fleet_%s' % self._fid)
        self._m.close()
        self._rm_owned_state_dir()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
