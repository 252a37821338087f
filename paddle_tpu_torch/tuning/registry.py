"""Central registry of every hand-set performance tunable.

Port of paddle_tpu/tuning/registry.py.  Each :class:`Tunable` names one
knob the autotuner (tuning/search.py) may search: a bounded finite
candidate domain, the shipped default, the subsystem that consumes it,
and the documented ``PADDLE_TPU_TORCH_*`` env override through which a
choice is applied.

Two scopes:

- ``'flag'`` tunables apply by setting their env var.  Every consumer
  re-reads its flag: the pass-affecting ones (``amp``) are components of
  the executor's plan key (pass_manager.plan_key), so an applied
  override plans anew, and the kernel launcher re-reads
  ``dense_apply_blocks_per_sm`` at every launch of #5.
- ``'bench'`` tunables (train batch, run_steps K) change the program or
  the call shape; the executor cannot apply them, so the harness that
  builds the program consumes them (chip_smoke.py ``--tune``).

Pinning: a tunable whose env var the USER set (not the tuner) is pinned:
the search skips it and the pinned value rides unchanged in every
candidate.  Export its env var before tuning to pin it; unset it to
unpin.

The registry is the reference's, less the distribution tunables of
``WAITING``, with one rename: the reference's ``flat_tile_budget`` is a
per-block VMEM budget of its Pallas tile walk, and a CUDA block has no
such budget.  What sets each block's share of #5's grid-stride walk here
is the grid cap, so the tunable is ``dense_apply_blocks_per_sm``.
``python -m paddle_tpu_torch.tools.check_tunables`` lints the registry.
"""
import contextlib
import os

__all__ = ['Tunable', 'register_tunable', 'registered_tunables',
           'tunable', 'defaults', 'current_config', 'is_pinned',
           'applied', 'apply_persistent', 'tuner_applied_env',
           'base_env', 'WAITING', 'RENAMED']

# env vars the TUNER set in this process (apply_persistent): masked by
# base_env() so the winner-cache key is computed from the configuration a
# fresh, untuned process would also compute, and never pinned
_TUNER_APPLIED = set()

# reference tunables whose consumers the port does not have yet, by the
# ROADMAP.md Queue 1 item that brings them
WAITING = {
    'mesh': 'item 10',
    'embed_bucket_tile': 'item 10',
    'embed_cache_rows': 'item 10',
    'overlap': 'item 10',
    'overlap_bucket_mb': 'item 10',
    'pp_microbatches': 'item 10',
}

# reference name -> port name
RENAMED = {'flat_tile_budget': 'dense_apply_blocks_per_sm'}


class Tunable(object):
    """One searchable knob: name, bounded domain, default, subsystem,
    and the env override that applies a choice."""

    __slots__ = ('name', 'domain', 'default', 'subsystem', 'env',
                 'scope', 'help', 'feasible')

    def __init__(self, name, domain, default, subsystem, env,
                 scope='flag', help='', feasible=None):
        self.name = name
        self.domain = tuple(domain)
        self.default = default
        self.subsystem = subsystem
        self.env = env
        self.scope = scope
        self.help = help
        self.feasible = feasible  # optional value -> bool (device fit)

    def coerce(self, raw):
        """Parse an env-var string back to this tunable's value type."""
        if isinstance(self.default, bool):
            return raw.lower() in ('1', 'true', 'yes', 'on')
        return type(self.default)(raw)

    def encode(self, value):
        """The env-var string that applies ``value``."""
        return str(value)

    def __repr__(self):
        return 'Tunable(%r, domain=%r, default=%r, env=%r)' % (
            self.name, self.domain, self.default, self.env)


_REGISTRY = {}  # name -> Tunable, registration order preserved


def register_tunable(name, domain, default, subsystem, env,
                     scope='flag', help='', feasible=None):
    if name in _REGISTRY:
        raise ValueError('tunable %r already registered' % name)
    t = Tunable(name, domain, default, subsystem, env, scope=scope,
                help=help, feasible=feasible)
    _REGISTRY[name] = t
    return t


def registered_tunables():
    """Every registered tunable, in registration order."""
    return tuple(_REGISTRY.values())


def tunable(name):
    return _REGISTRY[name]


def defaults():
    """{name: shipped default} over the whole registry."""
    return {t.name: t.default for t in _REGISTRY.values()}


def is_pinned(t):
    """True when the USER set this tunable's env var: the tuner then
    treats the knob as fixed (skipped by the search, kept verbatim in
    every candidate).  Env vars the tuner itself applied do not pin."""
    return t.env in os.environ and t.env not in _TUNER_APPLIED


def current_config(tunables=None):
    """{name: effective value}: the env override when set (coerced to the
    default's type), the shipped default otherwise."""
    out = {}
    for t in (tunables or _REGISTRY.values()):
        raw = os.environ.get(t.env)
        if raw is None:
            out[t.name] = t.default
        else:
            try:
                out[t.name] = t.coerce(raw)
            except (TypeError, ValueError):
                out[t.name] = t.default
    return out


@contextlib.contextmanager
def applied(overrides):
    """Temporarily apply ``{name: value}`` through env vars (flag and
    bench scope alike), restoring the prior environment on exit: the
    search's guard around one candidate."""
    saved = {}
    try:
        for name, value in (overrides or {}).items():
            t = _REGISTRY[name]
            saved[t.env] = os.environ.get(t.env)
            os.environ[t.env] = t.encode(value)
        yield
    finally:
        for env, old in saved.items():
            if old is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = old


def apply_persistent(overrides, skip=()):
    """Apply winners for the rest of the process (the
    PADDLE_TPU_TORCH_TUNE=cached executor path): set each tunable's env
    var and remember that the TUNER did it, so base_env() masks it out of
    the cache key and is_pinned() keeps the knob tunable.  User-pinned
    tunables are never overwritten.  Returns the overrides applied."""
    done = {}
    for name, value in (overrides or {}).items():
        t = _REGISTRY.get(name)
        if t is None or name in skip or is_pinned(t):
            continue
        os.environ[t.env] = t.encode(value)
        _TUNER_APPLIED.add(t.env)
        done[name] = value
    return done


def tuner_applied_env():
    return frozenset(_TUNER_APPLIED)


@contextlib.contextmanager
def base_env():
    """Mask every tuner-applied env var: inside, the environment is what
    a fresh, untuned process with the same USER configuration sees.  The
    winner-cache key (runtime.py) is computed here, so a tuned process
    and a fresh one derive the same key for one program."""
    saved = {}
    try:
        for env in list(_TUNER_APPLIED):
            if env in os.environ:
                saved[env] = os.environ.pop(env)
        yield
    finally:
        os.environ.update(saved)


# ---------------------------------------------------------------------------
# the registrations: the reference's, in its order, less WAITING
# ---------------------------------------------------------------------------

register_tunable(
    'dense_apply_blocks_per_sm', (2, 4, 8, 16, 32),
    default=16, subsystem='ops.kernels',
    env='PADDLE_TPU_TORCH_DENSE_APPLY_BLOCKS_PER_SM',
    help='grid cap of the dense optimizer apply kernel (#5): at most this '
         'many 256-thread blocks per SM walk the parameter grid-stride; '
         'fewer blocks walk longer strides, more hide more latency')
register_tunable(
    'device_prefetch_chunk', (0, 1, 2, 4, 8, 16, 32),
    default=0, subsystem='runtime.prefetch',
    env='PADDLE_TPU_TORCH_DEVICE_PREFETCH_CHUNK',
    help='steps per staged chunk of the device-prefetched run_steps feed '
         '(0 = auto ~K/4)')
register_tunable(
    'amp', ('0', 'bf16', 'f16'),
    default='0', subsystem='transpiler.amp', env='PADDLE_TPU_TORCH_AMP',
    help='mixed-precision mode the AMP pass applies per plan build')
register_tunable(
    'serving_max_wait_ms', (1.0, 2.0, 5.0, 10.0, 20.0),
    default=5.0, subsystem='inference.batching',
    env='PADDLE_TPU_TORCH_SERVING_MAX_WAIT_MS',
    help='serving deadline flush: max ms the oldest queued request '
         'waits before a partial batch dispatches')
register_tunable(
    'serving_max_batch', (8, 16, 32, 64, 128),
    default=8, subsystem='inference.batching',
    env='PADDLE_TPU_TORCH_SERVING_MAX_BATCH',
    help='serving bucket-ladder top (powers of two up to this)')
register_tunable(
    'train_batch', (16, 32, 64, 128, 256, 512),
    default=64, subsystem='bench', env='PADDLE_TPU_TORCH_BENCH_BATCH',
    scope='bench',
    help='train batch size: changes the program, so only the harness '
         '(which rebuilds per candidate) can search it')
register_tunable(
    'run_steps_k', (20, 50, 100, 200, 500),
    default=100, subsystem='bench',
    env='PADDLE_TPU_TORCH_BENCH_RUN_STEPS', scope='bench',
    help='steps per run_steps call: amortizes the per-call staging and '
         'fetch; consumed by the harness')
register_tunable(
    'decode_page_size', (8, 16, 32, 64, 128),
    default=16, subsystem='inference.decode',
    env='PADDLE_TPU_TORCH_DECODE_PAGE_SIZE',
    help='KV-cache page granularity (tokens per page): small pages '
         'waste less on ragged tails but grow the page table; large '
         'pages read denser but strand capacity on short streams')
register_tunable(
    'decode_max_streams', (2, 4, 8, 16, 32),
    default=8, subsystem='inference.decode',
    env='PADDLE_TPU_TORCH_DECODE_MAX_STREAMS',
    help='decode step width (streams batched per token step): wider '
         'amortizes the weight read across streams but multiplies '
         'the page pool the admission check must cover')
register_tunable(
    'decode_prefill_bucket', (32, 64, 128, 256, 512),
    default=128, subsystem='inference.decode',
    env='PADDLE_TPU_TORCH_DECODE_PREFILL_BUCKET',
    help='prompt-length bucket ladder top for prefill (page-size '
         'multiples doubling up to this): taller ladders pad long '
         'prompts less but warm more variants')
register_tunable(
    'decode_prefix_cache', (False, True),
    default=False, subsystem='inference.decode',
    env='PADDLE_TPU_TORCH_DECODE_PREFIX_CACHE',
    help='radix-trie prefix reuse of KV pages: shared-prefix prompts '
         'skip the cached span\'s prefill at the price of trie '
         'bookkeeping and chunked prefill dispatches')
register_tunable(
    'decode_prefill_chunk_tokens', (0, 32, 64, 128, 256),
    default=0, subsystem='inference.decode',
    env='PADDLE_TPU_TORCH_DECODE_PREFILL_CHUNK_TOKENS',
    help='per-tick chunked-prefill token budget: smaller bounds the '
         'inter-token latency hit of a long-prompt admission, larger '
         'finishes prefill (TTFT) sooner; 0 = whole prefill per tick')
register_tunable(
    'decode_page_reserve', (0, 1, 2, 4, 8),
    default=2, subsystem='inference.decode',
    env='PADDLE_TPU_TORCH_DECODE_PAGE_RESERVE',
    help='admission-time free-page watermark under incremental '
         'allocation: higher admits later but preempts growing '
         'streams less often when the pool runs tight')
