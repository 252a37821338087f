"""Env-var configuration (gflags parity): the serving stack's, the pass
pipeline's, the step report's, observability's, the feed runtime's,
the tuner's and the lock watchdog's flags.

Every flag is ``PADDLE_TPU_TORCH_<NAME>`` in the environment, declared
with a type and default, and read through the global ``FLAGS``.  The
prefix differs from the JAX package's ``PADDLE_TPU_``, so neither package
reads the other's switches.  Defaults are those of paddle_tpu/flags.py,
but ``profile_dir``, which lies under the process's temporary directory
(``tempfile.gettempdir()``) rather than a fixed ``/tmp`` path.

``python -m paddle_tpu_torch.flags`` prints every flag with its
environment name, default and help.
"""
import os
import tempfile

__all__ = ['FLAGS', 'ENV_PREFIX']

ENV_PREFIX = 'PADDLE_TPU_TORCH_'
_TRUE = ('1', 'true', 'yes', 'on')


class _Flags(object):
    def __init__(self):
        self._defs = {}

    def _define(self, name, default, parser, help_str):
        self._defs[name] = (default, parser, help_str)

    def __getattr__(self, name):
        defs = object.__getattribute__(self, '_defs')
        if name not in defs:
            raise AttributeError("flag %r was never defined" % name)
        default, parser, _ = defs[name]
        env = os.environ.get(ENV_PREFIX + name.upper())
        if env is None:
            return default
        return parser(env)

    def declared(self):
        """{name: current value} of every declared flag."""
        return {n: getattr(self, n) for n in self._defs}

    def definitions(self):
        """{name: (default, help)} of every declared flag."""
        return {n: (d, h) for n, (d, _, h) in self._defs.items()}

    def help(self):
        return '\n'.join(
            '%s%s (default %r): %s' % (ENV_PREFIX, n.upper(), d, h)
            for n, (d, _, h) in sorted(self._defs.items()))


FLAGS = _Flags()


def _bool(s):
    return s.lower() in _TRUE


FLAGS._define(
    'decode_page_size', 16, int,
    'positions per KV-cache page in the decode engine '
    '(inference/decode.py)')
FLAGS._define(
    'decode_max_streams', 8, int,
    'decode batch slots: how many streams one DecodeEngine steps at once')
FLAGS._define(
    'decode_prefill_bucket', 128, int,
    'top of the prefill bucket ladder (page-size multiples doubling up to '
    'this); longer prompts are rejected at submit')
FLAGS._define(
    'decode_prefix_cache', False, _bool,
    'radix-trie prefix cache over the KV pages; switches prefill to the '
    'chunked path')
FLAGS._define(
    'decode_prefill_chunk_tokens', 0, int,
    'per-tick prefill token budget for chunked prefill (0 = none; the '
    'chunked path still runs when the prefix cache is on)')
FLAGS._define(
    'decode_page_reserve', 2, int,
    'free pages kept in reserve at admission when pages are claimed '
    'incrementally (prefix cache or chunked prefill on)')
FLAGS._define(
    'graph_opt_level', 2, int,
    'pass pipeline run once per executor plan (transpiler/'
    'pass_manager.py): 0 disables, 1 runs dead-op elimination only, 2 '
    'adds constant folding and common-subexpression elimination; part of '
    'the plan key, so a flip takes effect at the next run')
FLAGS._define(
    'amp', '0', str,
    "automatic mixed precision (transpiler/amp.py): '0' off, 'bf16', or "
    "'f16' (adds dynamic loss scaling); applied per plan after the "
    'graph-opt passes, with f32 master weights')
FLAGS._define(
    'amp_init_loss_scale', 32768.0, float,
    'f16 mode: initial dynamic loss scale')
FLAGS._define(
    'amp_incr_every_n_steps', 1000, int,
    'f16 mode: double the loss scale after this many consecutive finite '
    'steps')
FLAGS._define(
    'amp_decr_every_n_nan_or_inf', 2, int,
    'f16 mode: halve the loss scale after this many consecutive '
    'overflowing steps (each of them skipped)')
FLAGS._define(
    'verify_ir', 'boundary', str,
    'static IR verification of the pass pipeline (transpiler/verify.py): '
    "'boundary' checks the final program once, 'every_pass' after each "
    "rewrite pass (naming the pass at fault), 'off' skips it")
FLAGS._define(
    'peak_tflops', 0.0, float,
    "the card's peak TFLOP/s for the step's dtype: when > 0, a synced "
    "Executor.last_step_report gives phases['compute']['mfu'] = achieved "
    'FLOP/s (the cost model\'s FLOPs over the measured compute wall) over '
    'this peak.  0 (the default): no mfu; there is no default peak')
FLAGS._define(
    'peak_hbm_bytes', 0, int,
    "the card's memory in bytes: when > 0, last_step_report['memory'] "
    'adds a headroom block (the modelled and measured peaks as ratios of '
    'it).  0 (the default) leaves it out')
FLAGS._define(
    'serving_max_wait_ms', 5.0, float,
    'default deadline flush for BatchingInferenceServer when the '
    'constructor is not passed max_wait_ms=: how long the oldest queued '
    'request may wait before a partial batch dispatches anyway')
FLAGS._define(
    'serving_max_batch', 8, int,
    'default bucket-ladder top for export_bucketed / '
    'BatchingInferenceServer.from_program when max_batch= is not passed: '
    'buckets are powers of two up to this many rows')
FLAGS._define(
    'aot_cache_dir', '', str,
    'root directory of the serving AOT cache (entries under '
    '<dir>/paddle_tpu_aot, inference/aot_cache.py): a bucket that had to '
    'be loaded from its torch.export artifact stores its unlifted graph '
    'code and state there, and a later process readies that bucket from '
    'the entry, skipping torch.export.load and the unlifting: zero '
    'counted compiles on a warm cache.  Empty (the default) disables it')
FLAGS._define(
    'fleet_replicas', 2, int,
    'default replica count of inference.ServingFleet when replicas= is '
    'not passed: the fleet starts this many BatchingInferenceServer '
    'replicas and deploy() builds as many for the incoming version')
FLAGS._define(
    'fleet_unroutable_after', 3, int,
    'consecutive dispatch failures before the fleet marks a replica '
    'UNROUTABLE and stops routing to it; the health loop probes it and '
    'restores it on the first success')
FLAGS._define(
    'fleet_retry_limit', 2, int,
    'how many times one request is re-dispatched onto a different replica '
    'after a dispatch failure before its future carries the error')
FLAGS._define(
    'fleet_health_interval_ms', 250.0, float,
    'period of the ServingFleet health loop, which probes each UNROUTABLE '
    'replica with a one-row zero request; <= 0 disables the loop')
FLAGS._define(
    'fleet_drain_timeout_s', 30.0, float,
    'seconds a retiring replica gets to finish its queued and in-flight '
    'requests before the fleet closes it anyway')
FLAGS._define(
    'fleet_hbm_admission', 'warn', str,
    "ServingFleet HBM budget mode: 'warn' (the default) logs and counts "
    "an over-budget deploy() and lets it proceed; 'enforce' first evicts "
    "cold tenants' warmed buckets, least recently used first, and "
    'rejects a deploy that still does not fit with '
    'tenancy.AdmissionError before any replica is built')
FLAGS._define(
    'fleet_tenant_quota', 0, int,
    'base outstanding-request quota of a fleet tenant, scaled by its SLO '
    'class weight (gold the base, silver half, bronze an eighth, at '
    'least 1); a submit past it is parked and drained in weighted '
    'round-robin order, never dropped.  0 (the default) disables it')

# -- observability, the profiler and the feed runtime ----------------------
FLAGS._define(
    'check_nan_inf', False, _bool,
    'scan every op output for NaN and Inf as the executor runs it and raise '
    "naming the first op that made one (Fluid executor.cc's "
    'FLAGS_check_nan_inf; debug.nan_guard() arms the same scan for a '
    'region).  Each scan syncs the host, so it is off by default')
FLAGS._define(
    'reader_buf_size', 64, int,
    'prefetch depth for the buffered and xmap readers '
    '(runtime.prefetch_reader)')
FLAGS._define(
    'profile_dir', os.path.join(tempfile.gettempdir(), 'paddle_tpu_torch_prof'),
    str,
    'where profiler traces are written (profiler.profiler / '
    'start_profiler), and where a dump-on-error trace goes when no trace '
    'dir is set')
FLAGS._define(
    'use_native_runtime', True, _bool,
    'use the C++ queue, record reader/writer and staging arena '
    '(runtime/native.py, built with g++ at first use).  On, a failed '
    'build raises; off, the pure-Python classes run')
FLAGS._define(
    'metrics_enabled', True, _bool,
    'arm the observability registry (paddle_tpu_torch.observability): '
    'executor plan-cache and run counters, reader sample counters and '
    'span() timings.  0 disables every instrumented executor and reader '
    'path at one cached-bool cost (no registry allocation on the hot '
    'path); the servers keep counting for stats()')
FLAGS._define(
    'metrics_port', 0, int,
    'when > 0, serving runtimes expose GET /metrics (Prometheus text '
    'exposition 0.0.4) and /healthz on this port from a daemon-thread '
    'HTTP server (observability.serve_metrics / maybe_serve_from_env).  '
    '0 (the default) serves nothing')
FLAGS._define(
    'metrics_host', '127.0.0.1', str,
    'bind address of the /metrics endpoint: loopback by default, since the '
    'listener is unauthenticated')
FLAGS._define(
    'profiler_event_cap', 10000, int,
    'bound of the one event ring (observability/timeline.py) that '
    'RecordEvent, profile regions and the step-timeline recorder share; '
    'oldest events drop first.  <= 0 means unbounded; read when the ring '
    'is made or reset (profiler.reset_profiler())')
FLAGS._define(
    'trace_dir', '', str,
    'arm the step-timeline flight recorder (observability/timeline.py) '
    'and export it here: the executor records per-step phase events '
    '(feed staging, plan build, compute, scope update, prefetch staging) '
    'into the event ring and, after every run_steps call, writes it as '
    'Chrome trace_event JSON (trace_<pid>.json, atomic replace).  Empty '
    '(the default) records nothing on the executor paths: one cached-bool '
    'check a call')
FLAGS._define(
    'trace_steps', 256, int,
    'how many trailing steps of timeline events each exported trace keeps '
    '(the run_steps flush and the dump-on-error file); 0 exports every '
    'event still in the ring')
FLAGS._define(
    'trace_dump_on_error', False, _bool,
    'on an executor or serving-dispatch exception, write the last '
    'PADDLE_TPU_TORCH_TRACE_STEPS steps of the ring to '
    'trace_<pid>_error[_<tag>].json under the trace dir (or the profile '
    'dir) before the error propagates.  Arming this also arms recording')
FLAGS._define(
    'device_prefetch', False, _bool,
    'run_steps with per-step feeds stages them in chunks of '
    'PADDLE_TPU_TORCH_DEVICE_PREFETCH_CHUNK steps through pinned host '
    'blocks and a side CUDA stream: chunk c+1 is copied while the card '
    'runs chunk c, so only the first chunk is a blocking put '
    '(paddle_tpu_executor_feed_blocking_puts_total) and about two chunks '
    'of feed are on the card at once.  Off (the default) stages every '
    'feed before the first step.  Re-read on every run_steps call; the '
    'numbers are bitwise the same either way')
FLAGS._define(
    'device_prefetch_chunk', 0, int,
    'steps per staged chunk when PADDLE_TPU_TORCH_DEVICE_PREFETCH is on; '
    '0 (the default) takes max(1, ceil(K/4))')


# -- tuning, the roofline and the lock watchdog ----------------------------
FLAGS._define(
    'tune', 'off', str,
    "the autotuner (paddle_tpu_torch.tuning): 'off' (the default) leaves "
    'every executor path bitwise untuned at one env read a call, nothing '
    "imported; 'cached' makes the executor apply the persisted winners "
    'of a program (keyed by plan key, device kind and mesh, under '
    'PADDLE_TPU_TORCH_TUNE_CACHE_DIR) before its plan key is computed, '
    "so a fresh process starts tuned with no search; 'search' is read "
    'by the harness that drives a search (chip_smoke.py --tune)')
FLAGS._define(
    'tune_cache_dir', '', str,
    'where the tuner\'s winners persist (one JSON file per (plan key, '
    'device kind, mesh) under <dir>/paddle_tpu_tuning).  Empty falls back '
    'to PADDLE_TPU_TORCH_AOT_CACHE_DIR; empty too means no persistence.  '
    'A corrupted file is counted (paddle_tpu_tune_cache_corrupt_total) '
    'and read as a miss')
FLAGS._define(
    'tune_trace', False, _bool,
    'print the search trace (one line a candidate: modelled and measured '
    'score, pruned / measured / adopted and why) after a harness-driven '
    'search')
FLAGS._define(
    'tune_measure_budget', 24, int,
    'most candidates one search measures; pruned candidates are free, and '
    'past the budget the rest are pruned as measure-budget')
FLAGS._define(
    'hbm_gbps', 0.0, float,
    "the card's memory rate in GB/s for the roofline (tuning/"
    'roofline.py): an op\'s bytes-bound floor is its bytes over this.  0 '
    "(the default) takes the H100 80GB HBM3's 3350 GB/s.  Modelled "
    'numbers only, never measured ones')
FLAGS._define(
    'lock_debug', False, _bool,
    'the run-time lock watchdog (paddle_tpu_torch.analysis.lockdebug): '
    'on, the serving modules make their locks as checking wrappers that '
    'keep each thread\'s acquisition stack and assert the static '
    "analyzer's lock-order graph; acquiring B while holding A where B "
    'comes before A (statically, or earlier in this process) counts a '
    'paddle_tpu_lock_order_violations_total and records the site.  Read '
    'when a lock is made; off (the default), plain threading locks')
FLAGS._define(
    'dense_apply_blocks_per_sm', 16, int,
    'grid cap of the dense optimizer apply kernel (#5, csrc/'
    'dense_update.cu): at most this many 256-thread blocks per SM walk '
    "the parameter grid-stride; the SM count is the card's.  A tunable "
    '(2, 4, 8, 16, 32); every value gives the same bits, the rule being '
    'per element')


if __name__ == '__main__':
    print(FLAGS.help())
