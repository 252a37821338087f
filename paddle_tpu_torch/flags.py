"""Env-var configuration (gflags parity), cut to the serving stack's,
the pass pipeline's and the step report's flags.

Every flag is ``PADDLE_TPU_TORCH_<NAME>`` in the environment, declared
with a type and default, and read through the global ``FLAGS``.  The
prefix differs from the JAX package's ``PADDLE_TPU_``, so neither package
reads the other's switches.  Defaults are those of paddle_tpu/flags.py.
"""
import os

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
    'the reference\'s on-disk cache of compiled serving executables; not '
    'ported yet (ROADMAP.md Queue 1 item 8b): a BatchingInferenceServer '
    'raises while it is set')
