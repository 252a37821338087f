"""Env-var configuration (gflags parity), cut to the decode engine's flags.

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
