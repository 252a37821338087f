"""The autotuner's registry (tuning/registry.py) is searchable and
documented.

Port of tools/check_tunables.py.  Every registered tunable needs:

- a bounded, duplicate-free domain of 2 to 64 values (one value is a
  constant, not a tunable), with the default inside it;
- ``coerce(encode(v)) == v`` for every value, so the env override
  applies the value it names;
- a documented ``PADDLE_TPU_TORCH_*`` override: a flag declared in
  paddle_tpu_torch/flags.py, or for a bench-scope tunable the env name
  in README.md's port section;
- a non-empty subsystem and help string.

The tunables ``REQUIRED`` names must stay registered.

``python -m paddle_tpu_torch.tools.check_tunables`` (exit 1 on an
error).
"""
from . import port_section, read_readme, run_main
from .check_flags_doc import pristine_flags

MAX_DOMAIN = 64
PREFIX = 'PADDLE_TPU_TORCH_'

# knobs that must stay registered: deleting one silently un-tunes it
REQUIRED = (
    'dense_apply_blocks_per_sm', 'amp',
    'decode_page_size', 'decode_max_streams', 'decode_prefill_bucket',
    'decode_prefix_cache', 'decode_prefill_chunk_tokens',
    'decode_page_reserve',
)


def check(tunables=None, readme=None):
    """Error strings (empty: clean).  ``tunables`` defaults to the
    registry's, ``readme`` to README.md's text."""
    from ..tuning import registry
    tunables = registry.registered_tunables() if tunables is None \
        else tuple(tunables)
    if not tunables:
        return ['the tunable registry is empty: import order bug?']
    try:
        section = port_section(readme if readme is not None
                               else read_readme())
    except OSError as e:
        return ['cannot read README.md: %s' % e]
    mod = pristine_flags()
    flag_envs = {mod.ENV_PREFIX + n.upper()
                 for n in mod.FLAGS.definitions()}
    errors = []
    seen = set()
    for t in tunables:
        where = 'tunable %r' % t.name
        if t.name in seen:
            errors.append('%s registered twice' % where)
        seen.add(t.name)
        if not isinstance(t.domain, tuple):
            errors.append('%s: domain must be a tuple, got %s'
                          % (where, type(t.domain).__name__))
            continue
        if len(t.domain) < 2:
            errors.append('%s: domain %r has fewer than 2 candidates: a '
                          'one-value domain is a constant, not a tunable'
                          % (where, t.domain))
        if len(t.domain) > MAX_DOMAIN:
            errors.append('%s: domain has %d candidates (max %d)'
                          % (where, len(t.domain), MAX_DOMAIN))
        if len(set(t.domain)) != len(t.domain):
            errors.append('%s: domain %r contains duplicates'
                          % (where, t.domain))
        if t.default not in t.domain:
            errors.append('%s: default %r is not in the domain %r'
                          % (where, t.default, t.domain))
        for v in t.domain:
            try:
                back = t.coerce(t.encode(v))
            except Exception as e:
                errors.append('%s: coerce(encode(%r)) raised %s: %s'
                              % (where, v, type(e).__name__, e))
                continue
            if back != v:
                errors.append('%s: coerce(encode(%r)) round-trips to %r'
                              % (where, v, back))
        if not (t.env or '').startswith(PREFIX):
            errors.append('%s: env override %r must start with %s'
                          % (where, t.env, PREFIX))
        elif t.env not in flag_envs and t.env not in section:
            errors.append('%s: env override %s is neither a declared flag '
                          '(paddle_tpu_torch/flags.py) nor documented in '
                          'README.md\'s port section' % (where, t.env))
        if not (t.subsystem or '').strip():
            errors.append('%s: empty subsystem' % where)
        if not (t.help or '').strip():
            errors.append('%s: empty help string' % where)
    for name in REQUIRED:
        if name not in seen:
            errors.append('required tunable %r is no longer registered'
                          % name)
    return errors


def main():
    from ..tuning import registry
    return run_main('check_tunables', check(),
                    '%d tunables: bounded domains, documented overrides'
                    % len(registry.registered_tunables()))


if __name__ == '__main__':
    raise SystemExit(main())
