"""Run every check of paddle_tpu_torch/tools/ with one summary table.

Port of tools/lint_all.py: discovers every ``check_*.py`` module beside
this one, runs its ``check()`` (a list of error strings, empty: clean)
and prints a table.  Exit 1 when any check fails, raises, or a
``check_*.py`` module defines no ``check()``, so a half-wired checker
cannot be skipped silently.

``python -m paddle_tpu_torch.tools.lint_all`` (on the CPU; about 15 s).
"""
import importlib
import os
import sys
import time

_TOOLS = os.path.dirname(os.path.abspath(__file__))


def discover():
    """Sorted module names of every check_*.py here."""
    return sorted(fn[:-3] for fn in os.listdir(_TOOLS)
                  if fn.startswith('check_') and fn.endswith('.py'))


def run_all():
    """{checker: (errors, wall_s)} over every discovered checker; a
    checker without ``check()``, or whose ``check()`` raises, reports
    that as its one error."""
    out = {}
    for name in discover():
        t0 = time.perf_counter()
        try:
            mod = importlib.import_module(__package__ + '.' + name)
            fn = getattr(mod, 'check', None)
            if fn is None:
                errors = ['%s.py defines no check(): every check_*.py '
                          'returns a list of error strings from check()'
                          % name]
            else:
                errors = list(fn())
        except Exception as e:  # a crashing checker is a failing one
            errors = ['%s raised: %r' % (name, e)]
        out[name] = (errors, time.perf_counter() - t0)
    return out


def main():
    results = run_all()
    width = max([len(n) for n in results] + [7])
    print('%-*s  %-6s  %8s  %s' % (width, 'checker', 'status', 'wall',
                                   'errors'))
    failed = 0
    for name in sorted(results):
        errors, wall = results[name]
        failed += bool(errors)
        print('%-*s  %-6s  %7.2fs  %d' % (width, name,
                                          'FAIL' if errors else 'OK', wall,
                                          len(errors)))
    for name in sorted(results):
        for e in results[name][0]:
            print('%s: %s' % (name, e), file=sys.stderr)
    if failed:
        print('lint_all: %d/%d checkers FAILED' % (failed, len(results)),
              file=sys.stderr)
        return 1
    print('lint_all: OK (%d checkers)' % len(results))
    return 0


if __name__ == '__main__':
    sys.exit(main())
