"""The port's observability metric names follow the convention.

Port of tools/check_metric_names.py over paddle_tpu_torch/: every
literal-named registration ``<registry>.counter('name', ...)`` /
``.gauge(...)`` / ``.histogram(...)`` must

- start with ``paddle_tpu_`` (the reference's namespace: the port's
  series carry the reference's names);
- end in ``_total`` when it is a counter;
- carry a unit suffix (``_seconds``, ``_bytes``) when it is a
  histogram, unless ``WAIVERS`` names it with its reason;
- appear in README.md's metrics inventory.

``python -m paddle_tpu_torch.tools.check_metric_names`` (exit 1 on an
error).
"""
import ast
import os

from . import PACKAGE, read_readme, run_main

PREFIX = 'paddle_tpu_'
KINDS = {'counter', 'gauge', 'histogram'}
HISTOGRAM_UNITS = ('_seconds', '_bytes')

# names exempt from one rule, each with its reason
WAIVERS = {
    # rows per batch: dimensionless by design, and stats() reads it back
    # by this name, as the reference's does
    'paddle_tpu_serving_batch_occupancy': 'histogram unit suffix',
}

# the registry layer passes names through variables: no sites there
_SKIP = ('observability/metrics.py',)


def registrations(root=None):
    """[(name, kind, relpath, lineno)] of every literal-named
    registration under ``root`` (default: the package)."""
    root = root or PACKAGE
    found = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != '__pycache__']
        for fn in sorted(filenames):
            if not fn.endswith('.py'):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, os.path.dirname(root))
            if rel.replace(os.sep, '/').endswith(_SKIP):
                continue
            with open(path) as f:
                try:
                    tree = ast.parse(f.read())
                except SyntaxError as e:
                    found.append((None, 'parse-error', rel, e.lineno))
                    continue
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in KINDS and node.args):
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str):
                    found.append((arg.value, node.func.attr, rel,
                                  node.lineno))
    return found


def check(root=None, readme=None):
    """Error strings (empty: clean)."""
    regs = registrations(root)
    if not any(name for name, _k, _f, _l in regs):
        return ['no metric registrations found: AST walk bug?']
    try:
        readme = readme if readme is not None else read_readme()
    except OSError as e:
        return ['cannot read README.md: %s' % e]
    errors = []
    seen = set()
    for name, kind, rel, lineno in regs:
        where = '%s:%s' % (rel, lineno)
        if kind == 'parse-error':
            errors.append('%s: file does not parse' % where)
            continue
        if not name.startswith(PREFIX):
            errors.append('%s: metric %r must start with %r'
                          % (where, name, PREFIX))
        if kind == 'counter' and not name.endswith('_total'):
            errors.append("%s: counter %r must end in '_total'"
                          % (where, name))
        if kind == 'histogram' and not name.endswith(HISTOGRAM_UNITS) \
                and WAIVERS.get(name) != 'histogram unit suffix':
            errors.append('%s: histogram %r must carry a unit suffix %s'
                          % (where, name, list(HISTOGRAM_UNITS)))
        if name not in seen and name not in readme:
            errors.append('%s: metric %r is not documented in README.md'
                          % (where, name))
        seen.add(name)
    if root is None:
        for name in sorted(set(WAIVERS) - seen):
            errors.append('WAIVERS entry %r matches no registered metric'
                          % name)
    return errors


def main():
    names = {n for n, _k, _f, _l in registrations() if n}
    return run_main('check_metric_names', check(),
                    '%d metric names conform and are documented'
                    % len(names))


if __name__ == '__main__':
    raise SystemExit(main())
