"""The port's static checks (ports of the repository's tools/check_*.py,
run over paddle_tpu_torch/).

Each ``check_*`` module exposes ``check()``, which returns a list of
error strings (empty: clean), and runs alone with ``python -m
paddle_tpu_torch.tools.check_<name>`` (exit 1 on any error).
``python -m paddle_tpu_torch.tools.lint_all`` runs them all.  They live
in the package, not under tools/, so the reference's own lint never
picks them up.
"""
import os

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PACKAGE)
README = os.path.join(REPO, 'README.md')
PORT_SECTION = '## PyTorch/CUDA port'


def read_readme(path=None):
    with open(path or README) as f:
        return f.read()


def port_section(readme):
    """The README's port section: from its heading to the next ``## ``
    heading (empty when the heading is missing)."""
    start = readme.find('\n' + PORT_SECTION)
    if start < 0:
        return ''
    end = readme.find('\n## ', start + 1)
    return readme[start:] if end < 0 else readme[start:end]


def run_main(name, errors, ok_line):
    """A checker's command line: each error to stderr, exit 1 on any."""
    import sys
    for e in errors:
        print('%s: %s' % (name, e), file=sys.stderr)
    if errors:
        return 1
    print('%s: OK (%s)' % (name, ok_line))
    return 0
