"""The concurrency sweep over paddle_tpu_torch/ (guarded-by and lock
order) has no unwaived finding.

Port of tools/check_concurrency.py over the port's own analyzer
(analysis/concurrency.py): a field written under a lock on one path and
touched without it on a thread-reachable path, a violated
``# lock: guarded_by(_x)``, a cycle in the lock-order graph, or a waiver
with an empty reason fails.  Benign findings are waived in the source
with ``# lock: unguarded-ok(<reason>)``.

``python -m paddle_tpu_torch.tools.check_concurrency [-v]`` (exit 1 on a
finding; ``-v`` prints the waivers, entrypoints and order edges).
"""
import sys

from . import PACKAGE, run_main


def report(root=None):
    from ..analysis import concurrency
    return concurrency.analyze_package(root or PACKAGE)


def check(root=None):
    """Error strings, one per unwaived finding under ``root`` (default:
    the package)."""
    return report(root).errors()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    rep = report()
    if '-v' in argv or '--verbose' in argv:
        print('thread entrypoints (%d):' % len(rep.entrypoints))
        for path, lineno, desc in rep.entrypoints:
            print('  %s:%d  %s' % (path, lineno, desc))
        print('lock-order edges (%d):' % len(rep.order_edges))
        for (a, b), sites in sorted(rep.order_edges.items()):
            print('  %s -> %s  (%s:%d)' % (a, b, sites[0][0], sites[0][1]))
        print('waived findings (%d):' % len(rep.waived))
        for f, reason in rep.waived:
            print('  %s:%d  %s.%s [%s]  -- %s'
                  % (f.path, f.lineno, f.cls, f.field, f.kind, reason))
    return run_main('check_concurrency', rep.errors(),
                    '%d lock-owning classes, %d thread entrypoints, %d '
                    'order edges, %d waived findings, 0 unwaived'
                    % (rep.classes, len(rep.entrypoints),
                       len(rep.order_edges), len(rep.waived)))


if __name__ == '__main__':
    raise SystemExit(main())
