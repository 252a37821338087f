"""The AMP white and black op lists (core/registry.py ``AMP_WHITE`` /
``AMP_BLACK``) name registered ops and classify them soundly.

Port of tools/check_amp_lists.py: every entry names a registered op, the
lists are disjoint, a white op can be lowered (no env access, not an
effectful barrier), the optimizer updates and the AMP machinery are
black (float32 master weights), and every op is classified once.
``WAITING`` names the list entries whose op comes with a later item.

``python -m paddle_tpu_torch.tools.check_amp_lists`` (exit 1 on an
error).
"""
from . import run_main

# these apply steps to the float32 master weights: lowering any of them
# would break the master-weight guarantee
OPTIMIZER_OPS = (
    'sgd', 'momentum', 'adam', 'adamax', 'adagrad', 'decayed_adagrad',
    'adadelta', 'rmsprop', 'ftrl', 'proximal_gd', 'proximal_adagrad',
)
AMP_MACHINERY_OPS = ('check_finite_and_unscale', 'update_loss_scale')

# list entries (the reference's lists) for ops the port registers with a
# later ROADMAP.md Queue 1 item
WAITING = {'vocab_parallel_ce': 'item 10'}


def check():
    """Error strings (empty: clean)."""
    import paddle_tpu_torch  # noqa: F401  (registers every op)
    from ..core import registry
    from ..transpiler import passes
    errors = []
    reg = set(registry.registered_ops())
    for list_name, lst in (('AMP_WHITE', registry.AMP_WHITE),
                           ('AMP_BLACK', registry.AMP_BLACK)):
        for t in sorted(set(lst) - reg - set(WAITING)):
            errors.append('%s entry %r is not a registered op' % (list_name,
                                                                  t))
    for t in sorted(set(WAITING) & reg):
        errors.append('%r is registered now: take it out of WAITING' % t)
    for t in sorted(registry.AMP_WHITE & registry.AMP_BLACK):
        errors.append('op %r is in both AMP_WHITE and AMP_BLACK' % t)
    for t in sorted(registry.AMP_WHITE & reg):
        if registry.op_traits(t).needs_env or t in passes.EFFECTFUL_OPS:
            errors.append('AMP_WHITE op %r is an env or effectful barrier: '
                          'the weaver can never lower it' % t)
    for t in OPTIMIZER_OPS:
        if t in reg and registry.amp_class(t) != 'black':
            errors.append('optimizer op %r must be AMP black, got %r'
                          % (t, registry.amp_class(t)))
    for t in AMP_MACHINERY_OPS:
        if t in reg and registry.amp_class(t) != 'black':
            errors.append('AMP machinery op %r must be AMP black, got %r'
                          % (t, registry.amp_class(t)))
    for t in sorted(reg):
        cls = registry.amp_class(t)
        n = (t in registry.AMP_WHITE) + (t in registry.AMP_BLACK)
        if n > 1 or (n == 1) != (cls in ('white', 'black')):
            errors.append('op %r classification is ambiguous' % t)
    return errors


def main():
    from ..core import registry
    return run_main('check_amp_lists', check(),
                    '%d white, %d black, %d registered'
                    % (len(registry.AMP_WHITE), len(registry.AMP_BLACK),
                       len(registry.registered_ops())))


if __name__ == '__main__':
    raise SystemExit(main())
