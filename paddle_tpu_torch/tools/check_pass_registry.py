"""The pass manager's registry (transpiler/pass_manager.py ``PASSES``)
is consistent and every rewrite pass has a verifier mutation test.

Port of tools/check_pass_registry.py: each registered pass declares a
unique integer order, a non-empty report key and a valid kind; every
rewrite pass appears in ``PASS_MUTATIONS`` of tests/test_torch_verify.py
(a corruption the verifier must catch and attribute to it), and every
entry there names a registered pass; the stock plans (levels 0-2, AMP
off, bf16, f16) come out in strictly ascending order; and each pass with
a dedicated verifier hook has it defined in transpiler/verify.py and
called from ``verify_program``.  The reference's hooks for ``sharding``
and ``overlap_collectives`` come with those passes (ROADMAP.md Queue 1
item 10).

``python -m paddle_tpu_torch.tools.check_pass_registry`` (exit 1 on an
error).
"""
import ast
import os

from . import PACKAGE, REPO, run_main

MUTATIONS_FILE = os.path.join(REPO, 'tests', 'test_torch_verify.py')

# pass -> its verifier hook in transpiler/verify.py
REQUIRED_VERIFY_HOOKS = {
    'donation': '_check_donation_order',
}


def mutation_matrix_keys(path=None):
    """The pass names of the literal ``PASS_MUTATIONS`` dict in the
    mutation-test file, read statically; None when it is missing or a key
    is not a string literal."""
    with open(path or MUTATIONS_FILE) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == 'PASS_MUTATIONS':
                    keys = []
                    for k in node.value.keys:
                        if not (isinstance(k, ast.Constant)
                                and isinstance(k.value, str)):
                            return None
                        keys.append(k.value)
                    return keys
    return None


def _verify_program_calls():
    """(functions defined in transpiler/verify.py, the names
    ``verify_program`` calls)."""
    with open(os.path.join(PACKAGE, 'transpiler', 'verify.py')) as f:
        tree = ast.parse(f.read())
    defined = {n.name for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef)}
    called = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and \
                node.name == 'verify_program':
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Name):
                    called.add(sub.func.id)
    return defined, called


def check(matrix=None):
    """Error strings (empty: clean).  ``matrix`` (pass names) defaults to
    the ``PASS_MUTATIONS`` keys of tests/test_torch_verify.py."""
    from ..transpiler import pass_manager as pm
    if not pm.PASSES:
        return ['the pass registry is empty: import order bug?']
    errors = []
    orders = {}
    for name, pd in sorted(pm.PASSES.items()):
        if pd.name != name:
            errors.append('pass %r is registered under key %r'
                          % (pd.name, name))
        if not isinstance(pd.order, int):
            errors.append('pass %r declares a non-int order %r'
                          % (name, pd.order))
        elif pd.order in orders:
            errors.append('pass %r reuses order %d (taken by %r)'
                          % (name, pd.order, orders[pd.order]))
        else:
            orders[pd.order] = name
        if not (pd.report_key or '').strip():
            errors.append('pass %r declares an empty report key' % name)
        if pd.kind not in ('rewrite', 'analysis'):
            errors.append('pass %r has unknown kind %r' % (name, pd.kind))
        if not callable(pd.fn):
            errors.append('pass %r has a non-callable fn' % name)
        if not callable(pd.enabled):
            errors.append('pass %r has a non-callable enabled gate'
                          % name)
    for level in (0, 1, 2):
        for amp in ('0', 'bf16', 'f16'):
            seq = [p.order for p in pm.build_plan(level, amp)]
            if seq != sorted(seq) or len(set(seq)) != len(seq):
                errors.append('build_plan(level=%d, amp=%r) is not '
                              'strictly ordered' % (level, amp))
    if matrix is None:
        matrix = mutation_matrix_keys()
    if matrix is None:
        errors.append('tests/test_torch_verify.py must define a literal '
                      'PASS_MUTATIONS dict (the verifier mutation matrix)')
    else:
        rewrite = {n for n, p in pm.PASSES.items() if p.kind == 'rewrite'}
        for n in sorted(rewrite - set(matrix)):
            errors.append('rewrite pass %r is missing from PASS_MUTATIONS '
                          'in tests/test_torch_verify.py: add a corruption '
                          'the verifier must catch and attribute' % n)
        for n in sorted(set(matrix) - set(pm.PASSES)):
            errors.append('PASS_MUTATIONS entry %r names no registered '
                          'pass' % n)
    defined, called = _verify_program_calls()
    for pass_name, hook in sorted(REQUIRED_VERIFY_HOOKS.items()):
        if pass_name not in pm.PASSES:
            errors.append('verify hook table names unregistered pass %r'
                          % pass_name)
        if hook not in defined:
            errors.append('pass %r: verify hook %s() is not defined in '
                          'transpiler/verify.py' % (pass_name, hook))
        elif hook not in called:
            errors.append('pass %r: verify hook %s() is never called from '
                          'verify_program' % (pass_name, hook))
    return errors


def main():
    from ..transpiler import pass_manager as pm
    return run_main('check_pass_registry', check(),
                    '%d passes, %d rewrite' % (
                        len(pm.PASSES), sum(1 for p in pm.PASSES.values()
                                            if p.kind == 'rewrite')))


if __name__ == '__main__':
    raise SystemExit(main())
