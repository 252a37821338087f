"""The port's checks (paddle_tpu_torch/tools/): each is green on the
tree, each catches one planted fault, and ``lint_all`` runs all six.

The planted faults: a flag the README's port section does not name, a
counter without ``_total``, a one-value tunable domain, an unwaived race
(the reference lint's unguarded-write fixture), a rewrite pass missing
from ``PASS_MUTATIONS``, and an AMP list entry naming no op.
"""
import sys
import textwrap
import types

import pytest

from paddle_tpu_torch.tools import (check_amp_lists, check_concurrency,
                                    check_flags_doc, check_metric_names,
                                    check_pass_registry, check_tunables,
                                    lint_all)

CHECKERS = ('check_amp_lists', 'check_concurrency', 'check_flags_doc',
            'check_metric_names', 'check_pass_registry', 'check_tunables')


@pytest.fixture(scope='module')
def results():
    return lint_all.run_all()


def test_lint_all_discovers_the_six():
    assert tuple(lint_all.discover()) == CHECKERS


@pytest.mark.parametrize('name', CHECKERS)
def test_checker_is_green_on_the_tree(results, name):
    errors, _wall = results[name]
    assert errors == []


def test_lint_all_main_exits_0(capsys):
    assert lint_all.main() == 0
    assert 'lint_all: OK (6 checkers)' in capsys.readouterr().out


def test_lint_all_fails_a_checker_without_check(monkeypatch, capsys):
    name = 'check_planted'
    monkeypatch.setitem(sys.modules, 'paddle_tpu_torch.tools.' + name,
                        types.ModuleType(name))
    monkeypatch.setattr(lint_all, 'discover', lambda: [name])
    res = lint_all.run_all()
    assert len(res[name][0]) == 1 and 'defines no check()' in res[name][0][0]
    assert lint_all.main() == 1
    assert 'lint_all: 1/1 checkers FAILED' in capsys.readouterr().err


def test_undocumented_flag_is_caught():
    mod = check_flags_doc.pristine_flags()
    mod.FLAGS._define('planted_knob', 1, int, 'a knob nobody documented')
    errors = check_flags_doc.check(flags=mod.FLAGS)
    assert errors == ["PADDLE_TPU_TORCH_PLANTED_KNOB is not documented in "
                      "README.md's port section"]


def test_counter_without_total_is_caught(tmp_path):
    pkg = tmp_path / 'pkg'
    pkg.mkdir()
    (pkg / 'm.py').write_text(textwrap.dedent('''
        def f(r):
            r.counter('paddle_tpu_executor_runs_total', 'fine')
            r.counter('paddle_tpu_planted_runs', 'no suffix')
    '''))
    errors = check_metric_names.check(root=str(pkg))
    assert len(errors) == 2
    assert "counter 'paddle_tpu_planted_runs' must end in '_total'" in \
        errors[0]
    assert 'not documented in README.md' in errors[1]


def test_one_value_domain_is_caught():
    from paddle_tpu_torch.tuning import registry
    planted = registry.Tunable('planted', (1,), 1, 'test',
                               env='PADDLE_TPU_TORCH_AMP', help='a constant')
    errors = check_tunables.check(
        tunables=registry.registered_tunables() + (planted,))
    assert errors == ["tunable 'planted': domain (1,) has fewer than 2 "
                      "candidates: a one-value domain is a constant, not a "
                      "tunable"]


def test_unwaived_race_is_caught(tmp_path):
    pkg = tmp_path / 'pkg'
    pkg.mkdir()
    (pkg / 'worker.py').write_text(textwrap.dedent('''
        import threading

        class Worker(object):
            def __init__(self):
                self._lock = threading.Lock()
                self._count = 0
                self._t = threading.Thread(target=self._run, daemon=True)

            def _run(self):
                while True:
                    self._count += 1

            def bump(self):
                with self._lock:
                    self._count += 1
    '''))
    errors = check_concurrency.check(root=str(pkg))
    assert len(errors) == 1
    assert '[unguarded-write] Worker._count' in errors[0]


def test_pass_missing_from_the_mutation_matrix_is_caught():
    keys = check_pass_registry.mutation_matrix_keys()
    assert 'cse' in keys
    errors = check_pass_registry.check(matrix=[k for k in keys
                                               if k != 'cse'])
    assert len(errors) == 1
    assert "rewrite pass 'cse' is missing from PASS_MUTATIONS" in errors[0]


def test_amp_entry_naming_no_op_is_caught(monkeypatch):
    from paddle_tpu_torch.core import registry
    monkeypatch.setattr(registry, 'AMP_WHITE',
                        registry.AMP_WHITE | {'planted_op'})
    assert check_amp_lists.check() == [
        "AMP_WHITE entry 'planted_op' is not a registered op"]
