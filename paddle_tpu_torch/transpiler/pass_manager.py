"""PassManager: one statically checked rewrite pipeline over program IR.

Reference parity: paddle_tpu/transpiler/pass_manager.py.  Every pass is
**registered** (``@register_pass``) with a declared ``order``, a
``report_key`` and a kind (``rewrite`` | ``analysis``);
``run_pipeline`` builds the plan for the current configuration
(graph-opt level, AMP mode), runs the passes in order on one copy of the
program, and runs the static verifier (transpiler/verify.py) after every
rewrite pass (``every_pass``) or once at the end (``boundary``, the
default).  ``plan_key`` is the one plan-cache key component derived from
that configuration; the executor keys its plans on it.

The port registers the graph-opt passes, AMP, the donation analysis
and the cost and memory models (analysis passes at orders 95 and 96,
after every rewrite, on the feed shapes the executor plans with; their
report is ``report['cost']``, the memory model's under
``report['cost']['memory']``).  The reference's ``sharding``,
``embed_shard`` and ``overlap_collectives`` come with the multi-chip
slice (ROADMAP.md Queue 1 item 10).

Recorded departure: no fallback.  The reference skips a pass that
raises and reports it (its ``status`` entry); here the error propagates,
since a skipped ``amp`` pass would train in float32 while the run says
bf16.

The per-pass report list lands in
``Executor.last_graph_opt_report['passes']`` as
``{'name', 'ops_before', 'ops_after', 'wall_s', 'verify'}``.
"""
import collections
import copy
import time

from . import passes
from . import verify as verify_mod

__all__ = ['register_pass', 'registered_passes', 'build_plan',
           'run_pipeline', 'plan_key', 'resolve_level', 'PassDef',
           'PassContext', 'IRVerificationError']

IRVerificationError = verify_mod.IRVerificationError

PassDef = collections.namedtuple(
    'PassDef', ['name', 'order', 'report_key', 'kind', 'enabled', 'fn'])

# name -> PassDef; the plan executes in ascending order
PASSES = {}

# test hook: {pass name -> fn(program)} applied to a pass's output before
# verification, so a test can corrupt exactly one pass and see
# every_pass mode pin the failure on it.  Never set in production.
_TEST_CORRUPTORS = {}


def register_pass(name, order, report_key, kind='rewrite', enabled=None):
    """Register a pass.  ``fn(program, ctx) -> extra-report-dict`` must
    rewrite ``program`` in place (rewrite kind) or only read it
    (analysis kind); ``enabled(cfg)`` gates it per configuration."""
    if kind not in ('rewrite', 'analysis'):
        raise ValueError("pass kind must be rewrite|analysis")
    if any(p.order == order for p in PASSES.values()):
        raise ValueError("pass order %d already taken" % order)

    def deco(fn):
        if name in PASSES:
            raise ValueError("pass %r already registered" % name)
        PASSES[name] = PassDef(name, order, report_key, kind,
                               enabled or (lambda cfg: True), fn)
        return fn

    return deco


def registered_passes():
    return sorted(PASSES.values(), key=lambda p: p.order)


PassConfig = collections.namedtuple('PassConfig', ['level', 'amp_mode'])


class PassContext(object):
    """Shared state the passes read: fetch/feed sets, caller-pinned
    names, and the protected/no-fold sets (computed once per pipeline)."""

    def __init__(self, fetch_names, feed_names, pinned, amp_mode,
                 feed_specs=None):
        self.fetch_names = tuple(fetch_names)
        self.feed_names = tuple(feed_names)
        # {name: (shape, dtype)} of the fed values, for the analyses
        self.feed_specs = feed_specs
        self.pinned = set(pinned)
        self.amp_mode = amp_mode
        self.amp_report = None  # set by the amp pass
        self._protected = None
        self._no_fold = None

    def compute_protected(self, program):
        persist = passes._persistable_names(program)
        ctrl = passes._control_referenced_names(program)
        self._protected = (set(self.fetch_names) | set(self.feed_names)
                           | persist | ctrl | self.pinned)
        self._no_fold = persist | ctrl | self.pinned

    def protected(self, program):
        if self._protected is None:
            self.compute_protected(program)
        return self._protected

    def no_fold(self, program):
        if self._no_fold is None:
            self.compute_protected(program)
        return self._no_fold


def _dce_report(program, ctx):
    before = {op.attrs.get('op_seq'): op.type
              for op in program.global_block().ops}
    n = passes.dce_pass(program, ctx.fetch_names, extra_live=ctx.pinned)
    after = {op.attrs.get('op_seq') for op in program.global_block().ops}
    # the user's op positions the run leaves out (Executor.skipped_ops)
    return {'eliminated': n,
            'removed': sorted((s, t) for s, t in before.items()
                              if s is not None and s not in after)}


@register_pass('dce', 10, 'dce', enabled=lambda cfg: cfg.level >= 1)
def _dce(program, ctx):
    return _dce_report(program, ctx)


@register_pass('constant_fold', 20, 'fold',
               enabled=lambda cfg: cfg.level >= 2)
def _constant_fold(program, ctx):
    n = passes.constant_fold_pass(
        program, ctx.fetch_names, ctx.feed_names,
        protected=ctx.protected(program), no_fold=ctx.no_fold(program))
    return {'eliminated': n}


@register_pass('cse', 30, 'cse', enabled=lambda cfg: cfg.level >= 2)
def _cse(program, ctx):
    n = passes.cse_pass(program, ctx.fetch_names, ctx.feed_names,
                        protected=ctx.protected(program))
    return {'eliminated': n}


@register_pass('dce_sweep', 40, 'dce',
               enabled=lambda cfg: cfg.level >= 2)
def _dce_sweep(program, ctx):
    # folding and dedup can orphan their upstream producers
    return _dce_report(program, ctx)


@register_pass('amp', 60, 'amp',
               enabled=lambda cfg: cfg.amp_mode is not None)
def _amp(program, ctx):
    from . import amp as amp_mod
    rewritten, report = amp_mod.apply_amp(program, mode=ctx.amp_mode)
    ctx.amp_report = report
    # apply_amp weaves its own copy; splice the result back into the
    # in-place contract the manager runs passes under
    program.blocks = rewritten.blocks
    for b in program.blocks:
        b.program = program
    return {'amp': report}


@register_pass('donation', 90, 'donation', kind='analysis',
               enabled=lambda cfg: cfg.level >= 1)
def _donation(program, ctx):
    return {'donation': passes.analyze_donation(
        program, ctx.fetch_names, ctx.feed_names)}


@register_pass('cost_model', 95, 'cost', kind='analysis',
               enabled=lambda cfg: cfg.level >= 1)
def _cost_model(program, ctx):
    # after graph-opt and AMP: eliminated ops cost nothing and lowered
    # values count their 16-bit bytes
    from . import cost_model
    return {'cost': cost_model.analyze_cost(
        program, fetch_names=ctx.fetch_names, feed_specs=ctx.feed_specs)}


@register_pass('memory_model', 96, 'memory', kind='analysis',
               enabled=lambda cfg: cfg.level >= 1)
def _memory_model(program, ctx):
    # the cost model's program and feed shapes (its inference memo warm)
    from . import memory_model
    return {'memory': memory_model.analyze_memory(
        program, fetch_names=ctx.fetch_names, feed_specs=ctx.feed_specs)}


def resolve_level(program=None, level=None):
    """Effective graph-opt level: the flag (re-read per build), floored
    at 1 when memory_optimize()/release_memory() armed the pipeline for
    this program."""
    lv = passes._resolve_level(level)
    if program is not None and \
            getattr(program, '_graph_opt_requested', False):
        lv = max(lv, 1)
    return lv


def build_plan(level, amp_mode):
    cfg = PassConfig(level, amp_mode)
    return [p for p in registered_passes() if p.enabled(cfg)]


def plan_key(program=None):
    """The plan-cache key component derived from the pass configuration:
    graph-opt level, AMP mode (with the loss-scale knobs) and verify
    mode, everything that changes what a plan build produces."""
    from .amp import plan_key_component
    return ('pm', resolve_level(program), plan_key_component(),
            verify_mod.resolve_mode(None))


def _amp_low(amp_mode):
    from .amp import LOW_DTYPE
    return LOW_DTYPE.get(amp_mode)


_FROM_FLAG = object()


def run_pipeline(program, fetch_names=(), feed_names=(), level=None,
                 amp_mode=_FROM_FLAG, verify=_FROM_FLAG,
                 extra_protected=(), feed_specs=None):
    """Run the registered pass plan over a copy of ``program``.

    Returns ``(program_out, report)``; the input program is never
    mutated, and with an empty plan (level 0, AMP off) the original comes
    back untouched.  ``amp_mode`` and ``verify`` default to their flags
    (PADDLE_TPU_TORCH_AMP / PADDLE_TPU_TORCH_VERIFY_IR); pass '0' / 'off'
    to pin them.  ``feed_specs`` ({name: (shape, dtype)}) binds the batch
    dimension for the cost and memory models.  Raises IRVerificationError
    when the verifier rejects a pass output (every_pass) or the final
    program (boundary), and whatever a pass raises.
    """
    from .amp import resolve_mode as amp_resolve
    level = resolve_level(program, level)
    amp_mode = amp_resolve(None if amp_mode is _FROM_FLAG else amp_mode)
    verify_mode = verify_mod.resolve_mode(
        None if verify is _FROM_FLAG else verify)
    fetch_names = tuple(fetch_names)
    feed_names = tuple(feed_names)
    plan = build_plan(level, amp_mode)

    report = {
        'level': level,
        'ops_before': None,
        'ops_after': None,
        'eliminated': {},
        'removed': [],
        'pass_wall_s': 0.0,
        'passes': [],
        'verify': {'mode': verify_mode, 'checks': 0, 'wall_s': 0.0},
    }
    if not any(p.kind == 'rewrite' for p in plan):
        if verify_mode != 'off':
            tv = time.perf_counter()
            verify_mod.check_program(program, fetch_names, feed_names,
                                     require_op_seq=False)
            report['verify']['checks'] = 1
            report['verify']['wall_s'] = time.perf_counter() - tv
        return program, report

    t0 = time.perf_counter()
    pinned = set(extra_protected) | set(
        getattr(program, '_graph_opt_skip_set', None) or ())
    ctx = PassContext(fetch_names, feed_names, pinned, amp_mode,
                      feed_specs=feed_specs)

    p = copy.deepcopy(program)
    passes._stamp_op_seq(p.global_block())
    snapshot0 = verify_mod.pin_snapshot(p, fetch_names, feed_names)
    graph_opt_ran = level >= 1
    if graph_opt_ran:
        report['ops_before'] = len(p.global_block().ops)
    amp_applied = None

    for pd in plan:
        n_before = len(p.global_block().ops)
        entry = {'name': pd.name, 'ops_before': n_before,
                 'ops_after': n_before, 'wall_s': 0.0,
                 'verify': 'skipped'}
        report['passes'].append(entry)
        tp = time.perf_counter()
        snap = (verify_mod.pin_snapshot(p, fetch_names, feed_names)
                if pd.kind == 'rewrite' else None)
        frag = pd.fn(p, ctx) or {}
        corrupt = _TEST_CORRUPTORS.get(pd.name)
        if corrupt is not None:
            corrupt(p)
        entry['wall_s'] = time.perf_counter() - tp
        if pd.kind == 'rewrite':
            entry['ops_after'] = len(p.global_block().ops)
            if pd.name == 'amp' and ctx.amp_report is not None:
                amp_applied = _amp_low(amp_mode)
            if verify_mode == 'every_pass':
                tv = time.perf_counter()
                try:
                    verify_mod.check_program(
                        p, fetch_names, feed_names, require_op_seq=True,
                        amp_low=amp_applied, snapshot=snap,
                        pass_name=pd.name)
                except verify_mod.IRVerificationError:
                    entry['verify'] = 'failed'
                    raise
                else:
                    entry['verify'] = 'ok'
                finally:
                    report['verify']['checks'] += 1
                    report['verify']['wall_s'] += \
                        time.perf_counter() - tv
        n = frag.get('eliminated')
        if n is not None:
            report['eliminated'][pd.report_key] = \
                report['eliminated'].get(pd.report_key, 0) + n
        report['removed'].extend(frag.get('removed', ()))
        for key in ('donation', 'amp', 'cost'):
            if frag.get(key) is not None:
                report[key] = frag[key]
        if frag.get('memory') is not None:
            # one 'cost' entry carries the whole static analysis
            report.setdefault('cost', {})['memory'] = frag['memory']

    if graph_opt_ran:
        report['ops_after'] = len(p.global_block().ops)
    if verify_mode == 'boundary':
        tv = time.perf_counter()
        verify_mod.check_program(p, fetch_names, feed_names,
                                 require_op_seq=True,
                                 amp_low=amp_applied,
                                 snapshot=snapshot0)
        report['verify']['checks'] = 1
        report['verify']['wall_s'] = time.perf_counter() - tv
    report['pass_wall_s'] = time.perf_counter() - t0
    return p, report
