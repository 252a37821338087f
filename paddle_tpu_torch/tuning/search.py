"""The autotuner: cost-model-pruned greedy search with measured
feedback (port of paddle_tpu/tuning/search.py; same search, same trace).

One search (``Autotuner.search``) starts from the current configuration
(registry defaults and user-pinned env overrides), then walks the
tunables in registration order in coordinate descent.  For each
candidate value of the current tunable it

1. **models** it (``model_fn(cfg) -> {'score', 'peak_bytes'}``): the
   static cost and memory models price the candidate without running it.
   A candidate whose modelled peak exceeds the memory budget
   (PADDLE_TPU_TORCH_PEAK_HBM_BYTES) or whose modelled score is worse
   than the incumbent's by more than ``prune_slack`` is pruned here;
2. **measures** the survivors (``measure_fn(cfg) -> score``, lower is
   better), at most PADDLE_TPU_TORCH_TUNE_MEASURE_BUDGET of them;
3. **adopts** the best measured candidate when it beats the incumbent's
   measured score.

``score`` is whatever the caller normalises to (seconds a step for a
fixed program, seconds an example when the batch is searched); model and
measurement must agree on units.

Determinism: tunables in registration order, domains in declared order,
ties keep the incumbent, so fixed measurements give one winner and one
trace.  Dry run (``measure_fn=None``): the model is the measurement, so
the CPU tests drive the whole search, cache and apply machinery.
"""
import sys

from . import registry
from . import cache as cache_mod

__all__ = ['Autotuner', 'SearchResult', 'autotune']


class SearchResult(object):
    """Outcome of one search (or cache hit).

    - ``winners``: {tunable: value} for every choice that differs from
      the registry default — what persists and what ``cached`` mode
      applies.
    - ``config``: the full chosen configuration over the searched set.
    - ``trace``: one dict per considered candidate (action in
      {'baseline', 'pruned', 'measured', 'adopted'}, with modeled /
      measured scores and the prune reason).
    - ``cached``: True when winners came from the persistent cache and
      no search ran.
    """

    def __init__(self, winners, config=None, trace=(), measurements=0,
                 cached=False, base_score=None, best_score=None):
        self.winners = dict(winners)
        self.config = dict(config or {})
        self.trace = list(trace)
        self.measurements = measurements
        self.cached = cached
        self.base_score = base_score
        self.best_score = best_score

    def format_trace(self):
        """The printable search trace (PADDLE_TPU_TORCH_TUNE_TRACE=1)."""
        if self.cached:
            return 'tune: cache hit — zero search (winners: %r)' % (
                self.winners,)
        lines = ['tune: %d candidates considered, %d measured'
                 % (len(self.trace), self.measurements)]
        for e in self.trace:
            row = '  %-22s = %-12r %-9s' % (
                e['tunable'], e['value'], e['action'])
            if e.get('modeled') is not None:
                row += ' modeled=%.4g' % e['modeled']
            if e.get('measured') is not None:
                row += ' measured=%.4g' % e['measured']
            if e.get('reason'):
                row += '  (%s)' % e['reason']
            lines.append(row)
        if self.base_score is not None and self.best_score is not None \
                and self.base_score > 0:
            lines.append('  winner: %r — score %.4g vs base %.4g '
                         '(%.1f%% better)'
                         % (self.winners, self.best_score,
                            self.base_score,
                            100.0 * (1 - self.best_score /
                                     self.base_score)))
        return '\n'.join(lines)


class Autotuner(object):
    def __init__(self, model_fn, measure_fn=None, tunables=None,
                 hbm_budget_bytes=None, prune_slack=0.15,
                 measure_budget=None):
        """``tunables``: Tunable objects or names; defaults to every
        registered flag-scope tunable.  Pinned tunables (user-set env)
        are skipped either way.  ``measure_fn=None`` is dry-run mode:
        the model scores stand in for measurements."""
        self.model_fn = model_fn
        self.measure_fn = measure_fn
        if tunables is None:
            tunables = [t for t in registry.registered_tunables()
                        if t.scope == 'flag']
        self.tunables = [registry.tunable(t) if isinstance(t, str)
                         else t for t in tunables]
        if hbm_budget_bytes is None:
            from ..flags import FLAGS
            hbm_budget_bytes = int(FLAGS.peak_hbm_bytes or 0)
        self.hbm_budget = hbm_budget_bytes or 0
        self.prune_slack = float(prune_slack)
        if measure_budget is None:
            from ..flags import FLAGS
            measure_budget = int(FLAGS.tune_measure_budget)
        self.measure_budget = measure_budget

    def _model(self, cfg):
        m = self.model_fn(cfg) if self.model_fn is not None else None
        if m is None:
            return None
        return {'score': m.get('score'),
                'peak_bytes': m.get('peak_bytes')}

    def _measure(self, cfg, model):
        if self.measure_fn is None:  # dry run: the model measures
            return None if model is None else model['score']
        return self.measure_fn(cfg)

    def search(self, base=None):
        """Greedy coordinate descent; returns a :class:`SearchResult`."""
        trace = []
        cfg = dict(base) if base is not None else \
            registry.current_config(self.tunables)
        active = [t for t in self.tunables if not registry.is_pinned(t)]
        best_model = self._model(cfg)
        best_score = self._measure(cfg, best_model)
        measurements = 0 if self.measure_fn is None else 1
        base_score = best_score
        trace.append({'tunable': '(base)', 'value': dict(cfg),
                      'action': 'baseline',
                      'modeled': best_model and best_model['score'],
                      'measured': best_score, 'reason': None})
        for t in active:
            round_best = None  # (score, value, model)
            for v in t.domain:
                if v == cfg[t.name]:
                    continue
                entry = {'tunable': t.name, 'value': v,
                         'modeled': None, 'measured': None,
                         'reason': None}
                trace.append(entry)
                if t.feasible is not None and not t.feasible(v):
                    entry['action'] = 'pruned'
                    entry['reason'] = 'infeasible on this backend'
                    continue
                cand = dict(cfg)
                cand[t.name] = v
                model = self._model(cand)
                if model is not None:
                    entry['modeled'] = model['score']
                    peak = model.get('peak_bytes')
                    if self.hbm_budget and peak and \
                            peak > self.hbm_budget:
                        entry['action'] = 'pruned'
                        entry['reason'] = ('modeled peak %d B blows the '
                                           'HBM budget %d B'
                                           % (peak, self.hbm_budget))
                        continue
                    inc = best_model and best_model['score']
                    if inc and model['score'] > inc * \
                            (1.0 + self.prune_slack):
                        entry['action'] = 'pruned'
                        entry['reason'] = ('modeled %.3gx worse than '
                                           'incumbent'
                                           % (model['score'] / inc))
                        continue
                elif self.measure_fn is None:
                    entry['action'] = 'pruned'
                    entry['reason'] = 'unmodelable (dry run measures ' \
                                      'nothing)'
                    continue
                if self.measure_fn is not None and \
                        measurements >= self.measure_budget:
                    entry['action'] = 'pruned'
                    entry['reason'] = (
                        'measure budget exhausted '
                        '(PADDLE_TPU_TORCH_TUNE_MEASURE_BUDGET)')
                    continue
                score = self._measure(cand, model)
                if self.measure_fn is not None:
                    measurements += 1
                entry['action'] = 'measured'
                entry['measured'] = score
                if score is None:
                    entry['reason'] = 'measurement failed'
                    continue
                if round_best is None or score < round_best[0]:
                    round_best = (score, v, model)
            if round_best is not None and best_score is not None and \
                    round_best[0] < best_score:
                best_score = round_best[0]
                cfg[t.name] = round_best[1]
                best_model = round_best[2] or best_model
                trace.append({'tunable': t.name,
                              'value': round_best[1],
                              'action': 'adopted',
                              'modeled': round_best[2] and
                              round_best[2]['score'],
                              'measured': round_best[0],
                              'reason': 'beats incumbent'})
        winners = {t.name: cfg[t.name] for t in active
                   if cfg[t.name] != t.default}
        return SearchResult(winners, config=cfg, trace=trace,
                            measurements=measurements,
                            base_score=base_score,
                            best_score=best_score)


def autotune(model_fn, measure_fn=None, tunables=None, cache=None,
             cache_key=None, mode='search', hbm_budget_bytes=None,
             prune_slack=0.15, measure_budget=None, base=None):
    """Cache-through tuning entry point.

    - cached winners for ``cache_key`` short-circuit everything
      (``result.cached`` True, zero search — the restart contract);
    - otherwise ``mode='search'`` runs the search and persists the
      winners; ``mode='cached'`` returns the defaults untouched
      (``winners`` empty) rather than searching;
    - ``mode='off'`` returns None.

    With PADDLE_TPU_TORCH_TUNE_TRACE on, a search prints its trace to
    stderr.
    """
    if mode == 'off':
        return None
    if cache is None:
        cache = cache_mod.TuneCache()
    if cache_key is not None and cache.enabled():
        winners = cache.load(cache_key)
        if winners is not None:
            return SearchResult(winners, config=winners, cached=True)
    if mode == 'cached':
        return SearchResult({}, cached=False)
    tuner = Autotuner(model_fn, measure_fn, tunables=tunables,
                      hbm_budget_bytes=hbm_budget_bytes,
                      prune_slack=prune_slack,
                      measure_budget=measure_budget)
    result = tuner.search(base=base)
    from ..flags import FLAGS
    if FLAGS.tune_trace:
        # the reference's bench harness prints it; the port has no such
        # harness, so the search does
        print(result.format_trace(), file=sys.stderr)
    if cache_key is not None and cache.enabled():
        cache.store(cache_key, result.winners,
                    meta={'base_score': result.base_score,
                          'best_score': result.best_score,
                          'measurements': result.measurements})
    return result
