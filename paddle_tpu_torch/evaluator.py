"""Evaluators: metrics accumulated across minibatches.

Reference parity: paddle_tpu/evaluator.py (python/paddle/v2/fluid/
evaluator.py: ``Accuracy``, ``ChunkEvaluator``).  The states are
persistable variables that the main program updates in its own ops, on
the executor's device; ``reset`` zeroes them through the executor, and
``eval`` reads them from the global scope (``scope_guard`` picks
another).  ``StreamingAUC`` is the reference's host-side histogram AUC.
"""
import numpy as np

from . import layers
from .core.program import Program, program_guard, unique_name
from .core.scope import global_scope
from .initializer import ConstantInitializer
from .layers.layer_helper import LayerHelper

__all__ = ['Accuracy', 'ChunkEvaluator', 'Evaluator', 'StreamingAUC']


def _clone_var_(block, var):
    return block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                            persistable=True)


class Evaluator(object):
    def __init__(self, name, **kwargs):
        self.states = []
        self.metrics = []
        self.helper = LayerHelper(name, **kwargs)

    def reset(self, executor, reset_program=None):
        """Zero every state, running ``reset_program`` (a new Program by
        default) on ``executor``."""
        if reset_program is None:
            reset_program = Program()
        with program_guard(reset_program):
            for var in self.states:
                g_var = _clone_var_(reset_program.current_block(), var)
                layers.fill_constant(shape=g_var.shape, value=0.0,
                                     dtype=g_var.dtype, out=g_var)
        executor.run(reset_program)

    def eval(self, executor, eval_program=None):
        raise NotImplementedError

    def create_state(self, suffix, dtype, shape):
        state = self.helper.create_global_variable(
            name=unique_name(self.helper.name + "_" + suffix),
            persistable=True, dtype=dtype, shape=shape)
        self.helper.set_variable_initializer(state, ConstantInitializer(0.0))
        self.states.append(state)
        return state


def _state(var):
    return float(global_scope().get_numpy(var.name)[0])


class StreamingAUC(object):
    """Mergeable streaming AUC over a fixed-bin rank histogram.

    Scores land in ``bins`` equal-width bins over ``[lo, hi]``; the
    evaluator keeps one positive and one negative count a bin, so the
    state is two int64 vectors whatever the number of samples, and
    partial states ``merge`` exactly (counts add).  ``eval`` is the
    Mann-Whitney statistic over the histogram,

        AUC = sum_b pos_b * (neg_below_b + neg_b / 2) / (P * N),

    the exact pairwise AUC of the scores quantised to their bins (a
    same-bin pair counts 1/2).  Update and merge order do not matter.
    """

    __slots__ = ('bins', 'lo', 'hi', '_pos', '_neg')

    def __init__(self, bins=2048, lo=0.0, hi=1.0):
        if bins < 2:
            raise ValueError("StreamingAUC needs >= 2 bins, got %d" % bins)
        if not hi > lo:
            raise ValueError("StreamingAUC needs hi > lo, got [%r, %r]"
                             % (lo, hi))
        self.bins = int(bins)
        self.lo = float(lo)
        self.hi = float(hi)
        self._pos = np.zeros(self.bins, dtype=np.int64)
        self._neg = np.zeros(self.bins, dtype=np.int64)

    def update(self, scores, labels):
        """Add a batch: ``scores`` float-like, ``labels`` 0/1 (nonzero is
        positive); scores out of range go to the edge bins.  Returns
        self."""
        s = np.asarray(scores, dtype=np.float64).reshape(-1)
        y = np.asarray(labels).reshape(-1)
        if s.shape != y.shape:
            raise ValueError("scores and labels disagree: %d vs %d samples"
                             % (s.size, y.size))
        if s.size == 0:
            return self
        idx = (s - self.lo) * (self.bins / (self.hi - self.lo))
        idx = np.clip(idx.astype(np.int64), 0, self.bins - 1)
        pos = y != 0
        self._pos += np.bincount(idx[pos], minlength=self.bins)
        self._neg += np.bincount(idx[~pos], minlength=self.bins)
        return self

    def merge(self, other):
        """Add another StreamingAUC's counts (same bins) to this one."""
        if (other.bins, other.lo, other.hi) != (self.bins, self.lo,
                                                self.hi):
            raise ValueError(
                "cannot merge StreamingAUC(bins=%d, [%r, %r]) into "
                "(bins=%d, [%r, %r])" % (other.bins, other.lo, other.hi,
                                         self.bins, self.lo, self.hi))
        self._pos += other._pos
        self._neg += other._neg
        return self

    def eval(self):
        """The AUC of everything added so far; 0.5 when a class is
        empty."""
        p = int(self._pos.sum())
        n = int(self._neg.sum())
        if p == 0 or n == 0:
            return 0.5
        neg_below = np.cumsum(self._neg) - self._neg
        num = float(np.sum(self._pos * (neg_below + self._neg * 0.5)))
        return num / (float(p) * float(n))

    @property
    def count(self):
        return int(self._pos.sum() + self._neg.sum())

    @property
    def positives(self):
        return int(self._pos.sum())

    @property
    def negatives(self):
        return int(self._neg.sum())

    def reset(self):
        self._pos[:] = 0
        self._neg[:] = 0
        return self


class Accuracy(Evaluator):
    """Streaming top-k accuracy."""

    def __init__(self, input, label, k=1, **kwargs):
        super(Accuracy, self).__init__("accuracy", **kwargs)
        total = self.create_state(dtype='float32', shape=[1],
                                  suffix='total')
        correct = self.create_state(dtype='float32', shape=[1],
                                    suffix='correct')
        batch_correct = self.helper.create_tmp_variable('int32',
                                                        stop_gradient=True)
        batch_total = self.helper.create_tmp_variable('int32',
                                                      stop_gradient=True)
        acc = layers.accuracy(input=input, label=label, k=k,
                              correct=batch_correct, total=batch_total)
        bc_f = layers.cast(batch_correct, 'float32')
        bt_f = layers.cast(batch_total, 'float32')
        layers.sums(input=[total, bt_f], out=total)
        layers.sums(input=[correct, bc_f], out=correct)
        self.metrics.append(acc)
        self._total = total
        self._correct = correct

    def eval(self, executor, eval_program=None):
        return np.array([_state(self._correct) / max(_state(self._total),
                                                     1.0)],
                        dtype=np.float32)


class ChunkEvaluator(Evaluator):
    """Streaming chunk precision, recall and F1 from the ``chunk_eval``
    op's counts."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None, **kwargs):
        super(ChunkEvaluator, self).__init__("chunk_eval", **kwargs)
        num_infer_chunks = self.create_state(
            dtype='float32', shape=[1], suffix='num_infer_chunks')
        num_label_chunks = self.create_state(
            dtype='float32', shape=[1], suffix='num_label_chunks')
        num_correct_chunks = self.create_state(
            dtype='float32', shape=[1], suffix='num_correct_chunks')
        precision, recall, f1, infer_cnt, label_cnt, correct_cnt = \
            layers.chunk_eval(
                input=input, label=label, chunk_scheme=chunk_scheme,
                num_chunk_types=num_chunk_types,
                excluded_chunk_types=excluded_chunk_types)
        for state, cnt in ((num_infer_chunks, infer_cnt),
                           (num_label_chunks, label_cnt),
                           (num_correct_chunks, correct_cnt)):
            layers.sums(input=[state, layers.cast(cnt, 'float32')],
                        out=state)
        self.metrics.extend([precision, recall, f1])
        self._states = (num_infer_chunks, num_label_chunks,
                        num_correct_chunks)

    def eval(self, executor, eval_program=None):
        """[precision, recall, F1] float32 of the accumulated counts."""
        infer, label, correct = (_state(v) for v in self._states)
        precision = correct / infer if infer else 0.0
        recall = correct / label if label else 0.0
        f1 = 2 * precision * recall / (precision + recall) \
            if precision + recall else 0.0
        return np.array([precision, recall, f1], dtype=np.float32)
