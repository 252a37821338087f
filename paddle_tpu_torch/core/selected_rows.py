"""SelectedRows: row-sparse gradients.

Reference parity: paddle_tpu/core/selected_rows.py (paddle/framework/
selected_rows.{h,cc}): a (rows, values) pair standing in for a mostly-zero
dense [height, ...] tensor.  The ``is_sparse`` lookups' backward emits one
(ops/embedding.py ``sparse_grad_assemble``) and the sparse branches of the
sgd, adagrad and adam ops apply it row by row (ops/optim_ops.py), so the
vocab-height dense gradient never exists.

Index rules, the reference's: ids in [-height, 0) wrap by +height
(``normalize_rows``, table_update.py ``_prep``), and any other id outside
[0, height) is the sentinel ``height``, which every consumer skips, so a
ragged id vector padded with ``height`` is exact.  Sums over duplicate ids
are taken in slot order, one addition after another, as the reference's
segment sum adds them; the sums are deterministic on every device.
"""
import numpy as np
import torch

__all__ = ['SelectedRows', 'normalize_rows', 'merge_rows_sentinel']


class SelectedRows(object):
    """rows: int [K] dense-row indices (may repeat); values: [K, ...] per-row
    data; height: the dense row count.  The fields are torch tensors, or
    numpy arrays in a fetched result."""

    def __init__(self, rows, values, height):
        self.rows = rows
        self.values = values
        self.height = int(height)

    def to_dense(self):
        """The dense [height, ...] tensor: values scattered by adding at
        their rows in slot order; ids outside [0, height) dropped after
        negatives wrap."""
        if isinstance(self.values, np.ndarray):
            rows = np.asarray(self.rows).astype(np.int64).reshape(-1)
            rows = np.where(rows < 0, rows + self.height, rows)
            keep = (rows >= 0) & (rows < self.height)
            dense = np.zeros((self.height,) + self.values.shape[1:],
                             self.values.dtype)
            np.add.at(dense, rows[keep], self.values[keep])
            return dense
        rows = normalize_rows(self.rows, self.height)
        keep = rows < self.height
        dense = torch.zeros((self.height,) + tuple(self.values.shape[1:]),
                            dtype=self.values.dtype,
                            device=self.values.device)
        runs, starts, counts, order = _runs(rows[keep])
        sums = _fold_runs(self.values[keep], order, starts, counts)
        dense[runs] = sums
        return dense

    def numpy(self):
        """A copy with numpy fields, as a fetch returns it."""
        return SelectedRows(self.rows.detach().cpu().numpy(),
                            self.values.detach().cpu().numpy(), self.height)

    def __repr__(self):
        return 'SelectedRows(rows=%s, values=%s, height=%d)' % (
            tuple(self.rows.shape), tuple(self.values.shape), self.height)


def normalize_rows(rows, height):
    """int64 [K] ids with the reference's index rules: [-height, 0) wraps
    by +height, anything else outside [0, height) becomes ``height``."""
    rows = rows.reshape(-1).long()
    rows = torch.where(rows < 0, rows + height, rows)
    return torch.where((rows < 0) | (rows >= height),
                       torch.full_like(rows, height), rows)


def _runs(rows):
    """Runs of equal ids after a stable sort: (run ids, first sorted slot
    of each run, run lengths, sort order), sentinel runs included."""
    srows, order = torch.sort(rows, stable=True)
    ids, counts = torch.unique_consecutive(srows, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    return ids, starts, counts, order


def _fold_runs(values, order, starts, counts, init=None):
    """Per run, ``init`` (or the run's first value) plus each further value
    of the run in slot order, one rounded addition after another.  Step j
    adds the (j+1)-th value of every run that long; the runs are visited
    longest first, so each step's runs are a prefix of that order."""
    n = int(counts.numel())
    if n == 0:
        return values.new_zeros((0,) + tuple(values.shape[1:]))
    svals = values[order]
    if init is None:
        acc = svals[starts].clone()
        first = 1
    else:
        acc = init.clone()
        first = 0
    desc = torch.argsort(counts, descending=True, stable=True)
    host = np.sort(counts.cpu().numpy())[::-1]
    for j in range(first, int(host[0])):
        live = desc[:int(np.count_nonzero(host > j))]
        acc[live] = acc[live] + svals[starts[live] + j]
    return acc


def merge_rows_sentinel(rows, values, height):
    """Sum the values of duplicate rows (operators/math/
    selected_rows_functor MergeAdd) with the sentinel slot convention of
    the row-wise rules: ids outside [0, height) (negatives included: wrap
    them first with ``normalize_rows``) become ``height`` and merge into
    one sentinel run; every unused slot carries row ``height`` and zero
    values.  Returns (rows [K], values [K, ...], valid [K] bool), the
    unique real rows ascending first."""
    rows = rows.reshape(-1).long()
    k = int(rows.numel())
    height = int(height)
    if k == 0:
        return rows, values, torch.zeros((0,), dtype=torch.bool,
                                         device=rows.device)
    in_range = (rows >= 0) & (rows < height)
    rows_in = torch.where(in_range, rows, torch.full_like(rows, height))
    ids, starts, counts, order = _runs(rows_in)
    n = int(ids.numel())
    out_rows = torch.full((k,), height, dtype=torch.long, device=rows.device)
    out_vals = values.new_zeros((k,) + tuple(values.shape[1:]))
    out_rows[:n] = ids
    out_vals[:n] = _fold_runs(values, order, starts, counts)
    valid = torch.arange(k, device=rows.device) < int(
        (ids < height).sum())
    return out_rows, out_vals, valid
