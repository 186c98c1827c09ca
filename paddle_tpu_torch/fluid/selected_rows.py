"""SelectedRows: the sparse-gradient representation (counterpart of
``paddle_tpu/fluid/selected_rows.py``): the grad ``lookup_table`` gives its
table when ``is_sparse=True``, a row-index list and a value tensor of just
those rows, which ``sgd`` applies row by row.

The layout is the reference's: one ``(row, value)`` pair per *occurrence*
of an id in the batch, duplicates allowed, so ``rows`` is ``[N]`` and
``values`` ``[N, ...]`` for a batch that looked up N ids.  Both shapes are
fixed by the batch's, which a CUDA graph can capture (a unique-row layout
would be sized by the data).  Every consumer folds duplicates with a
scatter-add (``index_add_``; on CUDA its atomics add repeated rows in no
fixed order).
"""

from __future__ import annotations

import torch

__all__ = ["SelectedRows", "is_selected_rows"]


class SelectedRows:
    """rows: int64 tensor [N] (duplicates allowed); values: [N, ...] per-row
    payload; height: the dense dim-0 extent (the vocab size)."""

    __slots__ = ("rows", "values", "height")

    def __init__(self, rows, values, height=None):
        self.rows = rows
        self.values = values
        self.height = int(height) if height is not None else None

    def to_dense(self, height=None):
        """Fold into a dense [height, ...] tensor: duplicate rows add up."""
        h = height if height is not None else self.height
        if h is None:
            raise ValueError("SelectedRows.to_dense needs a height")
        dense = torch.zeros((h,) + tuple(self.values.shape[1:]),
                            dtype=self.values.dtype,
                            device=self.values.device)
        return dense.index_add_(0, self.rows, self.values)

    def scatter_sub_into(self, dense, scale=1.0):
        """``dense -= scale · this`` IN PLACE at the touched rows only (the
        sparse optimizer update); returns ``dense``.  ``scale`` may be a
        tensor (the learning rate)."""
        return dense.index_add_(0, self.rows,
                                (-scale * self.values).to(dense.dtype))

    def merge_with(self, other: "SelectedRows") -> "SelectedRows":
        """The sum of two sparse grads: their concatenation (consumers
        scatter-add, so duplicate rows fold)."""
        if not isinstance(other, SelectedRows):
            raise TypeError("can only merge SelectedRows with SelectedRows")
        return SelectedRows(
            torch.cat([self.rows, other.rows], 0),
            torch.cat([self.values, other.values], 0),
            self.height if self.height is not None else other.height)

    def map(self, fn) -> "SelectedRows":
        """The same structure with ``fn`` applied to ``rows`` and
        ``values`` (a copy to another device, a snapshot)."""
        return SelectedRows(fn(self.rows), fn(self.values), self.height)

    @property
    def shape(self):
        # the dense shape, so that shape-probing code stays sane
        if self.height is None:
            return tuple(self.values.shape)
        return (self.height,) + tuple(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    def __repr__(self):  # pragma: no cover - cosmetic
        return (f"SelectedRows(rows={tuple(self.rows.shape)}, "
                f"values={tuple(self.values.shape)}, height={self.height})")


def is_selected_rows(v) -> bool:
    return isinstance(v, SelectedRows)
