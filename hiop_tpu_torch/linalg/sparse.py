"""Triplet (COO) sparse matrices with static structure.

Counterpart of ``hiop_tpu/linalg/sparse.py`` (reference
hiopMatrixSparseTriplet, hiopMatrixSparseTriplet.hpp:26): the structure
(rows, cols) is fixed when the problem is built and kept on the host as
integer arrays, with one copy as index tensors on the values' device; only
the values are re-evaluated. Products are gathers and scatter-adds over the
nnz entries, so the solver's residual and LSQ paths never form an (m, n)
dense Jacobian. The scatter-adds are the sort-based
``index_put_(accumulate=True)`` of :func:`~hiop_tpu_torch.linalg.vector_ops.scatter_add_`
(``index_add_`` adds with atomics on CUDA), so two runs give the same bits.

:class:`TripletMatrix` has the small part of the tensor interface that the
solver uses on Jacobians (``shape``, ``A @ v``, ``A.T @ w``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hiop_tpu_torch.linalg.vector_ops import scatter_add_


class TripletMatrix:
    """Static-structure COO matrix: host ``rows``/``cols``, device ``vals``.

    ``index`` is the pair of (rows, cols) as int64 tensors on the values'
    device; callers that build many matrices on one structure pass it once
    made (:class:`hiop_tpu_torch.formulation.sparse.NlpSparse` does)."""

    def __init__(self, rows, cols, vals, shape: Tuple[int, int],
                 index: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        self.rows = np.asarray(rows, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int64)
        self.vals = vals
        self.shape = tuple(shape)
        if index is None:
            index = (torch.as_tensor(self.rows, device=vals.device),
                     torch.as_tensor(self.cols, device=vals.device))
        self.index = index

    def __matmul__(self, v):
        m = self.shape[0]
        out = self.vals.new_zeros((m,))
        if m == 0:
            return out
        r, c = self.index
        return scatter_add_(out, r, self.vals * v[c])

    @property
    def T(self) -> "TransposedTriplet":
        return TransposedTriplet(self)

    def todense(self):
        out = self.vals.new_zeros(self.shape)
        return out.index_put_(self.index, self.vals, accumulate=True)

    def with_values(self, vals) -> "TripletMatrix":
        return TripletMatrix(self.rows, self.cols, vals, self.shape, self.index)


class TransposedTriplet:
    def __init__(self, base: TripletMatrix):
        self.base = base
        self.shape = (base.shape[1], base.shape[0])

    def __matmul__(self, w):
        m, n = self.base.shape
        out = self.base.vals.new_zeros((n,))
        if n == 0 or m == 0:
            return out
        r, c = self.base.index
        return scatter_add_(out, c, self.base.vals * w[r])
