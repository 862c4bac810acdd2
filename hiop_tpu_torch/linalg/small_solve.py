"""Small dense linear solves by unrolled Gaussian elimination.

Counterpart of ``hiop_tpu/linalg/small_solve.py``, copied operation for
operation: partial pivoting with the pivot row found by ``argmax`` (first
maximum on ties), rows swapped and eliminated by masked whole-matrix
updates, then a masked back substitution. The compact-BFGS solves (the
2l x 2l matrices of :mod:`hiop_tpu_torch.optimization.hessian_lowrank`)
therefore round as ``hiop_tpu``'s do, which keeps the BFGS skip test and
the sigma clip on the same side of their thresholds. The pivot index stays
a tensor, so a solve never synchronizes with the host. Intended for
k <= ~32 (the loop runs k times).
"""

from __future__ import annotations

import torch


def solve_small(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B for small square A (k x k). B may be (k,) or (k, m)."""
    single = B.dim() == 1
    Bm = B[:, None] if single else B
    k = A.shape[0]
    M = torch.cat([A, Bm.to(A.dtype)], dim=1)
    rows = torch.arange(k, device=A.device)
    neg_inf = torch.tensor(float("-inf"), dtype=A.dtype, device=A.device)
    for i in range(k):
        col = M[:, i].abs()
        col = torch.where(rows >= i, col, neg_inf)
        p = torch.argmax(col)
        row_i = M[i]
        row_p = M.index_select(0, p.reshape(1))[0]
        M = torch.where((rows == i)[:, None], row_p[None, :], M)
        M = torch.where((rows == p)[:, None], row_i[None, :], M)
        pivot = M[i, i]
        inv_p = torch.where(pivot.abs() > 0, 1.0 / pivot, 0.0)
        factor = M[:, i] * inv_p
        elim = rows > i
        M = M - torch.where(elim[:, None], factor[:, None] * M[i][None, :], 0.0)
    # back substitution
    for i in reversed(range(k)):
        inv_p = torch.where(M[i, i].abs() > 0, 1.0 / M[i, i], 0.0)
        M = torch.where((rows == i)[:, None], (M[i] * inv_p)[None, :], M)
        above = rows < i
        M = M - torch.where(above[:, None], M[:, i][:, None] * M[i][None, :], 0.0)
    X = M[:, k:]
    return X[:, 0] if single else X
