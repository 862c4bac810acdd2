"""KKT solve for the quasi-Newton path (low-rank Hessian).

Counterpart of ``hiop_tpu/kkt/lowrank.py`` (reference
hiopKKTLinSysLowRank, hiopKKTLinSys.hpp:385, doc :417-428): the compressed
XYcYd system with H = B_BFGS is Schur-reduced onto the (m_eq + m_ineq)
dual space through the compact-BFGS inverse::

  N = J (H+Dx)^{-1} J^T + blkdiag(0, Dd^{-1})
  N [dyc;dyd] = J (H+Dx)^{-1} rx_t - [ryc; ryd + Dd^{-1} rd_t]
  dx = (H+Dx)^{-1} (rx_t - J^T [dyc;dyd]);   dd = Dd^{-1} (dyd + rd_t)

(H+Dx)^{-1} is applied to the m+1 right-hand sides at once (matrix
products over n). The m x m system is factorized by the port's Cholesky
(:func:`hiop_tpu_torch.linalg.cholesky.cholesky`, the hand-written kernel
on the card) with one refinement sweep; when N is not positive definite a
diagonal bump is tried instead (solveWithRefin, hiopKKTLinSys.hpp:434).
``hiop_tpu`` picks between the two with ``lax.cond``; here it is one host
branch on ``ok`` (one synchronization per solve).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hiop_tpu_torch.kkt.newton_dense import _cho_solve
from hiop_tpu_torch.linalg.cholesky import cholesky as _chol
from hiop_tpu_torch.optimization import hessian_lowrank as blr


class LowRankKKTData(NamedTuple):
    bfgs: blr.BfgsState
    Dx_tot: torch.Tensor   # Dx + delta_wx
    Dd: torch.Tensor       # barrier diagonal for d (positive on bounded ineqs)
    Jc: torch.Tensor       # (m_eq, n)
    Jd: torch.Tensor       # (m_ineq, n)


def solve_compressed(data: LowRankKKTData, rx_t, rd_t, ryc, ryd):
    """Returns (dx, dd, dyc, dyd). Dd entries of 0 (inequality with no
    finite bounds) are guarded with a tiny floor."""
    mc = data.Jc.shape[0]
    J = torch.cat([data.Jc, data.Jd], dim=0)               # (m, n)
    dd_safe = torch.clamp(data.Dd, min=1e-30)
    dd_inv = torch.where(data.Dd > 0, 1.0 / dd_safe, 0.0)

    nrhs = torch.cat([J.T, rx_t[:, None]], dim=1)          # (n, m+1)
    Minv = blr.solve(data.bfgs, data.Dx_tot, nrhs)
    MinvJT = Minv[:, :-1]                                  # (n, m)
    Minv_rx = Minv[:, -1]                                  # (n,)

    N = J @ MinvJT                                         # (m, m)
    N = N + torch.diag(torch.cat([N.new_zeros((mc,)), dd_inv]))

    rhs_y = J @ Minv_rx - torch.cat([ryc, ryd + dd_inv * rd_t])

    dy = _sym_solve_with_refin(N, rhs_y)
    dyc, dyd = dy[:mc], dy[mc:]
    dx = Minv_rx - MinvJT @ dy
    dd = dd_inv * (dyd + rd_t)
    return dx, dd, dyc, dyd


def _sym_solve_with_refin(N: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cholesky with one refinement sweep; when N is not PD, the Cholesky
    of N + sqrt(eps)*max(|N|, 1)*I (identity if that fails too)."""
    m = N.shape[0]
    if m == 0:
        return b
    L = _chol(N)
    if bool(torch.isfinite(L).all()):
        x0 = _cho_solve(L, b)
        r = b - N @ x0
        return x0 + _cho_solve(L, r)
    eps = torch.finfo(N.dtype).eps
    scale = torch.clamp(N.abs().max(), min=1.0)
    eye = torch.eye(m, dtype=N.dtype, device=N.device)
    Lb = _chol(N + eps ** 0.5 * scale * eye)
    ok_b = torch.isfinite(Lb).all()
    Lb = torch.where(ok_b, Lb, eye)
    return _cho_solve(Lb, b)
