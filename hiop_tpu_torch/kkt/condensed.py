"""Condensed KKT system for inequality-only NLPs.

Counterpart of ``hiop_tpu/kkt/condensed.py`` (reference
hiopKKTLinSysCondensedSparse, hiopKKTLinSysSparseCondensed.hpp:65-104): with
no equality constraints (the formulation relaxes equalities into tight
two-sided inequalities, option ``eq_relax_factor``), the XDYcYd system
condenses to the SPD matrix

  K = H + Dx + delta_wx*I + Jd^T Dd_tilde Jd,
  Dd_tilde = (Dd + delta_wd) (I + delta_cd (Dd + delta_wd))^{-1}

factorized by the port's Cholesky (the hand-written kernel on the card).
Direction recovery::

  dd  = T (Jd dx - ryd + delta_cd rd_t),  T = (I + delta_cd (Dd+delta_wd))^{-1}
  dyd = (Dd + delta_wd) dd - rd_t
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hiop_tpu_torch.linalg.cholesky import cholesky as _chol


class CondensedFactors(NamedTuple):
    Lk: torch.Tensor       # chol(K)
    Jd: torch.Tensor
    dd_tot: torch.Tensor   # Dd + delta_wd
    T: torch.Tensor        # (I + delta_cd*(Dd+delta_wd))^{-1} diagonal
    ok: torch.Tensor


def factorize(H, Dx, Dd, Jd, delta_wx, delta_wd, delta_cd) -> CondensedFactors:
    n = H.shape[0]
    dd_tot = Dd + delta_wd
    T = 1.0 / (1.0 + delta_cd * dd_tot)
    dd_tilde = dd_tot * T
    K = (H + torch.diag(Dx + delta_wx) + (Jd.T * dd_tilde) @ Jd).contiguous()
    Lk = _chol(K)
    ok = torch.isfinite(Lk).all()
    Lk_safe = torch.where(ok, Lk, torch.eye(n, dtype=K.dtype, device=K.device))
    return CondensedFactors(Lk_safe, Jd, dd_tot, T, ok)


def solve(f: CondensedFactors, rx_t, rd_t, ryd, delta_cd):
    dd_tilde = f.dd_tot * f.T
    rhs = rx_t + f.Jd.T @ (dd_tilde * (ryd - delta_cd * rd_t) + rd_t)
    dx = torch.cholesky_solve(rhs[:, None], f.Lk)[:, 0]
    dd = f.T * (f.Jd @ dx - ryd + delta_cd * rd_t)
    dyd = f.dd_tot * dd - rd_t
    return dx, dd, dyd
