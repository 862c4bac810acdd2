"""Normal-equations KKT system for diagonal-Hessian (LP/QP) problems.

Counterpart of ``hiop_tpu/kkt/normal_eqn.py`` (reference
hiopKKTLinSysSparseNormalEqn, hiopKKTLinSysSparseNormalEqn.hpp:67-89): when
H + Dx + delta_wx is diagonal, dx and dd are eliminated from XDYcYd, leaving
the SPD system in the constraint duals::

  [ Jc Hx^{-1} Jc^T + delta_cc*I        Jc Hx^{-1} Jd^T                  ] [dyc]
  [ Jd Hx^{-1} Jc^T   Jd Hx^{-1} Jd^T + (Dd+delta_wd)^{-1} + delta_cd*I ] [dyd]
      = [ Jc Hx^{-1} rx_t - ryc ; Jd Hx^{-1} rx_t - ryd - (Dd+delta_wd)^{-1} rd_t ]

then dx = Hx^{-1}(rx_t - Jc^T dyc - Jd^T dyd), dd = (Dd+delta_wd)^{-1}(rd_t+dyd).
The m x m Cholesky is the port's (the hand-written kernel on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hiop_tpu_torch.kkt.newton_dense import _pos_inv
from hiop_tpu_torch.linalg.cholesky import cholesky as _chol


class NormalEqnFactors(NamedTuple):
    Ls: torch.Tensor       # chol of the m x m system
    Jc: torch.Tensor
    Jd: torch.Tensor
    hx_inv: torch.Tensor   # (n,) inverse of the diagonal H + Dx + delta_wx
    dd_inv: torch.Tensor   # (m_ineq,)
    ok: torch.Tensor


def factorize(h_diag, Dx, Dd, Jc, Jd, delta_wx, delta_wd, delta_cc, delta_cd) -> NormalEqnFactors:
    mc, md = Jc.shape[0], Jd.shape[0]
    hx = h_diag + Dx + delta_wx
    ok_h = (hx > 0).all()
    hx_inv = _pos_inv(hx)
    dd_inv = _pos_inv(Dd + delta_wd)
    J = torch.cat([Jc, Jd], dim=0)
    S = (J * hx_inv) @ J.T + torch.diag(torch.cat([
        torch.full((mc,), float(delta_cc), dtype=J.dtype, device=J.device), dd_inv + delta_cd,
    ]))
    Ls = _chol(S)
    ok = ok_h & torch.isfinite(Ls).all()
    Ls_safe = torch.where(ok, Ls, torch.eye(mc + md, dtype=J.dtype, device=J.device))
    return NormalEqnFactors(Ls_safe, Jc, Jd, hx_inv, dd_inv, ok)


def solve(f: NormalEqnFactors, rx_t, rd_t, ryc, ryd):
    mc = f.Jc.shape[0]
    J = torch.cat([f.Jc, f.Jd], dim=0)
    rhs = J @ (f.hx_inv * rx_t) - torch.cat([ryc, ryd + f.dd_inv * rd_t])
    dy = torch.cholesky_solve(rhs[:, None], f.Ls)[:, 0]
    dyc, dyd = dy[:mc], dy[mc:]
    dx = f.hx_inv * (rx_t - J.T @ dy)
    dd = f.dd_inv * (rd_t + dyd)
    return dx, dd, dyc, dyd
