"""Constraint-multiplier updates (LSQ).

Counterpart of ``hiop_tpu/optimization/duals_update.py`` (reference
hiopDualsUpdater, hiopDualsUpdater.hpp:68,116). The LSQ update solves

  [ Jc Jc^T    Jc Jd^T     ] [yc]   [Jc  0] [ -grad_f + zl - zu ]
  [ Jd Jc^T    Jd Jd^T + I ] [yd] = [Jd  I] [ -vl + vu          ]

(doc hiopDualsUpdater.hpp:199-231) with a regularized Cholesky of the small
m x m matrix. That factorization is a library call in both packages
(XLA's potrf there, ``torch.linalg.cholesky_ex`` here); it is not one of
the hand-written kernels.
"""

from __future__ import annotations

import torch


def _cholesky_nan_on_failure(M):
    """Lower Cholesky factor with ``jnp.linalg.cholesky``'s failure
    semantics: a NaN lower triangle (and zero upper triangle) when M is not
    positive definite; never raises, never synchronizes."""
    L, info = torch.linalg.cholesky_ex(M)
    nan_lower = torch.tril(torch.full_like(M, float("nan")))
    return torch.where(info == 0, L, nan_lower)


def lsq_duals(Jc, Jd, grad_f, zl, zu, vl, vu):
    """Returns (yc, yd) minimizing the dual-infeasibility LSQ problem."""
    mc, md = Jc.shape[0], Jd.shape[0]
    m = mc + md
    if m == 0:
        z = grad_f.new_zeros((0,))
        return z, z.clone()
    J = torch.cat([Jc, Jd], dim=0)
    diag = torch.cat([J.new_zeros(mc), J.new_ones(md)])
    M = J @ J.T + torch.diag(diag)
    r1 = -grad_f + zl - zu
    r2 = -vl + vu
    rhs = J @ r1 + torch.cat([J.new_zeros(mc), r2])
    # SPD up to Jacobian rank deficiency; regularized Cholesky
    eps = torch.finfo(M.dtype).eps
    scale = torch.clamp(M.abs().max(), min=1.0)
    eye = torch.eye(m, dtype=M.dtype, device=M.device)
    L = _cholesky_nan_on_failure(M + (eps ** 0.5) * scale * eye)
    y = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    return y[:mc], y[mc:]


def initial_duals_lsq(Jc, Jd, grad_f, zl, zu, vl, vu, lsq_max: float):
    """LSQ initialization with the duals_lsq_ini_max cap
    (compute_initial_duals_eq): falls back to zeros when the LSQ duals are
    large (badly scaled problems)."""
    if (Jc.shape[0] + Jd.shape[0]) * Jc.shape[1] > 50_000_000:
        raise NotImplementedError(
            "LSQ duals for a dense Jacobian above 5e7 entries need the "
            "matrix-free CG realization (ROADMAP.md section 1, item 9: "
            "linalg/krylov.py)"
        )
    yc, yd = lsq_duals(Jc, Jd, grad_f, zl, zu, vl, vu)
    ynrm = max(
        float(yc.abs().max()) if yc.numel() else 0.0,
        float(yd.abs().max()) if yd.numel() else 0.0,
    )
    if ynrm > lsq_max:
        return torch.zeros_like(yc), torch.zeros_like(yd)
    return yc, yd
