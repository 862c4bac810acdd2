"""Constraint-multiplier updates (LSQ).

Counterpart of ``hiop_tpu/optimization/duals_update.py`` (reference
hiopDualsUpdater, hiopDualsUpdater.hpp:68,116). The LSQ update solves

  [ Jc Jc^T    Jc Jd^T     ] [yc]   [Jc  0] [ -grad_f + zl - zu ]
  [ Jd Jc^T    Jd Jd^T + I ] [yd] = [Jd  I] [ -vl + vu          ]

(doc hiopDualsUpdater.hpp:199-231) with a regularized Cholesky of the small
m x m matrix. That factorization is a library call in both packages
(XLA's potrf there, ``torch.linalg.cholesky_ex`` here); it is not one of
the hand-written kernels. On a mesh the m x m system is replicated and is
factored and solved on each rank's replica. For a Jacobian too large to
form J J^T, :func:`lsq_duals_matfree` solves the same normal equations by CG
(:func:`hiop_tpu_torch.linalg.krylov.pcg`) with Jacobian products only,
dense or :class:`~hiop_tpu_torch.linalg.sparse.TripletMatrix`.
"""

from __future__ import annotations

import torch

from hiop_tpu_torch.linalg.sparse import TripletMatrix
from hiop_tpu_torch.utils.dtensor import plain, replicate_like


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
    # a library factorization DTensor has no rule for in every torch
    # version: on a mesh it runs on this rank's replica
    M_reg = M + (eps ** 0.5) * scale * eye
    wrap = replicate_like(M_reg, rhs)
    L = _cholesky_nan_on_failure(plain(M_reg))
    y = wrap(torch.cholesky_solve(plain(rhs)[:, None], L)[:, 0])
    return y[:mc], y[mc:]


def lsq_duals_matfree(Jc, Jd, grad_f, zl, zu, vl, vu, tol=1e-10, maxit=200):
    """LSQ duals via CG on the normal equations with Jacobian products only
    (the reference's sparse augmented LSQ realization,
    hiopDualsLsqUpdateLinsysAugSparse, hpp:357), never forming J J^T.
    Runs in the dtype of its inputs."""
    from hiop_tpu_torch.linalg import krylov

    mc, md = Jc.shape[0], Jd.shape[0]
    if mc + md == 0:
        z = grad_f.new_zeros((0,))
        return z, z.clone()
    r1 = -grad_f + zl - zu
    r2 = -vl + vu
    empty = grad_f.new_zeros((0,))

    def matvec(y):
        yc, yd = y[:mc], y[mc:]
        v = (Jc.T @ yc if mc else 0.0) + (Jd.T @ yd if md else 0.0)
        top = Jc @ v if mc else empty
        bot = (Jd @ v if md else empty) + yd
        return torch.cat([top, bot])

    rhs = torch.cat([
        Jc @ r1 if mc else empty,
        (Jd @ r1 if md else empty) + r2,
    ])
    y, _info = krylov.pcg(matvec, rhs, tol=tol, maxit=maxit)
    return y[:mc], y[mc:]


#: Jacobian entries above which the LSQ initialization runs the f32
#: matrix-free CG instead of forming J J^T
LSQ_DENSE_MAX_ENTRIES = 50_000_000


def initial_duals_lsq(Jc, Jd, grad_f, zl, zu, vl, vu, lsq_max: float):
    """LSQ initialization with the duals_lsq_ini_max cap
    (compute_initial_duals_eq): falls back to zeros when the LSQ duals are
    large (badly scaled problems). Triplet (matrix-free) Jacobians take
    :func:`lsq_duals_matfree` in f64. Above ``LSQ_DENSE_MAX_ENTRIES`` dense Jacobian
    entries it runs the matrix-free CG in f32 at ``tol=1e-6`` and casts
    back: this is an initialization whose result is magnitude-capped
    anyway, and J J^T of such a Jacobian costs more memory than the solve
    proper (the feasibility-restoration NLP of ACOPF B=512 has a
    4608 x 14 438 Jacobian)."""
    if isinstance(Jc, TripletMatrix) or isinstance(Jd, TripletMatrix):
        yc, yd = lsq_duals_matfree(Jc, Jd, grad_f, zl, zu, vl, vu)
    elif (Jc.shape[0] + Jd.shape[0]) * Jc.shape[1] > LSQ_DENSE_MAX_ENTRIES:
        f32 = torch.float32
        yc, yd = lsq_duals_matfree(
            Jc.to(f32), Jd.to(f32), grad_f.to(f32),
            zl.to(f32), zu.to(f32), vl.to(f32), vu.to(f32),
            tol=1e-6,
        )
        yc, yd = yc.to(grad_f.dtype), yd.to(grad_f.dtype)
    else:
        yc, yd = lsq_duals(Jc, Jd, grad_f, zl, zu, vl, vu)
    ynrm = max(
        float(yc.abs().max()) if yc.numel() else 0.0,
        float(yd.abs().max()) if yd.numel() else 0.0,
    )
    if ynrm > lsq_max:
        return torch.zeros_like(yc), torch.zeros_like(yd)
    return yc, yd
