"""Dense Newton KKT systems (XDYcYd / XYcYd) for exact-Hessian solves.

Counterpart of ``hiop_tpu/kkt/newton_dense.py`` (reference
hiopKKTLinSysDenseXYcYd/XDYcYd, hiopKKTLinSysDense.hpp:72,227, and the
compressed-system algebra of hiopKKTLinSys.hpp:292-345). The ladder:

* **quick** — range-space (Schur) elimination with two Cholesky
  factorizations, both through :func:`hiop_tpu_torch.linalg.cholesky.cholesky`
  (the hand-written kernel on the card)::

    K = H + Dx + delta_wx*I                       (n x n, PD after regular.)
    S = J K^{-1} J^T + blkdiag(delta_cc*I, (Dd+delta_wd)^{-1} + delta_cd*I)
    S [dyc;dyd] = J K^{-1} rx_t - [ryc; ryd + (Dd+delta_wd)^{-1} rd_t]
    dx = K^{-1}(rx_t - J^T dy);   dd = (Dd+delta_wd)^{-1}(rd_t + dyd)

  A failed factorization is a NaN factor: ``ok_k`` false means wrong
  inertia, ``ok_s`` false (or a pivot of S below the tiny-pivot threshold)
  a singular Jacobian; identity factors stand in for failed ones. The
  triangular solves are ``torch.cholesky_solve`` (``cho_solve`` in JAX,
  outside the Pallas kernel too).

* **safe, device** — the assembled XDYcYd (or XYcYd) matrix through the
  no-pivot LDL^T of :mod:`hiop_tpu_torch.linalg.ldl_blocked` (the
  hand-written kernel on the card); the inertia is the negative-pivot
  count, and a breakdown reports ``n_neg_eig = -1``.

* **safe, host** — the same matrices through the host LU + eigen inertia
  (:func:`_lu_with_inertia`, scipy), the last tier of the ladder.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.linalg as sla
import torch

from hiop_tpu_torch.formulation.base import to_numpy
from hiop_tpu_torch.linalg import ldl_blocked as _ldl
from hiop_tpu_torch.linalg.cholesky import cholesky as _chol
from hiop_tpu_torch.utils.dtensor import plain, replicate_like


def _pos_inv(v):
    """1/v where v > 0, else 0."""
    return torch.where(v > 0, 1.0 / torch.clamp(v, min=1e-300), 0.0)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _full(k: int, v, like):
    """A (k,) tensor of the scalar v in ``like``'s dtype and device. v may
    be a number or a 0-dim tensor on the device (the fused modes keep their
    regularization on the device): no host read either way."""
    if isinstance(v, torch.Tensor):
        return v.to(like.dtype).expand(k)
    return torch.full((k,), float(v), dtype=like.dtype, device=like.device)


def _cap_at_dual_reg(thresh, delta_cc):
    """The tiny-pivot threshold lowered to 0.5 sqrt(delta_cc) when
    delta_cc > 0: a branch on a number, a ``torch.where`` on a tensor."""
    if isinstance(delta_cc, torch.Tensor):
        return torch.where(delta_cc > 0, torch.minimum(thresh, 0.5 * torch.sqrt(delta_cc)), thresh)
    if delta_cc > 0:
        return torch.clamp(thresh, max=0.5 * float(delta_cc) ** 0.5)
    return thresh


def _cho_solve(L, b):
    """cho_solve((L, True), b) for b of shape (k,) or (k, r). On a mesh (a
    replicated DTensor L: DTensor has no rule for ``cholesky_solve`` in
    every torch version) it runs on this rank's replica and returns a
    ``Replicate`` DTensor."""
    wrap = replicate_like(L, b)
    L, b = plain(L), plain(b)
    if b.dim() == 1:
        return wrap(torch.cholesky_solve(b[:, None], L)[:, 0])
    return wrap(torch.cholesky_solve(b, L))


class QuickFactors(NamedTuple):
    Lk: torch.Tensor       # chol(K), (n, n)
    Ls: torch.Tensor       # chol(S), (m, m)
    Jc: torch.Tensor
    Jd: torch.Tensor
    dd_tot: torch.Tensor   # Dd + delta_wd (m_ineq,)
    dcd: torch.Tensor      # scalar
    ok_k: torch.Tensor     # Hessian-block Cholesky finite (else: wrong inertia)
    ok_s: torch.Tensor     # Schur Cholesky finite, no tiny pivot (else: singular Jacobian)
    ok: torch.Tensor       # both


def factorize_quick(H, Dx, Dd, Jc, Jd, delta_wx, delta_wd, delta_cc, delta_cd) -> QuickFactors:
    n = H.shape[0]
    mc, md = Jc.shape[0], Jd.shape[0]
    dt = H.dtype
    K = H.clone(memory_format=torch.contiguous_format)
    K.diagonal().add_(Dx + delta_wx)
    Lk = _chol(K)
    del K
    ok_k = torch.isfinite(Lk).all()
    Lk_safe = torch.where(ok_k, Lk, _eye(n, H))
    del Lk

    J = torch.cat([Jc, Jd], dim=0)                  # (m, n)
    KinvJT = _cho_solve(Lk_safe, J.T)              # (n, m)
    dd_tot = Dd + delta_wd
    dd_inv = _pos_inv(dd_tot)
    S = J @ KinvJT + torch.diag(torch.cat([_full(mc, delta_cc, H), dd_inv + delta_cd]))
    Ls = _chol(S)
    # a numerically PSD-but-singular Schur complement whose Cholesky
    # succeeds is caught by its tiny pivots; with delta_cc > 0 the pivots
    # are >= sqrt(delta_cc) by construction, so the threshold is lowered
    if mc + md:
        scale_s = torch.sqrt(torch.clamp(S.abs().max(), min=1e-300))
        min_diag = torch.diagonal(Ls).abs().min()
    else:
        scale_s = S.new_tensor(1.0)
        min_diag = S.new_tensor(float("inf"))
    thresh = _cap_at_dual_reg((torch.finfo(dt).eps ** 0.5) * scale_s * 1e-2, delta_cc)
    ok_s = torch.isfinite(Ls).all() & ~(min_diag < thresh)
    ok = ok_k & ok_s
    Ls_safe = torch.where(ok, Ls, _eye(mc + md, H))
    return QuickFactors(
        Lk_safe, Ls_safe, Jc, Jd, dd_tot, _full(1, delta_cd, H)[0],
        ok_k, ok_s, ok,
    )


def solve_quick(f: QuickFactors, rx_t, rd_t, ryc, ryd):
    mc = f.Jc.shape[0]
    J = torch.cat([f.Jc, f.Jd], dim=0)
    dd_inv = _pos_inv(f.dd_tot)
    Kinv_rx = _cho_solve(f.Lk, rx_t)
    rhs_y = J @ Kinv_rx - torch.cat([ryc, ryd + dd_inv * rd_t])
    dy = _cho_solve(f.Ls, rhs_y) if rhs_y.numel() else rhs_y
    dyc, dyd = dy[:mc], dy[mc:]
    dx = Kinv_rx - _cho_solve(f.Lk, J.T @ dy)
    dd = dd_inv * (dyd + rd_t)
    return dx, dd, dyc, dyd


def assemble_xdycyd(H, Dx, Dd, Jc, Jd, delta_wx, delta_wd, delta_cc, delta_cd):
    """Full symmetric XDYcYd matrix (doc hiopKKTLinSys.hpp:334-345),
    ordered [x, d, yc, yd]."""
    n = H.shape[0]
    mc, md = Jc.shape[0], Jd.shape[0]
    N = n + md + mc + md
    M = H.new_zeros((N, N))
    ix, idd, iyc, iyd = 0, n, n + md, n + md + mc
    M[:n, :n] = H
    M[:n, :n].diagonal().add_(Dx + delta_wx)
    M[ix:n, iyc:iyd] = Jc.T
    M[ix:n, iyd:] = Jd.T
    M[idd:iyc, idd:iyc] = torch.diag(Dd + delta_wd)
    M[idd:iyc, iyd:] = -_eye(md, H)
    M[iyc:iyd, ix:n] = Jc
    M[iyc:iyd, iyc:iyd] = -float(delta_cc) * _eye(mc, H)
    M[iyd:, ix:n] = Jd
    M[iyd:, idd:iyc] = -_eye(md, H)
    M[iyd:, iyd:] = -float(delta_cd) * _eye(md, H)
    return M


def xdycyd_matvec(H, Dx, Dd, Jc, Jd, delta_wx, delta_wd, delta_cc, delta_cd,
                  dx, dd, dyc, dyd):
    """Apply the compressed XDYcYd operator (the blocks of
    :func:`assemble_xdycyd`) to a direction tuple — the matvec of the
    FGMRES inner refinement of low-precision solves."""
    rx = H @ dx + (Dx + delta_wx) * dx + Jc.T @ dyc + Jd.T @ dyd
    rd = (Dd + delta_wd) * dd - dyd
    ryc = Jc @ dx - delta_cc * dyc
    ryd = Jd @ dx - dd - delta_cd * dyd
    return rx, rd, ryc, ryd


class DeviceLdlFactors(NamedTuple):
    """No-pivot LDL^T factors of the XDYcYd matrix (the analogue of
    hiopLinSolverSymDenseMagmaNopiv, hiopLinSolverSymDenseMagma.hpp:145)."""
    ldl: _ldl.LdlFactors
    n: int
    mc: int
    md: int
    n_neg_eig: torch.Tensor   # -1 if breakdown, else negative-pivot count
    ok: torch.Tensor


def factorize_safe_device(H, Dx, Dd, Jc, Jd, delta_wx, delta_wd, delta_cc, delta_cd):
    """Safe tier on the device: the assembled XDYcYd matrix through the
    blocked no-pivot LDL^T. Inertia from the pivot signs (Sylvester, valid
    without breakdown); a breakdown reports n_neg_eig = -1."""
    n = H.shape[0]
    mc, md = Jc.shape[0], Jd.shape[0]
    M = assemble_xdycyd(H, Dx, Dd, Jc, Jd, delta_wx, delta_wd, delta_cc, delta_cd)
    f = _ldl.ldl_factor(M)
    n_neg = torch.where(f.ok, f.n_neg, -1)
    return DeviceLdlFactors(f, n, mc, md, n_neg, f.ok)


def solve_safe_device(f: DeviceLdlFactors, rx_t, rd_t, ryc, ryd):
    rhs = torch.cat([rx_t, rd_t, ryc, ryd])
    sol = _ldl.ldl_solve(f.ldl, rhs)
    n, mc, md = f.n, f.mc, f.md
    return sol[:n], sol[n:n + md], sol[n + md:n + md + mc], sol[n + md + mc:]


def assemble_xycyd(H, Dx, Dd, Jc, Jd, delta_wx, delta_wd, delta_cc, delta_cd):
    """Full symmetric XYcYd matrix — the other compressed linearization
    (hiopKKTLinSys.hpp:292-301, dense realization
    hiopKKTLinSysDense.hpp:72): d eliminated through (Dd+delta_wd)^{-1},
    ordered [x, yc, yd]::

      [ H + Dx + delta_wx   Jc^T        Jd^T                         ]
      [ Jc                  -delta_cc                                ]
      [ Jd                              -(Dd+delta_wd)^{-1}-delta_cd ]
    """
    n = H.shape[0]
    mc, md = Jc.shape[0], Jd.shape[0]
    dd_inv = _pos_inv(Dd + delta_wd)
    N = n + mc + md
    M = H.new_zeros((N, N))
    M[:n, :n] = H
    M[:n, :n].diagonal().add_(Dx + delta_wx)
    M[:n, n:n + mc] = Jc.T
    M[:n, n + mc:] = Jd.T
    M[n:n + mc, :n] = Jc
    M[n:n + mc, n:n + mc] = -float(delta_cc) * _eye(mc, H)
    M[n + mc:, :n] = Jd
    M[n + mc:, n + mc:] = -torch.diag(dd_inv + delta_cd)
    return M


def xycyd_matvec(H, Dx, Dd, Jc, Jd, delta_wx, delta_wd, delta_cc, delta_cd,
                 dx, dyc, dyd):
    """Apply the compressed XYcYd operator (blocks of :func:`assemble_xycyd`)."""
    dd_inv = _pos_inv(Dd + delta_wd)
    rx = H @ dx + (Dx + delta_wx) * dx + Jc.T @ dyc + Jd.T @ dyd
    ryc = Jc @ dx - delta_cc * dyc
    ryd = Jd @ dx - (dd_inv + delta_cd) * dyd
    return rx, ryc, ryd


class SafeFactors(NamedTuple):
    """Host LU + eigen inertia of the assembled XDYcYd matrix."""
    lu: np.ndarray
    piv: np.ndarray
    n: int
    mc: int
    md: int
    n_neg_eig: np.ndarray   # -1 if singular, else count of negative eigenvalues
    ok: bool


class XycydSafeFactors(NamedTuple):
    """Host LU + eigen inertia of the assembled XYcYd matrix. Expected
    inertia (n, mc+md, 0): the same negative count as XDYcYd."""
    lu: np.ndarray
    piv: np.ndarray
    n: int
    mc: int
    md: int
    n_neg_eig: np.ndarray
    ok: bool


class XycydDeviceLdlFactors(NamedTuple):
    """No-pivot LDL^T of the XYcYd matrix (the reference's XYcYd GPU
    branch, hiopKKTLinSysDense.hpp:100-113)."""
    ldl: _ldl.LdlFactors
    n: int
    mc: int
    md: int
    n_neg_eig: torch.Tensor
    ok: torch.Tensor


def factorize_xycyd_safe(H, Dx, Dd, Jc, Jd, delta_wx, delta_wd, delta_cc, delta_cd):
    n = H.shape[0]
    mc, md = Jc.shape[0], Jd.shape[0]
    M = assemble_xycyd(H, Dx, Dd, Jc, Jd, delta_wx, delta_wd, delta_cc, delta_cd)
    lu, piv, n_neg_eig = _lu_with_inertia(M, delta_cc)
    return XycydSafeFactors(lu, piv, n, mc, md, n_neg_eig, bool(np.all(np.isfinite(lu))))


def factorize_xycyd_safe_device(H, Dx, Dd, Jc, Jd, delta_wx, delta_wd,
                                delta_cc, delta_cd):
    n = H.shape[0]
    mc, md = Jc.shape[0], Jd.shape[0]
    M = assemble_xycyd(H, Dx, Dd, Jc, Jd, delta_wx, delta_wd, delta_cc, delta_cd)
    f = _ldl.ldl_factor(M)
    n_neg = torch.where(f.ok, f.n_neg, -1)
    return XycydDeviceLdlFactors(f, n, mc, md, n_neg, f.ok)


def _host_lu_solve(f, rhs_parts, like):
    rhs = np.concatenate([to_numpy(a) for a in rhs_parts])
    sol = sla.lu_solve((f.lu, f.piv), rhs)
    return torch.as_tensor(sol, dtype=like.dtype, device=like.device)


def solve_xycyd_safe(f, rx_t, ryc, ryd_t):
    """Solve the 3x3 system; returns (dx, dyc, dyd). The caller recovers
    dd = (Dd+delta_wd)^{-1} (rd_t + dyd) (hiopKKTLinSys.cpp:670)."""
    n, mc = f.n, f.mc
    if isinstance(f, XycydDeviceLdlFactors):
        sol = _ldl.ldl_solve(f.ldl, torch.cat([rx_t, ryc, ryd_t]))
    else:
        sol = _host_lu_solve(f, (rx_t, ryc, ryd_t), rx_t)
    return sol[:n], sol[n:n + mc], sol[n + mc:]


def _lu_with_inertia(M, delta_cc):
    """Host-side LU + eigen inertia (numpy LAPACK), the stable fallback of
    the safe ladder (the reference's MA57/dsytrf on the CPU while the quick
    path lives on the accelerator). Returns (lu, piv, n_neg_eig) with
    n_neg_eig = -1 for a numerically singular matrix."""
    Mh = to_numpy(M)
    lu, piv = sla.lu_factor(Mh)
    delta_cc = float(delta_cc)
    w = np.linalg.eigvalsh(0.5 * (Mh + Mh.T))
    tol = 1e1 * np.finfo(Mh.dtype).eps * max(float(np.max(np.abs(w))), 1.0)
    if delta_cc > 0.0:
        # the dual-regularized eigenvalues sit at -delta_cc, usually BELOW
        # the eig noise floor tol ~ eps*||M||; attribute noise-band
        # eigenvalues to the negative count: if they are the -delta_cc ones
        # the inertia comes out right, if they are a near-singular Hessian
        # block the count exceeds mc+md and the caller bumps delta_w
        n_neg_eig = int(np.sum(w < tol))
    else:
        n_neg = int(np.sum(w < -tol))
        n_zero = int(np.sum(np.abs(w) <= tol))
        n_neg_eig = -1 if n_zero > 0 else n_neg
    return lu, piv, np.asarray(n_neg_eig)


def factorize_safe(H, Dx, Dd, Jc, Jd, delta_wx, delta_wd, delta_cc, delta_cd):
    n = H.shape[0]
    mc, md = Jc.shape[0], Jd.shape[0]
    M = assemble_xdycyd(H, Dx, Dd, Jc, Jd, delta_wx, delta_wd, delta_cc, delta_cd)
    lu, piv, n_neg_eig = _lu_with_inertia(M, delta_cc)
    return SafeFactors(lu, piv, n, mc, md, n_neg_eig, bool(np.all(np.isfinite(lu))))


def solve_safe(f: SafeFactors, rx_t, rd_t, ryc, ryd):
    sol = _host_lu_solve(f, (rx_t, rd_t, ryc, ryd), rx_t)
    n, mc, md = f.n, f.mc, f.md
    return sol[:n], sol[n:n + md], sol[n + md:n + md + mc], sol[n + md + mc:]


def curvature_test(H, Dx, Dd, delta_wx, delta_wd, dx, dd, neg_curv_test_fact):
    """Inertia-free acceptance (hiopKKTLinSysCompressed::test_direction,
    hiopKKTLinSys.cpp:455): dWd >= fact * ||(dx,dd)||^2 with
    dWd = dx'(H+Dx+delta_wx)dx + dd'(Dd+delta_wd)dd. A 0-dim bool tensor."""
    dWd = dx @ (H @ dx) + dx @ ((Dx + delta_wx) * dx) + dd @ ((Dd + delta_wd) * dd)
    nrmsq = dx @ dx + dd @ dd
    return dWd >= nrmsq * neg_curv_test_fact
