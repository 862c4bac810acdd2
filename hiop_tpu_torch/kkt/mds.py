"""KKT system for mixed dense-sparse (MDS) NLPs.

Counterpart of ``hiop_tpu/kkt/mds.py`` (reference
hiopKKTLinSysCompressedMDSXYcYd, hiopKKTLinSysMDS.hpp:97): variables split
[x_s, x_d] with the Hessian block-diagonal — a *diagonal* sparse block H_ss
and a dense block H_dd.

Quick tier: the full range-space reduction with two Cholesky
factorizations (the hand-written kernel of :mod:`hiop_tpu_torch.linalg.cholesky`)::

  K_s = H_ss + Dx_s + delta_wx   (diagonal)
  K_d = H_dd + Dx_d + delta_wx   (n_d x n_d, Cholesky)
  S   = J_s K_s^{-1} J_s^T + J_d K_d^{-1} J_d^T
        + blkdiag(delta_cc I, (Dd+delta_wd)^{-1} + delta_cd I)   (m x m, Cholesky)

with J_s K_s^{-1} J_s^T assembled from the sparse-block triplets
(:func:`schur_js_triplets`). Failure of K_d's Cholesky signals wrong
inertia, failure of S a singular Jacobian.

Safe tiers, in the ladder's order: the bordered sparse host tier
(:func:`factorize_safe_schur`: the native sparse LDL^T of the Schur block
plus a small dense border, when the native library builds); the partly
reduced (n_d + m) saddle, factorized by the inertia-revealing no-pivot
LDL^T kernel on the device (:mod:`hiop_tpu_torch.linalg.ldl_blocked`) or by
the host LU + eigen inertia (``lu_eig``).

The fused and mixed-precision factorizations of ``hiop_tpu`` are not
ported yet (ROADMAP.md section 1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.linalg as sla
import torch

from hiop_tpu_torch.formulation.base import to_numpy
from hiop_tpu_torch.kkt.newton_dense import _lu_with_inertia
from hiop_tpu_torch.linalg import ldl_blocked as _ldl
from hiop_tpu_torch.linalg.cholesky import cholesky as _chol
from hiop_tpu_torch.linalg.vector_ops import scatter_add_


class MdsFactors(NamedTuple):
    ks_inv: torch.Tensor   # (n_s,) inverse of the diagonal sparse block
    Ld: torch.Tensor       # chol(K_d) (n_d, n_d)
    Ls: torch.Tensor       # chol(S) (m, m)
    Js: torch.Tensor       # (m, n_s) [Jc_s; Jd_s]
    Jdn: torch.Tensor      # (m, n_d) [Jc_d; Jd_d]
    dd_tot: torch.Tensor   # Dd + delta_wd
    ok_k: torch.Tensor
    ok_s: torch.Tensor
    ok: torch.Tensor


def _pos_inv(v):
    """1/v where v > 0, else 0."""
    return torch.where(v > 0, 1.0 / torch.clamp(v, min=1e-300), 0.0)


def build_schur_pairs(stacked_rows, cols, n_s, device=None, max_pairs=8_000_000):
    """Precompute (once per problem) the index tensors driving
    :func:`schur_js_triplets`: all ordered pairs of sparse-Jacobian
    nonzeros sharing a column, with their stacked row coordinates.
    ``stacked_rows`` follows the [eq; m_eq + ineq] row order of
    Js = [Jc_s; Jd_s]. Returns None (dense fallback) when the pair count
    exceeds ``max_pairs`` or the structure holds duplicate (row, col)
    entries (the dense materialization sums duplicates, which the pairwise
    products would overcount)."""
    stacked_rows = np.asarray(stacked_rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    nnz = cols.size
    if nnz == 0:
        return None
    if np.unique(stacked_rows * n_s + cols).size != nnz:
        return None
    order = np.argsort(cols, kind="stable")
    counts = np.bincount(cols, minlength=n_s)
    n_pairs = int(np.sum(counts.astype(np.int64) ** 2))
    if n_pairs == 0 or n_pairs > max_pairs:
        return None
    starts = np.concatenate([[0], np.cumsum(counts)])
    pa_parts, pb_parts = [], []
    for c in np.nonzero(counts)[0]:
        idx = order[starts[c]:starts[c + 1]]
        k = idx.size
        pa_parts.append(np.repeat(idx, k))
        pb_parts.append(np.tile(idx, k))
    pa = np.concatenate(pa_parts)
    pb = np.concatenate(pb_parts)
    pvar = cols[pa]
    prow = stacked_rows[pa]
    pcol = stacked_rows[pb]
    return tuple(torch.as_tensor(x, device=device) for x in (pa, pb, pvar, prow, pcol))


def schur_js_triplets(js_vals, ks_inv, pairs, m: int):
    """Js Ks^{-1} Js^T assembled from the sparse-block TRIPLETS: for every
    pair of nonzeros (a, b) sharing a column c,
    S[row_a, row_b] += v_a * v_b * ks_inv[c] — one gather-multiply and one
    1-D deterministic scatter-add, O(sum_c deg_c^2) work instead of the dense
    (m, n_s) @ (n_s, m) product (the reference's addMDinvMtransToDiagBlock-
    OfSymDeMatUTri kernel family, hiopKKTLinSysMDS.cpp:172-276)."""
    pa, pb, pvar, prow, pcol = pairs
    prod = js_vals[pa] * js_vals[pb] * ks_inv[pvar]
    flat = torch.zeros((m * m,), dtype=js_vals.dtype, device=js_vals.device)
    return scatter_add_(flat, prow * m + pcol, prod).reshape(m, m)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def factorize(
    hss, Hdd, Dxs, Dxd, Dd, Jc_s, Jc_d, Jd_s, Jd_d,
    delta_wx, delta_wd, delta_cc, delta_cd,
    js_vals=None, js_pairs=None,
) -> MdsFactors:
    """Quick-tier factorization (``_factorize_core``). ``js_vals`` follows
    the [eq; ineq] stacked row order; ``js_pairs`` from
    :func:`build_schur_pairs` selects the triplet Schur assembly."""
    nd = Hdd.shape[0]
    mc, md = Jc_s.shape[0], Jd_s.shape[0]
    dt = Hdd.dtype

    ks = hss + Dxs + delta_wx
    ok_ks = (ks > 0).all()
    ks_inv = _pos_inv(ks)

    Kd = Hdd + torch.diag(Dxd + delta_wx)
    Ld = _chol(Kd)
    ok_kd = torch.isfinite(Ld).all()
    ok_k = ok_ks & ok_kd
    Ld_safe = torch.where(ok_kd, Ld, _eye(nd, Hdd))

    Js = torch.cat([Jc_s, Jd_s], dim=0)        # (m, n_s)
    Jdn = torch.cat([Jc_d, Jd_d], dim=0)       # (m, n_d)
    dd_tot = Dd + delta_wd
    dd_inv = _pos_inv(dd_tot)

    KdinvJT = torch.cholesky_solve(Jdn.T, Ld_safe)   # (n_d, m)
    if js_pairs is not None:
        JKJt = schur_js_triplets(js_vals, ks_inv, js_pairs, mc + md)
    else:
        JKJt = (Js * ks_inv) @ Js.T
    S = JKJt + Jdn @ KdinvJT + torch.diag(
        torch.cat([torch.full((mc,), float(delta_cc), dtype=dt, device=Hdd.device),
                   dd_inv + delta_cd])
    )
    Ls = _chol(S)
    diag_s = torch.diagonal(Ls)
    if mc + md:
        scale_s = torch.sqrt(torch.clamp(S.abs().max(), min=1e-300))
        min_diag = diag_s.abs().min()
    else:
        scale_s = S.new_tensor(1.0)
        min_diag = S.new_tensor(float("inf"))
    thresh = (torch.finfo(dt).eps ** 0.5) * scale_s * 1e-2
    if delta_cc > 0:
        thresh = torch.clamp(thresh, max=0.5 * float(delta_cc) ** 0.5)
    tiny = min_diag < thresh
    ok_s = torch.isfinite(Ls).all() & ~tiny
    ok = ok_k & ok_s
    Ls_safe = torch.where(ok_s, Ls, _eye(mc + md, Hdd))
    return MdsFactors(ks_inv, Ld_safe, Ls_safe, Js, Jdn, dd_tot, ok_k, ok_s, ok)


def solve(f: MdsFactors, rxs_t, rxd_t, rd_t, ryc, ryd):
    """Direction recovery for :func:`factorize`."""
    mc = ryc.shape[0]
    dd_inv = _pos_inv(f.dd_tot)
    Ksinv_rxs = f.ks_inv * rxs_t
    Kdinv_rxd = torch.cholesky_solve(rxd_t[:, None], f.Ld)[:, 0]
    rhs_y = f.Js @ Ksinv_rxs + f.Jdn @ Kdinv_rxd - torch.cat([ryc, ryd + dd_inv * rd_t])
    dy = torch.cholesky_solve(rhs_y[:, None], f.Ls)[:, 0]
    dyc, dyd = dy[:mc], dy[mc:]
    dxs = f.ks_inv * (rxs_t - f.Js.T @ dy)
    dxd = torch.cholesky_solve((rxd_t - f.Jdn.T @ dy)[:, None], f.Ld)[:, 0]
    dd = dd_inv * (dyd + rd_t)
    return dxs, dxd, dd, dyc, dyd


class MdsSafeFactors(NamedTuple):
    """Safe-tier factors: the sparse diagonal block stays eliminated
    (exact), and the (n_d + m) symmetric-indefinite saddle is factorized
    with an inertia-revealing method, like the reference's MAGMA-BuKa
    escalation for MDS systems (hiopKKTLinSysMDS.cpp:437-477)."""
    fact: object        # LdlFactors (device) or (lu, piv) host pair
    host: bool
    ks_inv: torch.Tensor
    Js: torch.Tensor
    dd_tot: torch.Tensor
    nd: int
    mc: int
    md: int
    n_neg_eig: int      # -1 on breakdown
    ok: bool


def factorize_safe(
    hss, Hdd, Dxs, Dxd, Dd, Jc_s, Jc_d, Jd_s, Jd_d,
    delta_wx, delta_wd, delta_cc, delta_cd, host: bool = False,
    js_vals=None, js_pairs=None,
) -> MdsSafeFactors:
    """Assemble and factorize the reduced MDS saddle system

      [ K_d    J_dn^T ] [dx_d]   [ rx_d                        ]
      [ J_dn   -C     ] [ dy ] = [ [ryc; ryd + Dd^{-1} rd] - J_s K_s^{-1} rx_s ]

    with K_s eliminated exactly (diagonal) and
    C = J_s K_s^{-1} J_s^T + blkdiag(delta_cc I, (Dd+delta_wd)^{-1} + delta_cd I).
    Expected inertia (n_d, m_c + m_d, 0). ``host=True`` uses scipy LU +
    eigen inertia; otherwise the blocked no-pivot LDL^T factorizes on the
    solver's device with inertia from the pivot signs."""
    nd = Hdd.shape[0]
    mc, md = Jc_s.shape[0], Jd_s.shape[0]
    dt = Hdd.dtype

    ks = hss + Dxs + delta_wx
    # an INDEFINITE diagonal sparse block is eliminated exactly with its
    # signed inverse; by Haynsworth inertia additivity its negative entries
    # count toward the system's negative eigenvalues (hiopKKTLinSysMDS.cpp:85-96)
    tol_ks = 1e-14
    n_zero_ks = int((ks.abs() <= tol_ks).sum())
    n_neg_ks = int((ks < -tol_ks).sum())
    ks_inv = torch.where(ks.abs() > tol_ks, 1.0 / torch.where(ks == 0, 1.0, ks), 0.0)
    Js = torch.cat([Jc_s, Jd_s], dim=0)
    Jdn = torch.cat([Jc_d, Jd_d], dim=0)
    dd_tot = Dd + delta_wd
    dd_inv = _pos_inv(dd_tot)

    Kd = Hdd + torch.diag(Dxd + delta_wx)
    if js_pairs is not None and js_vals is not None:
        JKJt = schur_js_triplets(js_vals, ks_inv, js_pairs, mc + md)
    else:
        JKJt = (Js * ks_inv) @ Js.T
    C = JKJt + torch.diag(
        torch.cat([torch.full((mc,), float(delta_cc), dtype=dt, device=Hdd.device),
                   dd_inv + delta_cd])
    )
    M = torch.cat([torch.cat([Kd, Jdn.T], dim=1), torch.cat([Jdn, -C], dim=1)], dim=0)

    if n_zero_ks > 0:
        # null eigenvalues in the (1,1) sparse block: singular
        # (n_neg_eig_11 = -1 in the reference, hiopKKTLinSysMDS.cpp:93-96)
        return MdsSafeFactors(None, host, ks_inv, Js, dd_tot, nd, mc, md, -1, False)
    if host:
        lu, piv, n_neg = _lu_with_inertia(M, delta_cc)
        ok = bool(np.all(np.isfinite(lu)))
        return MdsSafeFactors(
            (lu, piv), True, ks_inv, Js, dd_tot, nd, mc, md,
            int(n_neg) + n_neg_ks if n_neg >= 0 else -1, ok,
        )
    f = _ldl.ldl_factor(M)
    ok = bool(f.ok)
    n_neg = int(f.n_neg) + n_neg_ks if ok else -1
    return MdsSafeFactors(f, False, ks_inv, Js, dd_tot, nd, mc, md, n_neg, ok)


def solve_safe(f: MdsSafeFactors, rxs_t, rxd_t, rd_t, ryc, ryd):
    """Direction recovery for :func:`factorize_safe`."""
    nd, mc = f.nd, f.mc
    dd_inv = _pos_inv(f.dd_tot)
    Ksinv_rxs = f.ks_inv * rxs_t
    rhs2 = torch.cat([ryc, ryd + dd_inv * rd_t]) - f.Js @ Ksinv_rxs
    rhs = torch.cat([rxd_t, rhs2])
    if f.host:
        sol = torch.as_tensor(
            sla.lu_solve(f.fact, to_numpy(rhs)), dtype=rhs.dtype, device=rhs.device
        )
    else:
        sol = _ldl.ldl_solve(f.fact, rhs)
    dxd = sol[:nd]
    dy = sol[nd:]
    dyc, dyd = dy[:mc], dy[mc:]
    dxs = f.ks_inv * (rxs_t - f.Js.T @ dy)
    dd = dd_inv * (rd_t + dyd)
    return dxs, dxd, dd, dyc, dyd


def _host(a) -> np.ndarray:
    """Host numpy view of a tensor or array, keeping its dtype."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class MdsSchurHostFactors(NamedTuple):
    """Bordered sparse safe-tier factors (host): the MDS saddle

      M = [ K_d    J_dn^T ]      N = -C,  C = Js Ks^{-1} Js^T (signed)
          [ J_dn   -C     ]               + blkdiag(delta_cc I, Dd_inv + delta_cd)

    is mostly SPARSE — C has the network-local pattern of same-column
    Jacobian nonzero pairs — with only an (m, n_d) dense border from the
    dense block. Factor N with the native inertia-reporting simplicial
    LDL^T (symbolic cached per pattern), Schur the n_d dense columns onto
    S_d = K_d - J_dn^T N^{-1} J_dn (tiny dense sym-indefinite, LAPACK
    sytrf), and combine inertias by Haynsworth additivity:
    n_neg(M) = n_neg(N) + n_neg(S_d). The same structure exploitation as
    the reference's sparse MA57 safe path (hiopKKTLinSysSparse.cpp) rather
    than its dense MAGMA one. Every field is a host numpy object."""
    fact: object          # NativeLdlFactorization of N = -C, or None
    sd_fact: object       # (ldu, ipiv) LAPACK sytrf factors of S_d
    W: object             # (m, n_d) = N^{-1} J_dn
    Jdn: object           # (m, n_d) np
    js_rows: object       # stacked triplet structure of Js (np int)
    js_cols: object
    js_vals: object       # np float64
    ks_inv: object        # (n_s,) np signed inverse
    dd_tot: object        # (m_ineq,) np
    nd: int
    mc: int
    md: int
    host: bool
    n_neg_eig: object     # n_neg(N) + n_neg(S_d) + n_neg(ks); -1 on breakdown
    ok: object


def _sytrf_inertia(ldu, ipiv):
    """(n_pos, n_neg, n_zero) from LAPACK sytrf factors (lower): 1x1 pivots
    by sign, 2x2 pivots (ipiv < 0) by det/trace of the block."""
    n = ldu.shape[0]
    d = np.diag(ldu)
    npos = nneg = nzero = 0
    k = 0
    while k < n:
        if ipiv[k] < 0:
            a11, a22, e = d[k], d[k + 1], ldu[k + 1, k]
            det = a11 * a22 - e * e
            if det < 0:
                npos += 1
                nneg += 1
            elif a11 + a22 > 0:
                npos += 2
            else:
                nneg += 2
            k += 2
        else:
            if d[k] > 0:
                npos += 1
            elif d[k] < 0:
                nneg += 1
            else:
                nzero += 1
            k += 1
    return npos, nneg, nzero


def factorize_safe_schur(
    hss, Hdd, Dxs, Dxd, Dd, Jdn, js_rows, js_cols, js_vals, js_pairs,
    delta_wx, delta_wd, delta_cc, delta_cd, mc: int, md: int,
) -> MdsSchurHostFactors:
    """Bordered sparse factorization of the MDS saddle (see
    :class:`MdsSchurHostFactors`), on the host: tensors are copied off the
    solver's device. Inertia acceptance and breakdown routing follow
    :func:`factorize_safe`'s conventions (``n_neg_eig = -1`` with
    ``ok=True`` routes to the singularity handler)."""
    import scipy.sparse as sp
    from scipy.linalg import lapack as _lapack

    from hiop_tpu_torch.native.ldl import NativeLdlFactorization, SingularError

    hss, Hdd, Dxs, Dxd, Dd, Jdn, js_vals = (
        _host(a).astype(np.float64, copy=False) for a in (hss, Hdd, Dxs, Dxd, Dd, Jdn, js_vals)
    )
    js_rows, js_cols = _host(js_rows), _host(js_cols)
    m = mc + md
    nd = Hdd.shape[0]

    tol_ks = 1e-14
    ks = hss + Dxs + delta_wx
    n_zero_ks = int(np.sum(np.abs(ks) <= tol_ks))
    n_neg_ks = int(np.sum(ks < -tol_ks))
    ks_inv = np.where(np.abs(ks) > tol_ks, 1.0 / np.where(ks == 0, 1.0, ks), 0.0)
    dd_tot = Dd + delta_wd
    dd_inv = np.where(dd_tot > 0, 1.0 / np.maximum(dd_tot, 1e-300), 0.0)

    def fail(n_neg):
        # ok=True + n_neg_eig=-1: the strategy's acceptance test routes this
        # to the SINGULARITY handler (delta_cc bump) — a breakdown of the
        # sparse no-pivot LDL^T on N = -C most often means a rank-deficient
        # Schur block, not wrong curvature. fact=None can never be solved:
        # n_neg_eig=-1 != mc + md guarantees rejection before any solve.
        return MdsSchurHostFactors(
            None, None, None, Jdn, js_rows, js_cols, js_vals, ks_inv,
            dd_tot, nd, mc, md, True, n_neg, True,
        )

    if n_zero_ks > 0:
        return fail(-1)

    # N = -C sparse: pairwise JKJt entries + the diagonal block
    pa, pb, pvar, prow, pcol = (_host(a) for a in js_pairs)
    vals = -(js_vals[pa] * js_vals[pb] * ks_inv[pvar])
    diag = -np.concatenate(
        [np.full(mc, delta_cc), dd_inv + delta_cd]
    )
    rows = np.concatenate([prow, np.arange(m)])
    cols = np.concatenate([pcol, np.arange(m)])
    N = sp.coo_matrix(
        (np.concatenate([vals, diag]), (rows, cols)), shape=(m, m)
    ).tocsc()
    try:
        nf = NativeLdlFactorization(N, ordering="amd")
    except (SingularError, RuntimeError):
        return fail(-1)
    _, n_neg_N, n_zero_N = nf.inertia()
    if n_zero_N > 0:
        return fail(-1)

    W = nf.solve(Jdn) if nd else np.zeros((m, 0))
    Kd = Hdd + np.diag(Dxd + delta_wx)
    Sd = Kd - Jdn.T @ W
    if nd:
        ldu, ipiv, info = _lapack.dsytrf(Sd, lower=1)
        if info != 0 or not np.all(np.isfinite(ldu)):
            return fail(-1)
        _, n_neg_Sd, n_zero_Sd = _sytrf_inertia(ldu, ipiv)
        if n_zero_Sd > 0:
            return fail(-1)
        sd_fact = (ldu, ipiv)
    else:
        sd_fact = None
        n_neg_Sd = 0

    n_neg = n_neg_N + n_neg_Sd + n_neg_ks
    return MdsSchurHostFactors(
        nf, sd_fact, W, Jdn, js_rows, js_cols, js_vals, ks_inv,
        dd_tot, nd, mc, md, True, n_neg, True,
    )


def solve_safe_schur(f: MdsSchurHostFactors, rxs_t, rxd_t, rd_t, ryc, ryd):
    """Direction recovery for :func:`factorize_safe_schur` (host numpy; Js
    enters only through triplet matvecs — no dense (m, n_s) product). The
    directions come back as tensors on the device and in the dtype of
    ``rxs_t``."""
    from scipy.linalg import lapack as _lapack

    like = rxs_t
    rxs, rxd, rd, ryc, ryd = (
        _host(a).astype(np.float64, copy=False) for a in (rxs_t, rxd_t, rd_t, ryc, ryd)
    )
    m = f.mc + f.md
    dd_inv = np.where(f.dd_tot > 0, 1.0 / np.maximum(f.dd_tot, 1e-300), 0.0)

    ks_rxs = f.ks_inv * rxs
    js_ksr = np.zeros(m)
    np.add.at(js_ksr, f.js_rows, f.js_vals * ks_rxs[f.js_cols])
    r2 = np.concatenate([ryc, ryd + dd_inv * rd]) - js_ksr

    t = f.fact.solve(r2)
    if f.nd:
        rhs_d = rxd - f.Jdn.T @ t
        dxd, _ = _lapack.dsytrs(f.sd_fact[0], f.sd_fact[1], rhs_d, lower=1)
        dy = t - f.W @ dxd
    else:
        dxd = rxd[:0]
        dy = t
    jst_dy = np.zeros(f.ks_inv.shape[0])
    np.add.at(jst_dy, f.js_cols, f.js_vals * dy[f.js_rows])
    dxs = f.ks_inv * (rxs - jst_dy)
    dyc, dyd = dy[: f.mc], dy[f.mc:]
    dd = dd_inv * (rd + dyd)
    return tuple(
        torch.as_tensor(a, dtype=like.dtype, device=like.device)
        for a in (dxs, dxd, dd, dyc, dyd)
    )
