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

With ``kkt_fact_dtype=float32`` the strategy casts the operands and runs
the same quick and device safe tiers in f32. The device saddle family
(:func:`factorize_saddle_device` and its mixed-precision forms, dense
:func:`factorize_saddle_device_mp` and operator-form
:func:`factorize_saddle_device_mp_op`, certified by f64 refinement with an
FGMRES escalation) keeps every factor field a tensor and folds the inertia
acceptance into ``ok``; the fused modes
(:mod:`hiop_tpu_torch.optimization.fused_newton`) call it, as
``hiop_tpu``'s fused program does. Its f64 saddle has two routes to
C = J_s K_s^-1 J_s^T: :func:`factorize_saddle_device` forms the dense J_s and
a GEMM over it; :func:`factorize_saddle_triplets` sums the same products
over J_s's same-column nonzero pairs (:class:`JsTriplets`) and reads J_s in
its solves through the nonzeros alone. The lane-batched solve
(:mod:`hiop_tpu_torch.optimization.batch_solve`) takes the triplet route
whenever :func:`js_triplets` gives a structure: no duplicate entries, and
pairs far fewer than the dense product's multiply-adds
(``TRIPLET_SHARE``); the fused modes keep the dense route.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.linalg as sla
import torch

from hiop_tpu_torch.formulation.base import to_numpy
from hiop_tpu_torch.kkt.newton_dense import _cap_at_dual_reg, _eye, _full, _lu_with_inertia, _pos_inv
from hiop_tpu_torch.linalg import ldl_blocked as _ldl
from hiop_tpu_torch.linalg.cholesky import cholesky as _chol
from hiop_tpu_torch.linalg.vector_ops import scatter_add_
from hiop_tpu_torch.utils.dtensor import plain


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


def schur_js_triplets_sharded(js_vals, ks_inv, pairs, m: int, mesh):
    """Mesh-sharded triplet Schur assembly: the pair list is partitioned
    over the mesh's ranks (padded with zero-weight pairs), each rank
    scatter-adds its partial (m, m) sum with the deterministic scatter-add,
    and one all-reduce (a ``Partial`` DTensor made ``Replicate``) gives the
    replicated Schur matrix (``hiop_tpu``'s shard_map + psum; SURVEY.md
    §2.9: partial local products and an allreduce, here over same-column
    nonzero pairs). The replicated S then feeds the replicated Cholesky,
    the reference's replicated small solve. ``js_vals`` and ``ks_inv`` are
    the same on every rank (plain tensors or replicated DTensors)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    vals, kinv = plain(js_vals), plain(ks_inv)
    n_dev, r = mesh.size(), mesh.get_local_rank()
    n_pairs = pairs[0].numel()
    per = -(-n_pairs // n_dev)
    lo, hi = min(r * per, n_pairs), min((r + 1) * per, n_pairs)
    # this rank's block, padded to ``per`` pairs that index entry 0 and
    # write through a zero weight
    pad = per - (hi - lo)
    pa, pb, pvar, prow, pcol = (
        torch.cat([a[lo:hi], a.new_zeros(pad)]) for a in pairs
    )
    w = (torch.arange(per, device=vals.device) < hi - lo).to(vals.dtype)
    prod = vals[pa] * vals[pb] * kinv[pvar] * w
    part = scatter_add_(torch.zeros((m * m,), dtype=vals.dtype, device=vals.device),
                        prow * m + pcol, prod)
    S = DTensor.from_local(part, mesh, [Partial()], run_check=False).redistribute(mesh, [Replicate()])
    return S.reshape(m, m)


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
    S = JKJt + Jdn @ KdinvJT + torch.diag(torch.cat([_full(mc, delta_cc, Hdd), dd_inv + delta_cd]))
    Ls = _chol(S)
    diag_s = torch.diagonal(Ls)
    if mc + md:
        scale_s = torch.sqrt(torch.clamp(S.abs().max(), min=1e-300))
        min_diag = diag_s.abs().min()
    else:
        scale_s = S.new_tensor(1.0)
        min_diag = S.new_tensor(float("inf"))
    thresh = _cap_at_dual_reg((torch.finfo(dt).eps ** 0.5) * scale_s * 1e-2, delta_cc)
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


#: |K_s| entries at or below this are null: the saddle is singular
TOL_KS = 1e-14


def _ks_inertia(ks):
    """(ks_ok, n_neg_ks) of the eliminated diagonal block K_s as tensors: an
    INDEFINITE block is eliminated exactly with its signed inverse, and by
    Haynsworth inertia additivity its negative entries count toward the
    system's negative eigenvalues (hiopKKTLinSysMDS.cpp:85-96)."""
    return (ks.abs() > TOL_KS).all(), (ks < -TOL_KS).sum()


def _signed_inv(ks):
    """1/ks on the entries of K_s above TOL_KS in magnitude, else 0."""
    return torch.where(ks.abs() > TOL_KS, 1.0 / torch.where(ks == 0, 1.0, ks), 0.0)


def _diag_c(mc, dd_inv, delta_cc, delta_cd):
    """The diagonal of C beyond Js Ks^-1 Js^T: [delta_cc I; dd_inv + delta_cd]."""
    return torch.cat([_full(mc, delta_cc, dd_inv), dd_inv + delta_cd])


def _saddle(Kd, Jdn, neg_c):
    """[[K_d, J_dn^T], [J_dn, -C]] from ``neg_c`` = -C."""
    return torch.cat([torch.cat([Kd, Jdn.T], dim=1), torch.cat([Jdn, neg_c], dim=1)], dim=0)


def _dense_saddle(hss, Hdd, Dxs, Dxd, Dd, Jc_s, Jc_d, Jd_s, Jd_d,
                  delta_wx, delta_wd, delta_cc, delta_cd, js_vals=None, js_pairs=None):
    """The reduced MDS saddle M = [[K_d, J_dn^T], [J_dn, -C]] and the
    operands its solves need: (ks, ks_inv, Js, Jdn, dd_tot, M), ks_inv the
    signed inverse of K_s (0 on its null entries)."""
    mc, md = Jc_s.shape[0], Jd_s.shape[0]
    ks = hss + Dxs + delta_wx
    ks_inv = _signed_inv(ks)
    Js = torch.cat([Jc_s, Jd_s], dim=0)
    Jdn = torch.cat([Jc_d, Jd_d], dim=0)
    dd_tot = Dd + delta_wd
    Kd = Hdd + torch.diag(Dxd + delta_wx)
    if js_pairs is not None and js_vals is not None:
        JKJt = schur_js_triplets(js_vals, ks_inv, js_pairs, mc + md)
    else:
        JKJt = (Js * ks_inv) @ Js.T
    C = JKJt + torch.diag(_diag_c(mc, _pos_inv(dd_tot), delta_cc, delta_cd))
    return ks, ks_inv, Js, Jdn, dd_tot, _saddle(Kd, Jdn, -C)


def _js_mv(f, u, js):
    """J_s u: through the factors' dense ``Js``, or, given the structure
    ``js`` (:class:`JsTriplets`), through their ``js_vals``."""
    if js is None:
        return f.Js @ u
    return _seg_sum(f.js_vals * u[js.cols], js.row_nz)


def _jst_mv(f, v, js):
    """J_s^T v, as :func:`_js_mv`."""
    if js is None:
        return f.Js.T @ v
    return _seg_sum(f.js_vals * v[js.rows], js.col_nz)


def _saddle_rhs(f, rxs_t, rxd_t, rd_t, ryc, ryd, js=None):
    """The saddle's right-hand side [rx_d; [ryc; ryd + Dd^-1 rd] - J_s K_s^-1
    rx_s] and Dd^-1, for factors with fields ``ks_inv``, ``dd_tot`` and
    ``Js`` (or ``js_vals`` with ``js``)."""
    dd_inv = _pos_inv(f.dd_tot)
    rhs_y = torch.cat([ryc, ryd + dd_inv * rd_t]) - _js_mv(f, f.ks_inv * rxs_t, js)
    return torch.cat([rxd_t, rhs_y]), dd_inv


def _saddle_direction(f, sol, nd: int, mc: int, rxs_t, rd_t, dd_inv, js=None):
    """(dxs, dxd, dd, dyc, dyd) from the saddle's solution [dx_d; dy]."""
    dxd = sol[:nd]
    dy = sol[nd:]
    dyc, dyd = dy[:mc], dy[mc:]
    dxs = f.ks_inv * (rxs_t - _jst_mv(f, dy, js))
    dd = dd_inv * (rd_t + dyd)
    return dxs, dxd, dd, dyc, dyd


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
    ks, ks_inv, Js, _, dd_tot, M = _dense_saddle(
        hss, Hdd, Dxs, Dxd, Dd, Jc_s, Jc_d, Jd_s, Jd_d,
        delta_wx, delta_wd, delta_cc, delta_cd, js_vals, js_pairs,
    )
    if int((ks.abs() <= TOL_KS).sum()) > 0:
        # null eigenvalues in the (1,1) sparse block: singular
        # (n_neg_eig_11 = -1 in the reference, hiopKKTLinSysMDS.cpp:93-96)
        return MdsSafeFactors(None, host, ks_inv, Js, dd_tot, nd, mc, md, -1, False)
    n_neg_ks = int(_ks_inertia(ks)[1])
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
    rhs, dd_inv = _saddle_rhs(f, rxs_t, rxd_t, rd_t, ryc, ryd)
    if f.host:
        sol = torch.as_tensor(
            sla.lu_solve(f.fact, to_numpy(rhs)), dtype=rhs.dtype, device=rhs.device
        )
    else:
        sol = _ldl.ldl_solve(f.fact, rhs)
    return _saddle_direction(f, sol, f.nd, f.mc, rxs_t, rd_t, dd_inv)


# ---------------------------------------------------------------------------
# device saddle family: every factor field a tensor, inertia acceptance
# folded into ``ok``, no host synchronization in the factorizations
# ---------------------------------------------------------------------------
def _row_max_scale(M, floor):
    """Symmetric row-max equilibration s = 1/sqrt(max_j |M_ij|) (1 on zero
    rows), and the row maxima: s M s is a congruence, so it keeps the
    inertia."""
    rmax = M.abs().amax(dim=1)
    return torch.where(rmax > 0, 1.0 / torch.sqrt(torch.clamp(rmax, min=floor)), 1.0), rmax


class MdsSaddleDeviceFactors(NamedTuple):
    """MDS saddle factors with every field a tensor (the counterpart of
    ``hiop_tpu``'s traceable factors, which flow through the fused
    program's ``lax.while_loop`` carries): the diagonal sparse block
    eliminated with its SIGNED inverse, the (n_d + m) saddle factorized by
    the no-pivot LDL^T kernel, inertia by pivot signs + Haynsworth
    additivity for the eliminated diagonal.

    The saddle is symmetrically row-max equilibrated before factorization
    (a congruence, inertia preserved; ``s`` holds the scale): without it
    the no-pivot breakdown test (pivot magnitude vs eps * max|M|) misfires
    on barrier-scaled saddles whose row scales span ~1e9."""
    L: torch.Tensor        # unit-lower LDL factor of s M s (padded)
    d: torch.Tensor        # pivots (padded)
    s: torch.Tensor        # (nd+m,) equilibration scale
    ks_inv: torch.Tensor
    Js: torch.Tensor
    Jdn: torch.Tensor
    dd_tot: torch.Tensor
    ok: torch.Tensor       # finite factorization AND inertia == mc + md


def factorize_saddle_device(
    hss, Hdd, Dxs, Dxd, Dd, Jc_s, Jc_d, Jd_s, Jd_d,
    delta_wx, delta_wd, delta_cc, delta_cd,
) -> MdsSaddleDeviceFactors:
    """:func:`factorize_safe` (device branch) with the inertia acceptance
    folded into ``ok``: the factorization is finite AND n_neg(saddle) +
    n_neg(eliminated diagonal) == mc + md, the reference's
    hiopFactAcceptorIC criterion evaluated on the device."""
    m = Jc_s.shape[0] + Jd_s.shape[0]
    ks, ks_inv, Js, Jdn, dd_tot, M = _dense_saddle(
        hss, Hdd, Dxs, Dxd, Dd, Jc_s, Jc_d, Jd_s, Jd_d,
        delta_wx, delta_wd, delta_cc, delta_cd,
    )
    f, s, ok = _ldl_saddle(ks, M, m)
    return MdsSaddleDeviceFactors(f.L, f.d, s, ks_inv, Js, Jdn, dd_tot, ok)


def _ldl_saddle(ks, M, m: int):
    """The no-pivot LDL^T of the equilibrated saddle s M s: (factors, s, ok),
    ``ok`` the finite factorization AND n_neg(saddle) + n_neg(K_s) == m."""
    ks_ok, n_neg_ks = _ks_inertia(ks)
    s, _ = _row_max_scale(M, 1e-300)
    f = _ldl.ldl_factor(s[:, None] * M * s[None, :])
    return f, s, f.ok & ks_ok & (f.n_neg + n_neg_ks == m)


def _ldl_of(f, n):
    return _ldl.LdlFactors(f.L, f.d, n, f.d.new_zeros((), dtype=torch.int64), f.ok)


def solve_saddle_device(f, rxs_t, rxd_t, rd_t, ryc, ryd, js=None):
    """Direction recovery for :func:`factorize_saddle_device`, or, given
    the structure ``js``, for :func:`factorize_saddle_triplets`: J_s then
    enters the right-hand side and the x_s back-substitution through its
    triplets."""
    rhs, dd_inv = _saddle_rhs(f, rxs_t, rxd_t, rd_t, ryc, ryd, js)
    sol = f.s * _ldl.ldl_solve(_ldl_of(f, rhs.shape[0]), f.s * rhs)
    return _saddle_direction(f, sol, rxd_t.shape[0], ryc.shape[0], rxs_t, rd_t, dd_inv, js)


# ---------------------------------------------------------------------------
# the triplet route of the device saddle: J_s only through its nonzeros
# ---------------------------------------------------------------------------
#: The triplet route is taken when the same-column pairs number at most
#: this share of the dense product's m * m * n_s multiply-adds: a pair costs
#: a few gathered loads where the GEMM spends one tensor-core multiply-add.
TRIPLET_SHARE = 1e-2


class JsTriplets(NamedTuple):
    """The sparse block J_s = [Jc_s; Jd_s] of an MDS formulation as
    triplets, with fixed-shape index plans for the triplet route
    (:func:`factorize_saddle_triplets`). Each sum it forms is a gather into
    a padded (targets, k) array and a sum over its last axis: the order of
    summation is fixed at build time, and a call neither sorts nor adds
    atomically. Every lane of a family shares it; an index equal to the
    length of the gathered vector reads a zero."""
    eq_rc: tuple           # (rows, cols) of the nonzeros in Jc
    in_rc: tuple           # (rows, cols) of the nonzeros in Jd
    rows: torch.Tensor     # (nnz,) stacked row of each nonzero, [eq; m_eq + ineq]
    cols: torch.Tensor     # (nnz,) its column
    pa: torch.Tensor       # (P,) same-column pairs of nonzeros (a, b) and
    pb: torch.Tensor       #      their column, as :func:`build_schur_pairs`
    pvar: torch.Tensor
    c_pairs: torch.Tensor  # (T, k) the pairs summed into each entry C holds
    c_diag: torch.Tensor   # (T,) the entry's row if on the diagonal, else m
    c_flat: torch.Tensor   # (T,) its position row * m + col in C
    row_nz: torch.Tensor   # (m, k) the nonzeros of each row
    col_nz: torch.Tensor   # (n_s, k) the nonzeros of each column


def _padded_groups(keys, n_keys: int) -> np.ndarray:
    """(n_keys, k): row j lists, ascending, the positions i with keys[i] == j,
    padded with len(keys)."""
    counts = np.bincount(keys, minlength=n_keys)
    order = np.argsort(keys, kind="stable")
    starts = np.cumsum(counts) - counts
    slot = np.arange(keys.size) - np.repeat(starts, counts)
    out = np.full((n_keys, max(int(counts.max(initial=0)), 1)), keys.size, dtype=np.int64)
    out[keys[order], slot] = order
    return out


def _seg_sum(vals, groups):
    """The sum of ``vals`` over each row of ``groups`` (:func:`_padded_groups`)."""
    return torch.cat([vals, vals.new_zeros((1,))])[groups].sum(-1)


def stacked_js(nlp):
    """(rows, cols) of J_s's nonzeros in the stacked [eq; m_eq + ineq] row
    order, as int64 numpy arrays."""
    rows = np.concatenate([
        np.asarray(nlp.jac_sp_eq_rows, dtype=np.int64),
        nlp.m_eq + np.asarray(nlp.jac_sp_in_rows, dtype=np.int64),
    ])
    cols = np.concatenate([
        np.asarray(nlp.jac_sp_eq_cols, dtype=np.int64),
        np.asarray(nlp.jac_sp_in_cols, dtype=np.int64),
    ])
    return rows, cols


def js_triplets(nlp):
    """The :class:`JsTriplets` of an NlpMDS formulation on its device, or
    None where the dense product is the route: :func:`build_schur_pairs`
    declines (duplicate entries, no pairs), or the pairs exceed
    ``TRIPLET_SHARE`` of the product's multiply-adds."""
    rows, cols = stacked_js(nlp)
    m, ns = nlp.m, nlp.n_sparse
    pairs = build_schur_pairs(rows, cols, ns)
    if pairs is None or pairs[0].numel() > TRIPLET_SHARE * m * m * ns:
        return None
    pa, pb, pvar, prow, pcol = (p.numpy() for p in pairs)
    # the entries of C: every pair's target, and the whole diagonal
    flat = np.unique(np.concatenate([prow * m + pcol, np.arange(m) * (m + 1)]))
    diag = np.where(flat // m == flat % m, flat // m, m)
    c_pairs = _padded_groups(np.searchsorted(flat, prow * m + pcol), flat.size)
    dev = nlp.device

    def on(a):
        return torch.as_tensor(a, device=dev)

    return JsTriplets(
        nlp._jac_eq_rc_t, nlp._jac_in_rc_t, on(rows), on(cols), on(pa), on(pb), on(pvar),
        on(c_pairs), on(diag), on(flat), on(_padded_groups(rows, m)),
        on(_padded_groups(cols, ns)),
    )


def js_values(Jc, Jd, js: JsTriplets):
    """J_s's nonzeros in the order of ``js``, read from the dense Jacobian
    blocks (sparse columns first)."""
    return torch.cat([Jc[js.eq_rc], Jd[js.in_rc]])


def _triplet_saddle(hss, Hdd, Dxs, Dxd, Dd, Jc_d, Jd_d, js_vals, js: JsTriplets,
                    delta_wx, delta_wd, delta_cc, delta_cd):
    """:func:`_dense_saddle` with C assembled from J_s's triplets: (ks,
    ks_inv, Jdn, dd_tot, M). Each entry of C sums the dense route's
    products (J_s[r, c] K_s^-1[c]) J_s[r', c] over the columns where both
    are nonzero, then adds the diagonal; J_s itself is never dense."""
    mc = Jc_d.shape[0]
    m = mc + Jd_d.shape[0]
    ks = hss + Dxs + delta_wx
    ks_inv = _signed_inv(ks)
    Jdn = torch.cat([Jc_d, Jd_d], dim=0)
    dd_tot = Dd + delta_wd
    Kd = Hdd + torch.diag(Dxd + delta_wx)
    prod = js_vals[js.pa] * ks_inv[js.pvar] * js_vals[js.pb]
    diag_c = _diag_c(mc, _pos_inv(dd_tot), delta_cc, delta_cd)
    c_vals = _seg_sum(prod, js.c_pairs) + torch.cat([diag_c, diag_c.new_zeros((1,))])[js.c_diag]
    neg_c = js_vals.new_zeros((m * m,)).index_put((js.c_flat,), -c_vals).reshape(m, m)
    return ks, ks_inv, Jdn, dd_tot, _saddle(Kd, Jdn, neg_c)


class MdsSaddleTripletFactors(NamedTuple):
    """:class:`MdsSaddleDeviceFactors` of the triplet route: J_s's nonzeros
    in place of the dense ``Js``."""
    L: torch.Tensor
    d: torch.Tensor
    s: torch.Tensor
    ks_inv: torch.Tensor
    js_vals: torch.Tensor  # (nnz,) in the order of the JsTriplets
    Jdn: torch.Tensor
    dd_tot: torch.Tensor
    ok: torch.Tensor


def factorize_saddle_triplets(
    hss, Hdd, Dxs, Dxd, Dd, Jc_d, Jd_d, js_vals, js: JsTriplets,
    delta_wx, delta_wd, delta_cc, delta_cd,
) -> MdsSaddleTripletFactors:
    """:func:`factorize_saddle_device` with J_s K_s^-1 J_s^T assembled from
    the triplets (:func:`_triplet_saddle`): the same saddle M up to the
    order of summation, the same equilibration, LDL^T and inertia test, and
    no dense J_s, no copy of it and no GEMM over it."""
    m = Jc_d.shape[0] + Jd_d.shape[0]
    ks, ks_inv, Jdn, dd_tot, M = _triplet_saddle(
        hss, Hdd, Dxs, Dxd, Dd, Jc_d, Jd_d, js_vals, js,
        delta_wx, delta_wd, delta_cc, delta_cd,
    )
    f, s, ok = _ldl_saddle(ks, M, m)
    return MdsSaddleTripletFactors(f.L, f.d, s, ks_inv, js_vals, Jdn, dd_tot, ok)



class MdsSaddleDeviceMpFactors(NamedTuple):
    """Mixed-precision saddle factors: the f64 saddle M is symmetrically
    row-max equilibrated (a congruence, inertia preserved), cast to f32 and
    factorized by the no-pivot LDL^T kernel in f32; M itself is kept for
    the f64 iterative-refinement matvecs. The ReSolve pattern (f32
    factorization + f64 IR certification, ReSolve/RefactorizationSolver.hpp:74,
    IterativeRefinement.hpp:25) on the device."""
    L: torch.Tensor        # f32 unit-lower LDL factor (padded)
    d: torch.Tensor        # f32 pivots (padded)
    s: torch.Tensor        # (nd+m,) f64 equilibration scale
    M: torch.Tensor        # (nd+m, nd+m) f64 saddle (IR operator)
    ks_inv: torch.Tensor
    Js: torch.Tensor
    Jdn: torch.Tensor
    dd_tot: torch.Tensor
    ok: torch.Tensor       # finite f32 factorization AND inertia == mc + md
    n_neg: torch.Tensor    # f32 pivot-sign negative count incl. eliminated diag


def factorize_saddle_device_mp(
    hss, Hdd, Dxs, Dxd, Dd, Jc_s, Jc_d, Jd_s, Jd_d,
    delta_wx, delta_wd, delta_cc, delta_cd, count_inertia: bool = True,
) -> MdsSaddleDeviceMpFactors:
    """Mixed-precision :func:`factorize_saddle_device`: assemble the saddle
    in f64, equilibrate, factorize in f32. The inertia acceptance is folded
    into ``ok`` as in the f64 variant (D M D is a congruence, so the f32
    pivot signs count the same inertia). ``count_inertia=False`` drops the
    count from ``ok`` (finite factorization only) for the inertia-free
    curvature acceptance, where the caller tests the direction instead."""
    m = Jc_s.shape[0] + Jd_s.shape[0]
    ks, ks_inv, Js, Jdn, dd_tot, M = _dense_saddle(
        hss, Hdd, Dxs, Dxd, Dd, Jc_s, Jc_d, Jd_s, Jd_d,
        delta_wx, delta_wd, delta_cc, delta_cd,
    )
    ks_ok, n_neg_ks = _ks_inertia(ks)
    # the barrier diagonals blow up as mu -> 0; scaling the huge rows to
    # unit max keeps the f32 factorization's condition number far below
    # 1/eps_f32 deep into the barrier trajectory
    s, _ = _row_max_scale(M, 1e-300)
    f = _ldl.ldl_factor((s[:, None] * M * s[None, :]).to(torch.float32))
    ok = f.ok & ks_ok
    if count_inertia:
        ok = ok & (f.n_neg + n_neg_ks == m)
    return MdsSaddleDeviceMpFactors(
        f.L, f.d, s, M, ks_inv, Js, Jdn, dd_tot, ok, f.n_neg + n_neg_ks
    )


def _mp_solve32(f, n: int, dt):
    """r -> s * (f32 solve of (s M s) y = s r), back in ``dt``."""
    lf = _ldl_of(f, n)

    def solve32(r):
        y32 = _ldl.ldl_solve(lf, (f.s * r).to(torch.float32))
        return f.s * y32.to(dt)

    return solve32


def _mp_solve_refined(f: MdsSaddleDeviceMpFactors, rhs,
                      ir_tol: float = 1e-9, max_ir: int = 8):
    """Solve M x = rhs through the equilibrated f32 factors with f64
    iterative refinement. Returns (x, certified): ``certified`` is the f64
    relative residual test ||rhs - M x|| <= ir_tol * (||rhs|| +
    ||M||_max ||x||), a backward-error bound that ``hiop_tpu`` keeps
    although it can certify poor directions late in the barrier (the
    operator form, :func:`_mp_solve_refined_op`, normalizes by ||rhs||).
    The loop stops at the first certified iterate or after ``max_ir``
    steps (one host read per step, :func:`_read_ir`)."""
    solve32 = _mp_solve32(f, rhs.shape[0], rhs.dtype)
    m_norm = f.M.abs().max()
    b_norm = torch.linalg.norm(rhs)

    def relres(x, r):
        return torch.linalg.norm(r) / torch.clamp(b_norm + m_norm * torch.linalg.norm(x), min=1e-300)

    x = solve32(rhs)
    r = rhs - f.M @ x
    k = 0
    more, certified = _read_ir(relres(x, r), x, ir_tol)
    while k < max_ir and more:
        x = x + solve32(r)
        r = rhs - f.M @ x
        k += 1
        more, certified = _read_ir(relres(x, r), x, ir_tol)
    return x, certified


def _read_ir(rel, x, ir_tol: float):
    """One host read for a refinement step: (refine again, certified), i.e.
    rel > ir_tol, and rel <= ir_tol with x finite (a NaN residual does
    neither)."""
    more, conv, finite = torch.stack([rel > ir_tol, rel <= ir_tol, torch.isfinite(x).all()]).tolist()
    return bool(more), bool(conv) and bool(finite)


def solve_saddle_device_mp(f: MdsSaddleDeviceMpFactors, rxs_t, rxd_t, rd_t,
                           ryc, ryd, ir_tol: float = 1e-9):
    """Direction recovery for :func:`factorize_saddle_device_mp` with IR
    certification; returns (dxs, dxd, dd, dyc, dyd, certified)."""
    rhs, dd_inv = _saddle_rhs(f, rxs_t, rxd_t, rd_t, ryc, ryd)
    sol, certified = _mp_solve_refined(f, rhs, ir_tol=ir_tol)
    return (*_saddle_direction(f, sol, rxd_t.shape[0], ryc.shape[0], rxs_t, rd_t, dd_inv),
            certified)


def mds_js_struct(nlp):
    """The sparse-block triplet structure of an NlpMDS formulation for the
    operator-form mp path: (js_rows, js_cols, schur_pairs), int64 tensors on
    the formulation's device with rows in the stacked [eq; m_eq + ineq]
    order, or None when :func:`build_schur_pairs` declines. Cached on the
    formulation."""
    cached = getattr(nlp, "_js_struct_cache", "miss")
    if cached != "miss":
        return cached
    sr, sc = stacked_js(nlp)
    pairs = build_schur_pairs(sr, sc, nlp.n_sparse, device=nlp.device)
    out = None
    if pairs is not None:
        out = (
            torch.as_tensor(sr, device=nlp.device),
            torch.as_tensor(sc, device=nlp.device),
            pairs,
        )
    nlp._js_struct_cache = out
    return out


class MdsSaddleDeviceMpOpFactors(NamedTuple):
    """Memory-lean mixed-precision factors: the f64 saddle is never
    materialized. The iterative-refinement operator stays in OPERATOR FORM
    over the original f64 operands (Kd, the dense border Jdn, the
    sparse-block triplet values, the eliminated diagonal), as the
    reference's ReSolve IR matvecs against the original CSR operands
    (ReSolve/IterativeRefinement.hpp:25). Only the equilibrated f32 saddle
    is ever dense, and each IR matvec costs O(nd^2 + m*nd + nnz) instead of
    the dense (nd+m)^2. The triplet structure (js_rows, js_cols) is passed
    to the solve functions, not stored here."""
    L: torch.Tensor        # f32 unit-lower LDL factor (padded)
    d: torch.Tensor        # f32 pivots (padded)
    s: torch.Tensor        # (nd+m,) f64 equilibration scale
    m_norm: torch.Tensor   # f64 scalar ~ max |M|
    Kd: torch.Tensor       # (nd, nd) f64 dense block
    Jdn: torch.Tensor      # (m, nd) f64 dense border
    js_vals: torch.Tensor  # (nnz,) f64 sparse-block triplet values ([eq; ineq])
    diagC: torch.Tensor    # (m,) f64 diagonal of C beyond Js Ks^-1 Js^T
    ks_inv: torch.Tensor   # (n_s,) f64 signed inverse of the eliminated block
    dd_tot: torch.Tensor
    ok: torch.Tensor       # finite f32 factorization AND inertia == mc + md
    n_neg: torch.Tensor    # f32 pivot-sign negative count INCL. the eliminated
                           # diagonal; near-zero pivots make it noisy in f32


def factorize_saddle_device_mp_op(
    hss, Hdd, Dxs, Dxd, Dd, Jc_d, Jd_d, js_vals, js_pairs,
    delta_wx, delta_wd, delta_cc, delta_cd, count_inertia: bool = True,
) -> MdsSaddleDeviceMpOpFactors:
    """Operator-form :func:`factorize_saddle_device_mp`: the block
    C = Js Ks^{-1} Js^T is assembled DIRECTLY IN f32 from the same-column
    triplet pairs (products in f64, a deterministic scatter-add in f32),
    the saddle is equilibrated and factorized by the no-pivot LDL^T kernel
    in f32, and the factors carry the f64 operands instead of a dense f64
    copy."""
    mc, md = Jc_d.shape[0], Jd_d.shape[0]
    m = mc + md
    f32 = torch.float32
    ks = hss + Dxs + delta_wx
    ks_ok, n_neg_ks = _ks_inertia(ks)
    ks_inv = _signed_inv(ks)
    Jdn = torch.cat([Jc_d, Jd_d], dim=0)
    dd_tot = Dd + delta_wd
    dd_inv = _pos_inv(dd_tot)
    diagC = _diag_c(mc, dd_inv, delta_cc, delta_cd)
    Kd = Hdd + torch.diag(Dxd + delta_wx)

    pa, pb, pvar, prow, pcol = js_pairs
    prod32 = (js_vals[pa] * js_vals[pb] * ks_inv[pvar]).to(f32)
    flat = torch.zeros((m * m,), dtype=f32, device=Hdd.device)
    C32 = scatter_add_(flat, prow * m + pcol, prod32).reshape(m, m) + torch.diag(diagC.to(f32))
    Ms = _saddle(Kd.to(f32), Jdn.to(f32), -C32)
    s32, rmax = _row_max_scale(Ms, 1e-30)
    f = _ldl.ldl_factor(s32[:, None] * Ms * s32[None, :])
    ok = f.ok & ks_ok
    if count_inertia:
        ok = ok & (f.n_neg + n_neg_ks == mc + md)
    dt = Hdd.dtype
    return MdsSaddleDeviceMpOpFactors(
        f.L, f.d, s32.to(dt), rmax.max().to(dt),
        Kd, Jdn, js_vals, diagC, ks_inv, dd_tot, ok, f.n_neg + n_neg_ks,
    )


def _op_matvec(f: MdsSaddleDeviceMpOpFactors, js_rows, js_cols, v):
    """f64 saddle matvec in operator form:
    M [vd; vy] = [Kd vd + Jdn^T vy; Jdn vd - (Js Ks^{-1} Js^T + diagC) vy]
    with Js applied through its triplets (two deterministic scatter-adds)."""
    nd = f.Kd.shape[0]
    vd, vy = v[:nd], v[nd:]
    top = f.Kd @ vd + f.Jdn.T @ vy
    jt = scatter_add_(torch.zeros_like(f.ks_inv, dtype=v.dtype), js_cols, f.js_vals * vy[js_rows])
    cy = scatter_add_(torch.zeros_like(vy), js_rows, f.js_vals * (f.ks_inv * jt)[js_cols])
    return torch.cat([top, f.Jdn @ vd - cy - f.diagC * vy])


def _fgmres_y(H, beta, K: int):
    """The GMRES least squares min ||beta e1 - H y|| by regularized normal
    equations (H^T H + eps I) y = H^T beta e1: zero columns (iterations not
    built, or a breakdown) get y = 0 through the regularization. A (K, K)
    Cholesky (the reference chose it over an SVD-based lstsq on the TPU;
    it squares cond(H), which the reference accepts)."""
    dt = H.dtype
    e1 = torch.zeros((H.shape[0],), dtype=dt, device=H.device)
    e1[0] = beta
    G = H.T @ H
    g = H.T @ e1
    scale = torch.clamp(G.abs().max(), min=1e-300)
    G = G + (1e-14 * scale) * torch.eye(K, dtype=dt, device=H.device)
    c = torch.linalg.cholesky(G)
    return torch.cholesky_solve(g[:, None], c)[:, 0]


def _fgmres_device(matvec, precond, rhs, x0, K: int, tol_abs):
    """Early-exit flexible GMRES (the escalation stage of the IR
    certification, run only when plain refinement fails): CGS2
    orthogonalization in a loop that stops as soon as the projected
    residual |g_{j+1}| of the small least squares drops under ``tol_abs``
    (one host read to start, then one per iteration). Returns (x, n_iter)."""
    n = rhs.shape[0]
    dt = rhs.dtype
    r0 = rhs - matvec(x0)
    beta = torch.linalg.norm(r0)
    V = torch.zeros((K + 1, n), dtype=dt, device=rhs.device)
    V[0] = r0 / torch.clamp(beta, min=1e-300)
    Z = torch.zeros((K, n), dtype=dt, device=rhs.device)
    H = torch.zeros((K + 1, K), dtype=dt, device=rhs.device)
    e1 = torch.zeros((K + 1,), dtype=dt, device=rhs.device)
    e1[0] = beta
    if isinstance(tol_abs, torch.Tensor):
        tol_abs, res = torch.stack([tol_abs.double(), beta.double()]).tolist()
    else:
        tol_abs, res = float(tol_abs), float(beta)
    j = 0
    while res > tol_abs and j < K:
        z = precond(V[j])
        w = matvec(z)
        h1 = V @ w
        w = w - V.T @ h1
        h2 = V @ w
        w = w - V.T @ h2
        hn = torch.linalg.norm(w)
        V[j + 1] = w / torch.clamp(hn, min=1e-300)
        col = h1 + h2
        col[j + 1] += hn
        H[:, j] = col
        Z[j] = z
        # projected residual of min ||beta e1 - H y|| through the tiny
        # normal-equations solve (K x K work next to the matvec above)
        y = _fgmres_y(H, beta, K)
        res = float(torch.linalg.norm(e1 - H @ y))
        j += 1
    y = _fgmres_y(H, beta, K)
    return x0 + Z.T @ y, j


def _mp_solve_refined_op(f: MdsSaddleDeviceMpOpFactors, js_rows, js_cols, rhs,
                         ir_tol: float = 1e-9, max_ir: int = 4,
                         fgmres_k: int = 16):
    """Solve M x = rhs through the equilibrated f32 factors with f64
    OPERATOR-FORM iterative refinement, escalating to a fixed-K FGMRES
    cycle (the f32 solve as right preconditioner) when plain IR fails.
    Returns (x, certified, n_ir) where n_ir counts refinement steps (FGMRES
    counted as its inner iterations).

    Certification normalizes by ||rhs|| ALONE, not by the backward-error
    bound ||rhs|| + ||M|| ||x|| of :func:`_mp_solve_refined`: with
    late-barrier diagonals ~1e9 that bound lets an absolute residual of
    order ||x|| certify with zero refinement steps."""
    solve32 = _mp_solve32(f, rhs.shape[0], rhs.dtype)

    def matvec(v):
        return _op_matvec(f, js_rows, js_cols, v)

    b_norm = torch.linalg.norm(rhs)

    def relres(r):
        return torch.linalg.norm(r) / torch.clamp(b_norm, min=1e-300)

    x = solve32(rhs)
    r = rhs - matvec(x)
    k = 0
    more, certified = _read_ir(relres(r), x, ir_tol)
    while k < max_ir and more:
        x = x + solve32(r)
        r = rhs - matvec(x)
        k += 1
        more, certified = _read_ir(relres(r), x, ir_tol)
    if fgmres_k > 0 and not certified:
        x_f, n_f = _fgmres_device(matvec, solve32, rhs, x, fgmres_k, ir_tol * b_norm)
        # a diverged FGMRES (breakdown) must not replace a finite iterate
        x = torch.where(torch.isfinite(x_f).all(), x_f, x)
        r = rhs - matvec(x)
        k += n_f
        certified = _read_ir(relres(r), x, ir_tol)[1]
    return x, certified, k


def solve_saddle_device_mp_op(f: MdsSaddleDeviceMpOpFactors, js_rows, js_cols,
                              rxs_t, rxd_t, rd_t, ryc, ryd,
                              ir_tol: float = 1e-9, fgmres_k: int = 16):
    """Direction recovery for :func:`factorize_saddle_device_mp_op`; Js
    enters the rhs reduction and the x_s back-substitution through its
    triplets only. Returns (dxs, dxd, dd, dyc, dyd, certified, n_ir)."""
    nd = rxd_t.shape[0]
    mc = ryc.shape[0]
    m = f.Jdn.shape[0]
    dd_inv = _pos_inv(f.dd_tot)
    u = f.ks_inv * rxs_t
    js_u = scatter_add_(u.new_zeros((m,)), js_rows, f.js_vals * u[js_cols])
    rhs = torch.cat([rxd_t, torch.cat([ryc, ryd + dd_inv * rd_t]) - js_u])
    sol, certified, n_ir = _mp_solve_refined_op(
        f, js_rows, js_cols, rhs, ir_tol=ir_tol, fgmres_k=fgmres_k
    )
    dxd = sol[:nd]
    dy = sol[nd:]
    dyc, dyd = dy[:mc], dy[mc:]
    jst_dy = scatter_add_(torch.zeros_like(f.ks_inv), js_cols, f.js_vals * dy[js_rows])
    dxs = f.ks_inv * (rxs_t - jst_dy)
    dd = dd_inv * (rd_t + dyd)
    return dxs, dxd, dd, dyc, dyd, certified, n_ir


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
