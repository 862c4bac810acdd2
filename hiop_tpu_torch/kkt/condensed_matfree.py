"""Matrix-free condensed KKT for large sparse NLPs.

Counterpart of ``hiop_tpu/kkt/condensed_matfree.py``. The dense condensed
path (kkt/condensed.py) forms K = H + Dx + Jd^T Dd Jd as an (n, n) tensor:
right for moderate n, O(n^2) memory beyond. This module keeps everything in
triplet form and solves the SPD condensed system with Jacobi-preconditioned
conjugate gradient, the analogue of HiOp's Krylov-based inner solves
(hiopKrylovSolver and the ReSolve FGMRES machinery):

  K v = H v + (Dx + delta_wx) v + Jd^T (Dd_tilde (Jd v))

with every sparse product a gather and a sort-based scatter-add over the
static triplet structure (:func:`~hiop_tpu_torch.linalg.vector_ops.scatter_add_`,
so two runs give the same bits), O(nnz) per application. Nonconvexity shows
as a CG breakdown (p^T K p <= 0), which the strategy treats exactly like a
failed Cholesky: bump delta_w and retry.

The reference runs CG as one device while-loop. Here the step runs
``CG_CHUNK`` times between two host reads of the stopping test, and a
device ``done`` mask freezes the carry once the test holds, so the result
is that of stopping at the first ``done``: the same iterations and the same
x, with one host read per chunk instead of one per step.

Selected with ``linear_solver_sparse`` in {'cg'} (or 'auto' with large n)
and ``KKTLinsys=condensed``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hiop_tpu_torch.linalg.vector_ops import scatter_add_

#: CG steps between two host reads of the stopping test
CG_CHUNK = 8


class SparseOps(NamedTuple):
    """Static triplet structure of J_d (the inequality Jacobian) and of the
    upper-triangle Hessian, as index tensors on the solver's device."""

    jd_rows: torch.Tensor   # (nnz_j,)
    jd_cols: torch.Tensor
    h_rows: torch.Tensor    # (nnz_h,) upper triangle
    h_cols: torch.Tensor
    n: int
    m_ineq: int


def build_ops(jd_rows, jd_cols, h_rows, h_cols, n, m_ineq, device) -> SparseOps:
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    return SparseOps(t(jd_rows), t(jd_cols), t(h_rows), t(h_cols), int(n), int(m_ineq))


def jd_times_vec(ops: SparseOps, jd_vals, v):
    """J_d @ v, summed over rows."""
    return scatter_add_(v.new_zeros(ops.m_ineq), ops.jd_rows, jd_vals * v[ops.jd_cols])


def jd_trans_times_vec(ops: SparseOps, jd_vals, w):
    """J_d^T @ w, summed over columns."""
    return scatter_add_(w.new_zeros(ops.n), ops.jd_cols, jd_vals * w[ops.jd_rows])


def hess_times_vec(ops: SparseOps, h_vals, v):
    """Symmetric H @ v from the upper-triangle triplets."""
    up = scatter_add_(v.new_zeros(ops.n), ops.h_rows, h_vals * v[ops.h_cols])
    lo = scatter_add_(v.new_zeros(ops.n), ops.h_cols, h_vals * v[ops.h_rows])
    diag_mask = (ops.h_rows == ops.h_cols).to(h_vals.dtype)
    diag = scatter_add_(v.new_zeros(ops.n), ops.h_rows, diag_mask * h_vals * v[ops.h_rows])
    return up + lo - diag


def condensed_diag(ops: SparseOps, h_vals, jd_vals, Dx, dd_tilde, delta_wx):
    """diag(K), for the Jacobi preconditioner."""
    diag_mask = (ops.h_rows == ops.h_cols).to(h_vals.dtype)
    h_diag = scatter_add_(h_vals.new_zeros(ops.n), ops.h_rows, diag_mask * h_vals)
    jtj_diag = scatter_add_(jd_vals.new_zeros(ops.n), ops.jd_cols,
                            dd_tilde[ops.jd_rows] * jd_vals * jd_vals)
    return h_diag + Dx + delta_wx + jtj_diag


def make_cg_solver(ops: SparseOps, maxit: int = 200):
    """A PCG solver over the static triplet structure.

    Returns solve(h_vals, jd_vals, Dx, Dd, rx_t, rd_t, ryd, delta_wx,
    delta_wd, delta_cd, tol) -> (dx, dd, dyd, (converged, neg_curv, iters,
    resid_norm)), the last four as 0-dim tensors on the device."""

    def solve(h_vals, jd_vals, Dx, Dd, rx_t, rd_t, ryd, delta_wx, delta_wd, delta_cd, tol):
        dd_tot = Dd + delta_wd
        T = 1.0 / (1.0 + delta_cd * dd_tot)
        dd_tilde = dd_tot * T

        def K(v):
            return (
                hess_times_vec(ops, h_vals, v)
                + (Dx + delta_wx) * v
                + jd_trans_times_vec(ops, jd_vals, dd_tilde * jd_times_vec(ops, jd_vals, v))
            )

        rhs = rx_t + jd_trans_times_vec(ops, jd_vals, dd_tilde * (ryd - delta_cd * rd_t) + rd_t)
        dK = condensed_diag(ops, h_vals, jd_vals, Dx, dd_tilde, delta_wx)
        m_inv = torch.where(dK > 0, 1.0 / torch.clamp(dK, min=1e-300), 1.0)

        b_norm = torch.linalg.vector_norm(rhs)
        stop = tol * torch.clamp(b_norm, min=1e-300)

        def body(x, r, z, p, rz):
            Kp = K(p)
            pKp = p @ Kp
            neg_now = pKp <= 0
            alpha = torch.where(neg_now, 0.0, rz / torch.where(pKp == 0, 1.0, pKp))
            x = x + alpha * p
            r = r - alpha * Kp
            z = m_inv * r
            rz_new = r @ z
            beta = rz_new / torch.where(rz == 0, 1.0, rz)
            p = z + beta * p
            done_now = (torch.linalg.vector_norm(r) <= stop) | neg_now
            return (x, r, z, p, rz_new), neg_now, done_now

        z0 = m_inv * rhs
        vec = (torch.zeros_like(rhs), rhs, z0, z0, rhs @ z0)
        it = torch.zeros((), dtype=torch.int64, device=rhs.device)
        neg = torch.zeros((), dtype=torch.bool, device=rhs.device)
        done = torch.zeros((), dtype=torch.bool, device=rhs.device)
        while True:
            for _ in range(CG_CHUNK):
                active = ~done & (it < maxit)
                new, neg_now, done_now = body(*vec)
                vec = tuple(torch.where(active, a, b) for a, b in zip(new, vec))
                it = it + active.to(it.dtype)
                neg = neg | (active & neg_now)
                done = torch.where(active, done_now, done)
            if bool(done | (it >= maxit)):
                break
        x, r = vec[0], vec[1]
        resid = torch.linalg.vector_norm(r)
        converged = (resid <= stop) & ~neg

        dx = x
        dd = T * (jd_times_vec(ops, jd_vals, dx) - ryd + delta_cd * rd_t)
        dyd = dd_tot * dd - rd_t
        return dx, dd, dyd, (converged, neg, it, resid)

    return solve
