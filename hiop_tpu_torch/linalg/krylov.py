"""Operator-based Krylov solvers over tuples of tensors.

Counterpart of ``hiop_tpu/linalg/krylov.py`` (reference hiopKrylovSolver /
hiopPCGSolver / hiopBiCGStabSolver, hiopKrylovSolver.hpp:80,162,192). The
operators are plain Python callables over a tensor or a tuple of tensors
(the compound primal-dual vector, e.g. the 4-tuple (dx, dd, dyc, dyd) of
the compressed MDS system), and the vector algebra is elementwise over the
tuple's leaves.

The iteration loops run on the host (they are O(10) steps of O(n) work and
the convergence test is data-dependent); each scalar the loop branches on
is one ``.item()``/``.tolist()`` synchronization. The Gram-Schmidt mass
dots (the reference's ``mass_inner_product`` kernels,
ReSolve/KrylovSolverKernels.cu) are one stacked product over the basis and
one ``.tolist()`` per pass, not a loop of scalar syncs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


def _leaves(a):
    return a if isinstance(a, (tuple, list)) else (a,)


def _tree_map(fn, *trees):
    if isinstance(trees[0], (tuple, list)):
        return tuple(fn(*xs) for xs in zip(*trees))
    return fn(*trees)


def _tree_dot_device(a, b):
    """sum over leaves of <a, b>, as a 0-dim tensor (no synchronization)."""
    return sum(x.flatten() @ y.flatten() for x, y in zip(_leaves(a), _leaves(b)))


def _mass_dots_dev(V, w):
    """Dots of w against every basis vector in V: one stacked product per
    leaf (``mass_inner_product``)."""
    return sum(torch.stack([_leaves(v)[k] for v in V]) @ wk
               for k, wk in enumerate(_leaves(w)))


def _mass_axpy_dev(V, coefs, w):
    """w - sum_j coefs[j] * V[j] as one product per leaf (``mass_axpy``)."""
    w0 = _leaves(w)[0]
    c = torch.as_tensor(coefs, dtype=w0.dtype, device=w0.device)
    out = tuple(wk - c @ torch.stack([_leaves(v)[k] for v in V])
                for k, wk in enumerate(_leaves(w)))
    return out if isinstance(w, (tuple, list)) else out[0]


def tree_dot(a, b) -> float:
    return float(_tree_dot_device(a, b))


def tree_norm(a) -> float:
    return tree_dot(a, a) ** 0.5


def tree_axpy(alpha, x, y):
    """y + alpha*x."""
    return _tree_map(lambda xv, yv: yv + alpha * xv, x, y)


def tree_scale(alpha, x):
    return _tree_map(lambda v: alpha * v, x)


def tree_sub(x, y):
    return _tree_map(lambda a, b: a - b, x, y)


def tree_zeros_like(x):
    return _tree_map(torch.zeros_like, x)


class KrylovInfo(NamedTuple):
    converged: bool
    iters: int
    resid_norm: float


def pcg(
    matvec: Callable,
    rhs,
    M_inv: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-9,
    maxit: int = 50,
):
    """Preconditioned conjugate gradient (hiopPCGSolver). Returns (x, info)."""
    M_inv = M_inv if M_inv is not None else (lambda v: v)
    x = x0 if x0 is not None else tree_zeros_like(rhs)
    r = tree_sub(rhs, matvec(x)) if x0 is not None else rhs
    b_norm = tree_norm(rhs)
    stop = max(tol * b_norm, 1e-300)
    z = M_inv(r)
    p = z
    rz = tree_dot(r, z)
    r_norm = tree_norm(r)
    it = 0
    while r_norm > stop and it < maxit:
        Ap = matvec(p)
        pAp = tree_dot(p, Ap)
        if pAp <= 0:
            break  # loss of positive definiteness
        alpha = rz / pAp
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, Ap, r)
        r_norm = tree_norm(r)
        if r_norm <= stop:
            it += 1
            break
        z = M_inv(r)
        rz_new = tree_dot(r, z)
        beta = rz_new / rz
        rz = rz_new
        p = tree_axpy(beta, p, z)
        it += 1
    return x, KrylovInfo(r_norm <= stop, it, r_norm)


def bicgstab(
    matvec: Callable,
    rhs,
    M_inv: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-9,
    maxit: int = 50,
):
    """Right-preconditioned BiCGStab (hiopBiCGStabSolver), the outer
    iterative refinement over a full KKT operator with a compressed direct
    solve as preconditioner (compute_directions_w_IR,
    hiopKKTLinSys.cpp:911-956). Returns (x, info)."""
    M_inv = M_inv if M_inv is not None else (lambda v: v)
    x = x0 if x0 is not None else tree_zeros_like(rhs)
    r = tree_sub(rhs, matvec(x))
    b_norm = tree_norm(rhs)
    stop = max(tol * b_norm, 1e-300)
    r_norm = tree_norm(r)
    if r_norm <= stop:
        return x, KrylovInfo(True, 0, r_norm)
    r_hat = r
    rho = alpha = omega = 1.0
    v = p = tree_zeros_like(rhs)
    it = 0
    while it < maxit:
        rho_new = tree_dot(r_hat, r)
        if rho_new == 0.0 or omega == 0.0:
            break
        beta = (rho_new / rho) * (alpha / omega)
        rho = rho_new
        p = tree_axpy(beta, tree_axpy(-omega, v, p), r)
        y = M_inv(p)
        v = matvec(y)
        denom = tree_dot(r_hat, v)
        if denom == 0.0:
            break
        alpha = rho / denom
        s = tree_axpy(-alpha, v, r)
        x = tree_axpy(alpha, y, x)
        s_norm = tree_norm(s)
        if s_norm <= stop:
            r = s
            r_norm = s_norm
            it += 1
            break
        z = M_inv(s)
        t = matvec(z)
        tt = tree_dot(t, t)
        if tt == 0.0:
            break
        omega = tree_dot(t, s) / tt
        x = tree_axpy(omega, z, x)
        r = tree_axpy(-omega, t, s)
        r_norm = tree_norm(r)
        it += 1
        if r_norm <= stop:
            break
    return x, KrylovInfo(r_norm <= stop, it, r_norm)


def _gs_orthogonalize(V, w, scheme: str, Lmat):
    """Orthogonalize w against the Krylov basis V (a list of vectors) with
    the requested Gram-Schmidt scheme; returns (hcol, hnorm, v_next or None).

    The schemes of ReSolve's ``GramSchmidt`` (IterativeRefinement.cpp:435-773),
    option ``ir_inner_gs_scheme``:

    * ``mgs``: modified Gram-Schmidt, j+1 sequential dots, one sync each;
    * ``cgs2``: classical Gram-Schmidt twice, H = h1 + h2, one stacked
      product and one sync per pass (three counting the norm);
    * ``mgs_two_synch``: one stacked V^T [v_j, w] product that also fills
      row j of the lower-triangular correction matrix L, then the host-side
      unit-lower-triangular solve h = (I + L_strict)^{-1} rv;
    * ``mgs_pm``: "post-modern" MGS, the two-synch h plus the second-order
      correction h -= (I + L_strict)^{-1} (L_strict^T h).
    """
    j = len(V) - 1
    if scheme == "mgs":
        hcol = np.zeros(j + 1)
        for i in range(j + 1):
            hcol[i] = tree_dot(w, V[i])
            w = tree_axpy(-hcol[i], V[i], w)
    elif scheme == "cgs2":
        h1 = np.asarray(_mass_dots_dev(V, w).tolist())
        w = _mass_axpy_dev(V, h1, w)
        h2 = np.asarray(_mass_dots_dev(V, w).tolist())
        w = _mass_axpy_dev(V, h2, w)
        hcol = h1 + h2
    elif scheme in ("mgs_two_synch", "mgs_pm"):
        lrow, rv = torch.stack([_mass_dots_dev(V, V[j]), _mass_dots_dev(V, w)]).tolist()
        Lmat[j, : j + 1] = lrow
        rv = np.asarray(rv)
        # unit-lower-triangular solve (I + L_strict) h = rv
        hcol = np.zeros(j + 1)
        for i in range(j + 1):
            hcol[i] = rv[i] - Lmat[i, :i] @ hcol[:i]
        if scheme == "mgs_pm":
            # second-order correction: aux = (I+L)^{-1} (L^T h); h -= aux
            rv2 = np.zeros(j + 1)
            for i in range(j + 1):
                rv2[i] = Lmat[i + 1 : j + 1, i] @ hcol[i + 1 : j + 1]
            aux = np.zeros(j + 1)
            for i in range(j + 1):
                aux[i] = rv2[i] - Lmat[i, :i] @ aux[:i]
            hcol -= aux
        w = _mass_axpy_dev(V, hcol, w)
    else:
        raise ValueError(f"unknown gs_scheme '{scheme}'")
    hnorm = tree_norm(w)
    v_next = tree_scale(1.0 / hnorm, w) if hnorm > 0 else None
    return hcol, hnorm, v_next


def fgmres(
    matvec: Callable,
    rhs,
    M_inv: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-12,
    restart: int = 20,
    maxit: int = 100,
    gs_scheme: str = "mgs",
):
    """Flexible GMRES with restart (right preconditioning that may change
    between iterations), the reference's ReSolve iterative refinement
    (ReSolve/IterativeRefinement.hpp:25): it refines a low-precision
    factorization's solves, which act as the preconditioner, while the
    matvec runs in f64. ``gs_scheme`` selects the orthogonalization (option
    ``ir_inner_gs_scheme``). Returns (x, info)."""
    x = x0 if x0 is not None else tree_zeros_like(rhs)
    b_norm = tree_norm(rhs)
    stop = max(tol * b_norm, 1e-300)
    total_it = 0
    n_restarts = 0
    n_stagnant = 0
    r_norm = float("inf")
    last_beta = float("inf")
    while total_it < maxit:
        r = tree_sub(rhs, matvec(x)) if (x0 is not None or total_it) else rhs
        beta = tree_norm(r)
        r_norm = beta
        if beta <= stop:
            return x, KrylovInfo(True, total_it, beta)
        # breakdown / stagnation guard: a non-finite residual fails at once;
        # lack of progress must persist for TWO consecutive restart cycles
        # before failure is reported (one near-stagnant cycle of a slowly
        # converging refinement must not demote f32 under mp_schedule=adaptive)
        if not np.isfinite(beta):
            return x, KrylovInfo(False, total_it, beta)
        n_stagnant = n_stagnant + 1 if beta >= 0.999 * last_beta else 0
        if n_restarts > 0 and n_stagnant >= 2:
            return x, KrylovInfo(False, total_it, beta)
        last_beta = beta
        n_restarts += 1
        m = min(restart, maxit - total_it)
        V = [tree_scale(1.0 / beta, r)]
        Z = []
        H = np.zeros((m + 1, m))
        Lmat = np.zeros((m + 1, m + 1))
        cs = np.zeros(m)
        sn = np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        j_done = 0
        for j in range(m):
            z = M_inv(V[j]) if M_inv is not None else V[j]
            Z.append(z)
            w = matvec(z)
            hcol, hnorm, v_next = _gs_orthogonalize(V, w, gs_scheme, Lmat)
            H[: j + 1, j] = hcol
            H[j + 1, j] = hnorm
            if v_next is not None:
                V.append(v_next)
            # apply the accumulated Givens rotations to the new column
            for i in range(j):
                t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
                H[i, j] = t
            denom = float(np.hypot(H[j, j], H[j + 1, j]))
            if denom == 0.0:
                j_done = j + 1
                break
            cs[j] = H[j, j] / denom
            sn[j] = H[j + 1, j] / denom
            H[j, j] = denom
            H[j + 1, j] = 0.0
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            total_it += 1
            j_done = j + 1
            r_norm = abs(g[j + 1])
            if r_norm <= stop or H[j + 1, j] == 0.0 and j + 2 > len(V):
                break
        if j_done:
            # back-substitute the (j_done x j_done) triangular system
            y = np.zeros(j_done)
            for i in range(j_done - 1, -1, -1):
                s = g[i] - H[i, i + 1:j_done] @ y[i + 1:j_done]
                y[i] = s / H[i, i] if H[i, i] != 0.0 else 0.0
            for i in range(j_done):
                if y[i] != 0.0:
                    x = tree_axpy(float(y[i]), Z[i], x)
        x0 = x  # later cycles recompute the true residual
        if r_norm <= stop:
            return x, KrylovInfo(True, total_it, r_norm)
        if j_done == 0:
            break  # breakdown with no progress
    # report the true residual of the final iterate
    r_norm = tree_norm(tree_sub(rhs, matvec(x)))
    return x, KrylovInfo(r_norm <= stop, total_it, r_norm)
