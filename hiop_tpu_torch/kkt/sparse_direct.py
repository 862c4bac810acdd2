"""Sparse-direct compressed KKT realizations (host factorization).

Counterpart of ``hiop_tpu/kkt/sparse_direct.py`` (:class:`SparseXDYcYdKKT`,
:class:`SparseXYcYdKKT`; reference hiopKKTLinSysCompressedSparseXDYcYd and
...XYcYd, hiopKKTLinSysSparse.hpp:74,133). The symmetric-indefinite
augmented system

  [ H + Dx + delta_wx I   0                  Jc^T          Jd^T        ]
  [ 0                     Dd + delta_wd I    0             -I          ]
  [ Jc                    0                  -delta_cc I   0           ]
  [ Jd                    -I                 0             -delta_cd I ]

(doc hiopKKTLinSys.hpp:334-345) is assembled in triplet form and handed to
a host sparse direct solver from
:mod:`hiop_tpu_torch.linalg.solver_registry` (``splu`` by default, the
reference's MA57 role). The static COO pattern is built once at
construction and only the value vector is refreshed per factorization
(symbolic-once, numeric-per-iteration). Both classes take and return host
numpy arrays; the caller (``_SparseDirectStrategy``) copies the nnz values,
diagonals and right-hand sides off the device, one transfer each. The COO
order and the CSC conversion are ``hiop_tpu``'s, so duplicates are summed
in the same order and both packages hand SuperLU the same matrix (the same
orderings, the same pivot signs).

:class:`DeviceSparseXDYcYdKKT` (``linear_solver_sparse=device_ldl``) keeps
the XDYcYd system on the solver's device: the symbolic analysis once on the
host, every numeric factorization and solve on the device
(:mod:`hiop_tpu_torch.linalg.sparse_device`); it takes and returns tensors.
"""

from __future__ import annotations

import functools
import inspect

import numpy as np
import torch

from hiop_tpu_torch.linalg.sparse_device import (
    DeviceSparseLDL, equilibrate, read_factor_stats, solve_refined,
)
from hiop_tpu_torch.linalg.vector_ops import scatter_add_


def _factory(nlp, solver_name: str):
    """The registry backend, with the linear_solver_sparse_ordering option
    for backends that take an ``ordering`` argument (the reference's
    cuSOLVER-chol AMD/sym-RCM selector, hiopLinSolverCholCuSparse)."""
    from hiop_tpu_torch.linalg import solver_registry

    factory = solver_registry.get_solver_factory(solver_name)
    if "ordering" in inspect.signature(factory).parameters:
        factory = functools.partial(
            factory, ordering=nlp.options.str_("linear_solver_sparse_ordering")
        )
    return factory


def _factorize(factory, rows, cols, vals, ntot):
    """Assemble the CSC matrix from the COO triplets and factorize it; None
    on a (near-)singular matrix (SuperLU and the native LDL^T raise
    RuntimeError)."""
    import scipy.sparse as sp

    A = sp.coo_matrix((vals, (rows, cols)), shape=(ntot, ntot)).tocsc()
    try:
        return factory(A)
    except RuntimeError:
        return None


class _HostKKT:
    _solver = None
    #: (n_pos, n_neg, n_zero) from the last factorization when the backend
    #: reports it (native_ldl; splu in its no-pivot mode), else None
    last_inertia = None

    def _factor(self, vals) -> bool:
        self._solver = _factorize(self._factory, self._rows, self._cols, vals, self.ntot)
        self._read_inertia()
        return self._solver is not None

    def _read_inertia(self) -> None:
        inert = getattr(self._solver, "inertia", None)
        self.last_inertia = inert() if callable(inert) else None

    def _solve(self, rhs):
        """The backend's solution, or None if it is not finite. A backend
        may drop its inertia mid-solve (splu's pivoted fallback), so the
        inertia is read again."""
        sol = self._solver.solve(rhs)
        self._read_inertia()
        return sol if np.all(np.isfinite(sol)) else None


class SparseXDYcYdKKT(_HostKKT):
    """Static-pattern assembler + registry-backed factorization."""

    def __init__(self, nlp, solver_name: str = "splu"):
        self._factory = _factory(nlp, solver_name)
        self.n = nlp.n
        self.m_eq = nlp.m_eq
        self.m_ineq = nlp.m_ineq
        n, me, mi = self.n, self.m_eq, self.m_ineq
        self.ntot = n + mi + me + mi

        hr, hc = np.asarray(nlp.hess_rows), np.asarray(nlp.hess_cols)
        jer, jec = np.asarray(nlp.jac_eq_rows), np.asarray(nlp.jac_eq_cols)
        jir, jic = np.asarray(nlp.jac_in_rows), np.asarray(nlp.jac_in_cols)
        off = hr != hc  # mirrored below the diagonal

        rows = [hr, hc[off]]                      # H upper + strict-lower mirror
        cols = [hc, hr[off]]
        rows += [np.arange(n)]                    # Dx + delta_wx
        cols += [np.arange(n)]
        rows += [np.arange(n, n + mi)]            # Dd + delta_wd
        cols += [np.arange(n, n + mi)]
        yc0, yd0 = n + mi, n + mi + me
        rows += [yc0 + jer, jec]                  # Jc and Jc^T
        cols += [jec, yc0 + jer]
        rows += [yd0 + jir, jic]                  # Jd and Jd^T
        cols += [jic, yd0 + jir]
        ii = np.arange(mi)
        rows += [n + ii, yd0 + ii]                # -I blocks (d,yd)/(yd,d)
        cols += [yd0 + ii, n + ii]
        rows += [yc0 + np.arange(me)]             # -delta_cc
        cols += [yc0 + np.arange(me)]
        rows += [yd0 + ii]                        # -delta_cd
        cols += [yd0 + ii]
        self._rows = np.concatenate(rows)
        self._cols = np.concatenate(cols)
        self._off = off

    def _values(self, hvals, Dx, Dd, je_vals, ji_vals, deltas):
        dwx, dwd, dcc, dcd = deltas
        me, mi = self.m_eq, self.m_ineq
        return np.concatenate([
            hvals, hvals[self._off],
            Dx + dwx, Dd + dwd,
            je_vals, je_vals,
            ji_vals, ji_vals,
            np.full(2 * mi, -1.0),
            np.full(me, -dcc),
            np.full(mi, -dcd),
        ])

    def factorize(self, hvals, Dx, Dd, je_vals, ji_vals, deltas) -> bool:
        """Numeric phase on host float64 arrays. Returns False on a
        (near-)singular matrix."""
        return self._factor(self._values(hvals, Dx, Dd, je_vals, ji_vals, deltas))

    def solve(self, rx_t, rd_t, ryc, ryd):
        """(dx, dd, dyc, dyd) as host arrays, or None if not finite."""
        n, me, mi = self.n, self.m_eq, self.m_ineq
        sol = self._solve(np.concatenate([rx_t, rd_t, ryc, ryd]))
        if sol is None:
            return None
        return sol[:n], sol[n:n + mi], sol[n + mi:n + mi + me], sol[n + mi + me:]


class SparseXYcYdKKT(_HostKKT):
    """Sparse-direct realization of the *XYcYd* compressed linearization
    (hiopKKTLinSysCompressedSparseXYcYd, hiopKKTLinSysSparse.hpp:74): the
    inequality slack row is eliminated too, leaving the 3-block symmetric
    system ordered [x, yc, yd]::

      [ H + Dx + delta_wx   Jc^T        Jd^T                         ]
      [ Jc                  -delta_cc                                ]
      [ Jd                              -(Dd+delta_wd)^{-1}-delta_cd ]

    Expected inertia (n, m_eq + m_ineq, 0): the same negative count as
    XDYcYd, so the strategy's acceptance test is shared. ``solve`` takes
    the XDYcYd rhs 4-tuple, forms ryd_tilde = ryd + Dd_tot^{-1} rd_t, and
    recovers dd = Dd_tot^{-1}(rd_t + dyd) (hiopKKTLinSys.cpp:620,670)."""

    def __init__(self, nlp, solver_name: str = "splu"):
        self._factory = _factory(nlp, solver_name)
        self.n = nlp.n
        self.m_eq = nlp.m_eq
        self.m_ineq = nlp.m_ineq
        n, me, mi = self.n, self.m_eq, self.m_ineq
        self.ntot = n + me + mi

        hr, hc = np.asarray(nlp.hess_rows), np.asarray(nlp.hess_cols)
        jer, jec = np.asarray(nlp.jac_eq_rows), np.asarray(nlp.jac_eq_cols)
        jir, jic = np.asarray(nlp.jac_in_rows), np.asarray(nlp.jac_in_cols)
        off = hr != hc

        yc0, yd0 = n, n + me
        rows = [hr, hc[off]]                      # H upper + strict-lower mirror
        cols = [hc, hr[off]]
        rows += [np.arange(n)]                    # Dx + delta_wx
        cols += [np.arange(n)]
        rows += [yc0 + jer, jec]                  # Jc and Jc^T
        cols += [jec, yc0 + jer]
        rows += [yd0 + jir, jic]                  # Jd and Jd^T
        cols += [jic, yd0 + jir]
        rows += [yc0 + np.arange(me)]             # -delta_cc
        cols += [yc0 + np.arange(me)]
        ii = np.arange(mi)
        rows += [yd0 + ii]                        # -(Dd_tot)^{-1} - delta_cd
        cols += [yd0 + ii]
        self._rows = np.concatenate(rows)
        self._cols = np.concatenate(cols)
        self._off = off
        self._dd_inv = None

    def factorize(self, hvals, Dx, Dd, je_vals, ji_vals, deltas) -> bool:
        dwx, dwd, dcc, dcd = deltas
        dd_tot = Dd + dwd
        dd_inv = np.where(dd_tot > 0, 1.0 / np.maximum(dd_tot, 1e-300), 0.0)
        self._dd_inv = dd_inv
        vals = np.concatenate([
            hvals, hvals[self._off],
            Dx + dwx,
            je_vals, je_vals,
            ji_vals, ji_vals,
            np.full(self.m_eq, -dcc),
            -(dd_inv + dcd),
        ])
        return self._factor(vals)

    def solve(self, rx_t, rd_t, ryc, ryd):
        n, me = self.n, self.m_eq
        ryd_t = ryd + self._dd_inv * rd_t
        sol = self._solve(np.concatenate([rx_t, ryc, ryd_t]))
        if sol is None:
            return None
        dx = sol[:n]
        dyc = sol[n:n + me]
        dyd = sol[n + me:]
        dd = self._dd_inv * (rd_t + dyd)
        return dx, dd, dyc, dyd


class DeviceSparseXDYcYdKKT(SparseXDYcYdKKT):
    """Device-resident numeric refactorization of the sparse XDYcYd
    augmented system (``linear_solver_sparse=device_ldl``).

    The ReSolve discipline (RefactorizationSolver.hpp:74): the symbolic
    analysis (elimination tree, L pattern, level-scheduled op program) runs
    once on the host through
    :class:`~hiop_tpu_torch.linalg.sparse_device.DeviceSparseLDL`; every
    numeric factorization of the regularization ladder (only the delta
    scalars change) assembles the value vector on the device and runs the
    level-scheduled numeric there, so a retry costs one host read of
    ``(ok, n_clamped, n_neg)``. The values are equilibrated by a symmetric
    row-max scaling first. With ``kkt_fact_dtype=float32`` the factors are
    f32 and every solve is certified by f64 iterative refinement through
    the device COO matvec (in f64 too); an uncertified solve returns None
    and the strategy's singularity handler regularizes."""

    def __init__(self, nlp, solver_name: str = "device_ldl"):
        # the parent builds the static COO structure; it gets a real host
        # factory (native_ldl) that it never uses
        super().__init__(nlp, "native_ldl")
        dev = nlp.device
        self.device = dev
        # ordering policy (linear_solver_sparse_ordering):
        #   auto/amd -> unrestricted AMD (fill-optimal; interleaved dual
        #     pivots can go tiny at small deltas, which the numeric's static
        #     pivot clamping and the IR certification absorb);
        #   qd_amd -> AMD restricted so that every primal column (x, d)
        #     comes before any dual row: a strictly quasi-definite
        #     elimination (stable without pivoting [Vanderbei], exact
        #     inertia), at the cost of dual-Schur fill on non-local
        #     structures;
        #   rcm/none -> as named.
        ordering = nlp.options.str_("linear_solver_sparse_ordering")
        if ordering == "qd_amd":
            import scipy.sparse as _sp

            from hiop_tpu_torch.native import amd_ordering

            S = _sp.coo_matrix(
                (np.ones(self._rows.size), (self._rows, self._cols)),
                shape=(self.ntot, self.ntot),
            ).tocsr()
            full_amd = np.asarray(
                amd_ordering(self.ntot, np.asarray(S.indptr, np.int64),
                             np.asarray(S.indices, np.int64)),
                np.int64,
            )
            primal = full_amd < (self.n + self.m_ineq)
            qd_perm = np.concatenate([full_amd[primal], full_amd[~primal]])
            self._ldl = DeviceSparseLDL(self._rows, self._cols, self.ntot, perm=qd_perm, device=dev)
        else:
            self._ldl = DeviceSparseLDL(
                self._rows, self._cols, self.ntot,
                ordering={"auto": "amd"}.get(ordering, ordering), device=dev,
            )
        self._fact_dtype = (
            torch.float32 if nlp.options.str_("kkt_fact_dtype") == "float32" else torch.float64
        )
        self._numeric = self._ldl.get_numeric(self._fact_dtype)
        self._dev_solve = self._ldl.get_solve()
        self._rows_t = torch.as_tensor(self._rows, device=dev)
        self._cols_t = torch.as_tensor(self._cols, device=dev)
        self._off_t = torch.as_tensor(np.flatnonzero(self._off), device=dev)
        self._ir_tol = min(nlp.options.num("ir_inner_tol_min"), 1e-9)
        self._factors = None
        self._scale = None
        self._vals64 = None
        #: IR steps of the last certified solve
        self.last_ir_steps = 0

    def _f64(self, a):
        return torch.as_tensor(a, dtype=torch.float64, device=self.device)

    def values_device(self, hvals, Dx, Dd, je, ji, deltas):
        """The COO value vector of the augmented system, on the device."""
        dwx, dwd, dcc, dcd = (float(x) for x in deltas)
        me, mi = self.m_eq, self.m_ineq
        hv = self._f64(hvals)
        full = functools.partial(torch.full, dtype=torch.float64, device=self.device)
        je, ji = self._f64(je), self._f64(ji)
        return torch.cat([
            hv, hv[self._off_t],
            self._f64(Dx) + dwx, self._f64(Dd) + dwd,
            je, je, ji, ji,
            full((2 * mi,), -1.0),
            full((me,), -dcc),
            full((mi,), -dcd),
        ])

    def coo_matvec(self, vals, x):
        return scatter_add_(vals.new_zeros(self.ntot), self._rows_t, vals * x[self._cols_t])

    def factorize(self, hvals, Dx, Dd, je_vals, ji_vals, deltas) -> bool:
        """Assemble, equilibrate and factorize on the device; False when the
        factorization is not finite."""
        vals = self.values_device(hvals, Dx, Dd, je_vals, ji_vals, deltas)
        vals_s, s = equilibrate(vals, self._rows_t, self._cols_t, self.ntot)
        f = self._numeric(vals_s)
        ok, n_clamped, n_neg = read_factor_stats(f)
        if not ok:
            self._factors = None
            self.last_inertia = None
            return False
        self._factors = f
        self._scale = s
        self._vals64 = vals
        if n_clamped > 0:
            # statically clamped pivots: the factorization is of A + E and
            # the pivot signs are unreliable; report no inertia (the strategy
            # then takes the inertia-free curvature test) but keep the
            # factors: the solves stay IR-certified
            self.last_inertia = None
        else:
            self.last_inertia = (self.ntot - n_neg, n_neg, 0)
        return True

    def solve(self, rx_t, rd_t, ryc, ryd):
        """(dx, dd, dyc, dyd) as tensors on the device, or None when IR
        cannot certify the solution."""
        n, me, mi = self.n, self.m_eq, self.m_ineq
        rhs = torch.cat([self._f64(rx_t), self._f64(rd_t), self._f64(ryc), self._f64(ryd)])
        sol, cert, self.last_ir_steps = solve_refined(
            self._dev_solve, self._factors, self._scale, self.coo_matvec, self._vals64, rhs, self._ir_tol)
        if not cert:
            return None  # the strategy regularizes (singularity handler)
        return sol[:n], sol[n:n + mi], sol[n + mi:n + mi + me], sol[n + mi + me:]
