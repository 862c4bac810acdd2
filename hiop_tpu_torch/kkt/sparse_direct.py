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

The device-resident ``DeviceSparseXDYcYdKKT`` waits for ROADMAP.md section
1, item 11b.
"""

from __future__ import annotations

import functools
import inspect

import numpy as np


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
