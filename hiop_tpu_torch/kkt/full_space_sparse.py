"""Sparse direct solve of the full (unreduced) 12-block KKT system.

Counterpart of ``hiop_tpu/kkt/full_space_sparse.py`` (reference
hiopKKTLinSysSparseFull, hiopKKTLinSysSparse.hpp:202): the nonsymmetric
unreduced primal-dual system (block doc hiopKKTLinSys.hpp:463-501) is
assembled as a scipy COO matrix straight from the formulation's Hessian
and Jacobian triplets, never as a dense operator, and factorized on the
host by a registry sparse LU (``splu`` by default; HiOp uses nonsymmetric
PARDISO/STRUMPACK, hiopKKTLinSysSparse.cpp:845-849). Every block outside
the triplets is diagonal (barrier slack/dual couplings), so assembly is
O(nnz(H) + nnz(J) + N).

Rows and columns follow :mod:`hiop_tpu_torch.kkt.full_space`'s compound
flattening [x, d, yc, yd, sxl, sxu, sdl, sdu, zl, zu, vl, vu], and inactive
bound rows carry a unit diagonal so the decoupled entries solve to zero,
as in ``full_space.assemble_full``. The COO order is ``hiop_tpu``'s. The
iterate's slacks and duals reach the host in one transfer per
factorization, the right-hand side in one per solve, and the direction goes
back to the device in one.

No inertia comes from a nonsymmetric LU, so callers pair this with the
inertia-free curvature acceptor.
"""

from __future__ import annotations

import numpy as np
import torch

from hiop_tpu_torch.formulation.base import to_numpy
from hiop_tpu_torch.kkt.full_space import _flatten_res, _unflatten_dir, residual_to_rhs
from hiop_tpu_torch.kkt.sparse_direct import _factorize, _factory


class SparseFullKKT:
    """Static-pattern sparse assembler + registry LU for the unreduced KKT."""

    def __init__(self, nlp, solver_name: str = "splu"):
        self._factory = _factory(nlp, solver_name)
        n, me, mi = nlp.n, nlp.m_eq, nlp.m_ineq
        self.n, self.m_eq, self.m_ineq = n, me, mi
        sizes = [n, mi, me, mi, n, n, mi, mi, n, n, mi, mi]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        (x0, d0, yc0, yd0, sxl0, sxu0, sdl0, sdu0,
         zl0, zu0, vl0, vu0) = offs[:12]
        self.ntot = int(offs[12])

        hr, hc = np.asarray(nlp.hess_rows), np.asarray(nlp.hess_cols)
        jer, jec = np.asarray(nlp.jac_eq_rows), np.asarray(nlp.jac_eq_cols)
        jir, jic = np.asarray(nlp.jac_in_rows), np.asarray(nlp.jac_in_cols)
        off = hr != hc  # H upper triplets mirrored below the diagonal
        self._off = off

        ix = np.arange(n)
        im = np.arange(mi)
        ie = np.arange(me)

        rows, cols = [], []
        # x rows: H + H^T-mirror + delta_wx diag + Jc^T + Jd^T - zl + zu
        rows += [hr, hc[off], ix, jec, jic, ix, ix]
        cols += [hc, hr[off], ix, yc0 + jer, yd0 + jir, zl0 + ix, zu0 + ix]
        # d rows: delta_wd diag - yd - vl + vu
        rows += [d0 + im, d0 + im, d0 + im, d0 + im]
        cols += [d0 + im, yd0 + im, vl0 + im, vu0 + im]
        # yc rows: Jc - delta_cc diag
        rows += [yc0 + jer, yc0 + ie]
        cols += [jec, yc0 + ie]
        # yd rows: Jd - I_d - delta_cd diag
        rows += [yd0 + jir, yd0 + im, yd0 + im]
        cols += [jic, d0 + im, yd0 + im]
        # bound rows sxl/sxu/sdl/sdu: +/- x (or d) and the slack diagonal
        rows += [sxl0 + ix, sxl0 + ix]
        cols += [x0 + ix, sxl0 + ix]
        rows += [sxu0 + ix, sxu0 + ix]
        cols += [x0 + ix, sxu0 + ix]
        rows += [sdl0 + im, sdl0 + im]
        cols += [d0 + im, sdl0 + im]
        rows += [sdu0 + im, sdu0 + im]
        cols += [d0 + im, sdu0 + im]
        # complementarity rows zl/zu/vl/vu: dual*dslack + slack*ddual
        rows += [zl0 + ix, zl0 + ix]
        cols += [sxl0 + ix, zl0 + ix]
        rows += [zu0 + ix, zu0 + ix]
        cols += [sxu0 + ix, zu0 + ix]
        rows += [vl0 + im, vl0 + im]
        cols += [sdl0 + im, vl0 + im]
        rows += [vu0 + im, vu0 + im]
        cols += [sdu0 + im, vu0 + im]
        self._rows = np.concatenate(rows).astype(np.int64)
        self._cols = np.concatenate(cols).astype(np.int64)
        self._solver = None
        self._template = None
        #: host copy of the last solution (flattened direction)
        self.last_solution = None

    def _values(self, hvals, je_vals, ji_vals, it, b, deltas):
        dwx, dwd, dcc, dcd = deltas
        n, me, mi = self.n, self.m_eq, self.m_ineq
        host = to_numpy(torch.cat([b.ixl, b.ixu, it.zl, it.sxl, it.zu, it.sxu,
                                   b.idl, b.idu, it.vl, it.sdl, it.vu, it.sdu]))
        ixl, ixu, zl, sxl, zu, sxu = np.split(host[:6 * n], 6)
        idl, idu, vl, sdl, vu, sdu = np.split(host[6 * n:], 6)
        one = 1.0
        return np.concatenate([
            hvals, hvals[self._off],
            np.full(n, dwx),
            je_vals, ji_vals,
            np.full(n, -1.0), np.full(n, 1.0),                # -zl +zu
            np.full(mi, dwd),
            np.full(mi, -1.0), np.full(mi, -1.0), np.full(mi, 1.0),
            je_vals, np.full(me, -dcc),
            ji_vals, np.full(mi, -1.0), np.full(mi, -dcd),
            # bound rows: active -> (x - sxl) etc.; inactive -> unit diag
            ixl, one - 2.0 * ixl,
            -ixu, one - 2.0 * ixu,
            idl, one - 2.0 * idl,
            -idu, one - 2.0 * idu,
            # complementarity rows: active -> dual*dslack + slack*ddual
            ixl * zl, ixl * sxl + (one - ixl),
            ixu * zu, ixu * sxu + (one - ixu),
            idl * vl, idl * sdl + (one - idl),
            idu * vu, idu * sdu + (one - idu),
        ])

    def factorize(self, hvals, je_vals, ji_vals, it, b, deltas) -> bool:
        """Numeric phase: triplet values as host float64 arrays, the iterate
        and bounds as tensors. Returns False on a (near-)singular matrix."""
        vals = self._values(hvals, je_vals, ji_vals, it, b, deltas)
        self._template = it
        self._solver = _factorize(self._factory, self._rows, self._cols, vals, self.ntot)
        return self._solver is not None

    def solve(self, resid):
        """Direction Iterate (on the iterate's device) from a Residual (rhs
        sign fixups included), or None if the solution is not finite."""
        rhs = to_numpy(_flatten_res(residual_to_rhs(resid)))
        sol = self._solver.solve(rhs)
        if not np.all(np.isfinite(sol)):
            return None
        self.last_solution = sol
        x = self._template.x
        return _unflatten_dir(torch.as_tensor(sol, dtype=x.dtype, device=x.device), self._template)
