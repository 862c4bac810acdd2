"""Sparse condensed KKT with device two-phase products.

Counterpart of ``hiop_tpu/kkt/condensed_sparse_device.py`` (HiOp's
``hiopKKTLinSysCondensedSparse`` CSR machinery,
src/LinAlg/hiopMatrixSparseCSR.hpp:116-261: ``times_mat_alloc/symbolic/
numeric`` and ``add_matrix_alloc/symbolic/numeric``):

- **symbolic once on the host**: the J_d^T D J_d product pattern is the set
  of Jacobian-nonzero pairs that share a row (built vectorized, lower
  triangle only), and the union pattern of K = H + diag(Dx) + J^T D J is
  the de-duplication pass inside
  :class:`~hiop_tpu_torch.linalg.sparse_device.DeviceSparseLDL`;
- **numeric per iteration on the device**: one gather and multiply forms
  the product values from (jd_vals, Dd-tilde), one concatenation lays every
  term out in the union COO, and the device sparse LDL^T factorizes it; for
  the SPD condensed system every pivot is positive, which makes it the
  sparse-Cholesky analogue of HiOp's cuSOLVER path
  (hiopLinSolverCholCuSparse.hpp:76).

Selected through the condensed strategy for sparse inequality-only NLPs
from n = 2000 on (FilterIPMNewton._make_strategy), in place of the dense
materialization of kkt/condensed.py.
"""

from __future__ import annotations

import numpy as np
import torch

from hiop_tpu_torch.linalg.sparse_device import (
    DeviceSparseLDL, equilibrate, read_factor_stats, solve_refined,
)
from hiop_tpu_torch.linalg.vector_ops import scatter_add_


class CondensedSparseDeviceKKT:
    """K = H + Dx + delta_wx I + J_d^T Dd_tilde J_d in sparse triplet form,
    factorized on the device; solves IR-certified in f64."""

    def __init__(self, nlp, max_pairs: int = 30_000_000):
        n, mi = nlp.n, nlp.m_ineq
        self.n, self.m_ineq = n, mi
        dev = self.device = nlp.device
        jr = np.asarray(nlp.jac_in_rows, np.int64)
        jc = np.asarray(nlp.jac_in_cols, np.int64)
        hr = np.asarray(nlp.hess_rows, np.int64)
        hc = np.asarray(nlp.hess_cols, np.int64)

        # ---- times_mat symbolic: pairs of J nonzeros sharing a row -------
        order = np.argsort(jr, kind="stable")
        counts = np.bincount(jr, minlength=mi)
        sq = counts.astype(np.int64) ** 2
        if int(sq.sum()) > max_pairs:
            raise ValueError(f"J^T D J pair count {int(sq.sum())} exceeds {max_pairs}")
        cum = np.concatenate([[0], np.cumsum(sq)])
        row_of = np.repeat(np.arange(mi), sq)
        local = np.arange(int(cum[-1])) - cum[row_of]
        d = np.maximum(counts[row_of], 1)
        a = local // d
        b = local % d
        start = np.concatenate([[0], np.cumsum(counts)])[row_of]
        pa = order[start + a]
        pb = order[start + b]
        # keep the lower triangle of the product (col[pa] >= col[pb]);
        # DeviceSparseLDL takes lower-only entries with no mirrors
        keep = jc[pa] >= jc[pb]
        pa, pb = pa[keep], pb[keep]
        pi, pj = jc[pa], jc[pb]

        # ---- add_matrix symbolic: the union COO of H (mirrored), the
        # diagonal and J^T D J, with explicit symmetrization weights: H's
        # mirrored pair halves sum back to the full value; the lone-
        # orientation product entries carry weight 1 (the heuristic cannot
        # tell these apart where the H and product patterns overlap)
        off = hr != hc
        rows = np.concatenate([hr, hc[off], np.arange(n), pi])
        cols = np.concatenate([hc, hr[off], np.arange(n), pj])
        w = np.concatenate([
            np.where(off, 0.5, 1.0),
            np.full(int(off.sum()), 0.5),
            np.ones(n),
            np.ones(pi.size),
        ])
        self._ldl = DeviceSparseLDL(rows, cols, n, weights=w, device=dev)
        self._fact_dtype = (
            torch.float32 if nlp.options.str_("kkt_fact_dtype") == "float32" else torch.float64
        )
        self._numeric = self._ldl.get_numeric(self._fact_dtype)
        self._dev_solve = self._ldl.get_solve()
        self._ir_tol = min(nlp.options.num("ir_inner_tol_min"), 1e-9)

        def t(x):
            return torch.as_tensor(x, dtype=torch.int64, device=dev)

        self._pa, self._pb, self._prow = t(pa), t(pb), t(jr[pa])
        self._off_t = t(np.flatnonzero(off))
        self._jr, self._jc = t(jr), t(jc)
        self._rows_t, self._cols_t = t(rows), t(cols)
        strict = np.flatnonzero(rows != cols)
        self._strict = t(strict)
        self._strict_rows, self._strict_cols = t(rows[strict]), t(cols[strict])
        self._w64 = torch.as_tensor(w, dtype=torch.float64, device=dev)
        #: IR steps of the last certified solve
        self.last_ir_steps = 0
        self._state = None

    def _f64(self, a):
        return torch.as_tensor(a, dtype=torch.float64, device=self.device)

    def values_device(self, h_vals, Dx, jd_vals, dd_tilde, dwx):
        """times_mat numeric and add_matrix numeric in one concatenation."""
        prod = jd_vals[self._pa] * jd_vals[self._pb] * dd_tilde[self._prow]
        return torch.cat([h_vals, h_vals[self._off_t], Dx + dwx, prod])

    def jd_mv(self, jd_vals, x):
        return scatter_add_(x.new_zeros(self.m_ineq), self._jr, jd_vals * x[self._jc])

    def jdT_mv(self, jd_vals, y):
        return scatter_add_(y.new_zeros(self.n), self._jc, jd_vals * y[self._jr])

    def k_mv(self, vals64, x):
        """The symmetrized COO matvec with the per-entry weights the
        factorization's assembly uses: y += w v (E_rc + E_cr^[r != c]) x."""
        wv = vals64 * self._w64
        lo = scatter_add_(x.new_zeros(self.n), self._rows_t, wv * x[self._cols_t])
        up = scatter_add_(x.new_zeros(self.n), self._strict_cols,
                          wv[self._strict] * x[self._strict_rows])
        return lo + up

    # ------------------------------------------------------------------
    def factorize(self, h_vals, Dx, Dd, jd_vals, deltas) -> bool:
        """SPD acceptance: a completed factorization with every pivot
        positive and no static clamps. Returns False otherwise; the strategy
        treats it as wrong curvature (a failed Cholesky, kkt/condensed.py
        semantics) and bumps delta_w."""
        dwx, dwd, dcd = (float(x) for x in deltas)
        dd_tot = self._f64(Dd) + dwd
        T = 1.0 / (1.0 + dcd * dd_tot)
        dd_tilde = dd_tot * T
        jd_vals = self._f64(jd_vals)
        vals = self.values_device(self._f64(h_vals), self._f64(Dx), jd_vals, dd_tilde, dwx)
        vals_s, s = equilibrate(vals, self._rows_t, self._cols_t, self.n)
        f = self._numeric(vals_s)
        ok, n_clamped, n_neg = read_factor_stats(f)
        if not (ok and n_neg == 0 and n_clamped == 0):
            self._state = None
            return False
        self._factors, self._scale, self._vals64 = f, s, vals
        self._state = (jd_vals, dd_tot, T, dcd)
        return True

    def solve(self, rx_t, rd_t, ryd):
        """Direction recovery (kkt/condensed.py solve, sparse matvecs);
        returns (dx, dd, dyd) or None when IR cannot certify."""
        jd_vals, dd_tot, T, dcd = self._state
        rx_t, rd_t, ryd = self._f64(rx_t), self._f64(rd_t), self._f64(ryd)
        dd_tilde = dd_tot * T
        rhs = rx_t + self.jdT_mv(jd_vals, dd_tilde * (ryd - dcd * rd_t) + rd_t)
        dx, cert, self.last_ir_steps = solve_refined(
            self._dev_solve, self._factors, self._scale, self.k_mv, self._vals64, rhs, self._ir_tol)
        if not cert:
            return None
        dd = T * (self.jd_mv(jd_vals, dx) - ryd + dcd * rd_t)
        dyd = dd_tot * dd - rd_t
        return dx, dd, dyd
