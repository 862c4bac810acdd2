"""Sparse NLP formulation (hiopNlpSparse, hiopNlpFormulation.hpp:565).

Counterpart of ``hiop_tpu/formulation/sparse.py``. The static triplet
structure of the Jacobian and of the upper-triangle Lagrangian Hessian is
split once, on the host, into equality and inequality row groups; their
index maps are kept on the solver's device, so each evaluation is a gather
and a scatter-add there. The Jacobian comes as two dense (m_eq, n) and
(m_ineq, n) tensors for moderate sizes (the dense Newton KKT consumes
them) or, in :attr:`NlpSparse.matrix_free` mode, as
:class:`~hiop_tpu_torch.linalg.sparse.TripletMatrix` handles that the
sparse-direct KKT and the residual use without densifying. Dense scatters
sum duplicate triplets with the sort-based ``index_put_(accumulate=True)``
(deterministic on CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

from hiop_tpu_torch.formulation.base import NlpFormulation, to_numpy


class NlpSparse(NlpFormulation):
    def finalize_initialization(self) -> None:
        if self._finalized:
            return
        super().finalize_initialization()
        p = self.problem
        jr, jc = (np.asarray(a) for a in p.jac_structure())
        self.jac_rows = jr
        self.jac_cols = jc
        # split triplets by eq/ineq rows (static)
        eq_set = np.zeros(self.m, dtype=bool)
        eq_set[self.eq_idx] = True
        self._jac_is_eq = eq_set[jr]
        # row remapping into the eq / ineq blocks
        eq_rank = np.full(self.m, -1)
        eq_rank[self.eq_idx] = np.arange(self.m_eq)
        in_rank = np.full(self.m, -1)
        in_rank[self.ineq_idx] = np.arange(self.m_ineq)
        self.jac_eq_rows = eq_rank[jr[self._jac_is_eq]]
        self.jac_eq_cols = jc[self._jac_is_eq]
        self.jac_in_rows = in_rank[jr[~self._jac_is_eq]]
        self.jac_in_cols = jc[~self._jac_is_eq]
        hr, hc = (np.asarray(a) for a in p.hess_structure())
        self.hess_rows = hr
        self.hess_cols = hc
        place = self._place
        self._jac_rows_t = place(jr.astype(np.int64))
        self._jac_eq_pos_t = place(np.nonzero(self._jac_is_eq)[0])
        self._jac_in_pos_t = place(np.nonzero(~self._jac_is_eq)[0])
        self._jac_eq_rc_t = (place(self.jac_eq_rows.astype(np.int64)),
                             place(self.jac_eq_cols.astype(np.int64)))
        self._jac_in_rc_t = (place(self.jac_in_rows.astype(np.int64)),
                             place(self.jac_in_cols.astype(np.int64)))
        self._hess_rc_t = (place(hr.astype(np.int64)), place(hc.astype(np.int64)))

    def maybe_setup_scaling(self, x0) -> None:
        if self._scaling_done:
            return
        grad0 = to_numpy(self.problem.eval_grad_f(x0))
        vals = np.abs(to_numpy(self.problem.eval_jac_vals(x0)))
        row_norms = np.zeros(self.m)
        np.maximum.at(row_norms, self.jac_rows, vals)
        self._setup_scaling(grad0, row_norms)

    @property
    def matrix_free(self) -> bool:
        """True when the Jacobian must stay in triplet form: explicit
        ``linear_solver_sparse`` in {cg, bicgstab} or a registry-backed
        sparse direct solver (they consume triplet values), or 'auto' with
        a large variable count (a dense (m, n) Jacobian would be O(n^2))."""
        ls = self.options.str_("linear_solver_sparse")
        if ls in ("cg", "bicgstab"):
            return True
        if ls != "auto":
            from hiop_tpu_torch.linalg import solver_registry

            if solver_registry.has_solver(ls):
                return True
        return ls == "auto" and self.n >= 8192

    def eval_jac(self, x):
        """Returns (Jc, Jd), scaled: dense tensors for moderate n, or
        :class:`TripletMatrix` handles in matrix-free mode."""
        constant = getattr(self.problem, "jac_constant", False)
        if self.matrix_free:
            from hiop_tpu_torch.linalg.sparse import TripletMatrix

            if constant and getattr(self, "_jac_cache_mf", None) is not None:
                return self._jac_cache_mf
            vals_eq, vals_in = self.eval_jac_vals_split(x)
            out = (
                TripletMatrix(self.jac_eq_rows, self.jac_eq_cols, vals_eq,
                              (self.m_eq, self.n), self._jac_eq_rc_t),
                TripletMatrix(self.jac_in_rows, self.jac_in_cols, vals_in,
                              (self.m_ineq, self.n), self._jac_in_rc_t),
            )
            if constant:
                self._jac_cache_mf = out
            return out
        if constant and getattr(self, "_jac_cache", None) is not None:
            return self._jac_cache
        vals_eq, vals_in = self.eval_jac_vals_split(x)
        Jc = x.new_zeros((self.m_eq, self.n)).index_put_(self._jac_eq_rc_t, vals_eq, accumulate=True)
        Jd = x.new_zeros((self.m_ineq, self.n)).index_put_(self._jac_in_rc_t, vals_in, accumulate=True)
        if constant:
            self._jac_cache = (Jc, Jd)
        return Jc, Jd

    def eval_jac_vals_split(self, x):
        """Scaled triplet values split into (eq, ineq) groups."""
        self.runstats.n_eval_jac += 1
        with self.runstats.tm_eval_jac:
            vals = self._dev(self.problem.eval_jac_vals(x)).reshape(-1)
        vals = vals * self._scale_cons_t[self._jac_rows_t]
        return vals[self._jac_eq_pos_t], vals[self._jac_in_pos_t]

    def eval_hess_vals(self, x, obj_factor, yc, yd):
        """Scaled upper-triangle Hessian triplet values; lam recombined from
        (yc, yd) into user constraint order."""
        self.runstats.n_eval_hess += 1
        lam = self._lam_user_order(yc, yd)
        with self.runstats.tm_eval_hess:
            vals = self.problem.eval_hess_vals(x, obj_factor * self.scale_obj, lam)
        return self._dev(vals).reshape(-1)

    def eval_hess(self, x, obj_factor, yc, yd):
        """Dense symmetric Hessian U + U^T - diag(U) assembled from the
        upper-triangle triplets, for the dense Newton KKT of moderate
        sizes."""
        vals = self.eval_hess_vals(x, obj_factor, yc, yd)
        n = self.n
        U = vals.new_zeros((n, n)).index_put_(self._hess_rc_t, vals, accumulate=True)
        return U + U.T - torch.diag(torch.diagonal(U))
