"""Mixed dense-sparse NLP formulation (hiopNlpMDS, hiopNlpFormulation.hpp:485).

Counterpart of ``hiop_tpu/formulation/mds.py``. Variables are ordered
[x_sparse, x_dense]; Jacobians split into a sparse triplet block and a
dense block; the Hessian is block-diagonal with a *diagonal* sparse block,
the structure the MDS KKT exploits (reference hiopKKTLinSysMDS.cpp:172-276).
The triplet structure is static: its index maps are built once on the host
and kept on the solver's device."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hiop_tpu_torch.formulation.base import NlpFormulation, to_numpy


class NlpMDS(NlpFormulation):
    def finalize_initialization(self) -> None:
        if self._finalized:
            return
        super().finalize_initialization()
        p = self.problem
        self.n_sparse, self.n_dense = p.get_sparse_dense_blocks_info()
        if self.n_sparse + self.n_dense != self.n:
            raise ValueError("n_sparse + n_dense must equal n")
        jr, jc = (np.asarray(a) for a in p.jac_sparse_structure())
        self.jac_sp_rows, self.jac_sp_cols = jr, jc
        eq_set = np.zeros(self.m, dtype=bool)
        eq_set[self.eq_idx] = True
        self._jac_is_eq = eq_set[jr]
        eq_rank = np.full(self.m, -1)
        eq_rank[self.eq_idx] = np.arange(self.m_eq)
        in_rank = np.full(self.m, -1)
        in_rank[self.ineq_idx] = np.arange(self.m_ineq)
        self.jac_sp_eq_rows = eq_rank[jr[self._jac_is_eq]]
        self.jac_sp_eq_cols = jc[self._jac_is_eq]
        self.jac_sp_in_rows = in_rank[jr[~self._jac_is_eq]]
        self.jac_sp_in_cols = jc[~self._jac_is_eq]
        place = self._place
        self._jac_sp_rows_t = place(jr.astype(np.int64))
        self._jac_eq_pos_t = place(np.nonzero(self._jac_is_eq)[0])
        self._jac_in_pos_t = place(np.nonzero(~self._jac_is_eq)[0])
        self._jac_eq_rc_t = (
            place(self.jac_sp_eq_rows.astype(np.int64)),
            place(self.jac_sp_eq_cols.astype(np.int64)),
        )
        self._jac_in_rc_t = (
            place(self.jac_sp_in_rows.astype(np.int64)),
            place(self.jac_sp_in_cols.astype(np.int64)),
        )

    def maybe_setup_scaling(self, x0) -> None:
        if self._scaling_done:
            return
        grad0 = to_numpy(self.problem.eval_grad_f(x0))
        sp_vals, dense_blk = self.problem.eval_jac_blocks(x0)
        row_norms = np.zeros(self.m)
        np.maximum.at(row_norms, self.jac_sp_rows, np.abs(to_numpy(sp_vals)))
        if self.m:
            dense_norms = (
                np.max(np.abs(to_numpy(dense_blk)), axis=1)
                if self.n_dense else np.zeros(self.m)
            )
            row_norms = np.maximum(row_norms, dense_norms)
        self._setup_scaling(grad0, row_norms)

    def eval_jac(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense (m_eq, n)/(m_ineq, n) materialization; the MDS KKT takes
        its blocks as column slices of these."""
        if getattr(self.problem, "jac_constant", False):
            cached = getattr(self, "_jac_cache", None)
            if cached is not None:
                return cached
        (veq, vin), De, Di = self.eval_jac_blocks_split(x)
        Jc = torch.zeros((self.m_eq, self.n), dtype=x.dtype, device=x.device)
        Jd = torch.zeros((self.m_ineq, self.n), dtype=x.dtype, device=x.device)
        if self.m_eq:
            Jc.index_put_(self._jac_eq_rc_t, veq, accumulate=True)
            Jc[:, self.n_sparse:] = De
        if self.m_ineq:
            Jd.index_put_(self._jac_in_rc_t, vin, accumulate=True)
            Jd[:, self.n_sparse:] = Di
        if getattr(self.problem, "jac_constant", False):
            self._jac_cache = (Jc, Jd)
        return Jc, Jd

    def eval_jac_blocks_split(self, x):
        """Returns ((sp_vals_eq, sp_vals_ineq), dense_eq, dense_ineq), scaled."""
        self.runstats.n_eval_jac += 1
        with self.runstats.tm_eval_jac:
            sp_vals, dense_blk = self.problem.eval_jac_blocks(x)
        sc = self._scale_cons_t
        sp_vals = self._dev(sp_vals) * sc[self._jac_sp_rows_t]
        dense_blk = self._dev(dense_blk).reshape(self.m, self.n_dense) * sc[:, None]
        return (
            (sp_vals[self._jac_eq_pos_t], sp_vals[self._jac_in_pos_t]),
            dense_blk[self._eq_idx_t, :],
            dense_blk[self._ineq_idx_t, :],
        )

    def eval_hess_blocks(self, x, obj_factor, yc, yd):
        """Returns (hss_diag, Hdd), scaled."""
        self.runstats.n_eval_hess += 1
        lam = torch.zeros((self.m,), dtype=x.dtype, device=x.device)
        if self.m_eq:
            lam[self._eq_idx_t] = yc * self.scale_cons_eq
        if self.m_ineq:
            lam[self._ineq_idx_t] = yd * self.scale_cons_ineq
        with self.runstats.tm_eval_hess:
            hss, hdd = self.problem.eval_hess_blocks(
                x, obj_factor * self.scale_obj, lam
            )
        return self._dev(hss), self._dev(hdd).reshape(self.n_dense, self.n_dense)
