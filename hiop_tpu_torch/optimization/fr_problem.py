"""Feasibility restoration (FR) phase.

Counterpart of ``hiop_tpu/optimization/fr_problem.py`` (reference
hiopFRProb{Sparse,MDS,Dense} and ``apply_feasibility_restoration``,
hiopFRProb.hpp:87,238,423, hiopFRProb.cpp ctor + iterate_callback): when the
line search collapses, pose the Ipopt §3.3 restoration NLP over
z = [x, p_e, n_e, p_i, n_i] (p, n >= 0):

  min  rho * sum(p + n) + zeta/2 * || D_R (x - x_ref) ||^2
  s.t. c_e(x) - p_e + n_e  = c_rhs
       dl <= c_i(x) - p_i + n_i <= du

with D_R = min(1/|x_ref|, 1), zeta = sqrt(mu_fr), rho = 1000, and
mu_fr = max(mu, ||infeasibility||_inf). The FR NLP is solved by a nested
IPM on the base solve's device; its iterate callback terminates the nested
solve as soon as the *original* infeasibility drops below kappa_resto times
its entry value and the point is acceptable to the original filter.

Evaluations run in torch on the base solve's device; index structures are
built once with numpy. The FR problem keeps the base's structure class:
dense-assembled for a dense-constrained base, triplets for a sparse one
(hiopFRProbSparse), sparse and dense blocks for an MDS one.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from hiop_tpu_torch.formulation.base import to_numpy
from hiop_tpu_torch.interface.base import INF, MdsProblem, NlpProblem, SparseProblem
from hiop_tpu_torch.status import SolveStatus
from hiop_tpu_torch.utils.logger import Verbosity

RHO = 1000.0  # penalty on p/n (reference hiopFRProb.cpp:132 "FIXME: option")


class FeasibilityRestorationProblem(NlpProblem):
    """The FR NLP, posed against the (scaled) base formulation.

    The Jacobian is dense-assembled: [J_base | -I | +I] blocks; the Hessian
    (Newton path) is blkdiag(H_base(x, 0, lam) + zeta*D_R^2, 0) — p/n enter
    linearly.
    """

    def __init__(self, base_form, x_ref, mu: float, nrmInf_feas_ref: float):
        self.base = base_form
        self.device = base_form.device
        self.n_x = base_form.n
        self.m_eq = base_form.m_eq
        self.m_ineq = base_form.m_ineq
        self.m = self.m_eq + self.m_ineq
        self.n = self.n_x + 2 * self.m
        self.x_ref = torch.as_tensor(x_ref, dtype=torch.float64, device=self.device)
        self.mu_fr = max(float(mu), float(nrmInf_feas_ref))
        self.zeta = math.sqrt(self.mu_fr)
        self.jittable = getattr(base_form.problem, "jittable", False)
        self.DR = torch.clamp(1.0 / torch.clamp(self.x_ref.abs(), min=1e-300), max=1.0)
        # termination bookkeeping (set by apply_feasibility_restoration)
        self.kappa_resto = base_form.options.num("kappa_resto")
        self.nrmInf_feas_ref = float(nrmInf_feas_ref)
        self.orig_filter = None
        self.accepted: Optional[dict] = None

    # -- sizes / bounds -----------------------------------------------------
    def get_prob_sizes(self):
        return self.n, self.m

    def get_vars_info(self):
        b = self.base.bounds
        xl = np.where(to_numpy(b.ixl) == 1.0, to_numpy(b.xl), -INF)
        xu = np.where(to_numpy(b.ixu) == 1.0, to_numpy(b.xu), INF)
        lo = np.concatenate([xl, np.zeros(2 * self.m)])
        hi = np.concatenate([xu, np.full(2 * self.m, INF)])
        return lo, hi

    def get_cons_info(self):
        b = self.base.bounds
        crhs = to_numpy(self.base.crhs)
        dl = np.where(to_numpy(b.idl) == 1.0, to_numpy(b.dl), -INF)
        du = np.where(to_numpy(b.idu) == 1.0, to_numpy(b.du), INF)
        return np.concatenate([crhs, dl]), np.concatenate([crhs, du])

    def get_starting_point(self):
        """x = x_ref; p/n from the Ipopt (3.5)-(3.6) closed form (host numpy,
        once per FR phase)."""
        c, d = self.base.eval_cons(self.x_ref)
        v_eq = to_numpy(c) - to_numpy(self.base.crhs)
        cl, cu = self.get_cons_info()
        d_np = to_numpy(d)
        v_in = d_np - np.clip(d_np, cl[self.m_eq:], cu[self.m_eq:])
        mu, rho = self.mu_fr, RHO

        def pn(v):
            t = (mu - rho * v) / (2 * rho)
            n = t + np.sqrt(t * t + mu * v / (2 * rho) + 1e-300 * (v == 0))
            n = np.maximum(n, 1e-12)
            p = np.maximum(v + n, 1e-12)
            return p, n

        pe, ne = pn(v_eq) if self.m_eq else (np.zeros(0), np.zeros(0))
        pi, ni = pn(v_in) if self.m_ineq else (np.zeros(0), np.zeros(0))
        return np.concatenate([to_numpy(self.x_ref), pe, ne, pi, ni])

    # -- evaluations --------------------------------------------------------
    def _split(self, z):
        nx, me, mi = self.n_x, self.m_eq, self.m_ineq
        x = z[:nx]
        pe = z[nx:nx + me]
        ne = z[nx + me:nx + 2 * me]
        pi = z[nx + 2 * me:nx + 2 * me + mi]
        ni = z[nx + 2 * me + mi:]
        return x, pe, ne, pi, ni

    def eval_f(self, z):
        x, pe, ne, pi, ni = self._split(z)
        dx = (x - self.x_ref) * self.DR
        return RHO * (pe.sum() + ne.sum() + pi.sum() + ni.sum()) + (
            0.5 * self.zeta * torch.dot(dx, dx)
        )

    def eval_grad_f(self, z):
        x, *_ = self._split(z)
        gx = self.zeta * self.DR * self.DR * (x - self.x_ref)
        return torch.cat([gx, gx.new_full((2 * self.m,), RHO)])

    def eval_cons(self, z):
        x, pe, ne, pi, ni = self._split(z)
        c, d = self.base.eval_cons(x)
        return torch.cat([c - pe + ne, d - pi + ni])

    def eval_jac_cons(self, z):
        x, *_ = self._split(z)
        Jc, Jd = self.base.eval_jac(x)
        me, mi = self.m_eq, self.m_ineq
        kw = dict(dtype=z.dtype, device=z.device)
        Ie = torch.eye(me, **kw)
        Ii = torch.eye(mi, **kw)
        top = torch.cat(
            [Jc, -Ie, Ie, torch.zeros((me, mi), **kw), torch.zeros((me, mi), **kw)], dim=1
        )
        bot = torch.cat(
            [Jd, torch.zeros((mi, me), **kw), torch.zeros((mi, me), **kw), -Ii, Ii], dim=1
        )
        return torch.cat([top, bot], dim=0)

    def eval_hess_lagr(self, z, obj_factor, lam):
        x, *_ = self._split(z)
        yc = lam[: self.m_eq]
        yd = lam[self.m_eq:]
        # base Hessian with zero objective contribution + FR proximal term
        Hx = self.base.eval_hess(x, 0.0, yc, yd)
        Hx = Hx + obj_factor * torch.diag(self.zeta * self.DR * self.DR)
        H = z.new_zeros((self.n, self.n))
        H[: self.n_x, : self.n_x] = Hx
        return H

    # -- termination --------------------------------------------------------
    def iterate_callback(self, info) -> bool:
        """Stop the nested solve once the original problem's infeasibility is
        small enough and the point is not in the original filter
        (hiopFRProbSparse::iterate_callback). The accepted point stays on
        the device."""
        dev = self.device
        z = torch.as_tensor(info.x, dtype=torch.float64, device=dev)
        x, *_ = self._split(z)
        c, d = self.base.eval_cons(x)
        # the FR solver's inequality slacks for the base-ineq rows
        s = torch.as_tensor(info.s, dtype=torch.float64, device=dev)
        d_base = s[s.shape[0] - self.m_ineq:]
        v_eq = c - self.base.crhs
        v_in = d - d_base
        zero = z.new_zeros(())
        nrm = torch.stack([
            v_eq.abs().max() if v_eq.numel() else zero,
            v_in.abs().max() if v_in.numel() else zero,
            v_eq.abs().sum() + v_in.abs().sum(),
        ]).tolist()
        nrmInf = max(nrm[0], nrm[1])
        if info.iter > 0 and nrmInf <= self.kappa_resto * self.nrmInf_feas_ref:
            theta_ori = nrm[2]
            if self.orig_filter is None or not self.orig_filter.contains(
                theta_ori, float("-inf")
            ):
                self.accepted = {"x": x, "d": d_base, "theta": theta_ori}
                return False  # stops the nested solver (User_Stopped)
        return True


class SparseFeasibilityRestorationProblem(FeasibilityRestorationProblem, SparseProblem):
    """Sparse-preserving FR NLP (hiopFRProbSparse, hiopFRProb.hpp:87).

    The FR Jacobian [J_base | -I | +I] and Hessian blkdiag(H_base +
    zeta*D_R^2, 0) are posed in TRIPLET form against the base NlpSparse
    formulation's static structure (nnz(J) + 2m and nnz(H) + n entries), so
    the nested IPM routes through the sparse KKT strategies and never forms
    the dense (m, n+2m) matrix of :class:`FeasibilityRestorationProblem`.

    FR constraint rows are ordered [base eq rows; base ineq rows]; triplet
    values come from the base formulation's scaled split evaluation, which
    is also what :meth:`eval_cons` (inherited) returns."""

    def __init__(self, base_form, x_ref, mu: float, nrmInf_feas_ref: float):
        super().__init__(base_form, x_ref, mu, nrmInf_feas_ref)
        b = base_form
        nx, me, mi = self.n_x, self.m_eq, self.m_ineq
        # base triplets in the split (eq-first) order of
        # NlpSparse.eval_jac_vals_split
        base_rows = np.concatenate([b.jac_eq_rows, me + b.jac_in_rows])
        base_cols = np.concatenate([b.jac_eq_cols, b.jac_in_cols])
        pn_rows = np.concatenate(
            [np.arange(me), np.arange(me), me + np.arange(mi), me + np.arange(mi)]
        )
        pn_cols = nx + np.concatenate(
            [
                np.arange(me),                 # p_e
                me + np.arange(me),            # n_e
                2 * me + np.arange(mi),        # p_i
                2 * me + mi + np.arange(mi),   # n_i
            ]
        )
        self._fr_jr = np.concatenate([base_rows, pn_rows]).astype(np.int64)
        self._fr_jc = np.concatenate([base_cols, pn_cols]).astype(np.int64)
        self._pn_vals = torch.as_tensor(
            np.concatenate([-np.ones(me), np.ones(me), -np.ones(mi), np.ones(mi)]),
            device=self.device,
        )
        # Hessian upper triangle: base triplets + the x-diagonal proximal
        # term (duplicates of existing diagonal entries scatter-add)
        self._fr_hr = np.concatenate([b.hess_rows, np.arange(nx)]).astype(np.int64)
        self._fr_hc = np.concatenate([b.hess_cols, np.arange(nx)]).astype(np.int64)

    # -- SparseProblem structure surface ------------------------------------
    def get_sparse_blocks_info(self):
        return self.n, self._fr_jr.size, self._fr_hr.size

    def jac_structure(self):
        return self._fr_jr, self._fr_jc

    def eval_jac_vals(self, z):
        x, *_ = self._split(z)
        vals_eq, vals_in = self.base.eval_jac_vals_split(x)
        return torch.cat([vals_eq, vals_in, self._pn_vals.to(z.dtype)])

    def hess_structure(self):
        return self._fr_hr, self._fr_hc

    def eval_hess_vals(self, z, obj_factor, lam):
        x, *_ = self._split(z)
        yc = lam[: self.m_eq]
        yd = lam[self.m_eq:]
        base_vals = self.base.eval_hess_vals(x, 0.0, yc, yd)
        return torch.cat([base_vals, obj_factor * self.zeta * self.DR * self.DR])


class MdsFeasibilityRestorationProblem(FeasibilityRestorationProblem, MdsProblem):
    """MDS-structured FR NLP (hiopFRProbMDS, hiopFRProb.hpp:238).

    The relaxation variables p/n join the SPARSE block — they enter the
    constraints as ±identity triplet entries and the Hessian not at all —
    so the FR variable order is z = [x_s, p_e, n_e, p_i, n_i, x_d]:
    (n_s + 2m) sparse + n_d dense variables. The nested IPM then routes
    through the MDS KKT strategy (triplet Schur elimination, the Cholesky
    kernel on the quick tier, the no-pivot LDL^T kernel on the device safe
    tier) and never calls :meth:`eval_jac_cons` or :meth:`eval_hess_lagr`,
    whose dense (m, n + 2m) and (n + 2m)^2 assemblies are for off-path
    consumers only (at ACOPF B=512: 532 MB and 1.67 GB in f64).

    Constraint rows are ordered [base eq; base ineq], matching the generic
    FR class; Jacobian/Hessian values come from the base NlpMDS
    formulation's scaled split evaluations."""

    def __init__(self, base_form, x_ref, mu: float, nrmInf_feas_ref: float):
        super().__init__(base_form, x_ref, mu, nrmInf_feas_ref)
        b = base_form
        self.ns = b.n_sparse
        self.nd = b.n_dense
        me, mi = self.m_eq, self.m_ineq
        ns = self.ns
        # sparse-block structure in FR row order (eq rows first), with the
        # p/n columns appended after the base sparse columns
        base_rows = np.concatenate([b.jac_sp_eq_rows, me + b.jac_sp_in_rows])
        base_cols = np.concatenate([b.jac_sp_eq_cols, b.jac_sp_in_cols])
        pn_rows = np.concatenate(
            [np.arange(me), np.arange(me), me + np.arange(mi), me + np.arange(mi)]
        )
        pn_cols = ns + np.concatenate(
            [
                np.arange(me),                 # p_e
                me + np.arange(me),            # n_e
                2 * me + np.arange(mi),        # p_i
                2 * me + mi + np.arange(mi),   # n_i
            ]
        )
        self._fr_jr = np.concatenate([base_rows, pn_rows]).astype(np.int64)
        self._fr_jc = np.concatenate([base_cols, pn_cols]).astype(np.int64)
        self._pn_vals = torch.as_tensor(
            np.concatenate([-np.ones(me), np.ones(me), -np.ones(mi), np.ones(mi)]),
            device=self.device,
        )

    # -- MDS structure surface ---------------------------------------------
    def get_sparse_dense_blocks_info(self):
        return self.ns + 2 * self.m, self.nd

    def jac_sparse_structure(self):
        return self._fr_jr, self._fr_jc

    def eval_jac_blocks(self, z):
        x, *_ = self._split(z)
        (veq, vin), De, Di = self.base.eval_jac_blocks_split(x)
        sp_vals = torch.cat([veq, vin, self._pn_vals.to(z.dtype)])
        dense_blk = torch.cat([De, Di], dim=0)
        return sp_vals, dense_blk

    def eval_hess_blocks(self, z, obj_factor, lam):
        x, *_ = self._split(z)
        yc = lam[: self.m_eq]
        yd = lam[self.m_eq:]
        hss, hdd = self.base.eval_hess_blocks(x, 0.0, yc, yd)
        drs = self.DR[: self.ns]
        drd = self.DR[self.ns:]
        hss_fr = torch.cat(
            [
                hss + obj_factor * self.zeta * drs * drs,
                hss.new_zeros((2 * self.m,)),
            ]
        )
        hdd_fr = hdd + obj_factor * self.zeta * torch.diag(drd * drd)
        return hss_fr, hdd_fr

    # -- reordered generic surface ------------------------------------------
    def _split(self, z):
        ns, me, mi = self.ns, self.m_eq, self.m_ineq
        xs = z[:ns]
        pe = z[ns:ns + me]
        ne = z[ns + me:ns + 2 * me]
        pi = z[ns + 2 * me:ns + 2 * me + mi]
        ni = z[ns + 2 * me + mi:ns + 2 * me + 2 * mi]
        xd = z[ns + 2 * self.m:]
        return torch.cat([xs, xd]), pe, ne, pi, ni

    def _reorder_x_pn(self, x_part, pn_part):
        """[x..., pn...] (generic order) -> [x_s, pn..., x_d] (MDS order)."""
        return np.concatenate([x_part[: self.ns], pn_part, x_part[self.ns:]])

    def get_vars_info(self):
        lo, hi = super().get_vars_info()
        return (
            self._reorder_x_pn(lo[: self.n_x], lo[self.n_x:]),
            self._reorder_x_pn(hi[: self.n_x], hi[self.n_x:]),
        )

    def get_starting_point(self):
        z = super().get_starting_point()
        return self._reorder_x_pn(z[: self.n_x], z[self.n_x:])

    def eval_grad_f(self, z):
        x, *_ = self._split(z)
        gx = self.zeta * self.DR * self.DR * (x - self.x_ref)
        rho = gx.new_full((2 * self.m,), RHO)
        return torch.cat([gx[: self.ns], rho, gx[self.ns:]])

    def eval_jac_cons(self, z):
        """Dense materialization in the MDS variable order (off-path
        consumers only; the MDS KKT uses eval_jac_blocks)."""
        sp_vals, dense_blk = self.eval_jac_blocks(z)
        J = z.new_zeros((self.m, self.n))
        rc = (torch.as_tensor(self._fr_jr, device=z.device),
              torch.as_tensor(self._fr_jc, device=z.device))
        J.index_put_(rc, sp_vals, accumulate=True)
        J[:, self.ns + 2 * self.m:] = dense_blk
        return J

    def eval_hess_lagr(self, z, obj_factor, lam):
        """Dense blkdiag in the MDS variable order (off-path)."""
        hss, hdd = self.eval_hess_blocks(z, obj_factor, lam)
        n_sp = self.ns + 2 * self.m
        H = z.new_zeros((self.n, self.n))
        H[:n_sp, :n_sp] = torch.diag(hss)
        H[n_sp:, n_sp:] = hdd
        return H


def apply_feasibility_restoration(solver, it_curr, mu, norms):
    """Drive the nested FR solve (apply_feasibility_restoration,
    hiopAlgFilterIPM.cpp:3040+). Returns the accepted dict (``x``, ``d`` on
    the device, ``theta``) or None; sets ``solver.solver_status`` to
    Infeasible_Problem when the FR NLP converges to a point that is still
    infeasible.

    The FR subproblem keeps the base formulation's structure class: a
    sparse base gets :class:`SparseFeasibilityRestorationProblem` under
    ``NlpSparse`` (triplet KKT), an MDS base
    :class:`MdsFeasibilityRestorationProblem` under ``NlpMDS``, a
    dense-constrained base the dense-assembled FR problem under
    ``NlpDenseConstraints``."""
    from hiop_tpu_torch.formulation.dense import NlpDenseConstraints
    from hiop_tpu_torch.formulation.mds import NlpMDS
    from hiop_tpu_torch.formulation.sparse import NlpSparse
    from hiop_tpu_torch.utils.options import NlpOptions
    import hiop_tpu_torch.optimization.filter_ipm as fi

    base = solver.nlp
    nrm_feas = float(norms.nlp_feasib)
    if isinstance(base, NlpSparse):
        fr_cls, form_cls = SparseFeasibilityRestorationProblem, NlpSparse
    elif isinstance(base, NlpMDS):
        fr_cls, form_cls = MdsFeasibilityRestorationProblem, NlpMDS
    elif isinstance(base, NlpDenseConstraints):
        fr_cls, form_cls = FeasibilityRestorationProblem, NlpDenseConstraints
    else:
        raise fi._unknown_formulation("feasibility restoration", base)
    fr_prob = fr_cls(base, it_curr.x, mu, nrm_feas)
    fr_prob.orig_filter = solver.filter

    o = NlpOptions()
    # inherit key tolerances from the base solve; quiet nested output. The
    # nested solve also inherits the base's compute_mode and exec_policies,
    # and only those: fresh options would resolve "auto" to cuda:0, and the
    # nested solve must stay on the base solve's device and factorization
    # lane (hiop_tpu's fresh options reset its global backend to xla for
    # the rest of the outer solve)
    o.update(
        mu0=max(fr_prob.mu_fr, 1e-6),
        tolerance=base.options.num("tolerance"),
        max_iter=min(base.options.integer("max_iter"), 500),
        verbosity_level=0,
        scaling_type="none",
        force_resto="no",
        compute_mode=base.options.str_("compute_mode"),
        exec_policies=base.options.str_("exec_policies"),
    )
    fr_file = base.options.str_("options_file_fr_prob")
    if fr_file and os.path.exists(fr_file):
        o.load_from_file(fr_file)

    newton = base.options.str_("Hessian") == "analytical_exact"
    if newton:
        o.update(Hessian="analytical_exact")
    nlp_fr = form_cls(fr_prob, o, logger=base.log)
    alg = fi.FilterIPMNewton(nlp_fr) if newton else fi.FilterIPMQuasiNewton(nlp_fr)
    alg.within_fr = True
    result = alg.run()
    # what the last nested solve did, for the caller's reports
    solver.last_fr = dict(iterations=result.iterations, status=result.status,
                          accepted=fr_prob.accepted is not None)
    if fr_prob.accepted is not None:
        solver.log.printf(
            Verbosity.SUMMARY,
            "FR phase succeeded after %d nested iterations (theta %.3e)",
            result.iterations,
            fr_prob.accepted["theta"],
        )
        return fr_prob.accepted
    solver.log.printf(
        Verbosity.WARNING,
        "FR phase did not restore feasibility (status %s)",
        result.status.name,
    )
    if result.status.is_success:
        # the FR NLP converged to a local minimizer of the infeasibility
        # that is still infeasible -> the problem is (locally) infeasible
        solver.solver_status = SolveStatus_Infeasible()
    return None


def SolveStatus_Infeasible():
    return SolveStatus.Infeasible_Problem
