"""NLP formulation: the problem runtime between user callbacks and solver.

Counterpart of ``hiop_tpu/formulation/base.py`` (reference
hiopNlpFormulation, hiopNlpFormulation.hpp:97): splits constraints into
equalities/inequalities, processes bounds (finite-bound patterns, bound
relaxation and its elastic-mode reset, fixed-variable relaxation or
removal), applies gradient-based scaling,
wraps user callbacks with counters, and owns options/logger/run-stats.

The transformation pipeline runs once at construction time on host numpy;
the solver's tensors live on the device that the ``compute_mode`` option
resolves to (:mod:`hiop_tpu_torch.backends.execspace`). Every user
evaluation receives ``x`` as a float64 tensor on that device, and its
result is moved there (a problem that computes with torch on ``x.device``
incurs no copy).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hiop_tpu_torch.backends.execspace import resolve_device
from hiop_tpu_torch.interface.base import INF, NlpProblem
from hiop_tpu_torch.optimization.iterate import Bounds
from hiop_tpu_torch.utils.logger import Logger, Verbosity
from hiop_tpu_torch.utils.dtensor import plain
from hiop_tpu_torch.utils.options import NlpOptions
from hiop_tpu_torch.utils.runstats import RunStats


class EvalError(RuntimeError):
    """User evaluation returned NaN/Inf (reference: Invalid_Number status)."""


def to_numpy(a) -> np.ndarray:
    """Host float64 copy of a tensor, array or scalar."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


class NlpFormulation:
    def __init__(
        self,
        problem: NlpProblem,
        options: Optional[NlpOptions] = None,
        logger: Optional[Logger] = None,
    ):
        self.problem = problem
        self.options = options if options is not None else NlpOptions()
        self.log = logger if logger is not None else Logger(
            self.options.integer("verbosity_level")
        )
        self.runstats = RunStats()
        self._finalized = False

    # ------------------------------------------------------------------ init
    def finalize_initialization(self) -> None:
        """Process sizes/bounds/constraints (reference finalizeInitialization,
        hiopNlpFormulation.cpp: process_bounds + process_constraints)."""
        if self._finalized:
            return
        p = self.problem
        self.device = resolve_device(self.options.str_("compute_mode"))
        self.n, self.m = p.get_prob_sizes()
        xl, xu = (np.asarray(a, dtype=np.float64).copy() for a in p.get_vars_info())
        cl, cu = (np.asarray(a, dtype=np.float64).copy() for a in p.get_cons_info())
        if xl.shape != (self.n,) or cl.shape != (self.m,):
            raise ValueError("bound arrays do not match get_prob_sizes()")

        # --- fixed variables (hiopFixedVarsRelaxer) -------------------------
        fv_tol = self.options.num("fixed_var_tolerance")
        fixed = (xu - xl) <= fv_tol * np.maximum(1.0, np.abs(xu))
        self.n_fixed_vars = int(np.sum(fixed))
        self._fixed_mask = fixed
        if self.n_fixed_vars > 0:
            mode = self.options.str_("fixed_var")
            if mode == "relax":
                pert = self.options.num("fixed_var_perturb")
                w = np.maximum(1.0, np.maximum(np.abs(xl), np.abs(xu)))
                xl = np.where(fixed, xl - pert * w, xl)
                xu = np.where(fixed, xu + pert * w, xu)
                self.log.printf(
                    Verbosity.WARNING,
                    "%d fixed variables relaxed by fixed_var_perturb",
                    self.n_fixed_vars,
                )
            elif mode in ("none", "fixed"):
                raise ValueError(
                    f"{self.n_fixed_vars} fixed variables detected; set option "
                    "fixed_var to 'relax' or 'remove' (reference behavior)"
                )
            elif mode == "remove":
                # true removal (hiopFixedVarsRemover): wrap the problem in
                # the reducing transform and re-run initialization on the
                # reduced space (dense-Jacobian problems, as in the
                # reference; others fall back to relaxation)
                from hiop_tpu_torch.formulation.transforms import FixedVarsRemover

                if hasattr(p, "eval_jac_cons"):
                    self.problem = FixedVarsRemover(p, fixed, 0.5 * (xl + xu))
                    self._fixed_remover = self.problem
                    self.log.printf(
                        Verbosity.SUMMARY,
                        "%d fixed variables removed from the problem",
                        self.n_fixed_vars,
                    )
                    return self.finalize_initialization()
                pert = max(self.options.num("fixed_var_perturb"), 1e-12)
                w = np.maximum(1.0, np.maximum(np.abs(xl), np.abs(xu)))
                xl = np.where(fixed, xl - pert * w, xl)
                xu = np.where(fixed, xu + pert * w, xu)
                self.log.printf(
                    Verbosity.WARNING,
                    "fixed_var=remove supported for dense-Jacobian problems; "
                    "falling back to relaxation",
                )

        # --- bound relaxation (hiopBoundsRelaxer, bound_relax_perturb) -----
        # keep the pristine bounds so elastic mode can re-relax with a
        # different perturbation later (reset_bounds)
        self._xl_pristine = xl.copy()
        self._xu_pristine = xu.copy()
        brp = self.options.num("bound_relax_perturb")
        if brp > 0:
            xl = np.where(xl > -INF, xl - brp * np.maximum(1.0, np.abs(xl)), xl)
            xu = np.where(xu < INF, xu + brp * np.maximum(1.0, np.abs(xu)), xu)

        # --- equality relaxation for the condensed KKT ---------------------
        # (hiopNlpSparseIneq, hiopNlpFormulation.hpp:657)
        if self.options.str_("KKTLinsys") == "condensed":
            r = self.options.num("eq_relax_factor") * np.maximum(1.0, np.abs(cl))
            is_eq = cl == cu
            cl = np.where(is_eq, cl - r, cl)
            cu = np.where(is_eq, cu + r, cu)

        # --- eq/ineq split (cons_eq_mapping_) ------------------------------
        eq = cl == cu
        self.eq_idx = np.nonzero(eq)[0]
        self.ineq_idx = np.nonzero(~eq)[0]
        self.m_eq = int(self.eq_idx.size)
        self.m_ineq = int(self.ineq_idx.size)
        crhs = cl[self.eq_idx]
        dl = cl[self.ineq_idx]
        du = cu[self.ineq_idx]
        self._dl_pristine = dl.copy()
        self._du_pristine = du.copy()
        if brp > 0 and self.m_ineq:
            dl = np.where(dl > -INF, dl - brp * np.maximum(1.0, np.abs(dl)), dl)
            du = np.where(du < INF, du + brp * np.maximum(1.0, np.abs(du)), du)

        ixl = (xl > -INF).astype(np.float64)
        ixu = (xu < INF).astype(np.float64)
        idl = (dl > -INF).astype(np.float64)
        idu = (du < INF).astype(np.float64)
        self.n_bnds_low = int(ixl.sum())
        self.n_bnds_upp = int(ixu.sum())
        self.m_ineq_low = int(idl.sum())
        self.m_ineq_upp = int(idu.sum())

        self._crhs_unscaled = crhs
        place = self._place
        self.bounds = Bounds(
            xl=place(np.where(ixl == 1.0, xl, 0.0)),
            xu=place(np.where(ixu == 1.0, xu, 0.0)),
            ixl=place(ixl),
            ixu=place(ixu),
            dl=place(np.where(idl == 1.0, dl, 0.0)),
            du=place(np.where(idu == 1.0, du, 0.0)),
            idl=place(idl),
            idu=place(idu),
        )
        self._eq_idx_t = place(self.eq_idx)
        self._ineq_idx_t = place(self.ineq_idx)

        # scaling factors set on first gradient evaluation
        self._set_scaling(1.0, np.ones(self.m))
        self._scaling_done = self.options.str_("scaling_type") == "none"
        self._finalized = True

    def reset_bounds(self, perturb: float) -> None:
        """Re-relax the pristine bounds with a new perturbation (elastic
        mode; reference hiopNlpFormulation::reset_bounds used by
        update_log_barrier_params). Rebuilds the device bound tensors; the
        finite-bound patterns stay."""
        xl = self._xl_pristine.copy()
        xu = self._xu_pristine.copy()
        dl = self._dl_pristine.copy()
        du = self._du_pristine.copy()
        if perturb > 0:
            xl = np.where(xl > -INF, xl - perturb * np.maximum(1.0, np.abs(xl)), xl)
            xu = np.where(xu < INF, xu + perturb * np.maximum(1.0, np.abs(xu)), xu)
            dl = np.where(dl > -INF, dl - perturb * np.maximum(1.0, np.abs(dl)), dl)
            du = np.where(du < INF, du + perturb * np.maximum(1.0, np.abs(du)), du)
        b = self.bounds
        place = self._place
        self.bounds = b._replace(
            xl=place(np.where(to_numpy(b.ixl) == 1.0, xl, 0.0)),
            xu=place(np.where(to_numpy(b.ixu) == 1.0, xu, 0.0)),
            dl=place(np.where(to_numpy(b.idl) == 1.0, dl, 0.0)),
            du=place(np.where(to_numpy(b.idu) == 1.0, du, 0.0)),
        )

    # --------------------------------------------------------------- scaling
    def _set_scaling(self, scale_obj: float, scale_cons: np.ndarray) -> None:
        self.scale_obj = scale_obj
        self._scale_cons = scale_cons
        place = self._place
        self._scale_cons_t = place(scale_cons)
        self.scale_cons_eq = place(scale_cons[self.eq_idx])
        self.scale_cons_ineq = place(scale_cons[self.ineq_idx])
        self.crhs = place(self._crhs_unscaled * scale_cons[self.eq_idx])

    def _setup_scaling(self, grad_f0: np.ndarray, jac0_row_norms: np.ndarray):
        """Gradient-based scaling (hiopNLPObjGradScaling): each of obj and
        constraints scaled so its gradient inf-norm <= scaling_max_grad."""
        gmax = self.options.num("scaling_max_grad")
        gmin = self.options.num("scaling_min_grad")
        o_target = self.options.num("scaling_max_obj_grad") or gmax
        c_target = self.options.num("scaling_max_con_grad") or gmax
        gnorm = float(np.max(np.abs(grad_f0))) if grad_f0.size else 0.0
        scale_obj = min(1.0, o_target / max(gnorm, 1e-30)) if gnorm > o_target else 1.0
        scale_obj = max(scale_obj, gmin)
        sc = np.ones(self.m)
        big = jac0_row_norms > c_target
        sc[big] = np.maximum(c_target / jac0_row_norms[big], gmin)
        self._set_scaling(scale_obj, sc)
        self._scaling_done = True
        self.log.printf(
            Verbosity.SCALARS,
            "scaling: obj %.3e, cons min %.3e",
            self.scale_obj,
            float(sc.min()) if self.m else 1.0,
        )

    # ------------------------------------------------------------ eval hooks
    def _place(self, a) -> torch.Tensor:
        """A host array (float or index) as a tensor on the solver's device."""
        return torch.as_tensor(a, device=self.device)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float64, device=self.device)

    def _for_problem(self, a):
        """``a`` as the problem's evaluations take it: this rank's replica
        of a DTensor for a problem that takes plain tensors only
        (``takes_dtensor``), else as it is."""
        if getattr(self, "_mesh", None) is None or getattr(self.problem, "takes_dtensor", True):
            return a
        return plain(a)

    def eval_f(self, x) -> torch.Tensor:
        self.runstats.n_eval_obj += 1
        x = self._for_problem(x)
        with self.runstats.tm_eval_obj:
            f = self._dev(self.problem.eval_f(x))
        return self.scale_obj * f

    def eval_grad_f(self, x):
        self.runstats.n_eval_grad += 1
        x = self._for_problem(x)
        with self.runstats.tm_eval_grad:
            g = self._dev(self.problem.eval_grad_f(x))
        return self.scale_obj * g

    def eval_cons(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (c_eq, d_ineq), scaled.

        Tries the user's two-call convention first (one evaluation per
        eq/ineq subset, hiopInterface.hpp:303-366); a ``NotImplemented``
        return falls back to the one-call convention with the internal
        eq/ineq split (hiopNlpFormulation.hpp:389-401)."""
        self.runstats.n_eval_cons += 1
        x = self._for_problem(x)
        with self.runstats.tm_eval_cons:
            subset = getattr(self.problem, "eval_cons_subset", None)
            c_eq = subset(x, self.eq_idx) if subset is not None else NotImplemented
            if c_eq is not NotImplemented:
                c_in = self.problem.eval_cons_subset(x, self.ineq_idx)
                return (
                    self._dev(c_eq).reshape(self.m_eq) * self.scale_cons_eq,
                    self._dev(c_in).reshape(self.m_ineq) * self.scale_cons_ineq,
                )
            c_all = self._dev(self.problem.eval_cons(x))
        c_all = c_all * self._scale_cons_t
        return c_all[self._eq_idx_t], c_all[self._ineq_idx_t]

    def eval_jac(self, x):
        """Formulation-specific; see subclasses."""
        raise NotImplementedError

    def eval_hess(self, x, obj_factor, yc, yd):
        """Dense (n, n) Lagrangian Hessian of the *scaled* problem; needed by
        the dense Newton solver. Formulation-specific; see subclasses."""
        raise NotImplementedError(
            "this formulation does not provide a dense Lagrangian Hessian"
        )

    def _lam_user_order(self, yc, yd):
        """Recombine (yc, yd) into user constraint order with scaling."""
        lam = torch.zeros((self.m,), dtype=torch.float64, device=self.device)
        if self.m_eq:
            lam[self._eq_idx_t] = plain(yc * self.scale_cons_eq)
        if self.m_ineq:
            lam[self._ineq_idx_t] = plain(yd * self.scale_cons_ineq)
        return lam

    def get_starting_point(self):
        return self._dev(np.asarray(self.problem.get_starting_point(), dtype=np.float64))

    # ------------------------------------------------------------- callbacks
    def user_callback_iterate(self, info) -> bool:
        if self.options.str_("callback_mem_space") == "host":
            # hand numpy arrays to the user (reference callback_mem_space
            # semantics, hiopInterface.hpp:395-399)
            import dataclasses

            info = dataclasses.replace(
                info,
                x=to_numpy(info.x), z_L=to_numpy(info.z_L),
                z_U=to_numpy(info.z_U), s=to_numpy(info.s),
                g=to_numpy(info.g), yc=to_numpy(info.yc),
                yd=to_numpy(info.yd),
            )
        return self.problem.iterate_callback(info)

    def user_callback_solution(self, status, x, zl, zu, cons, lam, obj) -> None:
        self.problem.solution_callback(status, x, zl, zu, cons, lam, obj)

    # -------------------------------------------------------------- unscaled
    def unscaled_obj(self, f_scaled) -> float:
        return float(f_scaled) / self.scale_obj
