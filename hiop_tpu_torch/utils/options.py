"""Typed options registry.

Parity with the reference's ``hiopOptions`` / ``hiopOptionsNLP`` /
``hiopOptionsPriDec`` (HiOp src/Utils/hiopOptions.hpp:61,196,211 and
the ~110 registrations at hiopOptions.cpp:566-1705): typed numeric/integer/
string options with ranges and self-documentation, file-based loading,
programmatic setters, user-set-vs-default tracking, consistency enforcement,
and pretty-printing.

TPU-specific additions are documented inline (e.g. ``kkt_fact_dtype`` for
mixed-precision factorization, ``jit_mode`` controlling how much of the
iteration is fused into one XLA computation).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Union


@dataclasses.dataclass
class _NumOption:
    name: str
    default: float
    lb: float
    ub: float
    description: str = ""
    value: float = 0.0
    is_user_defined: bool = False

    def set(self, v: Any) -> bool:
        try:
            v = float(v)
        except (TypeError, ValueError):
            return False
        if not (self.lb <= v <= self.ub) or not math.isfinite(v):
            return False
        self.value = v
        return True


@dataclasses.dataclass
class _IntOption:
    name: str
    default: int
    lb: int
    ub: int
    description: str = ""
    value: int = 0
    is_user_defined: bool = False

    def set(self, v: Any) -> bool:
        try:
            fv = float(v)
            iv = int(fv)
        except (TypeError, ValueError):
            return False
        if fv != iv or not (self.lb <= iv <= self.ub):
            return False
        self.value = iv
        return True


@dataclasses.dataclass
class _StrOption:
    name: str
    default: str
    range: Optional[List[str]]
    description: str = ""
    value: str = ""
    is_user_defined: bool = False

    def set(self, v: Any) -> bool:
        if not isinstance(v, str):
            return False
        # enumerated options match case-insensitively (reference behavior);
        # free strings (paths: checkpoint_file, profile_dir, ...) keep case
        if self.range is not None:
            v = v.lower()
            if v not in self.range:
                return False
        self.value = v
        return True


_Option = Union[_NumOption, _IntOption, _StrOption]


class OptionsBase:
    """Registry of typed options with validation and file loading."""

    #: set to None on an instance/class to disable cwd auto-loading
    DEFAULT_FILENAME: Optional[str] = None

    def __init__(self, options_file: Optional[str] = None, logger=None):
        self._opts: Dict[str, _Option] = {}
        self._log = logger
        self._register_all()
        for o in self._opts.values():
            if isinstance(o, _StrOption):
                o.value = o.default
            else:
                o.value = o.default
        # like the reference (hiopOptions ctor + hiopNlpFormulation), the
        # per-kind default file ("hiop.options" / "hiop_pridec.options") is
        # picked up from the working directory when present
        if options_file is None:
            options_file = self.DEFAULT_FILENAME
        if options_file is not None and os.path.exists(options_file):
            self.load_from_file(options_file)
        self.ensure_consistence()

    # -- registration -------------------------------------------------------
    def _register_all(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def register_num(self, name, default, lb, ub, description=""):
        self._opts[name] = _NumOption(name, default, lb, ub, description, default)

    def register_int(self, name, default, lb, ub, description=""):
        self._opts[name] = _IntOption(name, default, lb, ub, description, default)

    def register_str(self, name, default, rng: Optional[Sequence[str]] = None, description=""):
        rng_l = [r.lower() for r in rng] if rng is not None else None
        self._opts[name] = _StrOption(name, default.lower(), rng_l, description, default.lower())

    # -- access -------------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._opts

    def get(self, name: str):
        o = self._opts[name]
        return o.value

    # Convenience typed getters mirroring GetNumeric/GetInteger/GetString.
    def num(self, name: str) -> float:
        o = self._opts[name]
        assert isinstance(o, _NumOption), f"{name} is not a numeric option"
        return o.value

    def integer(self, name: str) -> int:
        o = self._opts[name]
        assert isinstance(o, _IntOption), f"{name} is not an integer option"
        return o.value

    def str_(self, name: str) -> str:
        o = self._opts[name]
        assert isinstance(o, _StrOption), f"{name} is not a string option"
        return o.value

    def is_user_defined(self, name: str) -> bool:
        return self._opts[name].is_user_defined

    def set(self, name: str, value, mark_user: bool = True) -> bool:
        """Programmatic setter (SetNumericValue/SetIntegerValue/SetStringValue)."""
        if name not in self._opts:
            self._warn(f"option '{name}' is not recognized and will be ignored")
            return False
        o = self._opts[name]
        if not o.set(value):
            self._warn(
                f"value '{value}' for option '{name}' is invalid; "
                f"keeping '{o.value}'"
            )
            return False
        if mark_user:
            o.is_user_defined = True
        self.ensure_consistence()
        return True

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.set(k, v)

    # -- file I/O -----------------------------------------------------------
    def load_from_file(self, path: str) -> None:
        """Load ``name value`` pairs; '#' starts a comment (hiop.options format)."""
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                if len(parts) < 2:
                    self._warn(f"malformed options line ignored: '{line}'")
                    continue
                self.set(parts[0], parts[1])

    # -- misc ---------------------------------------------------------------
    def ensure_consistence(self) -> None:
        """Subclasses enforce cross-option constraints (demote with warnings)."""

    def _warn(self, msg: str) -> None:
        if self._log is not None:
            self._log.warning(f"[options] {msg}")

    def pretty_print(self, only_user_defined: bool = False) -> str:
        lines = []
        for name in sorted(self._opts):
            o = self._opts[name]
            if only_user_defined and not o.is_user_defined:
                continue
            tag = " (user)" if o.is_user_defined else ""
            lines.append(f"{name} {o.value}{tag}")
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.value for k, v in self._opts.items()}


class NlpOptions(OptionsBase):
    """NLP solver options; names/defaults/ranges track hiopOptionsNLP
    (HiOp src/Utils/hiopOptions.cpp:566-1310)."""

    DEFAULT_FILENAME = "hiop.options"

    def _register_all(self) -> None:
        rn, ri, rs = self.register_num, self.register_int, self.register_str
        # barrier / mu strategy
        rn("mu0", 1.0, 1e-16, 1000.0, "Initial log-barrier parameter mu")
        rn("kappa_mu", 0.2, 1e-8, 0.999, "Linear reduction coefficient for mu")
        rn("theta_mu", 1.5, 1.0, 2.0, "Exponential reduction coefficient for mu")
        rn("eta_phi", 1e-8, 0.0, 0.01, "Armijo sufficient-decrease parameter")
        rn("tolerance", 1e-8, 1e-14, 1e-1, "Absolute NLP error tolerance")
        rn("cons_tol", 1e-4, 1e-12, 1e-1, "Absolute feasibility tolerance at 'solved' point")
        rn("dual_tol", 1.0, 1e-12, 1e1, "Absolute dual-infeasibility tolerance at 'solved' point")
        rn("comp_tol", 1e-4, 1e-12, 1e-1, "Absolute complementarity tolerance at 'solved' point")
        rn("rel_tolerance", 0.0, 0.0, 0.1, "Error tolerance relative to errors at initial point")
        rn("tau_min", 0.99, 0.9, 0.99999, "Fraction-to-the-boundary parameter")
        rn("kappa_eps", 10.0, 1e-6, 1e3, "mu reduced when log-bar error < kappa_eps*mu")
        rn("kappa1", 1e-2, 1e-16, 1.0, "bound-projection parameter in initialization")
        rn("kappa2", 1e-2, 1e-16, 0.49999, "shift projection parameter (double-bounded vars)")
        rn("smax", 100.0, 1.0, 1e7, "multiplier threshold in optimality-error scaling")
        # duals
        rs("duals_update_type", "lsq", ["lsq", "linear"], "multiplier update rule")
        rn("recalc_lsq_duals_tol", 1e-6, 0.0, 1e10, "recompute LSQ duals when infeasibility below this")
        rs("duals_init", "lsq", ["lsq", "zero"], "initialization of eq-multipliers")
        rn("duals_lsq_ini_max", 1e3, 1e-16, 1e10, "cap on initial LSQ duals; fall back to zeros above it")
        ri("max_iter", 3000, 1, int(1e6), "max iterations")
        rn("acceptable_tolerance", 1e-6, 1e-14, 1e-1, "acceptable NLP error")
        ri("acceptable_iterations", 10, 1, int(1e6), "consecutive acceptable iters before exit")
        rn("sigma0", 1.0, 0.0, 1e7, "initial multiplier of identity in secant approx")
        rs("accept_every_trial_step", "no", ["yes", "no"], "disable line-search")
        rn("min_step_size", 1e-16, 0.0, 1e6, "min step; smaller triggers restoration/small-step exit")
        rn("moving_lim_abs", 0.0, 0.0, 1e8, "absolute moving limits around current iterate (0=off)")
        rn("moving_lim_rel", 0.0, 0.0, 1.0, "relative moving limits (0=off)")
        rn("theta_max_fact", 1e4, 0.0, 1e7, "factor for max constraint violation in filter")
        rn("theta_min_fact", 1e-4, 0.0, 1e7, "factor for min constraint violation switching cond")
        rs(
            "sigma_update_strategy",
            "sty",
            ["sigma0", "sty", "sty_inv", "snrm_ynrm", "sty_srnm_ynrm"],
            "update of identity multiplier in secant approximation",
        )
        ri("secant_memory_len", 6, 0, 256, "L-BFGS memory")
        ri("verbosity_level", 3, 0, 12, "0 errors only .. 12 max")
        # fixed variables / scaling / warm start
        rs("fixed_var", "none", ["none", "fixed", "relax", "remove"], "fixed-variable treatment")
        rn("fixed_var_tolerance", 1e-15, 1e-30, 0.01, "bounds closer than this => fixed var")
        rn("fixed_var_perturb", 1e-8, 1e-14, 0.1, "relaxation amount for fixed vars")
        rs("warm_start", "no", ["yes", "no"], "use user-provided warm-start point/duals")
        rs("scaling_type", "gradient", ["none", "gradient"], "problem scaling strategy")
        rn("scaling_max_grad", 100.0, 1e-20, 1e20, "max gradient entry after scaling")
        rn("scaling_max_obj_grad", 0.0, 0.0, 1e20, "override: target inf-norm of scaled obj grad")
        rn("scaling_max_con_grad", 0.0, 0.0, 1e20, "override: target inf-norm of scaled cons grads")
        rn("scaling_min_grad", 1e-8, 0.0, 1e20, "floor on scaling factors")
        # outer iterative refinement (BiCGStab over full KKT)
        rn("ir_outer_tol_factor", 1e-2, 1e-20, 1.0, "outer IR tol = factor*mu, floored")
        rn("ir_outer_tol_min", 1e-6, 1e-20, 1.0, "floor for outer IR tolerance")
        ri("ir_outer_maxit", 8, 0, 100, "max outer IR iterations (0 disables)")
        rn("bound_relax_perturb", 1e-8, 0.0, 1e20, "relative perturbation of variable/constraint bounds")
        rn("eq_relax_factor", 1e-8, 1e-15, 1.0, "relaxation of equalities into inequalities (condensed KKT)")
        # second-order correction & restoration
        ri("max_soc_iter", 4, 0, 1000000, "max second-order-correction iterations")
        rn("kappa_soc", 0.99, 0.0, 1e20, "SOC constraint-violation decrease factor")
        rs("options_file_fr_prob", "hiop_fr.options", None, "options file for the FR subproblem")
        rn("kappa_resto", 0.9, 0.0, 1.0, "FR acceptance factor on infeasibility")
        rs("force_resto", "no", ["yes", "no"], "force feasibility-restoration phase")
        # Hessian & KKT selection
        rs(
            "Hessian",
            "quasinewton_approx",
            ["quasinewton_approx", "analytical_exact"],
            "Hessian mode",
        )
        rs(
            "KKTLinsys",
            "auto",
            ["auto", "xycyd", "xdycyd", "full", "condensed", "normaleqn"],
            "KKT linearization",
        )
        rs(
            "linear_solver_sparse",
            "auto",
            None,  # open set: builtins + any solver_registry bridge name
            "inner linear solver for (densified) sparse KKT systems "
            "(TPU-native set; the reference's ma57/pardiso/... map to these)",
        )
        rs(
            "duals_init_linear_solver_sparse",
            "auto",
            ["auto", "cholesky", "lu", "qr", "cg", "bicgstab"],
            "linear solver for the duals LSQ initialization",
        )
        rs(
            "linear_solver_sparse_ordering",
            "auto",
            ["auto", "none", "amd", "rcm", "qd_amd"],
            "fill-reducing ordering for sparse symbolic analysis (qd_amd: "
            "AMD restricted to primal-before-dual elimination — exact "
            "no-pivot inertia for quasi-definite KKT, device_ldl backend)",
        )
        # inner iterative refinement (FGMRES-style, ReSolve parity)
        ri("ir_inner_restart", 20, 1, 100, "FGMRES restart")
        rn("ir_inner_tol", 1e-12, 1e-16, 1e-1, "inner IR tolerance")
        rn("ir_inner_tol_min", 1e-6, 1e-20, 1.0, "floor for adaptive inner IR tolerance")
        ri("ir_inner_conv_cond", 0, 0, 2, "convergence condition for inner IR")
        rn("ir_inner_tol_factor", 1e-2, 1e-20, 1.0, "inner IR tol = factor*mu")
        ri("ir_inner_maxit", 50, 0, 1000, "max inner IR iterations")
        rs("ir_inner_gs_scheme", "cgs2",
           ["mgs", "cgs2", "mgs_two_synch", "mgs_pm"],
           "Gram-Schmidt orthogonalization for the inner FGMRES "
           "(hiopOptions.cpp:1042): mgs=modified GS (one device sync per "
           "basis vector); cgs2=reorthogonalized classical GS (3 syncs); "
           "mgs_two_synch/mgs_pm=low-synch MGS with a triangular correction "
           "(2 syncs) — fewer host<->TPU round trips per Krylov iteration")
        # reference backend sub-options accepted for option-file compatibility;
        # ensure_consistence demotes them onto the TPU-native solver set
        rs("resolve_factorization", "klu", None,
           "accepted for hiop option-file compatibility (ReSolve CUDA backend "
           "sub-option); the TPU build's equivalent is kkt_fact_dtype=float32 "
           "+ ir_inner_* FGMRES refinement")
        rs("resolve_refactorization", "glu", None,
           "accepted for hiop option-file compatibility (ReSolve CUDA backend "
           "sub-option); see resolve_factorization")
        rs("ginkgo_exec", "reference", None,
           "accepted for hiop option-file compatibility (Ginkgo executor); "
           "device placement here is governed by compute_mode/mem_space")
        rs("ginkgo_trisolve", "sparselib", None,
           "accepted for hiop option-file compatibility (Ginkgo triangular "
           "solve algorithm)")
        rs("linsol_mode", "stable", ["stable", "speculative", "forcequick"],
           "stable=safe factorizations; speculative=try fast path w/ fallback; forcequick=fast only")
        rs("profile_dir", "", None,
           "when nonempty, wrap the solve in a jax profiler trace written to "
           "this directory (device-level view on top of the runstats phase "
           "timers)")
        rs("linear_solver_dense", "auto", ["auto", "ldl_nopiv", "lu_eig"],
           "dense safe-tier KKT solver: ldl_nopiv=on-device blocked no-pivot LDL^T "
           "(MAGMA-Nopiv analogue), lu_eig=host LU + eigen inertia (LAPACK analogue); "
           "auto=ldl_nopiv then lu_eig on accelerators, lu_eig on CPU. "
           "ldl_nopiv also switches the MDS fused modes (jit_mode="
           "iteration/solve) to the on-device inertia-revealing saddle "
           "factorization — required for structurally indefinite problems "
           "in fused mode")
        rs("fact_acceptor", "inertia_correction",
           ["inertia_correction", "inertia_free"], "acceptance test for factorizations")
        rn("neg_curv_test_fact", 1e-11, 0.0, 1e10, "inertia-free curvature test parameter")
        # regularization (Ipopt-style delta curves)
        rn("delta_w_min_bar", 1e-20, 0.0, 1000.0, "min primal regularization")
        rn("delta_w_max_bar", 1e20, 1e-40, 1e40, "max primal regularization")
        rn("delta_0_bar", 1e-4, 0.0, 1e40, "initial primal regularization")
        rn("kappa_w_minus", 1.0 / 3, 1e-20, 1.0 - 1e-20, "regularization decrease factor")
        rn("kappa_w_plus", 8.0, 1.0 + 1e-20, 1e40, "regularization increase factor")
        rn("kappa_w_plus_bar", 100.0, 1.0 + 1e-20, 1e40, "aggressive increase factor (first time)")
        rn("delta_c_bar", 1e-8, 1e-20, 1e40, "dual regularization scale")
        rn("kappa_c", 0.25, 0.0, 1e40, "exponent of mu in dual regularization")
        rs("normaleqn_regularization_priority", "dual_first",
           ["dual_first", "primal_first"], "which delta to bump first (normal eqns)")
        rs("regularization_method", "scalar", ["scalar", "randomized"],
           "scalar or randomized diagonal regularization")
        rs("time_kkt", "off", ["on", "off"], "per-iteration KKT timing breakdown")
        # elastic mode
        rs("elastic_mode", "none",
           ["none", "tighten_bound", "correct_it", "correct_it_adjust_bound"],
           "elastic-mode strategy as mu decreases")
        rs("elastic_bound_strategy", "mu_projected",
           ["mu_scaled", "mu_projected"], "how elastic bound relaxation follows mu")
        rn("elastic_mode_bound_relax_initial", 1e-2, 1e-15, 1e-1, "initial elastic relaxation")
        rn("elastic_mode_bound_relax_final", 1e-12, 1e-15, 1e-1, "final elastic relaxation")
        rs("write_kkt", "no", ["yes", "no"], "dump KKT operands per iteration (npz, csr_iajaaa parity)")
        rs("print_options", "no", ["yes", "no", "user_options"], "echo options at start")
        # execution backends (TPU semantics; reference mem_space/compute_mode)
        rs("mem_space", "default", ["default", "host", "device", "um"],
           "where solver linear algebra lives: host=numpy/CPU jax, device=TPU HBM")
        rs("callback_mem_space", "default", ["default", "host", "device"],
           "where user callbacks receive arrays")
        rs("compute_mode", "auto", ["auto", "cpu", "hybrid", "gpu", "tpu"],
           "auto/tpu: device compute when a TPU is visible; cpu forces host")
        rs("mem_backend", "auto", ["auto", "stdcpp", "umpire"], "accepted for parity; no-op on TPU")
        rs("exec_policies", "auto", ["auto", "seq", "raja", "xla", "pallas"],
           "kernel dispatch: xla (fused jit) or pallas kernels for hot ops")
        # checkpointing
        rs("checkpoint_save", "no", ["yes", "no"], "save solver state every N iterations")
        ri("checkpoint_save_every_N_iter", 10, 1, int(1e6), "checkpoint frequency")
        rs("checkpoint_file", "hiop_state_chk", None, "checkpoint path")
        rs("checkpoint_load_on_start", "no", ["yes", "no"], "resume from checkpoint_file")
        rs(
            "checkpoint_format",
            "npz",
            ["npz", "orbax"],
            "npz: single portable file; orbax: sharded tensorstore directory "
            "(the axom/sidre scalable-IO analogue)",
        )
        # --- TPU-native additions ------------------------------------------
        rs("kkt_fact_dtype", "float64", ["float32", "float64"],
           "dtype of the KKT factorization; float32 pairs with f64 iterative refinement")
        rs("mp_schedule", "adaptive", ["adaptive", "mu_threshold"],
           "mixed-precision policy when kkt_fact_dtype=float32: 'adaptive' "
           "stays f32 while the f64 refinement residual certifies each solve "
           "(IR-driven demotion, f32 re-entry on safe-mode de-escalation); "
           "'mu_threshold' is the fixed mu cutover")
        rn("mp_mu_threshold", 1e-4, 0.0, 1.0,
           "barrier parameter below which mp_schedule=mu_threshold demotes "
           "the factorization to f64")
        ri("mp_deescalate_iters", 6, 2, 1000,
           "consecutive clean safe-mode iterations (no regularization, no "
           "corrections) before stepping back toward the quick KKT tier "
           "(switch_to_fast_KKT analogue, hiopAlgFilterIPM.hpp:468)")
        rs("deepchecks", "no", ["yes", "no"],
           "runtime numerical sanitizer: verify KKT-solve residuals, direction "
           "finiteness, and slack/dual pattern invariants each iteration "
           "(the reference's compile-time HIOP_DEEPCHECKS as a runtime switch; "
           "~30-40% overhead there, similar here)")
        rs("jit_mode", "kernels", ["kernels", "iteration", "solve", "off"],
           "jit granularity: individual kernels, whole fused iteration, the "
           "entire solve as one XLA program (outer loop in lax.while_loop; "
           "one dispatch per solve), or eager")
        ri("num_shards", 0, 0, 65536, "n-axis shards; 0 = infer from ambient mesh")

    def ensure_consistence(self) -> None:
        # QN solver only supports LSQ or linear duals with low-rank KKT; the
        # condensed/normaleqn KKT require analytical Hessians.
        if self.str_("Hessian") == "quasinewton_approx":
            if self.str_("KKTLinsys") not in ("auto", "xycyd"):
                self._warn(
                    "KKTLinsys reset to 'auto' (quasi-Newton Hessian only supports "
                    "the low-rank XYcYd system)"
                )
                self._opts["KKTLinsys"].set("auto")
        if self.str_("Hessian") == "analytical_exact":
            # Newton methods use the linear dual update (hiopOptions.cpp:628
            # comment: 'duals_update_type' can only be 'linear' for Newton)
            if self.str_("duals_update_type") == "lsq" and not self.is_user_defined(
                "duals_update_type"
            ):
                self._opts["duals_update_type"].set("linear")
        if self.str_("fixed_var") == "fixed":
            # 'fixed' leaves equal bounds in: requires relaxed complementarity
            pass


class PriDecOptions(OptionsBase):
    """Primal-decomposition options (hiopOptionsPriDec, hiopOptions.cpp:1615-1705)."""

    DEFAULT_FILENAME = "hiop_pridec.options"

    def _register_all(self) -> None:
        rn, ri, rs = self.register_num, self.register_int, self.register_str
        rs("options_file_master_prob", "hiop_pridec_master.options", None,
           "options file for the master solve")
        rs("mem_space", "default", ["default", "host", "device", "um"], "memory space")
        rs("shard_scenarios", "auto", ["auto", "yes", "no"],
           "shard the batched scenario axis over the device mesh via shard_map "
           "with on-device psum aggregation (TPU-native replacement for the "
           "reference's MPI master-worker dispatch); auto=when >1 device and "
           "the problem provides a traceable eval_rterms_batched")
        rs("accum_local", "false", ["true", "false"],
           "accumulate recourse terms locally then reduce (vs dynamic dispatch)")
        ri("num_local_workers", 1, 1, 1024,
           "TPU addition: worker threads for dynamic scenario dealing "
           "(the reference's MPI worker count comes from the communicator)")
        rn("alpha_max", 1e6, 1.0, 1e14, "max quadratic recourse coefficient")
        rn("alpha_min", 1e-5, 1e-8, 1e3, "min quadratic recourse coefficient")
        rn("tolerance", 1e-5, 1e-14, 1e-1, "predicted-decrease tolerance")
        rn("rel_tolerance", 0.0, 0.0, 0.1, "relative tolerance")
        rn("acceptable_tolerance", 1e-3, 1e-14, 1e-1, "acceptable predicted decrease")
        ri("acceptable_iterations", 25, 1, int(1e6), "consecutive acceptable iters")
        ri("max_iter", 30000, 1, int(1e9), "max PriDec iterations")
        ri("verbosity_level", 2, 0, 12, "verbosity")
        rs("print_options", "no", ["yes", "no"], "echo options")
