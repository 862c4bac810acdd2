"""Filter line-search interior-point solvers (quasi-Newton and Newton).

Counterpart of ``hiop_tpu/optimization/filter_ipm.py`` (reference
hiopAlgFilterIPMBase / hiopAlgFilterIPMQuasiNewton / hiopAlgFilterIPMNewton,
hiopAlgFilterIPM.hpp:83,349,446).
The outer algorithm (mu loop, filter line search, second-order correction,
dual updates, termination) runs in Python at iteration granularity, while
the O(n)/O(n*m) math (residuals, KKT factorizations and solves,
fraction-to-the-boundary) runs as torch operations and hand-written
kernels on the solver's device.

Algorithm skeleton (cpp:955-1552): startingProcedure -> loop {
errors/termination -> mu update loop -> KKT update -> search direction ->
fraction-to-boundary -> backtracking filter line search (with SOC) -> dual
update -> re-evals }.

The port covers the general loop (``jit_mode=kernels``) with five
search-direction strategies: :class:`_LowRankStrategy` (L-BFGS, the
low-rank KKT) for the quasi-Newton solver; :class:`_NewtonDenseStrategy`
(the dense KKT classes, quick Cholesky-Schur tier and safe ladder, FGMRES
and BiCGStab refinement), :class:`_MdsStrategy` (the quick Cholesky
tier and the safe ladder: the native bordered sparse LDL^T on the host,
device no-pivot LDL^T, host LU + eigen inertia), and for sparse problems
:class:`_SparseDirectStrategy` (the triplet-assembled KKT factorized on the
host, or with ``linear_solver_sparse=device_ldl`` on the device),
:class:`_SparseFullStrategy`, and the condensed
:class:`_CondensedSparseDeviceStrategy` and :class:`_CondensedMatfreeStrategy`
for the Newton solver. The
Newton strategies run in f64 or with ``kkt_fact_dtype=float32``: f32
factorizations through the same kernels, each solve certified by f64
FGMRES refinement (:mod:`hiop_tpu_torch.linalg.krylov`) under the
``mp_schedule`` policy, and on the card an f32 device LDL^T in the safe
slots until the first rejection or failed certification demotes f32.

A collapsed line search goes to the soft feasibility restoration on the
existing factorization, then to the nested FR solve of
:mod:`hiop_tpu_torch.optimization.fr_problem` on the same device (or
``force_resto=yes`` forces it at iteration 1). The loop also carries
elastic mode, checkpoints (:mod:`hiop_tpu_torch.utils.checkpoint`), the
per-iteration KKT dumps of ``write_kkt`` and the ``deepchecks`` sanitizer.
With ``jit_mode=iteration`` or ``jit_mode=solve`` on a jittable problem
the solvers run the fused modes of
:mod:`hiop_tpu_torch.optimization.fused_newton` (``_run_dispatch``), and
a fused step that needs the general loop's machinery hands its iterate
to :meth:`FilterIPMBase._run_loop`. A formulation sharded over a mesh
(:func:`hiop_tpu_torch.parallel.mesh.shard_formulation`) runs the same
code on DTensor values inside :func:`~hiop_tpu_torch.parallel.mesh.solve_scope`;
the Newton strategies factor their small systems on each rank's replica,
and the result is gathered and trimmed of the mesh's padding.

Each :meth:`FilterIPMBase.run` selects the dense factorizations' lane from
``exec_policies`` for its own duration
(:func:`hiop_tpu_torch.backends.execspace.kernel_backend`), and with
``profile_dir`` set runs under ``torch.profiler`` and writes a Chrome trace
there.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from hiop_tpu_torch.backends.execspace import kernel_backend, on_accelerator, resolve_device
from hiop_tpu_torch.formulation.base import NlpFormulation, to_numpy
from hiop_tpu_torch.interface.base import IterateCallbackInfo
from hiop_tpu_torch.kkt import condensed as kkt_cond
from hiop_tpu_torch.kkt import full_space as kkt_full
from hiop_tpu_torch.kkt import lowrank as kkt_lowrank
from hiop_tpu_torch.kkt import mds as kkt_mds
from hiop_tpu_torch.kkt import newton_dense as kkt_nd
from hiop_tpu_torch.kkt import normal_eqn as kkt_ne
from hiop_tpu_torch.kkt import sparse_direct as kkt_sd
from hiop_tpu_torch.linalg import cholesky as chol_mod
from hiop_tpu_torch.linalg import krylov
from hiop_tpu_torch.linalg.sparse import TripletMatrix
from hiop_tpu_torch.native import ldl as native_ldl
from hiop_tpu_torch.optimization import duals_update as du
from hiop_tpu_torch.optimization import fr_problem as fr_mod
from hiop_tpu_torch.optimization import hessian_lowrank as blr
from hiop_tpu_torch.optimization import iterate as it_mod
from hiop_tpu_torch.optimization import residual as res_mod
from hiop_tpu_torch.optimization.filter import Filter
from hiop_tpu_torch.optimization.iterate import Bounds, Iterate
from hiop_tpu_torch.optimization.perturbation import make_perturbation
from hiop_tpu_torch.optimization.residual import Residual
from hiop_tpu_torch.status import SolveStatus
from hiop_tpu_torch.utils import checkpoint as ckpt
from hiop_tpu_torch.utils import kkt_io
from hiop_tpu_torch.parallel.mesh import shard_n, solve_scope, to_host
from hiop_tpu_torch.utils.dtensor import plain, replicate_like
from hiop_tpu_torch.utils.logger import Verbosity


@contextlib.contextmanager
def _solve_trace(profile_dir: str, device: torch.device):
    """``torch.profiler`` around one solve when ``profile_dir`` is set (the
    reference wraps the solve in ``jax.profiler.trace(profile_dir)``): CPU
    activities, and CUDA ones on a card. On exit a Chrome trace goes to
    ``profile_dir``, named by rank and process so that ranks do not
    overwrite each other."""
    if not profile_dir:
        yield
        return
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    try:
        with prof:
            yield
    finally:
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            profile_dir, f"hiop_solve_rank{rank}_pid{os.getpid()}_{time.time_ns()}.pt.trace.json"))


@dataclass
class SolverResult:
    status: SolveStatus
    x: np.ndarray
    obj: float
    iterations: int
    err_nlp: float = float("nan")
    mu: float = float("nan")


class _UserEvalError(Exception):
    pass


class _StepComputationError(Exception):
    pass


class _FusedFallback(Exception):
    """Raised by the fused modes when an iteration needs machinery that
    lives only in the general loop (regularization past the ladder, SOC
    and restoration after a rejected line search)."""


def _unknown_formulation(what: str, nlp):
    """A formulation outside hiop_tpu's three classes, which are all ported
    (batch_solve's and PriDec's problems build on them)."""
    return NotImplementedError(
        f"{what} over {type(nlp).__name__}: the formulation classes are hiop_tpu's "
        "three, NlpDenseConstraints, NlpMDS and NlpSparse (ROADMAP.md section 1)"
    )


# =====================================================================
# search-direction strategies
# =====================================================================
class _LowRankStrategy:
    """Quasi-Newton: compact BFGS + low-rank Schur KKT (no regularization,
    PDPerturbationNull)."""

    def __init__(self, nlp: NlpFormulation):
        o = nlp.options
        self.nlp = nlp
        self.bfgs = blr.init_state(
            nlp.n, o.integer("secant_memory_len"), o.num("sigma0"), device=nlp.device,
            mesh=getattr(nlp, "_mesh", None), axis_name=getattr(nlp, "_mesh_axis", "n"),
        )
        self.sigma_strategy = o.str_("sigma_update_strategy")
        self.sigma0 = o.num("sigma0")
        self.prev = None
        self.kdata = None

    def prepare(self, it: Iterate, grad_f, Jc, Jd, b: Bounds, mu) -> None:
        if self.prev is not None:
            x_prev, grad_prev, Jc_prev, Jd_prev = self.prev
            s_new = it.x - x_prev
            y_new = grad_f - grad_prev
            if Jc.shape[0]:
                y_new = y_new + (Jc - Jc_prev).T @ it.yc
            if Jd.shape[0]:
                y_new = y_new + (Jd - Jd_prev).T @ it.yd
            self.bfgs = blr.update(self.bfgs, s_new, y_new, self.sigma0, strategy=self.sigma_strategy)
        self.prev = (it.x, grad_f, Jc, Jd)
        Dx, Dd = res_mod.barrier_diagonals(it, b)
        self.kdata = kkt_lowrank.LowRankKKTData(self.bfgs, Dx, Dd, Jc, Jd)

    def compute_direction(self, resid, it: Iterate, b: Bounds):
        return self.solve_rhs(resid, it, b), True

    def solve_rhs(self, resid, it: Iterate, b: Bounds) -> Iterate:
        rx_t, rd_t, ryc, ryd = res_mod.compress_rhs_xdycyd(resid, it, b)
        dx, dd, dyc, dyd = kkt_lowrank.solve_compressed(self.kdata, rx_t, rd_t, ryc, ryd)
        return res_mod.recover_direction(resid, it, b, dx, dd, dyc, dyd)


def _maybe_escalate_chronic(strategy, can_escalate: bool) -> None:
    """Escalate a KKT strategy to its next safe tier when the current tier
    only passes its acceptance checks with a persistent primal
    regularization (extends the reference's switch_to_safer_KKT trigger,
    hiopAlgFilterIPM.hpp:468). The quick Cholesky tier needs the FULL-space
    Hessian block to be PD; on structurally indefinite problems (the
    ACOPF-class example) it 'succeeds' with delta_w = O(1) at every
    iteration, while an inertia-revealing tier accepts delta_w ~ 0 whenever
    the reduced Hessian is PD. Called at the top of each iteration's
    prepare(), while the previous iteration's deltas are still live."""
    if strategy.perturb.delta_wx > 0.0:
        strategy._chronic_delta += 1
    else:
        strategy._chronic_delta = 0
    if (
        strategy._chronic_delta >= 4
        and can_escalate
        and strategy._safe_mode < len(strategy._safe_tiers)
        and strategy.linsol_mode != "forcequick"
    ):
        strategy._safe_mode += 1
        strategy._chronic_delta = 0
        strategy.log.printf(
            Verbosity.SCALARS,
            "KKT: chronic regularization (delta_w=%.2e for 4 iters); "
            "switching to inertia-revealing safe mode (%s)",
            strategy.perturb.delta_wx,
            strategy._safe_tiers[strategy._safe_mode - 1],
        )


def _mds_matvec(hss, Dxs, Dxd, Dd, Hdd, Jc_s, Jc_d, Jd_s, Jd_d,
                dwx, dwd, dcc, dcd, ns, dx, dd, dyc, dyd):
    """f64 compressed XDYcYd operator with the block MDS Hessian; dx
    carries [dxs; dxd]."""
    dxs, dxd = dx[:ns], dx[ns:]
    ax_s = (hss + Dxs + dwx) * dxs + Jc_s.T @ dyc + Jd_s.T @ dyd
    ax_d = Hdd @ dxd + (Dxd + dwx) * dxd + Jc_d.T @ dyc + Jd_d.T @ dyd
    ad = (Dd + dwd) * dd - dyd
    ayc = Jc_s @ dxs + Jc_d @ dxd - dcc * dyc
    ayd = Jd_s @ dxs + Jd_d @ dxd - dd - dcd * dyd
    return torch.cat([ax_s, ax_d]), ad, ayc, ayd


def _mp_init(strategy, o) -> None:
    """Attach the mixed-precision schedule state: the IR-residual-driven
    policy (``mp_schedule=adaptive``) or the fixed mu cutover
    (``mu_threshold``), and the de-escalation bookkeeping."""
    strategy._mp_schedule = o.str_("mp_schedule")
    strategy._mp_mu_threshold = o.num("mp_mu_threshold")
    strategy._mp_f32_ok = True
    strategy._deesc_n = o.integer("mp_deescalate_iters")
    strategy._deesc_clean = 0
    strategy._deesc_budget = 2  # flip-flop guard: at most 2 per solve


def _mp_fact_dtype(strategy):
    """Effective factorization dtype. In safe mode f64, unless the solve
    runs on the card (``_mp_safe_f32_device``): there the f32 device LDL^T,
    certified by the f64 residual and the inner IR, replaces the safe tier
    until the first rejection or failed certification demotes it. Outside
    safe mode 'adaptive' stays f32 until the f64 refinement stops
    certifying the solve, and 'mu_threshold' uses the fixed cutover (cf.
    ReSolve/IterativeRefinement.hpp:25, made adaptive)."""
    if strategy._fact_dtype_opt == torch.float64:
        return torch.float64
    if strategy._safe_mode:
        probe = getattr(strategy, "_mp_safe_f32_device", None)
        if (
            strategy._mp_schedule == "adaptive"
            and strategy._mp_f32_ok
            and probe is not None
            and probe()
        ):
            return torch.float32
        return torch.float64
    if strategy._mp_schedule == "mu_threshold":
        return (
            torch.float32
            if strategy._mu >= strategy._mp_mu_threshold
            else torch.float64
        )
    return torch.float32 if strategy._mp_f32_ok else torch.float64


def _mp_demote(strategy, why: str) -> None:
    if strategy._mp_f32_ok:
        strategy._mp_f32_ok = False
        strategy.log.printf(
            Verbosity.SCALARS,
            "mixed precision: demoting KKT factorization to f64 (%s)", why,
        )


def _mp_count_fact(strategy) -> None:
    k = strategy.stats.kkt
    k.n_fact_total += 1
    if strategy.fact_dtype == torch.float32:
        k.n_fact_f32 += 1


def _maybe_deescalate_safe(strategy) -> None:
    """switch_to_fast_KKT analogue (hiopAlgFilterIPM.hpp:468): after N
    consecutive clean safe-mode iterations (zero regularization, zero
    corrections) step back one tier toward the quick path and give f32
    another chance. Called from prepare() while the previous iteration's
    deltas are live."""
    if not strategy._safe_mode or strategy._deesc_budget <= 0:
        strategy._deesc_clean = 0
        return
    kkt_stats = getattr(getattr(strategy, "stats", None), "kkt", None)
    clean = (
        strategy.perturb.delta_wx == 0.0
        and getattr(strategy.perturb, "delta_cc", 0.0) == 0.0
        and getattr(kkt_stats, "n_update_corrections_prev", 0) == 0
    )
    strategy._deesc_clean = strategy._deesc_clean + 1 if clean else 0
    if strategy._deesc_clean >= strategy._deesc_n:
        strategy._safe_mode -= 1
        strategy._deesc_clean = 0
        strategy._deesc_budget -= 1
        strategy._chronic_delta = 0
        if getattr(strategy, "_mp_schedule", "") == "adaptive":
            strategy._mp_f32_ok = True
        strategy.log.printf(
            Verbosity.SCALARS,
            "KKT: %d clean safe-mode iterations; de-escalating to %s",
            strategy._deesc_n,
            "quick tier"
            if strategy._safe_mode == 0
            else strategy._safe_tiers[strategy._safe_mode - 1],
        )


def _dense_safe_tiers(o) -> tuple:
    """Safe-mode escalation ladder for dense symmetric-indefinite KKT
    factorizations, from the linear_solver_dense option: the on-device
    no-pivot LDL^T (MAGMA-Nopiv analogue) before the host LU + eigen
    inertia (LAPACK analogue); 'auto' skips the device tier when the solve
    runs on the CPU, where scipy's pivoted LU is both faster and stabler."""
    dense_solver = o.str_("linear_solver_dense")
    if dense_solver == "auto":
        on_card = on_accelerator(resolve_device(o.str_("compute_mode")))
        return ("ldl_nopiv", "lu_eig") if on_card else ("lu_eig",)
    if dense_solver == "ldl_nopiv":
        return ("ldl_nopiv",)
    return ("lu_eig",)


class _NewtonDenseStrategy:
    """Exact Hessian with the dense XDYcYd KKT (or XYcYd, condensed,
    normal equations, full) and the quick/safe ladder.

    The factorize -> acceptance test -> regularize loop mirrors
    factorizeWithCurvCheck + compute_search_direction[_inertia_free]
    (hiopKKTLinSys.hpp:204, hiopAlgFilterIPM.cpp:3335,3374), at most 10
    refactorizations per direction. The quick tier is the Cholesky-Schur
    reduction (both factorizations on the Cholesky kernel); the safe tiers
    come from :func:`_dense_safe_tiers` (the device no-pivot LDL^T, then
    the host LU + eigen inertia). With ``kkt_fact_dtype=float32`` the
    factorizations follow :func:`_mp_fact_dtype` and each compressed solve
    is refined in f64 by FGMRES (:meth:`_inner_refine`); every direction
    may be refined over the full 12-block operator by BiCGStab
    (:meth:`_maybe_refine`, option ``ir_outer_maxit``)."""

    MAX_REFACT = 10

    def __init__(self, nlp: NlpFormulation, logger, stats):
        o = nlp.options
        self.nlp = nlp
        self.log = logger
        self.stats = stats
        self.perturb = make_perturbation(o, for_newton=True)
        self.inertia_free = o.str_("fact_acceptor") == "inertia_free"
        self.neg_curv_fact = o.num("neg_curv_test_fact")
        self.linsol_mode = o.str_("linsol_mode")
        # KKT class selection (decideAndCreateLinearSystem, cpp:1848-1901):
        # 'condensed' needs an inequality-only NLP (the formulation relaxed
        # the equalities), 'normaleqn' a diagonal Hessian; condensed,
        # normaleqn and the nonsymmetric LU of 'full' carry no inertia, so
        # they take the curvature acceptor
        self.kkt_kind = o.str_("KKTLinsys")
        if self.kkt_kind == "auto":
            self.kkt_kind = "xdycyd"
        if self.kkt_kind == "condensed" and nlp.m_eq > 0:
            raise ValueError("condensed KKT requires an inequality-only NLP")
        if self.kkt_kind in ("condensed", "normaleqn", "full"):
            self.inertia_free = True
        self.ir_maxit = o.integer("ir_outer_maxit")
        self.ir_tol_factor = o.num("ir_outer_tol_factor")
        self.ir_tol_min = o.num("ir_outer_tol_min")
        self._fact_dtype_opt = (
            torch.float32 if o.str_("kkt_fact_dtype") == "float32" else torch.float64
        )
        self._H = None
        self._Dx = self._Dd = None
        self._Jc = self._Jd = None
        self._mu = 1.0
        self._factors = None
        self._inertia_mismatches = 0
        # index into (quick,) + _safe_tiers; escalation through the safe
        # tiers is switch_to_safer_KKT (unless linsol_mode='forcequick')
        self._safe_mode = 0
        self._safe_tiers = _dense_safe_tiers(o)
        self._chronic_delta = 0
        _mp_init(self, o)

    def prepare(self, it: Iterate, grad_f, Jc, Jd, b: Bounds, mu) -> None:
        _maybe_deescalate_safe(self)
        _maybe_escalate_chronic(self, self.kkt_kind in ("xdycyd", "xycyd"))
        with self.stats.kkt.tm_update_init:
            self._H = self.nlp.eval_hess(it.x, 1.0, it.yc, it.yd)
            self._Dx, self._Dd = res_mod.barrier_diagonals(it, b)
            self._Jc, self._Jd = Jc, Jd
            if getattr(self.nlp, "_mesh", None) is not None:
                # the dense KKT is factored on each rank's replica, as the
                # replicated small solves of the reference
                self._H, self._Dx, self._Dd, self._Jc, self._Jd = (
                    plain(a) for a in (self._H, self._Dx, self._Dd, self._Jc, self._Jd))
        self._itb = (it, b)
        self.perturb.set_mu(float(mu))
        self.perturb.compute_initial_deltas()
        self._mu = float(mu)
        self._factors = None

    # -- factorization ----------------------------------------------------
    @property
    def fact_dtype(self):
        """Effective factorization dtype: see :func:`_mp_fact_dtype`."""
        return _mp_fact_dtype(self)

    def _cast(self, a):
        return a.to(self.fact_dtype) if a.dtype != self.fact_dtype else a

    def _factorize(self):
        p = self.perturb
        _mp_count_fact(self)
        if self.fact_dtype != torch.float64:
            H, Dx, Dd = self._cast(self._H), self._cast(self._Dx), self._cast(self._Dd)
            Jc, Jd = self._cast(self._Jc), self._cast(self._Jd)
        else:
            H, Dx, Dd, Jc, Jd = self._H, self._Dx, self._Dd, self._Jc, self._Jd
        deltas = (p.delta_wx, p.delta_wd, p.delta_cc, p.delta_cd)
        with self.stats.kkt.tm_update_fact:
            if self.kkt_kind == "full":
                it_k, b_k = self._itb
                return kkt_full.factorize_full(self._H, self._Jc, self._Jd, it_k, b_k, deltas)
            if self.kkt_kind == "condensed":
                return kkt_cond.factorize(H, Dx, Dd, Jd, p.delta_wx, p.delta_wd, p.delta_cd)
            if self.kkt_kind == "normaleqn":
                return kkt_ne.factorize(torch.diagonal(H), Dx, Dd, Jc, Jd, *deltas)
            if self._safe_mode:
                tier = self._safe_tiers[self._safe_mode - 1]
                if self.kkt_kind == "xycyd":
                    # the 3x3 XYcYd realization: d eliminated through the
                    # (Dd+delta_wd)^{-1} block (hiopKKTLinSys.hpp:292)
                    fact = (
                        kkt_nd.factorize_xycyd_safe_device
                        if tier == "ldl_nopiv"
                        else kkt_nd.factorize_xycyd_safe
                    )
                    return fact(H, Dx, Dd, Jc, Jd, *deltas)
                if tier == "ldl_nopiv":
                    return kkt_nd.factorize_safe_device(H, Dx, Dd, Jc, Jd, *deltas)
                return kkt_nd.factorize_safe(H, Dx, Dd, Jc, Jd, *deltas)
            # the quick tier's Schur elimination of x gives the same reduced
            # system for both compressed linearizations
            return kkt_nd.factorize_quick(H, Dx, Dd, Jc, Jd, *deltas)

    def _solve_factors(self, f, rx_t, rd_t, ryc, ryd):
        # on a mesh the KKT is solved on this rank's replica, as it is
        # factored there, and the direction goes on replicated
        wrap = replicate_like(rx_t, rd_t, ryc, ryd)
        rx_t, rd_t, ryc, ryd = (plain(a) for a in (rx_t, rd_t, ryc, ryd))
        mixed = self.fact_dtype != torch.float64
        if mixed:
            rx_t, rd_t, ryc, ryd = (self._cast(a) for a in (rx_t, rd_t, ryc, ryd))
        if self.kkt_kind == "condensed":
            dx, dd, dyd = kkt_cond.solve(f, rx_t, rd_t, ryd, self.perturb.delta_cd)
            out = dx, dd, torch.zeros_like(ryc), dyd
        elif self.kkt_kind == "normaleqn":
            out = kkt_ne.solve(f, rx_t, rd_t, ryc, ryd)
        elif self._safe_mode:
            if isinstance(f, (kkt_nd.XycydSafeFactors, kkt_nd.XycydDeviceLdlFactors)):
                # 3x3 solve in (dx, dyc, dyd); dd from the d-row
                # (hiopKKTLinSys.cpp:620,670): ryd_t = ryd + Dd_tot^{-1} rd_t,
                # dd = Dd_tot^{-1} (rd_t + dyd)
                dd_inv = kkt_nd._pos_inv((self._Dd + self.perturb.delta_wd).to(rd_t.dtype))
                ryd_t = ryd + dd_inv * rd_t
                dx, dyc, dyd = kkt_nd.solve_xycyd_safe(f, rx_t, ryc, ryd_t)
                dd = dd_inv * (rd_t.to(dyd.dtype) + dyd)
                out = (dx, dd, dyc, dyd)
            elif isinstance(f, kkt_nd.DeviceLdlFactors):
                out = kkt_nd.solve_safe_device(f, rx_t, rd_t, ryc, ryd)
            else:
                out = kkt_nd.solve_safe(f, rx_t, rd_t, ryc, ryd)
        else:
            out = kkt_nd.solve_quick(f, rx_t, rd_t, ryc, ryd)
        if mixed:
            out = tuple(a.to(torch.float64) for a in out)
        return tuple(wrap(a) for a in out)

    def _factorization_acceptable(self, f):
        """Returns (acceptable, singular)."""
        if self._safe_mode:
            if not bool(f.ok):
                # host LU: a non-finite factor means wrong inertia. Device
                # no-pivot LDL^T: a breakdown is ambiguous between a
                # singular Jacobian and wrong inertia; the singularity
                # handler bumps delta_c first and falls through to the
                # delta_w curve on repeats (the reference's handling of a
                # MAGMA-Nopiv zero pivot)
                return False, isinstance(
                    f, (kkt_nd.DeviceLdlFactors, kkt_nd.XycydDeviceLdlFactors)
                )
            n_neg = int(f.n_neg_eig)
            if n_neg < 0:
                return False, True
            if self.inertia_free:
                return True, False
            if n_neg != f.mc + f.md:
                # highly degenerate systems can defeat the floating-point
                # inertia count; after three mismatches the inertia-free
                # curvature acceptor takes over
                self._inertia_mismatches += 1
                if self._inertia_mismatches >= 3:
                    self.log.printf(
                        Verbosity.SCALARS,
                        "inertia count unreliable (%d != %d); switching to the "
                        "inertia-free curvature test", n_neg, f.mc + f.md,
                    )
                    self.inertia_free = True
                    return True, False
                return False, False
            return True, False
        if self.kkt_kind == "full":
            # nonsymmetric LU: a failure can only mean (near-)singularity
            return (True, False) if bool(f.ok) else (False, True)
        if self.kkt_kind in ("condensed", "normaleqn"):
            # one SPD factorization: a failure means wrong curvature
            return bool(f.ok), False
        # quick tier: the Hessian-block Cholesky failing means wrong inertia
        # (bump delta_w); the Schur Cholesky failing a singular Jacobian
        # (bump delta_c). One synchronization for both flags.
        ok_k, ok_s = torch.stack([f.ok_k, f.ok_s]).tolist()
        if not ok_k:
            return False, False
        if not ok_s:
            return False, True
        return True, False

    def _mp_safe_f32_device(self) -> bool:
        """f32 safe-tier factorizations only on the device no-pivot LDL^T
        tier (the host tiers are f64 by nature)."""
        return (
            self._safe_mode > 0
            and self._safe_tiers[self._safe_mode - 1] == "ldl_nopiv"
        )

    def _curvature_ok(self, dx, dd) -> bool:
        p = self.perturb
        return bool(kkt_nd.curvature_test(
            self._H, self._Dx, self._Dd, p.delta_wx, p.delta_wd, dx, dd, self.neg_curv_fact,
        ))

    def compute_direction(self, resid, it: Iterate, b: Bounds):
        rx_t, rd_t, ryc, ryd = res_mod.compress_rhs_xdycyd(resid, it, b)
        n_correction = 0
        for _ in range(self.MAX_REFACT):
            f = self._factorize()
            acceptable, singular = self._factorization_acceptable(f)
            if not acceptable and self._safe_mode and self.fact_dtype == torch.float32:
                # f32 pivot signs are not trusted through a rejection: redo
                # this direction in f64 with the deltas unchanged
                _mp_demote(self, "f32 safe-tier factorization rejected")
                continue
            if not acceptable:
                n_correction += 1
                self.stats.kkt.n_update_corrections = n_correction
                ok = (
                    self.perturb.compute_perturb_singularity()
                    if singular
                    else self.perturb.compute_perturb_wrong_inertia()
                )
                if not ok:
                    if (
                        self._safe_mode < len(self._safe_tiers)
                        and self.kkt_kind in ("xdycyd", "xycyd")
                        and self.linsol_mode != "forcequick"
                    ):
                        self._safe_mode += 1
                        self.log.printf(
                            Verbosity.SCALARS,
                            "KKT: switching to safe mode (%s)",
                            self._safe_tiers[self._safe_mode - 1],
                        )
                        self.perturb.compute_initial_deltas()
                        continue
                    raise _StepComputationError("regularization exhausted")
                continue
            self._factors = f
            with self.stats.kkt.tm_solve_inner:
                if self.kkt_kind == "full":
                    dir_full = kkt_full.solve_full(f, resid)
                    dx, dd = dir_full.x, dir_full.d
                else:
                    dir_full = None
                    dx, dd, dyc, dyd = self._solve_factors(f, rx_t, rd_t, ryc, ryd)
                    if self.fact_dtype != torch.float64 and self.kkt_kind in ("xdycyd", "xycyd"):
                        was_f32 = self.fact_dtype == torch.float32
                        dx, dd, dyc, dyd = self._inner_refine(
                            f, (rx_t, rd_t, ryc, ryd), (dx, dd, dyc, dyd)
                        )
                        if was_f32 and self.fact_dtype == torch.float64:
                            # certification failed and the schedule demoted:
                            # redo this factorization in f64 rather than use
                            # the uncertified direction
                            n_correction += 1
                            self.stats.kkt.n_update_corrections = n_correction
                            continue
            if (
                not self.inertia_free
                and self._safe_mode
                and self.fact_dtype == torch.float32
            ):
                # f32 pivot signs can flip on near-zero pivots and falsely
                # report the right inertia: cross-check the accepted f32
                # safe-tier factorization with the curvature test
                if not self._curvature_ok(dx, dd):
                    n_correction += 1
                    self.stats.kkt.n_update_corrections = n_correction
                    if not self.perturb.compute_perturb_wrong_inertia():
                        raise _StepComputationError(
                            "f32 curvature cross-check regularization exhausted"
                        )
                    continue
            if self.inertia_free and not self._curvature_ok(dx, dd):
                n_correction += 1
                self.stats.kkt.n_update_corrections = n_correction
                if not self.perturb.compute_perturb_wrong_inertia():
                    raise _StepComputationError("curvature regularization exhausted")
                continue
            self.perturb.update_fact_ok()
            if dir_full is not None:
                dir_ = dir_full
            else:
                dir_ = res_mod.recover_direction(resid, it, b, dx, dd, dyc, dyd)
            dir_ = self._maybe_refine(resid, it, b, dir_)
            return dir_, True
        raise _StepComputationError("max refactorizations reached")

    def _inner_refine(self, f, rhs4, sol4):
        """FGMRES inner refinement of the mixed-precision compressed solve:
        the f64 XDYcYd operator is the matvec, the f32 factorization the
        flexible right preconditioner (the ReSolve FGMRES-IR pattern,
        ReSolve/IterativeRefinement.hpp:25), driven by the ir_inner_*
        options."""
        o = self.nlp.options
        maxit = o.integer("ir_inner_maxit")
        if maxit <= 0:
            return sol4
        p = self.perturb
        deltas = (p.delta_wx, p.delta_wd, p.delta_cc, p.delta_cd)
        H, Dx, Dd, Jc, Jd = self._H, self._Dx, self._Dd, self._Jc, self._Jd

        def matvec(v):
            return kkt_nd.xdycyd_matvec(H, Dx, Dd, Jc, Jd, *deltas, *v)

        def precond(v):
            return self._solve_factors(f, *v)

        tol = max(o.num("ir_inner_tol"), o.num("ir_inner_tol_factor") * self._mu)
        refined, info = krylov.fgmres(
            matvec, rhs4, M_inv=precond, x0=sol4, tol=tol,
            restart=o.integer("ir_inner_restart"), maxit=maxit,
            gs_scheme=o.str_("ir_inner_gs_scheme"),
        )
        self.stats.kkt.n_iter_refin_inner += info.iters
        if self._mp_schedule == "adaptive" and not info.converged:
            # the f32 factorization stopped being a good enough
            # preconditioner for the f64 system at this conditioning
            _mp_demote(self, "inner FGMRES-IR did not converge")
        return refined if info.converged or info.iters > 0 else sol4

    def _maybe_refine(self, resid, it: Iterate, b: Bounds, dir_: Iterate) -> Iterate:
        """Outer BiCGStab refinement over the full 12-block KKT operator,
        preconditioned by the compressed direct solve
        (compute_directions_w_IR, hiopKKTLinSys.cpp:911-956)."""
        if self.ir_maxit <= 0:
            return dir_
        p = self.perturb
        deltas = (p.delta_wx, p.delta_wd, p.delta_cc, p.delta_cd)
        with self.stats.kkt.tm_resid:
            rn, bn = kkt_full.direction_residual_norms(
                self._H, self._Jc, self._Jd, it, b, *deltas, resid, dir_
            )
            res_norm, rhs_norm = torch.stack([rn, bn]).tolist()
            rhs_norm = max(rhs_norm, 1e-300)
        tol = max(self.ir_tol_min, self.ir_tol_factor * self._mu)
        if res_norm <= tol * rhs_norm:
            return dir_
        rhs = kkt_full.residual_to_rhs(resid)

        def matvec(d):
            return kkt_full.full_kkt_matvec(self._H, self._Jc, self._Jd, it, b, *deltas, Iterate(*d))

        def precond(v):
            v = Residual(*v)
            res_v = v._replace(rxl=-v.rxl, rxu=-v.rxu, rdl=-v.rdl, rdu=-v.rdu)
            return self.solve_rhs(res_v, it, b)

        refined, info = krylov.bicgstab(
            matvec, rhs, M_inv=precond, x0=dir_, tol=tol, maxit=self.ir_maxit
        )
        self.stats.kkt.n_iter_refin_outer += info.iters
        if not info.converged and info.resid_norm > res_norm:
            return dir_  # refinement diverged; keep the direct solution
        return Iterate(*refined)

    def solve_rhs(self, resid, it: Iterate, b: Bounds) -> Iterate:
        if self.kkt_kind == "full":
            return kkt_full.solve_full(self._factors, resid)
        rx_t, rd_t, ryc, ryd = res_mod.compress_rhs_xdycyd(resid, it, b)
        dx, dd, dyc, dyd = self._solve_factors(self._factors, rx_t, rd_t, ryc, ryd)
        return res_mod.recover_direction(resid, it, b, dx, dd, dyc, dyd)


def _to_host(*tensors):
    """The tensors as host float64 arrays, through one device-to-host copy
    (one synchronization)."""
    sizes = [t.numel() for t in tensors]
    flat = to_numpy(torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]))
    return np.split(flat, np.cumsum(sizes)[:-1])


def _to_device(arrays, like: torch.Tensor):
    """Host arrays as tensors on ``like``'s device, through one copy."""
    flat = torch.as_tensor(np.concatenate(arrays), dtype=like.dtype, device=like.device)
    return flat.split([a.size for a in arrays])


def _triplet_values(nlp, Jc, Jd):
    """The Jacobian's (eq, ineq) triplet values as tensors: the handles'
    own values in matrix-free mode, else gathered out of the dense
    Jacobians on their device (no re-evaluation of user callbacks, and
    only nnz values ever cross to the host)."""
    if isinstance(Jc, TripletMatrix):
        return Jc.vals, Jd.vals
    return Jc[nlp._jac_eq_rc_t], Jd[nlp._jac_in_rc_t]


def _triplet_curvature(nlp, h_vals, Dx, Dd, p, dx, dd, neg_curv_fact) -> bool:
    """dx'(H + Dx + delta_wx)dx + dd'(Dd + delta_wd)dd >= fact*||(dx,dd)||^2
    with H applied through its upper triplets (test_direction,
    hiopKKTLinSys.cpp), on host arrays."""
    hr, hc = nlp.hess_rows, nlp.hess_cols
    w = np.where(hr == hc, 1.0, 2.0)
    quad = (
        float(np.sum(w * h_vals * dx[hr] * dx[hc]))
        + float(np.sum((Dx + p.delta_wx) * dx * dx))
        + float(np.sum((Dd + p.delta_wd) * dd * dd))
    )
    return quad >= neg_curv_fact * float(dx @ dx + dd @ dd)


def _triplet_curvature_device(nlp, h_vals, Dx, Dd, p, dx, dd, neg_curv_fact) -> bool:
    """:func:`_triplet_curvature` on the solver's device, with one host read."""
    hr, hc = nlp._hess_rc_t
    w = torch.where(hr == hc, 1.0, 2.0)
    quad = (
        (w * h_vals * dx[hr] * dx[hc]).sum()
        + ((Dx + p.delta_wx) * dx * dx).sum()
        + ((Dd + p.delta_wd) * dd * dd).sum()
    )
    quad, nrm2 = torch.stack([quad, dx @ dx + dd @ dd]).tolist()
    return quad >= neg_curv_fact * nrm2


class _CondensedMatfreeStrategy:
    """Matrix-free condensed KKT for large sparse inequality-only NLPs:
    triplet matvecs and Jacobi-preconditioned CG (kkt/condensed_matfree.py).
    A CG negative-curvature breakdown plays the role of a failed Cholesky in
    the regularization ladder."""

    MAX_REFACT = 10

    def __init__(self, nlp, logger, stats):
        from hiop_tpu_torch.kkt import condensed_matfree as cmf

        o = nlp.options
        if nlp.m_eq > 0:
            raise ValueError("condensed KKT requires an inequality-only NLP")
        self.nlp = nlp
        self.log = logger
        self.stats = stats
        self.perturb = make_perturbation(o, for_newton=True)
        self.ops = cmf.build_ops(nlp.jac_in_rows, nlp.jac_in_cols, nlp.hess_rows,
                                 nlp.hess_cols, nlp.n, nlp.m_ineq, nlp.device)
        self.cg_maxit = max(o.integer("ir_inner_maxit") * 8, 400)
        self.cg_tol_min = o.num("ir_inner_tol")
        self._cg_solve = cmf.make_cg_solver(self.ops, maxit=self.cg_maxit)
        self._mu = 1.0
        self._state = None

    def prepare(self, it: Iterate, grad_f, Jc, Jd, b: Bounds, mu) -> None:
        with self.stats.kkt.tm_update_init:
            jd_vals = _jd_triplet_values(self.nlp, Jd, it.x)
            h_vals = self.nlp.eval_hess_vals(it.x, 1.0, it.yc, it.yd)
            Dx, Dd = res_mod.barrier_diagonals(it, b)
            self._state = (jd_vals, h_vals, Dx, Dd)
        self.perturb.set_mu(float(mu))
        self.perturb.compute_initial_deltas()
        self._mu = float(mu)

    def _cg_tol(self):
        return max(self.cg_tol_min, min(1e-8, 1e-2 * self._mu))

    def _solve(self, rx_t, rd_t, ryd):
        jd_vals, h_vals, Dx, Dd = self._state
        p = self.perturb
        return self._cg_solve(h_vals, jd_vals, Dx, Dd, rx_t, rd_t, ryd,
                              p.delta_wx, p.delta_wd, p.delta_cd, self._cg_tol())

    def compute_direction(self, resid, it: Iterate, b: Bounds):
        rx_t, rd_t, ryc, ryd = res_mod.compress_rhs_xdycyd(resid, it, b)
        n_corr = 0
        for _ in range(self.MAX_REFACT):
            with self.stats.kkt.tm_solve_inner:
                dx, dd, dyd, (conv, neg, iters, _) = self._solve(rx_t, rd_t, ryd)
                conv, neg, iters = _read_cg_info(conv, neg, iters)
            self.stats.kkt.n_iter_refin_inner += iters
            if neg or not conv:
                n_corr += 1
                self.stats.kkt.n_update_corrections = n_corr
                if not self.perturb.compute_perturb_wrong_inertia():
                    raise _StepComputationError("matrix-free regularization exhausted")
                continue
            self.perturb.update_fact_ok()
            dir_ = res_mod.recover_direction(resid, it, b, dx, dd, torch.zeros_like(ryc), dyd)
            return dir_, True
        raise _StepComputationError("matrix-free CG failed to converge")

    def solve_rhs(self, resid, it: Iterate, b: Bounds) -> Iterate:
        rx_t, rd_t, ryc, ryd = res_mod.compress_rhs_xdycyd(resid, it, b)
        dx, dd, dyd, _info = self._solve(rx_t, rd_t, ryd)
        return res_mod.recover_direction(resid, it, b, dx, dd, torch.zeros_like(ryc), dyd)


def _read_cg_info(conv, neg, iters):
    """(converged, negative curvature, iterations) of a CG solve, in one
    host read."""
    conv, neg, iters = torch.stack([conv.to(torch.int64), neg.to(torch.int64), iters]).tolist()
    return bool(conv), bool(neg), iters


def _jd_triplet_values(nlp, Jd, x):
    """The inequality Jacobian's triplet values: the handle's own in
    matrix-free mode, else evaluated again (as hiop_tpu's condensed
    strategies do: a gather out of the dense Jd would sum duplicates)."""
    if isinstance(Jd, TripletMatrix):
        return Jd.vals
    return nlp.eval_jac_vals_split(x)[1]


class _CondensedSparseDeviceStrategy:
    """Sparse condensed KKT with device two-phase products
    (kkt/condensed_sparse_device.py: hiopKKTLinSysCondensedSparse's CSR
    machinery, hiopMatrixSparseCSR.hpp:116-261, with the SPD factorization
    on the device sparse LDL^T in cuSOLVER-Cholesky's role). A non-SPD
    factorization or an uncertified solve is a failed Cholesky: bump
    delta_w and retry (the condensed ladder's semantics)."""

    MAX_REFACT = 10

    def __init__(self, nlp, logger, stats):
        from hiop_tpu_torch.kkt.condensed_sparse_device import CondensedSparseDeviceKKT

        if nlp.m_eq > 0:
            raise ValueError("condensed KKT requires an inequality-only NLP")
        self.nlp = nlp
        self.log = logger
        self.stats = stats
        self.perturb = make_perturbation(nlp.options, for_newton=True)
        self.kkt = CondensedSparseDeviceKKT(nlp)
        self._mu = 1.0
        self._state = None

    def prepare(self, it: Iterate, grad_f, Jc, Jd, b: Bounds, mu) -> None:
        with self.stats.kkt.tm_update_init:
            jd_vals = _jd_triplet_values(self.nlp, Jd, it.x)
            h_vals = self.nlp.eval_hess_vals(it.x, 1.0, it.yc, it.yd)
            Dx, Dd = res_mod.barrier_diagonals(it, b)
            self._state = (h_vals, Dx, Dd, jd_vals)
        self.perturb.set_mu(float(mu))
        self.perturb.compute_initial_deltas()
        self._mu = float(mu)

    def _try_solve(self, rx_t, rd_t, ryd):
        h_vals, Dx, Dd, jd_vals = self._state
        p = self.perturb
        with self.stats.kkt.tm_update_fact:
            ok = self.kkt.factorize(h_vals, Dx, Dd, jd_vals, (p.delta_wx, p.delta_wd, p.delta_cd))
        if not ok:
            return None
        with self.stats.kkt.tm_solve_inner:
            return self.kkt.solve(rx_t, rd_t, ryd)

    def compute_direction(self, resid, it: Iterate, b: Bounds):
        rx_t, rd_t, ryc, ryd = res_mod.compress_rhs_xdycyd(resid, it, b)
        n_corr = 0
        for _ in range(self.MAX_REFACT):
            out = self._try_solve(rx_t, rd_t, ryd)
            if out is None:
                n_corr += 1
                self.stats.kkt.n_update_corrections = n_corr
                if not self.perturb.compute_perturb_wrong_inertia():
                    raise _StepComputationError("sparse condensed regularization exhausted")
                continue
            dx, dd, dyd = out
            self.perturb.update_fact_ok()
            dir_ = res_mod.recover_direction(resid, it, b, dx, dd, torch.zeros_like(ryc), dyd)
            return dir_, True
        raise _StepComputationError("sparse condensed factorization failed")

    def solve_rhs(self, resid, it: Iterate, b: Bounds) -> Iterate:
        rx_t, rd_t, ryc, ryd = res_mod.compress_rhs_xdycyd(resid, it, b)
        out = self._try_solve(rx_t, rd_t, ryd)
        if out is None:
            raise _StepComputationError("sparse condensed solve failed")
        dx, dd, dyd = out
        return res_mod.recover_direction(resid, it, b, dx, dd, torch.zeros_like(ryc), dyd)


class _SparseDirectStrategy:
    """Host sparse-direct XDYcYd (or XYcYd) KKT (kkt/sparse_direct.py):
    O(nnz) triplet assembly and a registry-selected sparse factorization
    (``splu``, SuperLU in its no-pivot mode, plays the reference's MA57
    role, hiopKKTLinSysCompressedSparseXDYcYd, hiopKKTLinSysSparse.hpp:133).
    A backend that reports pivot-sign inertia (``native_ldl``; ``splu``
    while its no-pivot mode holds) gets the reference's inertia-correction
    acceptance (hiopFactAcceptorIC: n_neg must equal m_eq + m_ineq); an
    inertia-less one the curvature test, each such factorization counted in
    ``n_fact_no_inertia``.

    Per iteration the host receives the Hessian and Jacobian triplet values
    and the barrier diagonals in one copy, and the right-hand side in one;
    the direction goes back in one. With ``linear_solver_sparse=device_ldl``
    the KKT is :class:`~hiop_tpu_torch.kkt.sparse_direct.DeviceSparseXDYcYdKKT`
    and everything stays on the device (the host splu KKT, counted in
    ``n_device_ldl_fallback``, when its symbolic analysis refuses the
    pattern)."""

    MAX_REFACT = 10

    def __init__(self, nlp, logger, stats):
        o = nlp.options
        self.nlp = nlp
        self.log = logger
        self.stats = stats
        self.perturb = make_perturbation(o, for_newton=True)
        self.neg_curv_fact = o.num("neg_curv_test_fact")
        self.inertia_free = o.str_("fact_acceptor") == "inertia_free"
        name = o.str_("linear_solver_sparse")
        self._solver_name = "splu" if name == "auto" else name
        # xycyd selects the 3-block realization (shared acceptance: both
        # linearizations expect m_eq + m_ineq negative eigenvalues)
        self._kkt_cls = (
            kkt_sd.SparseXYcYdKKT if o.str_("KKTLinsys") == "xycyd" else kkt_sd.SparseXDYcYdKKT
        )
        self.kkt = None
        if self._solver_name == "device_ldl":
            if self._kkt_cls is kkt_sd.SparseXYcYdKKT:
                logger.printf(
                    Verbosity.WARNING,
                    "device_ldl supports the XDYcYd realization only; "
                    "demoting KKTLinsys=xycyd to the host splu backend",
                )
                self._solver_name = "splu"
            else:
                try:
                    self.kkt = kkt_sd.DeviceSparseXDYcYdKKT(nlp)
                except ValueError as e:
                    # the symbolic analysis refused the pattern (the fill and
                    # op guards of linalg/sparse_device.py): fall back to the
                    # host splu backend, as HiOp demotes an unavailable GPU
                    # solver with a warning (hiopKKTLinSysSparse.cpp:277+)
                    logger.printf(
                        Verbosity.WARNING,
                        "device_ldl symbolic analysis refused this pattern "
                        "(%s); falling back to the host splu backend",
                        str(e),
                    )
                    self._solver_name = "splu"
                    stats.kkt.n_device_ldl_fallback += 1
        if self.kkt is None:
            self.kkt = self._kkt_cls(nlp, self._solver_name)
        self._mu = 1.0
        self._state = None
        self._chronic_delta = 0

    def _maybe_switch_to_inertia_backend(self) -> None:
        """Chronic-regularization escalation for the sparse-direct path: an
        inertia-less backend's curvature test over-regularizes structurally
        indefinite problems (as the dense quick tier does, see
        :func:`_maybe_escalate_chronic`). After 4 consecutive regularized
        iterations on such a backend, rebuild on the pivot-sign inertia
        backend (native_ldl, the MA57 role) so that delta_w can return to ~0
        whenever the true reduced Hessian is PD."""
        from hiop_tpu_torch.linalg import solver_registry

        if self.perturb.delta_wx > 0.0:
            self._chronic_delta += 1
        else:
            self._chronic_delta = 0
        if (
            self._chronic_delta >= 4
            and self._solver_name != "native_ldl"
            and solver_registry.has_solver("native_ldl")
            # splu reports diag(U) pivot-sign inertia while its no-pivot
            # symmetric mode holds; escalate only when the current backend
            # is inertia-less (pivoted fallback in effect)
            and self.kkt.last_inertia is None
        ):
            self._solver_name = "native_ldl"
            self.kkt = self._kkt_cls(self.nlp, "native_ldl")
            self._chronic_delta = 0
            self.log.printf(
                Verbosity.SCALARS,
                "sparse KKT: chronic regularization (delta_w=%.2e for 4 "
                "iters); switching to the pivot-sign inertia backend "
                "(native_ldl)", self.perturb.delta_wx,
            )

    @property
    def _on_device(self) -> bool:
        """Whether the KKT lives on the solver's device (device_ldl): then the
        values, right-hand sides and directions stay tensors there."""
        return isinstance(self.kkt, kkt_sd.DeviceSparseXDYcYdKKT)

    def _local(self, *tensors):
        return list(tensors) if self._on_device else _to_host(*tensors)

    def prepare(self, it: Iterate, grad_f, Jc, Jd, b: Bounds, mu) -> None:
        self._maybe_switch_to_inertia_backend()
        with self.stats.kkt.tm_update_init:
            je, ji = _triplet_values(self.nlp, Jc, Jd)
            h = self.nlp.eval_hess_vals(it.x, 1.0, it.yc, it.yd)
            Dx, Dd = res_mod.barrier_diagonals(it, b)
            self._state = self._local(h, Dx, Dd, je, ji)
        self.perturb.set_mu(float(mu))
        self.perturb.compute_initial_deltas()
        self._mu = float(mu)

    def _curvature_ok(self, dx, dd) -> bool:
        h_vals, Dx, Dd, _, _ = self._state
        curvature = _triplet_curvature_device if self._on_device else _triplet_curvature
        return curvature(self.nlp, h_vals, Dx, Dd, self.perturb, dx, dd, self.neg_curv_fact)

    def _direction(self, out, like):
        return list(out) if self._on_device else _to_device(out, like)

    def compute_direction(self, resid, it: Iterate, b: Bounds):
        rhs = self._local(*res_mod.compress_rhs_xdycyd(resid, it, b))
        h_vals, Dx, Dd, je_vals, ji_vals = self._state
        n_corr = 0
        for _ in range(self.MAX_REFACT):
            p = self.perturb
            deltas = (p.delta_wx, p.delta_wd, p.delta_cc, p.delta_cd)
            with self.stats.kkt.tm_update_fact:
                ok = self.kkt.factorize(h_vals, Dx, Dd, je_vals, ji_vals, deltas)
            if ok:
                with self.stats.kkt.tm_solve_inner:
                    out = self.kkt.solve(*rhs)
            if not ok or out is None:
                n_corr += 1
                self.stats.kkt.n_update_corrections = n_corr
                if not self.perturb.compute_perturb_singularity():
                    raise _StepComputationError("sparse-direct regularization exhausted")
                continue
            dx, dd, dyc, dyd = out
            inert = self.kkt.last_inertia
            if inert is None:
                # the backend lost its inertia report (splu's pivoted
                # fallback): a high count means the no-pivot symmetric mode
                # does not hold on this problem's KKT structure
                self.stats.kkt.n_fact_no_inertia += 1
            if inert is not None and not self.inertia_free:
                # inertia-correction acceptance (hiopFactAcceptorIC): the
                # XDYcYd system must have exactly m_eq + m_ineq negative and
                # n + m_ineq positive eigenvalues
                npos, nneg, nzero = inert
                if nzero > 0 or nneg != self.nlp.m_eq + self.nlp.m_ineq:
                    n_corr += 1
                    self.stats.kkt.n_update_corrections = n_corr
                    # zero pivots signal a singular system (rank-deficient
                    # Jacobian rows): the delta_c handler, not the delta_w
                    # curve (hiopPDPerturbation's csingular vs cwrong split)
                    ok_p = (
                        self.perturb.compute_perturb_singularity()
                        if nzero > 0
                        else self.perturb.compute_perturb_wrong_inertia()
                    )
                    if not ok_p:
                        raise _StepComputationError("inertia regularization exhausted")
                    continue
            elif not self._curvature_ok(dx, dd):
                n_corr += 1
                self.stats.kkt.n_update_corrections = n_corr
                if not self.perturb.compute_perturb_wrong_inertia():
                    raise _StepComputationError("curvature regularization exhausted")
                continue
            self.perturb.update_fact_ok()
            dx, dd, dyc, dyd = self._direction(out, it.x)
            return res_mod.recover_direction(resid, it, b, dx, dd, dyc, dyd), True
        raise _StepComputationError("max refactorizations reached")

    def solve_rhs(self, resid, it: Iterate, b: Bounds) -> Iterate:
        out = self.kkt.solve(*self._local(*res_mod.compress_rhs_xdycyd(resid, it, b)))
        if out is None:
            # hiop_tpu unpacks the None and fails outside the SOC/soft-FR
            # handlers; here they treat it as "correction unavailable"
            raise _StepComputationError("sparse-direct solve produced a non-finite direction")
        dx, dd, dyc, dyd = self._direction(out, it.x)
        return res_mod.recover_direction(resid, it, b, dx, dd, dyc, dyd)


class _SparseFullStrategy:
    """Sparse-direct solve of the UNREDUCED 12-block KKT for sparse NLPs
    (hiopKKTLinSysSparseFull, hiopKKTLinSysSparse.hpp:202): O(nnz) triplet
    assembly (kkt/full_space_sparse.py) and a nonsymmetric registry LU; no
    dense (N, N) operator is ever formed. A nonsymmetric LU carries no
    inertia, so acceptance is the inertia-free curvature test, the pairing
    HiOp documents for its PARDISO-nonsym branch."""

    MAX_REFACT = 10

    def __init__(self, nlp, logger, stats):
        from hiop_tpu_torch.kkt.full_space_sparse import SparseFullKKT
        from hiop_tpu_torch.linalg import solver_registry

        o = nlp.options
        self.nlp = nlp
        self.log = logger
        self.stats = stats
        self.perturb = make_perturbation(o, for_newton=True)
        self.neg_curv_fact = o.num("neg_curv_test_fact")
        name = o.str_("linear_solver_sparse")
        name = "splu" if name == "auto" else name
        if solver_registry.is_symmetric_only(name):
            # a one-triangle LDL^T backend would silently factorize the
            # symmetrized unreduced KKT and produce wrong directions; HiOp
            # restricts this class to nonsymmetric solvers
            # (hiopKKTLinSysSparse.cpp:845-849)
            raise ValueError(
                f"KKTLinsys=full requires a nonsymmetric-capable sparse solver; "
                f"{name!r} is symmetric-only (set linear_solver_sparse=splu/auto)"
            )
        self.kkt = SparseFullKKT(nlp, name)
        self._mu = 1.0
        self._state = None

    def prepare(self, it: Iterate, grad_f, Jc, Jd, b: Bounds, mu) -> None:
        with self.stats.kkt.tm_update_init:
            je, ji = _triplet_values(self.nlp, Jc, Jd)
            h = self.nlp.eval_hess_vals(it.x, 1.0, it.yc, it.yd)
            Dx, Dd = res_mod.barrier_diagonals(it, b)
            self._state = _to_host(h, je, ji, Dx, Dd)
        self.perturb.set_mu(float(mu))
        self.perturb.compute_initial_deltas()
        self._mu = float(mu)

    def compute_direction(self, resid, it: Iterate, b: Bounds):
        h_vals, je_vals, ji_vals, Dx, Dd = self._state
        n, mi = self.nlp.n, self.nlp.m_ineq
        n_corr = 0
        for _ in range(self.MAX_REFACT):
            p = self.perturb
            deltas = (p.delta_wx, p.delta_wd, p.delta_cc, p.delta_cd)
            with self.stats.kkt.tm_update_fact:
                ok = self.kkt.factorize(h_vals, je_vals, ji_vals, it, b, deltas)
            if ok:
                with self.stats.kkt.tm_solve_inner:
                    dir_ = self.kkt.solve(resid)
            if not ok or dir_ is None:
                n_corr += 1
                self.stats.kkt.n_update_corrections = n_corr
                # an LU failure on the unreduced system can only signal
                # (near-)singularity (no inertia): the delta_c handler
                if not self.perturb.compute_perturb_singularity():
                    raise _StepComputationError("full-KKT regularization exhausted")
                continue
            sol = self.kkt.last_solution
            if not _triplet_curvature(self.nlp, h_vals, Dx, Dd, p, sol[:n],
                                      sol[n:n + mi], self.neg_curv_fact):
                n_corr += 1
                self.stats.kkt.n_update_corrections = n_corr
                if not self.perturb.compute_perturb_wrong_inertia():
                    raise _StepComputationError("curvature regularization exhausted")
                continue
            self.perturb.update_fact_ok()
            return dir_, True
        raise _StepComputationError("max refactorizations reached")

    def solve_rhs(self, resid, it: Iterate, b: Bounds) -> Iterate:
        dir_ = self.kkt.solve(resid)
        if dir_ is None:
            # a non-finite LU solution: a handled step-computation failure
            # (the SOC and soft-FR callers treat it as "correction
            # unavailable"), not a None in fraction_to_the_boundary
            raise _StepComputationError("full-KKT solve produced non-finite direction")
        return dir_


class _MdsStrategy:
    """Mixed dense-sparse KKT (hiopKKTLinSysCompressedMDSXYcYd): diagonal
    sparse Hessian block eliminated, dense block Cholesky, Schur Cholesky
    (see kkt/mds.py). Inertia-free acceptance on the quick tier (the
    all-Cholesky reduction carries no inertia), pivot-count acceptance on
    the safe tiers, with the same regularization ladder.

    The safe ladder is ``hiop_tpu``'s: the bordered ``schur_sparse_ldl``
    host tier first when the triplet Schur pairs exist and the native
    sparse LDL^T library builds (``native.ldl.native_available()``), then
    the dense tiers of :func:`_dense_safe_tiers`. With
    ``kkt_fact_dtype=float32`` the factorization dtype follows
    :func:`_mp_fact_dtype`, and every f32 solve is refined in f64 by
    :meth:`_inner_refine_mds`."""

    MAX_REFACT = 10

    def __init__(self, nlp, logger, stats):
        o = nlp.options
        self.nlp = nlp
        self.log = logger
        self.stats = stats
        self.perturb = make_perturbation(o, for_newton=True)
        self.neg_curv_fact = o.num("neg_curv_test_fact")
        self.inertia_free = o.str_("fact_acceptor") == "inertia_free"
        self.linsol_mode = o.str_("linsol_mode")
        self.ns = nlp.n_sparse
        self._fact_dtype_opt = (
            torch.float32 if o.str_("kkt_fact_dtype") == "float32" else torch.float64
        )
        self._mu = 1.0
        self._data = None
        self._factors = None
        # safe-mode escalation to an inertia-revealing factorization of the
        # partially reduced saddle system (the reference's MAGMA-BuKa MDS
        # escalation, hiopKKTLinSysMDS.cpp:437-477)
        self._safe_mode = 0
        self._safe_tiers = _dense_safe_tiers(o)
        self._chronic_delta = 0
        _mp_init(self, o)
        # triplet-based Schur assembly (the reference's addMDinv* kernels):
        # the same-column nonzero pairs, precomputed once
        dev = nlp.device
        stacked_rows, stacked_cols = kkt_mds.stacked_js(nlp)
        self._js_pairs = kkt_mds.build_schur_pairs(
            stacked_rows, stacked_cols, nlp.n_sparse, device=dev
        )
        # bordered sparse host safe tier first (MdsSchurHostFactors): the
        # saddle's m x m block is network-sparse, so the native
        # inertia-reporting LDL^T + a tiny dense Schur border beats a dense
        # (n_d + m)^2 factorization at ACOPF scale
        if self._js_pairs is not None and native_ldl.native_available():
            self._safe_tiers = ("schur_sparse_ldl",) + tuple(self._safe_tiers)
            self._js_rows, self._js_cols = stacked_rows, stacked_cols
            self._js_pairs_host = tuple(a.cpu().numpy() for a in self._js_pairs)
        self._js_eq = tuple(
            torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)
            for a in (nlp.jac_sp_eq_rows, nlp.jac_sp_eq_cols)
        )
        self._js_in = tuple(
            torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)
            for a in (nlp.jac_sp_in_rows, nlp.jac_sp_in_cols)
        )

    @property
    def fact_dtype(self):
        """Mixed-precision schedule: see :func:`_mp_fact_dtype`."""
        return _mp_fact_dtype(self)

    def _mp_safe_f32_device(self) -> bool:
        """On the card the f32 device LDL^T replaces the safe tiers (the
        kernel of :mod:`hiop_tpu_torch.linalg.ldl_blocked`); on the CPU the
        host f64 tiers are both faster and stabler, so never f32 there.
        Reads the solve's own device."""
        return on_accelerator(self.nlp.device)

    def _cast(self, a):
        return a.to(self.fact_dtype) if a.dtype != self.fact_dtype else a

    def prepare(self, it: Iterate, grad_f, Jc, Jd, b: Bounds, mu) -> None:
        _maybe_deescalate_safe(self)
        _maybe_escalate_chronic(self, True)
        ns = self.ns
        with self.stats.kkt.tm_update_init:
            hss, Hdd = self.nlp.eval_hess_blocks(it.x, 1.0, it.yc, it.yd)
            Dx, Dd = res_mod.barrier_diagonals(it, b)
            self._data = dict(
                hss=hss, Hdd=Hdd, Dxs=Dx[:ns], Dxd=Dx[ns:], Dd=Dd,
                Jc_s=Jc[:, :ns], Jc_d=Jc[:, ns:],
                Jd_s=Jd[:, :ns], Jd_d=Jd[:, ns:],
            )
            if self._js_pairs is not None:
                nlp = self.nlp
                parts = []
                if nlp.m_eq:
                    parts.append(Jc[self._js_eq])
                if nlp.m_ineq:
                    parts.append(Jd[self._js_in])
                self._data["js_vals"] = (
                    torch.cat(parts) if parts else Jc.new_zeros((0,))
                )
            if getattr(self.nlp, "_mesh", None) is not None:
                # the KKT factorization runs on each rank's replica, as the
                # replicated small solves of the reference
                self._data = {k: plain(v) for k, v in self._data.items()}
        self.perturb.set_mu(float(mu))
        self.perturb.compute_initial_deltas()
        self._mu = float(mu)
        self._factors = None

    def _factorize(self):
        p = self.perturb
        _mp_count_fact(self)
        d = self._data
        args = tuple(
            self._cast(d[k]) for k in
            ("hss", "Hdd", "Dxs", "Dxd", "Dd", "Jc_s", "Jc_d", "Jd_s", "Jd_d")
        ) + (p.delta_wx, p.delta_wd, p.delta_cc, p.delta_cd)
        with self.stats.kkt.tm_update_fact:
            if self._safe_mode:
                if self.fact_dtype == torch.float32:
                    # the f32 device safe tier (args already cast): the
                    # no-pivot LDL^T kernel, curvature-accepted and
                    # IR-certified downstream; triplet Schur assembly
                    if self._js_pairs is not None:
                        return kkt_mds.factorize_safe(
                            *args, host=False,
                            js_vals=self._cast(d["js_vals"]),
                            js_pairs=self._js_pairs,
                        )
                    return kkt_mds.factorize_safe(*args, host=False)
                tier = self._safe_tiers[self._safe_mode - 1]
                if tier == "schur_sparse_ldl":
                    return kkt_mds.factorize_safe_schur(
                        d["hss"], d["Hdd"], d["Dxs"], d["Dxd"], d["Dd"],
                        torch.cat([d["Jc_d"], d["Jd_d"]], dim=0),
                        self._js_rows, self._js_cols, d["js_vals"], self._js_pairs_host,
                        p.delta_wx, p.delta_wd, p.delta_cc, p.delta_cd,
                        self.nlp.m_eq, self.nlp.m_ineq,
                    )
                return kkt_mds.factorize_safe(*args, host=(tier == "lu_eig"))
            if self._js_pairs is not None:
                return kkt_mds.factorize(
                    *args, js_vals=self._cast(d["js_vals"]), js_pairs=self._js_pairs,
                )
            return kkt_mds.factorize(*args)

    def _solve(self, f, rx_t, rd_t, ryc, ryd):
        ns = self.ns
        # on a mesh the KKT is solved on this rank's replica, as it is
        # factored there, and the direction goes on replicated
        wrap = replicate_like(rx_t, rd_t, ryc, ryd)
        rx_t, rd_t, ryc, ryd = (plain(a) for a in (rx_t, rd_t, ryc, ryd))
        mixed = self.fact_dtype != torch.float64
        if mixed:
            rx_t, rd_t, ryc, ryd = (self._cast(a) for a in (rx_t, rd_t, ryc, ryd))
        if isinstance(f, kkt_mds.MdsSchurHostFactors):
            solver = kkt_mds.solve_safe_schur
        elif isinstance(f, kkt_mds.MdsSafeFactors):
            solver = kkt_mds.solve_safe
        else:
            solver = kkt_mds.solve
        dxs, dxd, dd, dyc, dyd = solver(f, rx_t[:ns], rx_t[ns:], rd_t, ryc, ryd)
        out = torch.cat([dxs, dxd]), dd, dyc, dyd
        if mixed:
            out = tuple(a.to(torch.float64) for a in out)
        return tuple(wrap(a) for a in out)

    def _mds_matvec(self, v):
        """The f64 compressed XDYcYd operator at the current deltas."""
        d = self._data
        p = self.perturb
        return _mds_matvec(
            d["hss"], d["Dxs"], d["Dxd"], d["Dd"], d["Hdd"],
            d["Jc_s"], d["Jc_d"], d["Jd_s"], d["Jd_d"],
            p.delta_wx, p.delta_wd, p.delta_cc, p.delta_cd,
            self.ns, *v,
        )

    def _inner_refine_mds(self, f, rhs4, sol4):
        """FGMRES inner IR of the mixed-precision MDS compressed solve: the
        f64 block operator as matvec, the f32 factorization as the flexible
        right preconditioner (the ReSolve pattern,
        ReSolve/IterativeRefinement.hpp:25). Returns (*refined, certified)."""
        o = self.nlp.options
        # certification budget: past ~16 FGMRES iterations (each several
        # host syncs) the f64 refactorization is the cheaper path
        maxit = min(o.integer("ir_inner_maxit"), 16)
        if maxit <= 0:
            return (*sol4, True)
        tol = max(o.num("ir_inner_tol"), o.num("ir_inner_tol_factor") * self._mu)
        refined, info = krylov.fgmres(
            self._mds_matvec, rhs4,
            M_inv=lambda v: self._solve(f, v[0], v[1], v[2], v[3]),
            x0=sol4, tol=tol,
            restart=o.integer("ir_inner_restart"), maxit=maxit,
            gs_scheme=o.str_("ir_inner_gs_scheme"),
        )
        self.stats.kkt.n_iter_refin_inner += info.iters
        out = refined if info.converged or info.iters > 0 else sol4
        return (*out, bool(info.converged))

    def compute_direction(self, resid, it: Iterate, b: Bounds):
        rx_t, rd_t, ryc, ryd = res_mod.compress_rhs_xdycyd(resid, it, b)
        d = self._data
        p = self.perturb
        n_corr = 0
        mp_retried = False
        for _ in range(self.MAX_REFACT):
            f = self._factorize()
            safe_f32 = self._safe_mode and self.fact_dtype == torch.float32
            if safe_f32:
                # f32 pivot signs flip on near-zero pivots, so the f32 safe
                # tier takes the quick tier's inertia-free curvature
                # acceptance and the IR certification instead of exact
                # pivot counts; a breakdown (n_neg_eig = -1) or a
                # non-finite factor demotes to the f64 tier
                acceptable = bool(f.ok) and int(f.n_neg_eig) >= 0
                singular = False
            elif self._safe_mode:
                # inertia-revealing acceptance (hiopFactAcceptorIC)
                if not bool(f.ok):
                    # fact None = zero eliminated diagonal block (wrong
                    # inertia); a device no-pivot LDL^T breakdown is
                    # ambiguous -> singularity handler (delta_c first,
                    # delta_w curve on repeats)
                    acceptable = False
                    singular = f.fact is not None and not f.host
                elif int(f.n_neg_eig) < 0:
                    acceptable, singular = False, True
                elif not self.inertia_free and int(f.n_neg_eig) != f.mc + f.md:
                    acceptable, singular = False, False
                else:
                    acceptable, singular = True, False
            else:
                ok, ok_k, ok_s = torch.stack([f.ok, f.ok_k, f.ok_s]).tolist()
                acceptable = ok
                singular = ok_k and not ok_s
            if not acceptable and safe_f32:
                _mp_demote(self, "f32 safe-tier factorization rejected")
                continue
            if not acceptable:
                n_corr += 1
                self.stats.kkt.n_update_corrections = n_corr
                ok = (
                    p.compute_perturb_singularity()
                    if singular
                    else p.compute_perturb_wrong_inertia()
                )
                if not ok:
                    if (
                        self._safe_mode < len(self._safe_tiers)
                        and self.linsol_mode != "forcequick"
                    ):
                        self._safe_mode += 1
                        self.log.printf(
                            Verbosity.SCALARS,
                            "MDS KKT: switching to safe mode (%s)",
                            self._safe_tiers[self._safe_mode - 1],
                        )
                        p.compute_initial_deltas()
                        continue
                    raise _StepComputationError("MDS regularization exhausted")
                continue
            self._factors = f
            with self.stats.kkt.tm_solve_inner:
                dx, dd, dyc, dyd = self._solve(f, rx_t, rd_t, ryc, ryd)
            if self.fact_dtype == torch.float32:
                dx, dd, dyc, dyd, certified = self._inner_refine_mds(
                    f, (rx_t, rd_t, ryc, ryd), (dx, dd, dyc, dyd)
                )
                if (
                    self._mp_schedule == "adaptive"
                    and not certified
                    and not mp_retried
                ):
                    _mp_demote(self, "MDS inner FGMRES-IR did not converge")
                    mp_retried = True
                    continue  # refactorize this direction in f64
            # curvature (inertia-free) test over the block Hessian; skipped
            # in safe mode with the inertia acceptor, where the pivot count
            # already certified the curvature
            ns = self.ns
            if safe_f32 or not (self._safe_mode and not self.inertia_free):
                dxs, dxd = dx[:ns], dx[ns:]
                dWd, nrmsq = torch.stack([
                    dxs @ ((d["hss"] + d["Dxs"] + p.delta_wx) * dxs)
                    + dxd @ (d["Hdd"] @ dxd)
                    + dxd @ ((d["Dxd"] + p.delta_wx) * dxd)
                    + dd @ ((d["Dd"] + p.delta_wd) * dd),
                    dx @ dx + dd @ dd,
                ]).tolist()
                if dWd < nrmsq * self.neg_curv_fact:
                    if safe_f32 and not mp_retried:
                        # let the f64 inertia-revealing tier decide whether
                        # this really needs regularization
                        _mp_demote(self, "f32 safe-tier curvature test failed")
                        mp_retried = True
                        continue
                    n_corr += 1
                    self.stats.kkt.n_update_corrections = n_corr
                    if not p.compute_perturb_wrong_inertia():
                        raise _StepComputationError(
                            "MDS curvature regularization exhausted"
                        )
                    continue
            p.update_fact_ok()
            return res_mod.recover_direction(resid, it, b, dx, dd, dyc, dyd), True
        raise _StepComputationError("MDS max refactorizations reached")

    def solve_rhs(self, resid, it: Iterate, b: Bounds) -> Iterate:
        rx_t, rd_t, ryc, ryd = res_mod.compress_rhs_xdycyd(resid, it, b)
        dx, dd, dyc, dyd = self._solve(self._factors, rx_t, rd_t, ryc, ryd)
        return res_mod.recover_direction(resid, it, b, dx, dd, dyc, dyd)


# =====================================================================
# base algorithm
# =====================================================================
class FilterIPMBase:
    """Shared IPM machinery (hiopAlgFilterIPMBase)."""

    # Wächter–Biegler constants (reference hiopAlgFilterIPM.cpp:259-268)
    gamma_theta = 1e-5
    gamma_phi = 1e-8
    s_theta = 1.1
    s_phi = 2.3
    delta = 1.0
    kappa_Sigma = 1e10
    kappa_d = 1e-5  # damping factor (hiopLogBarProblem kappa_d)

    #: set on the nested solver of a feasibility-restoration phase: it takes
    #: neither soft nor full restoration itself
    within_fr = False
    _force_resto_done = False
    #: what the last nested FR solve did (``apply_feasibility_restoration``)
    last_fr: Optional[dict] = None

    def __init__(self, nlp: NlpFormulation):
        self.nlp = nlp
        nlp.finalize_initialization()
        self.opts = nlp.options
        self.log = nlp.log
        o = self.opts
        self.eps_tol = o.num("tolerance")
        self.cons_tol = o.num("cons_tol")
        self.dual_tol = o.num("dual_tol")
        self.comp_tol = o.num("comp_tol")
        self.rel_tol = o.num("rel_tolerance")
        self.kappa_eps = o.num("kappa_eps")
        self.kappa_mu = o.num("kappa_mu")
        self.theta_mu = o.num("theta_mu")
        self.tau_min = o.num("tau_min")
        self.kappa1 = o.num("kappa1")
        self.kappa2 = o.num("kappa2")
        self.smax = o.num("smax")
        self.eta_phi = o.num("eta_phi")
        self.mu0 = o.num("mu0")
        self.max_iter = o.integer("max_iter")
        self.accep_tol = o.num("acceptable_tolerance")
        self.accep_iters = o.integer("acceptable_iterations")
        self.theta_max_fact = o.num("theta_max_fact")
        self.theta_min_fact = o.num("theta_min_fact")
        self.min_step_size = o.num("min_step_size")
        self.max_soc_iter = o.integer("max_soc_iter")
        self.kappa_soc = o.num("kappa_soc")

        # the dense factorizations' lane (exec_policies, the reference's
        # ExecSpace policy axis); applied by run() for its own duration
        self.kernel_backend = kernel_backend(o.str_("exec_policies"))

        self.filter = Filter()
        self.theta_max = 1e7
        self.theta_min = 1e7
        self._n_accep = 0
        self._err_nlp0: Optional[float] = None

        self.iter_num = 0
        self.solver_status = SolveStatus.NlpSolve_SolveNotCalled

    # ------------------------------------------------------------- utilities
    def _eval_f_cons(self, x):
        f = self.nlp.eval_f(x)
        c, d = self.nlp.eval_cons(x)
        if not bool(torch.isfinite(torch.cat([f.reshape(1), c, d])).all()):
            raise _UserEvalError()
        return f, c, d

    def _logbar_f(self, it: Iterate, f, b: Bounds, mu):
        """Barrier objective phi = f - mu*sum(log slacks) + damping."""
        val = f - mu * it_mod.eval_logbar(it, b)
        val = val + it_mod.linear_damping_term(it, b, mu, self.kappa_d)
        return float(val)

    def _logbar_grads(self, it: Iterate, grad_f, b: Bounds, mu):
        gx = it_mod.add_logbar_grad_x(grad_f, it, b, mu)
        gx = it_mod.add_damping_grad_x(gx, b, mu, self.kappa_d)
        gd = it_mod.add_logbar_grad_d(torch.zeros_like(it.d), it, b, mu)
        gd = it_mod.add_damping_grad_d(gd, b, mu, self.kappa_d)
        return gx, gd

    def _theta_onenorm(self, it: Iterate, c, d):
        """One-norm primal infeasibility (compute_nlp_infeasib_onenorm)."""
        return float((self.nlp.crhs - c).abs().sum() + (it.d - d).abs().sum())

    def _errors(self, it: Iterate, norms: res_mod.ResidualNorms):
        """Scaled NLP/barrier errors (evalNlpAndLogErrors)."""
        n, m = self.nlp.n, self.nlp.m
        eq1, bnd1 = (float(v) for v in it_mod.norm_one_of_duals(it))
        sd = min(max(self.smax, (bnd1 + eq1) / max(n + m, 1)) / self.smax, 1e8)
        sc = 0.0 if n == 0 else min(max(self.smax, bnd1 / n) / self.smax, 1e8)
        cons_violation = float(norms.cons_violation)
        err_nlp = max(
            float(norms.nlp_optim) / sd,
            cons_violation,
            float(norms.nlp_complem) / sc if sc > 0 else 0.0,
        )
        err_log = max(
            float(norms.bar_optim) / sd,
            cons_violation,
            float(norms.bar_complem) / sc if sc > 0 else 0.0,
        )
        return err_nlp, err_log, cons_violation

    def _check_termination(self, err_nlp: float, norms) -> Optional[SolveStatus]:
        if err_nlp <= self.eps_tol:
            return SolveStatus.Solve_Success
        if self._err_nlp0 is not None and self.rel_tol > 0:
            if err_nlp <= self.rel_tol * self._err_nlp0:
                return SolveStatus.Solve_Success_RelTol
        if err_nlp <= self.accep_tol:
            self._n_accep += 1
            if self._n_accep >= self.accep_iters:
                return SolveStatus.Solve_Acceptable_Level
        else:
            self._n_accep = 0
        if self.iter_num >= self.max_iter:
            return SolveStatus.Max_Iter_Exceeded
        if float(norms.nlp_feasib) > 1e20:
            return SolveStatus.Iterates_Diverging
        return None

    def _update_mu(self, mu: float):
        """(update_log_barrier_params): returns (changed, mu_new, tau_new)."""
        target_comp_tol = self.comp_tol / self.nlp.scale_obj
        new_mu = max(0.0, min(self.kappa_mu * mu, mu**self.theta_mu))
        new_mu = max(new_mu, min(self.eps_tol, target_comp_tol) / 11.0)
        if abs(new_mu - mu) < 1e-16:
            return False, mu, max(self.tau_min, 1.0 - mu)
        return True, new_mu, max(self.tau_min, 1.0 - new_mu)

    def _accept_line_search_conditions(
        self, theta_curr, theta_trial, phi_curr, phi_trial, alpha_primal, grad_phi_dx,
    ) -> int:
        """Returns ls status: 0 rejected, 1 suff-decrease (far), 2
        suff-decrease (near), 3 Armijo (accept_line_search_conditions,
        hiopAlgFilterIPM.cpp:2856-2945)."""
        if theta_curr >= self.theta_min:
            if (
                theta_trial <= (1 - self.gamma_theta) * theta_curr
                or phi_trial <= phi_curr - self.gamma_phi * theta_curr
            ):
                if self.filter.contains(theta_trial, phi_trial):
                    return 0
                return 1
            return 0
        # near-feasibility: switching condition (19)
        if grad_phi_dx < 0 and alpha_primal * (-grad_phi_dx) ** self.s_phi > self.delta * theta_curr**self.s_theta:
            if phi_trial <= phi_curr + self.eta_phi * alpha_primal * grad_phi_dx:
                if self.filter.contains(theta_trial, phi_trial):
                    return 0
                return 3
            return 0
        if (
            theta_trial <= (1 - self.gamma_theta) * theta_curr
            or phi_trial <= phi_curr - self.gamma_phi * theta_curr
        ):
            if self.filter.contains(theta_trial, phi_trial):
                return 0
            return 2
        return 0

    def _output_iteration(self, f_nlp, err_feas, err_optim, mu, alpha_du, alpha_pr, ls_num, ls_status, use_soc=0):
        """Per-iteration summary line (outputIteration); its format is a test
        interface (the reference diffs these tables across backends)."""
        if self.iter_num % 10 == 0:
            self.log.printf(
                Verbosity.SUMMARY,
                "iter    objective     inf_pr     inf_du   lg(mu)  alpha_du   alpha_pr linesrch",
            )
        obj_unscaled = float(f_nlp) / self.nlp.scale_obj
        if ls_status == -1:
            self.log.printf(
                Verbosity.SUMMARY,
                "%4d %14.7e %7.3e  %7.3e %6.2f  %7.3e  %7.3e  -(-)",
                self.iter_num, obj_unscaled, err_feas, err_optim,
                math.log10(mu), alpha_du, alpha_pr,
            )
        else:
            st = {1: "s", 2: "h", 3: "f"}.get(ls_status, "?")
            if use_soc:
                st = st.upper()
            self.log.printf(
                Verbosity.SUMMARY,
                "%4d %14.7e %7.3e  %7.3e %6.2f  %7.3e  %7.3e  %d(%s)",
                self.iter_num, obj_unscaled, err_feas, err_optim,
                math.log10(mu), alpha_du, alpha_pr, ls_num, st,
            )

    # ------------------------------------------------------------------ run
    def run(self) -> SolverResult:
        with solve_scope(self.nlp), chol_mod.backend_scope(self.kernel_backend), \
                _solve_trace(self.opts.str_("profile_dir"), self.nlp.device):
            return self._run_dispatch()

    def _run_general(self) -> SolverResult:
        nlp = self.nlp
        stats = nlp.runstats
        stats.tm_optimize_total.restart()
        try:
            return self._run_loop(self._make_strategy())
        except _UserEvalError:
            self.solver_status = SolveStatus.Error_In_User_Function
            return SolverResult(self.solver_status, np.zeros(nlp.n), float("nan"), self.iter_num)
        except _StepComputationError as e:
            self.log.printf(Verbosity.ERROR, "Unrecoverable error in step computation: %s", str(e))
            self.solver_status = SolveStatus.Err_Step_Computation
            last = getattr(self, "_last_good", None)
            if last is not None:
                it_l, f_l, err_l, mu_l = last
                return SolverResult(
                    self.solver_status, to_numpy(it_l.x),
                    nlp.unscaled_obj(f_l), self.iter_num,
                    err_nlp=err_l, mu=mu_l,
                )
            return SolverResult(self.solver_status, np.zeros(nlp.n), float("nan"), self.iter_num)
        finally:
            stats.tm_optimize_total.stop()

    def _make_strategy(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _apply_warm_start(self, it_curr, x0, d0, b):
        """User warm-start primal-dual point (startingProcedure warm path,
        hiopAlgFilterIPM.cpp:290+). Returns (it_curr, x0, d0,
        (f, c, d_eval) | None, warm_used)."""
        if self.opts.str_("warm_start") != "yes":
            return it_curr, x0, d0, None, False
        warm = self.nlp.problem.get_warmstart_point()
        if warm is None:
            return it_curr, x0, d0, None, False
        wx, wzl, wzu, wyc, wyd, wd, wvl, wvu = (
            self.nlp._dev(a) if a is not None else None for a in warm
        )
        x0, d0 = it_mod.starting_point_primal(
            wx, wd if wd is not None else d0, b, self.kappa1, self.kappa2
        )
        f, c, d_eval = self._eval_f_cons(x0)
        floor = 1e-12
        it_curr = it_curr._replace(
            x=x0, d=d0,
            zl=torch.where(b.ixl == 1.0, torch.clamp(wzl, min=floor), 0.0),
            zu=torch.where(b.ixu == 1.0, torch.clamp(wzu, min=floor), 0.0),
            vl=torch.where(b.idl == 1.0, torch.clamp(wvl, min=floor), 0.0) if wvl is not None else it_curr.vl,
            vu=torch.where(b.idu == 1.0, torch.clamp(wvu, min=floor), 0.0) if wvu is not None else it_curr.vu,
            yc=wyc if wyc is not None else it_curr.yc,
            yd=wyd if wyd is not None else it_curr.yd,
        )
        it_curr = it_mod.determine_slacks(it_curr, b)
        return it_curr, x0, d0, (f, c, d_eval), True

    # ------------------------------------------------------------- main loop
    def _run_loop(self, strategy) -> SolverResult:
        nlp = self.nlp
        b: Bounds = nlp.bounds
        o = self.opts
        stats = nlp.runstats
        mu = self.mu0
        tau = max(self.tau_min, 1.0 - mu)

        # ---------------- starting procedure (cpp:290) ---------------------
        stats.tm_starting_point.restart()
        x_user = nlp.get_starting_point()
        nlp.maybe_setup_scaling(x_user)
        f0, c0, d0_eval = self._eval_f_cons(x_user)
        x0, d0 = it_mod.starting_point_primal(x_user, d0_eval, b, self.kappa1, self.kappa2)
        f, c, d_eval = self._eval_f_cons(x0)
        n, m_eq, m_ineq = nlp.n, nlp.m_eq, nlp.m_ineq

        def ones(k):
            return torch.ones((k,), dtype=x0.dtype, device=x0.device)

        it_curr = Iterate(
            x=x0,
            d=d0,
            sxl=ones(n), sxu=ones(n), sdl=ones(m_ineq), sdu=ones(m_ineq),
            yc=torch.zeros_like(ones(m_eq)), yd=torch.zeros_like(ones(m_ineq)),
            zl=b.ixl * 1.0, zu=b.ixu * 1.0,
            vl=b.idl * 1.0, vu=b.idu * 1.0,
        )
        it_curr = it_mod.determine_slacks(it_curr, b)
        it_curr, x0, d0, fcd, warm_used = self._apply_warm_start(it_curr, x0, d0, b)
        if fcd is not None:
            f, c, d_eval = fcd
        grad_f = nlp.eval_grad_f(x0)
        Jc, Jd = nlp.eval_jac(x0)
        if not warm_used and o.str_("duals_init") == "lsq":
            yc, yd = du.initial_duals_lsq(
                Jc, Jd, grad_f, it_curr.zl, it_curr.zu, it_curr.vl, it_curr.vu,
                o.num("duals_lsq_ini_max"),
            )
            it_curr = it_curr._replace(yc=yc, yd=yd)
        stats.tm_starting_point.stop()

        resid, norms = self._update_residual(it_curr, c, d_eval, grad_f, Jc, Jd, b, mu)
        theta0 = self._theta_onenorm(it_curr, c, d_eval)
        self.theta_max = self.theta_max_fact * max(1.0, theta0)
        self.theta_min = self.theta_min_fact * max(1.0, theta0)
        self.filter.reinitialize(self.theta_max)

        # checkpoint restore (checkpoint_load_on_start, cpp:1001-1034)
        ckpt_file = o.str_("checkpoint_file")
        if o.str_("checkpoint_load_on_start") == "yes":
            restored = self._try_restore_checkpoint(ckpt_file, strategy)
            if restored is not None:
                it_curr, mu = restored
                tau = max(self.tau_min, 1.0 - mu)
                f, c, d_eval, grad_f, Jc, Jd, resid, norms = self._evaluate_at(it_curr, b, mu)
        ckpt_save = o.str_("checkpoint_save") == "yes"
        ckpt_every = o.integer("checkpoint_save_every_N_iter")

        alpha_primal = alpha_dual = 0.0
        ls_status, ls_num, use_soc = -1, 0, 0
        disable_ls = o.str_("accept_every_trial_step") == "yes"
        self.solver_status = SolveStatus.NlpSolve_Pending
        self.iter_num = 0

        # fused -> general handoff (the reference's quick->safe switch
        # keeps the iterate, switch_to_safer_KKT hpp:468): when a fused
        # mode exits needs-host, the general loop resumes from its last
        # iterate and barrier parameter. As in hiop_tpu, the starting
        # procedure above ran first, and the failing iteration is printed
        # again.
        handoff = getattr(self, "_fused_handoff", None)
        if handoff is not None:
            self._fused_handoff = None
            it_h, mu_h, it_done = handoff
            if bool(torch.isfinite(it_h.x).all()):
                it_curr = it_h
                mu = mu_h
                tau = max(self.tau_min, 1.0 - mu)
                f, c, d_eval, grad_f, Jc, Jd, resid, norms = self._evaluate_at(it_curr, b, mu)
                self.iter_num = it_done
                self.log.printf(
                    Verbosity.SUMMARY,
                    "resuming the general loop from the fused iterate "
                    "(iteration %d, mu=%.3e)", it_done, mu,
                )

        from hiop_tpu_torch import __version__

        self.log.printf(
            Verbosity.SUMMARY,
            "hiop_tpu_torch %s | Problem: %d variables, %d eq + %d ineq constraints "
            "(%d/%d lower/upper var bounds, %d/%d ineq bounds); solver %s on %s",
            __version__, nlp.n, m_eq, m_ineq,
            nlp.n_bnds_low, nlp.n_bnds_upp, nlp.m_ineq_low, nlp.m_ineq_upp,
            type(self).__name__, nlp.device,
        )
        if o.str_("print_options") != "no":
            self.log.printf(
                Verbosity.SUMMARY, "%s",
                o.pretty_print(only_user_defined=o.str_("print_options") == "user_options"),
            )

        while True:
            err_nlp, err_log, cons_viol = self._errors(it_curr, norms)
            if self._err_nlp0 is None:
                self._err_nlp0 = err_nlp
            self._output_iteration(
                f, float(norms.nlp_feasib), float(norms.nlp_optim), mu,
                alpha_dual, alpha_primal, ls_num, ls_status, use_soc,
            )
            # make checkpointing callable from inside the user callback
            # (the reference's Ex1 saves sidre state from iterate_callback)
            self._ckpt_ref = (it_curr, mu, strategy)
            f_host = float(f)
            # best-effort return point: an unrecoverable later failure
            # returns this iterate
            if np.isfinite(f_host):
                self._last_good = (it_curr, f_host, err_nlp, mu)
            info = IterateCallbackInfo(
                iter=self.iter_num, obj_value=nlp.unscaled_obj(f_host),
                logbar_obj_value=self._logbar_f(it_curr, f, b, mu),
                x=it_curr.x, z_L=it_curr.zl, z_U=it_curr.zu, s=it_curr.d,
                g=c, yc=it_curr.yc, yd=it_curr.yd,
                inf_pr=float(norms.nlp_feasib), inf_du=float(norms.nlp_optim),
                onenorm_pr=self._theta_onenorm(it_curr, c, d_eval),
                mu=mu, alpha_du=alpha_dual, alpha_pr=alpha_primal, ls_trials=ls_num,
            )
            if not nlp.user_callback_iterate(info):
                self.solver_status = SolveStatus.User_Stopped
                break

            term = self._check_termination(err_nlp, norms)
            if term is not None:
                self.solver_status = term
                break

            # forced restoration for testing the FR machinery (force_resto,
            # reference cpp:1384)
            if (
                o.str_("force_resto") == "yes"
                and self.iter_num == 1
                and not self.within_fr
                and not self._force_resto_done
            ):
                self._force_resto_done = True
                fr = fr_mod.apply_feasibility_restoration(self, it_curr, mu, norms)
                if fr is not None:
                    it_curr = it_curr._replace(x=fr["x"], d=fr["d"])
                    it_curr, _ = it_mod.compute_safe_slacks(it_curr, it_curr, b, mu)
                    f, c, d_eval, grad_f, Jc, Jd, resid, norms = self._evaluate_at(it_curr, b, mu)
                    self.filter.reinitialize(self.theta_max)

            # ------------- mu update loop (cpp:1168) -----------------------
            elastic_mode = o.str_("elastic_mode")
            while err_log <= self.kappa_eps * mu:
                changed, mu, tau = self._update_mu(mu)
                if not changed:
                    break
                self.log.printf(Verbosity.SCALARS, "barrier params reduced: mu=%g tau=%g", mu, tau)
                if elastic_mode != "none":
                    # tighten the bound relaxation as mu decreases
                    # (update_log_barrier_params elastic branch)
                    brp_ini = o.num("elastic_mode_bound_relax_initial")
                    brp_min = o.num("elastic_mode_bound_relax_final")
                    if o.str_("elastic_bound_strategy") == "mu_scaled":
                        brp = 0.995 * mu
                    else:  # mu_projected
                        brp = (mu - self.eps_tol) / max(self.mu0 - self.eps_tol, 1e-300) * (
                            brp_ini - brp_min
                        ) + brp_min
                    brp = min(max(brp, brp_min), brp_ini)
                    nlp.reset_bounds(brp)
                    b = nlp.bounds
                    if elastic_mode != "tighten_bound":
                        it_curr, n_adj = it_mod.compute_safe_slacks(it_curr, it_curr, b, mu)
                        if int(n_adj) > 0:
                            it_curr = it_mod.adjust_duals(it_curr, b, mu, self.kappa_Sigma)
                resid, norms = self._update_residual(it_curr, c, d_eval, grad_f, Jc, Jd, b, mu)
                err_nlp, err_log, cons_viol = self._errors(it_curr, norms)
                self.filter.reinitialize(self.theta_max)
                if elastic_mode != "none":
                    # reduce mu only once per iteration under elastic mode
                    break

            # ------------- search direction --------------------------------
            stats.kkt.start_iter()
            with stats.kkt.tm_total:
                strategy.prepare(it_curr, grad_f, Jc, Jd, b, mu)
                dir_, _dir_ok = strategy.compute_direction(resid, it_curr, b)
            if o.str_("time_kkt") == "on":
                self.log.printf(Verbosity.SUMMARY, "%s", stats.kkt.summary_last_iter())
            if o.str_("write_kkt") == "yes":
                Dx_dump, Dd_dump = res_mod.barrier_diagonals(it_curr, b)
                kkt_io.dump_kkt(
                    kkt_io.DUMP_PREFIX, self.iter_num,
                    H=getattr(strategy, "_H", None), Dx=Dx_dump, Dd=Dd_dump,
                    # triplet handles are left out of the dumps, as in hiop_tpu
                    Jc=None if isinstance(Jc, TripletMatrix) else Jc,
                    Jd=None if isinstance(Jd, TripletMatrix) else Jd,
                    rx=resid.rx, rd=resid.rd, ryc=resid.ryc, ryd=resid.ryd,
                    dx=dir_.x, dd=dir_.d, dyc=dir_.yc, dyd=dir_.yd,
                    mu=np.asarray(mu),
                )
            if o.str_("deepchecks") == "yes":
                self._deepchecks(it_curr, dir_, b)

            # ------------- line search -------------------------------------
            ap, ad = it_mod.fraction_to_the_boundary(it_curr, dir_, tau, b)
            alpha_primal, alpha_dual = (float(v) for v in torch.stack([ap, ad]).tolist())
            # moving limits (ensure_moving_lims): cap the primal step so
            # |alpha*dx_i| <= lim_abs + lim_rel*|x_i| when enabled
            lim_abs = o.num("moving_lim_abs")
            lim_rel = o.num("moving_lim_rel")
            if lim_abs > 0 or lim_rel > 0:
                cap = lim_abs + lim_rel * it_curr.x.abs()
                dmax = float(dir_.x.abs().max())
                if dmax > 0:
                    alpha_cap = float(
                        (cap / torch.clamp(dir_.x.abs(), min=1e-300)).min()
                    )
                    if alpha_cap < alpha_primal:
                        alpha_primal = max(alpha_cap, self.min_step_size)
                        self.log.printf(
                            Verbosity.SCALARS,
                            "moving limits reduced alpha_primal to %g", alpha_primal,
                        )
            theta_curr = self._theta_onenorm(it_curr, c, d_eval)
            phi_curr = self._logbar_f(it_curr, f, b, mu)
            gx, gd = self._logbar_grads(it_curr, grad_f, b, mu)
            grad_phi_dx = float(gx @ dir_.x + gd @ dir_.d)

            ls_status, ls_num, use_soc = 0, 0, 0
            ini_step = True
            it_trial = None
            f_trial = c_trial = d_trial = None
            theta_trial = phi_trial = None
            small_step = False

            while True:
                if not ini_step and alpha_primal < self.min_step_size:
                    self.log.printf(
                        Verbosity.ERROR,
                        "Minimum step size reached; problem may be locally infeasible.",
                    )
                    small_step = True
                    break
                it_trial = it_mod.take_step_primals(it_curr, dir_, alpha_primal)
                it_trial, n_adj = it_mod.compute_safe_slacks(it_trial, it_curr, b, mu)
                f_trial, c_trial, d_trial = self._eval_f_cons(it_trial.x)
                theta_trial = self._theta_onenorm(it_trial, c_trial, d_trial)
                phi_trial = self._logbar_f(it_trial, f_trial, b, mu)
                ls_num += 1
                if disable_ls:
                    ls_status = 1
                    break
                ls_status = self._accept_line_search_conditions(
                    theta_curr, theta_trial, phi_curr, phi_trial, alpha_primal, grad_phi_dx
                )
                if ls_status > 0:
                    break
                if ini_step and theta_curr <= theta_trial and self.max_soc_iter > 0:
                    soc = self._try_soc(
                        strategy, it_curr, resid, b, mu, tau, c, d_eval,
                        c_trial, d_trial, theta_curr, theta_trial,
                        alpha_primal, phi_curr, grad_phi_dx,
                    )
                    if soc is not None:
                        (it_trial, f_trial, c_trial, d_trial, theta_trial,
                         phi_trial, alpha_primal, alpha_dual, dir_, ls_status) = soc
                        use_soc = 1
                        break
                alpha_primal *= 0.5
                ini_step = False

            use_fr = 0
            if small_step:
                # attempt feasibility restoration (the QN solver is always in
                # safe mode; cpp:1425)
                if err_nlp <= self.accep_tol:
                    self.solver_status = SolveStatus.Solve_Acceptable_Level
                    break
                # soft FR first (apply_feasibility_restoration cpp:3046-3050):
                # cheap retries on the existing factorization before the
                # nested FR NLP solve
                soft = None
                if not self.within_fr:
                    soft = self._solve_soft_fr(
                        strategy, it_curr, resid, norms, dir_, b, mu, tau,
                        c, d_eval, grad_f, Jc, Jd,
                    )
                if soft is not None:
                    (it_trial, f_trial, c_trial, d_trial, theta_trial,
                     phi_trial, alpha_soft) = soft
                    self.log.printf(
                        Verbosity.SCALARS,
                        "soft feasibility restoration accepted (alpha=%g)",
                        alpha_soft,
                    )
                    alpha_primal = alpha_dual = alpha_soft
                    ls_status, ls_num, use_soc = 1, 0, 0
                    self.iter_num += 1
                    stats.n_iters = self.iter_num
                    it_curr = it_trial
                    f, c, d_eval = f_trial, c_trial, d_trial
                    grad_f = nlp.eval_grad_f(it_curr.x)
                    Jc, Jd = nlp.eval_jac(it_curr.x)
                    resid, norms = self._update_residual(
                        it_curr, c, d_eval, grad_f, Jc, Jd, b, mu
                    )
                    continue
                fr = None
                # hiop_tpu takes no nested restoration over triplet
                # (matrix-free) Jacobians
                if not self.within_fr and not isinstance(Jc, TripletMatrix):
                    fr = fr_mod.apply_feasibility_restoration(self, it_curr, mu, norms)
                if fr is None:
                    if self.solver_status != SolveStatus.Infeasible_Problem:
                        self.solver_status = SolveStatus.Steplength_Too_Small
                    break
                use_fr = 1
                it_trial = it_curr._replace(x=fr["x"], d=fr["d"])
                it_trial, _ = it_mod.compute_safe_slacks(it_trial, it_curr, b, mu)
                f_trial, c_trial, d_trial = self._eval_f_cons(it_trial.x)
                theta_trial = self._theta_onenorm(it_trial, c_trial, d_trial)
                phi_trial = self._logbar_f(it_trial, f_trial, b, mu)
                ls_status, ls_num = 1, 0

            # filter augmentation (cpp:1383-1420); skipped after FR
            if use_fr:
                ls_status = 1
            elif ls_status == 1:
                if grad_phi_dx < 0 and alpha_primal * (-grad_phi_dx) ** self.s_phi > self.delta * theta_curr**self.s_theta:
                    if not (phi_trial <= phi_curr + self.eta_phi * alpha_primal * grad_phi_dx):
                        self.filter.add(theta_trial, phi_trial)
                else:
                    self.filter.add(theta_trial, phi_trial)
            elif ls_status == 2:
                self.filter.add(theta_trial, phi_trial)

            self.iter_num += 1
            stats.n_iters = self.iter_num

            # ------------- dual update (dualsUpdate_->go) ------------------
            infeas_nrm_trial = theta_trial
            if use_fr:
                # duals are reinitialized after restoration: bound duals from
                # mu/slack, constraint duals from LSQ (the reference maps the
                # FR problem's duals back; mu/slack is the same fixed point)
                sxl = torch.where(b.ixl == 1.0, it_trial.sxl, 1.0)
                sxu = torch.where(b.ixu == 1.0, it_trial.sxu, 1.0)
                sdl = torch.where(b.idl == 1.0, it_trial.sdl, 1.0)
                sdu = torch.where(b.idu == 1.0, it_trial.sdu, 1.0)
                it_trial = it_trial._replace(
                    zl=torch.where(b.ixl == 1.0, mu / sxl, 0.0),
                    zu=torch.where(b.ixu == 1.0, mu / sxu, 0.0),
                    vl=torch.where(b.idl == 1.0, mu / sdl, 0.0),
                    vu=torch.where(b.idu == 1.0, mu / sdu, 0.0),
                )
                grad_f = nlp.eval_grad_f(it_trial.x)
                Jc, Jd = nlp.eval_jac(it_trial.x)
                yc_new, yd_new = du.initial_duals_lsq(
                    Jc, Jd, grad_f, it_trial.zl, it_trial.zu,
                    it_trial.vl, it_trial.vu, o.num("duals_lsq_ini_max"),
                )
                it_trial = it_trial._replace(yc=yc_new, yd=yd_new)
                self.filter.reinitialize(self.theta_max)
                it_curr = it_trial
                f, c, d_eval = f_trial, c_trial, d_trial
                resid, norms = self._update_residual(it_curr, c, d_eval, grad_f, Jc, Jd, b, mu)
                continue
            # ordering mirrors hiopDualsLsqUpdate::go: step the duals,
            # safeguard the bound duals, THEN least-squares-recompute yc/yd
            # from the *old* derivatives (cpp:1463-1476)
            it_trial = it_mod.take_step_duals(it_trial, dir_, alpha_primal, alpha_dual)
            it_trial = it_mod.adjust_duals(it_trial, b, mu, self.kappa_Sigma)
            if (
                o.str_("duals_update_type") == "lsq"
                and infeas_nrm_trial <= o.num("recalc_lsq_duals_tol")
            ):
                yc_new, yd_new = du.lsq_duals(
                    Jc, Jd, grad_f,
                    it_trial.zl, it_trial.zu, it_trial.vl, it_trial.vu,
                )
                it_trial = it_trial._replace(yc=yc_new, yd=yd_new)
            grad_f = nlp.eval_grad_f(it_trial.x)
            Jc, Jd = nlp.eval_jac(it_trial.x)

            it_curr = it_trial
            f, c, d_eval = f_trial, c_trial, d_trial
            resid, norms = self._update_residual(it_curr, c, d_eval, grad_f, Jc, Jd, b, mu)

            # periodic checkpoint (checkpointing_stuff, cpp:1152-1155)
            if ckpt_save and self.iter_num % ckpt_every == 0:
                self.save_state_to_file(ckpt_file, it_curr, mu, strategy)

        # ---------------- wrap up ------------------------------------------
        obj = nlp.unscaled_obj(f)
        nlp.user_callback_solution(
            self.solver_status, it_curr.x, it_curr.zl, it_curr.zu,
            torch.cat([c, d_eval]) if (nlp.m_eq or nlp.m_ineq) else c,
            (it_curr.yc, it_curr.yd), obj,
        )
        err_nlp, _, _ = self._errors(it_curr, norms)
        self.log.printf(
            Verbosity.SUMMARY,
            "Solver status: %s, objective %.12e, iterations %d",
            self.solver_status.name, obj, self.iter_num,
        )
        self.log.printf(Verbosity.SCALARS, "%s", self.nlp.runstats.get_summary())
        return SolverResult(
            status=self.solver_status,
            x=self._result_x(it_curr.x),
            obj=obj,
            iterations=self.iter_num,
            err_nlp=err_nlp,
            mu=mu,
        )

    # -------------------------------------------------------------- helpers
    def _result_x(self, x) -> np.ndarray:
        """The solution on the host, trimmed of a mesh's padding
        (PaddedDenseProblem)."""
        x_host = to_host(x)
        n_orig = getattr(self.nlp.problem, "_hiop_pad_n_orig", None)
        return x_host if n_orig is None else x_host[:n_orig]

    def _evaluate_at(self, it: Iterate, b: Bounds, mu):
        """f, c, d, grad f, Jc, Jd, the residual and its norms at an iterate
        the loop jumps to (a restored checkpoint, a restoration's point)."""
        f, c, d_eval = self._eval_f_cons(it.x)
        grad_f = self.nlp.eval_grad_f(it.x)
        Jc, Jd = self.nlp.eval_jac(it.x)
        resid, norms = self._update_residual(it, c, d_eval, grad_f, Jc, Jd, b, mu)
        return f, c, d_eval, grad_f, Jc, Jd, resid, norms

    def _update_residual(self, it: Iterate, c, d_eval, grad_f, Jc, Jd, b: Bounds, mu):
        """Residual blocks on the device and their norms as host floats
        (one synchronization for all nine)."""
        jacT_yc = Jc.T @ it.yc if Jc.shape[0] else torch.zeros_like(it.x)
        jacT_yd = Jd.T @ it.yd if Jd.shape[0] else torch.zeros_like(it.x)
        resid, norms = res_mod.update_residual(
            it, c, d_eval, grad_f, jacT_yc, jacT_yd, self.nlp.crhs, b, mu, self.kappa_d
        )
        return resid, res_mod.ResidualNorms(*torch.stack(list(norms)).tolist())

    def _try_soc(
        self, strategy, it_curr, resid, b, mu, tau, c_curr, d_curr,
        c_trial, d_trial, theta_curr, theta_trial0, alpha_primal,
        phi_curr, grad_phi_dx,
    ):
        """Second-order correction (apply_second_order_correction,
        hiopAlgFilterIPM.cpp:2949). Returns the accepted trial tuple or None."""
        crhs = self.nlp.crhs
        c_soc = crhs - c_curr
        d_soc = it_curr.d - d_curr
        alpha_soc = alpha_primal
        theta_trial = theta_trial0
        theta_last = 0.0
        num_soc = 0
        while num_soc < self.max_soc_iter and (num_soc == 0 or theta_trial <= self.kappa_soc * theta_last):
            theta_last = theta_trial
            c_soc = alpha_soc * c_soc + (crhs - c_trial)
            d_soc = alpha_soc * d_soc + (it_curr.d - d_trial)
            res_soc = resid._replace(ryc=c_soc, ryd=d_soc)
            try:
                dir_soc = strategy.solve_rhs(res_soc, it_curr, b)
            except _StepComputationError:
                return None  # SOC is best-effort: fall back to plain backtracking
            ap, ad = it_mod.fraction_to_the_boundary(it_curr, dir_soc, tau, b)
            alpha_soc, alpha_dual_soc = (float(v) for v in torch.stack([ap, ad]).tolist())
            it_trial = it_mod.take_step_primals(it_curr, dir_soc, alpha_soc)
            it_trial, _ = it_mod.compute_safe_slacks(it_trial, it_curr, b, mu)
            f_trial, c_trial, d_trial = self._eval_f_cons(it_trial.x)
            theta_trial = self._theta_onenorm(it_trial, c_trial, d_trial)
            phi_trial = self._logbar_f(it_trial, f_trial, b, mu)
            ls = self._accept_line_search_conditions(
                theta_curr, theta_trial, phi_curr, phi_trial, alpha_primal, grad_phi_dx
            )
            if ls > 0:
                return (
                    it_trial, f_trial, c_trial, d_trial, theta_trial,
                    phi_trial, alpha_soc, alpha_dual_soc, dir_soc, ls,
                )
            num_soc += 1
        return None

    #: soft-FR limits, hardwired as in the reference
    #: (solve_soft_feasibility_restoration, hiopAlgFilterIPM.cpp:3237-3238)
    MAX_SOFT_FR_ITER = 10
    KAPPA_F = 0.999

    def _solve_soft_fr(
        self, strategy, it_curr, resid, norms, dir_, b, mu, tau,
        c, d_eval, grad_f, Jc, Jd,
    ):
        """Soft feasibility restoration (solve_soft_feasibility_restoration,
        hiopAlgFilterIPM.cpp:3235): before posing the full FR NLP, re-use the
        *existing* KKT factorization to step from successive trial points,
        accepting when the one-norm barrier KKT error contracts by kappa_f
        and the trial is not in the filter. Duals are updated inside (the
        reference calls dualsUpdate_->go with equal primal/dual steps).
        Returns (it_trial, f, c, d, theta, phi, alpha) or None."""
        o = self.opts
        kkt_err_curr = float(norms.bar_optim_onenorm + norms.nlp_feasib_onenorm)
        soft_dir = dir_
        it_trial = None
        for num_soft in range(self.MAX_SOFT_FR_ITER):
            if num_soft > 0:
                # re-evaluate at the rejected trial, re-solve with the same
                # factorization and the trial residual (cpp:3276-3282)
                f_trial, c_trial, d_trial = self._eval_f_cons(it_trial.x)
                res_trial, _ = self._update_residual(
                    it_trial, c_trial, d_trial, grad_f, Jc, Jd, b, mu
                )
                try:
                    soft_dir = strategy.solve_rhs(res_trial, it_curr, b)
                except _StepComputationError:
                    return None  # soft FR is best-effort: escalate to full FR
            ap, ad = it_mod.fraction_to_the_boundary(it_curr, soft_dir, tau, b)
            alpha = min(torch.stack([ap, ad]).tolist())  # cpp:3288 equalizes the steps
            it_trial = it_mod.take_step_primals(it_curr, soft_dir, alpha)
            it_trial, _ = it_mod.compute_safe_slacks(it_trial, it_curr, b, mu)
            f_trial, c_trial, d_trial = self._eval_f_cons(it_trial.x)
            it_trial = it_mod.take_step_duals(it_trial, soft_dir, alpha, alpha)
            it_trial = it_mod.adjust_duals(it_trial, b, mu, self.kappa_Sigma)
            theta_trial = self._theta_onenorm(it_trial, c_trial, d_trial)
            if (
                o.str_("duals_update_type") == "lsq"
                and theta_trial <= o.num("recalc_lsq_duals_tol")
                and Jc.shape[0] + Jd.shape[0] > 0
            ):
                yc_new, yd_new = du.lsq_duals(
                    Jc, Jd, grad_f,
                    it_trial.zl, it_trial.zu, it_trial.vl, it_trial.vu,
                )
                it_trial = it_trial._replace(yc=yc_new, yd=yd_new)
            _, norms_t = self._update_residual(
                it_trial, c_trial, d_trial, grad_f, Jc, Jd, b, mu
            )
            kkt_err_trial = float(norms_t.bar_optim_onenorm + norms_t.nlp_feasib_onenorm)
            if kkt_err_trial > self.KAPPA_F * kkt_err_curr:
                return None  # insufficient KKT-error reduction (cpp:3340)
            phi_trial = self._logbar_f(it_trial, f_trial, b, mu)
            if self.filter.contains(float(theta_trial), float(phi_trial)):
                continue  # in the filter: reject, iterate again (cpp:3347)
            return it_trial, f_trial, c_trial, d_trial, theta_trial, phi_trial, alpha
        return None

    # ------------------------------------------------------------ deepchecks
    def _deepchecks(self, it_curr: Iterate, dir_: Iterate, b: Bounds) -> None:
        """Runtime numerical sanitizer (HIOP_DEEPCHECKS semantics): direction
        finiteness, slack positivity on-pattern, dual pattern matching. One
        host synchronization for all the checks."""
        checks = [(f"non-finite entries in direction {name}", torch.isfinite(getattr(dir_, name)).all())
                  for name in Iterate._fields]
        checks += [(f"non-positive slack {name} on pattern", torch.where(pat == 1.0, s > 0, True).all())
                   for name, s, pat in (("sxl", it_curr.sxl, b.ixl), ("sxu", it_curr.sxu, b.ixu),
                                        ("sdl", it_curr.sdl, b.idl), ("sdu", it_curr.sdu, b.idu))]
        checks += [(f"dual {name} does not match its pattern", torch.where(pat == 0.0, z == 0.0, True).all())
                   for name, z, pat in (("zl", it_curr.zl, b.ixl), ("zu", it_curr.zu, b.ixu),
                                        ("vl", it_curr.vl, b.idl), ("vu", it_curr.vu, b.idu))]
        for (what, _), good in zip(checks, torch.stack([flag for _, flag in checks]).tolist()):
            if not good:
                self.log.printf(Verbosity.WARNING, "deepchecks: %s", what)

    # --------------------------------------------------------- checkpointing
    def _collect_checkpoint(self, it_curr: Iterate, mu: float, strategy) -> dict:
        """The solver state in ``hiop_tpu``'s checkpoint schema (host numpy;
        the same keys and shapes, so either package resumes the other's)."""
        state = {
            "n": self.nlp.n, "m_eq": self.nlp.m_eq, "m_ineq": self.nlp.m_ineq,
            "mu": float(mu), "iter_num": int(self.iter_num),
            "theta_max": float(self.theta_max), "theta_min": float(self.theta_min),
            "filter_entries": self.filter._entries,
        }
        for name in Iterate._fields:
            state[f"it_{name}"] = to_numpy(getattr(it_curr, name))
        if isinstance(strategy, _LowRankStrategy):
            state["bfgs_S"] = to_numpy(strategy.bfgs.S)
            state["bfgs_Y"] = to_numpy(strategy.bfgs.Y)
            state["bfgs_active"] = to_numpy(strategy.bfgs.active)
            state["bfgs_sigma"] = float(strategy.bfgs.sigma)
        return state

    def save_state_to_file(self, path: str, it_curr: Iterate, mu: float, strategy) -> None:
        """Explicit checkpoint API (hiopAlgFilterIPM.hpp:399-421)."""
        ckpt.save_state(
            path,
            self._collect_checkpoint(it_curr, mu, strategy),
            fmt=self.opts.str_("checkpoint_format"),
        )

    def save_checkpoint(self, path: str) -> None:
        """Checkpoint the in-flight state; callable from an iterate callback
        (the reference's save_state_to_sidre_group usage in DenseConsEx1)."""
        ref = getattr(self, "_ckpt_ref", None)
        if ref is None:
            raise RuntimeError("no in-flight state; solver is not running")
        self.save_state_to_file(path, *ref)

    def _try_restore_checkpoint(self, path: str, strategy):
        """Returns (it_curr, mu) or None."""
        if not os.path.exists(path):
            self.log.printf(Verbosity.WARNING, "checkpoint file %s not found", path)
            return None
        state = ckpt.load_state(path)
        ckpt.validate(state, self.nlp.n, self.nlp.m_eq, self.nlp.m_ineq)
        dev = self.nlp._dev
        mesh = getattr(self.nlp, "_mesh", None)
        if mesh is not None:
            # the n-sized leaves go back to their shards
            def dev_n(a):
                return shard_n(mesh, dev(a), self.nlp._mesh_axis)
        else:
            dev_n = dev
        n_sized = ("x", "sxl", "sxu", "zl", "zu")
        it_curr = Iterate(*((dev_n if n in n_sized else dev)(state[f"it_{n}"]) for n in Iterate._fields))
        self.iter_num = int(state["iter_num"])
        self.theta_max = float(state["theta_max"])
        self.theta_min = float(state["theta_min"])
        self.filter._entries = list(state.get("filter_entries", []))
        if isinstance(strategy, _LowRankStrategy) and "bfgs_S" in state:
            strategy.bfgs = blr.BfgsState(
                S=dev_n(state["bfgs_S"]),
                Y=dev_n(state["bfgs_Y"]),
                active=dev(state["bfgs_active"]),
                sigma=dev(state["bfgs_sigma"]),
            )
        self.log.printf(
            Verbosity.SUMMARY, "restored checkpoint %s at iteration %d", path, self.iter_num
        )
        return it_curr, float(state["mu"])

    # ------------------------------------------------------ fused modes
    #: fused-iteration mode of the solver class ('newton'/'qn'); None
    #: disables the fused modes
    _fused_mode = None
    #: (iteration, reason) of a fused solve's needs-host exit to the
    #: general loop, None without one
    fused_fallback = None

    def _run_dispatch(self) -> SolverResult:
        """``jit_mode=iteration/solve`` on a jittable problem runs the fused
        modes (:mod:`hiop_tpu_torch.optimization.fused_newton`) where
        ``hiop_tpu`` would; a needs-host exit goes on in the general loop
        from the fused iterate."""
        o = self.opts
        jit_mode = o.str_("jit_mode")
        fusable = (
            self._fused_mode is not None
            and jit_mode in ("iteration", "solve")
            and getattr(self.nlp.problem, "jittable", False)
            and (self._fused_mode == "qn" or o.str_("KKTLinsys") in ("auto", "xdycyd"))
            and not getattr(self.nlp, "matrix_free", False)
            # per-iteration host-side debug and IO surfaces need the general loop
            and o.str_("deepchecks") == "no"
            and o.str_("write_kkt") == "no"
            and o.str_("time_kkt") == "off"
        )
        if fusable:
            fusable = self._fused_fits_memory()
        if fusable:
            try:
                if jit_mode == "solve" and not self._iterate_callback_overridden():
                    return self._run_fused_solve()
                return self._run_fused()
            except _FusedFallback as e:
                self.log.printf(
                    Verbosity.SUMMARY,
                    "fused iteration bailed out (%s); re-running the general path",
                    str(e),
                )
                self.fused_fallback = (self.iter_num, str(e))
                # reset the algorithm state and run the general loop
                self.filter = Filter()
                self._n_accep = 0
                self._err_nlp0 = None
                self.iter_num = 0
        return self._run_general()

    def _fused_fits_memory(self) -> bool:
        """``hiop_tpu``'s estimate of the fused MDS program's footprint, and
        its budget: 12e9 bytes (a TPU chip's), or HIOP_TPU_FUSED_MEM_BUDGET.
        The port keeps both so that a problem takes the same route in both
        packages, not because the card needs it. Operator form
        (kkt_fact_dtype=float32 with the triplet structure): the f32 saddle
        and factor and the dense Jacobian state twice; else the f64 saddle
        family's estimate."""
        from hiop_tpu_torch.formulation.mds import NlpMDS

        nlp = self.nlp
        if not isinstance(nlp, NlpMDS):
            return True
        n_sad = nlp.n_dense + nlp.m_eq + nlp.m_ineq
        m = nlp.m_eq + nlp.m_ineq
        if (
            self.opts.str_("kkt_fact_dtype") == "float32"
            and kkt_mds.mds_js_struct(nlp) is not None
        ):
            est = n_sad * n_sad * 12 + 2 * m * nlp.n * 8
        else:
            est = n_sad * n_sad * 20 + 2 * m * nlp.n_sparse * 8
        budget = float(os.environ.get("HIOP_TPU_FUSED_MEM_BUDGET", 12e9))
        if est > budget:
            self.log.printf(
                Verbosity.SUMMARY,
                "fused KKT footprint ~%.1f GB exceeds the %.1f GB budget; "
                "using the general loop's host tiers",
                est / 1e9, budget / 1e9,
            )
            return False
        return True

    def _iterate_callback_overridden(self) -> bool:
        """jit_mode=solve does not stop for a per-iteration user callback;
        a problem that overrides it takes the per-iteration fused path."""
        from hiop_tpu_torch.interface.base import NlpProblem

        cb = getattr(type(self.nlp.problem), "iterate_callback", None)
        return cb is not None and cb is not NlpProblem.iterate_callback

    def _fused_init(self):
        """The fused modes' starting procedure: scaling, primal and slack
        initialization, LSQ duals, theta_min/max, the option constants and
        the initial fused state."""
        from hiop_tpu_torch.optimization import fused_newton as fn

        nlp = self.nlp
        b: Bounds = nlp.bounds
        o = self.opts
        x_user = nlp.get_starting_point()
        nlp.maybe_setup_scaling(x_user)
        f0, c0, d0_eval = self._eval_f_cons(x_user)
        x0, d0 = it_mod.starting_point_primal(x_user, d0_eval, b, self.kappa1, self.kappa2)
        f, c, d_eval = self._eval_f_cons(x0)
        n, m_eq, m_ineq = nlp.n, nlp.m_eq, nlp.m_ineq

        def ones(k):
            return torch.ones((k,), dtype=x0.dtype, device=x0.device)

        it_curr = Iterate(
            x=x0, d=d0,
            sxl=ones(n), sxu=ones(n), sdl=ones(m_ineq), sdu=ones(m_ineq),
            yc=torch.zeros_like(ones(m_eq)), yd=torch.zeros_like(ones(m_ineq)),
            zl=b.ixl * 1.0, zu=b.ixu * 1.0, vl=b.idl * 1.0, vu=b.idu * 1.0,
        )
        it_curr = it_mod.determine_slacks(it_curr, b)
        it_curr, x0, d0, fcd, warm_used = self._apply_warm_start(it_curr, x0, d0, b)
        if fcd is not None:
            f, c, d_eval = fcd
        grad_f = nlp.eval_grad_f(x0)
        Jc, Jd = nlp.eval_jac(x0)
        if not warm_used and o.str_("duals_init") == "lsq":
            yc, yd = du.initial_duals_lsq(
                Jc, Jd, grad_f, it_curr.zl, it_curr.zu, it_curr.vl, it_curr.vu,
                o.num("duals_lsq_ini_max"),
            )
            it_curr = it_curr._replace(yc=yc, yd=yd)

        theta0 = self._theta_onenorm(it_curr, c, d_eval)
        self.theta_max = self.theta_max_fact * max(1.0, theta0)
        self.theta_min = self.theta_min_fact * max(1.0, theta0)
        consts = dict(
            kappa_d=self.kappa_d, kappa_Sigma=self.kappa_Sigma,
            gamma_theta=self.gamma_theta,
            gamma_phi=self.gamma_phi, s_theta=self.s_theta, s_phi=self.s_phi,
            delta=self.delta, eta_phi=self.eta_phi,
            min_step_size=self.min_step_size, smax=self.smax,
            max_soc_iter=o.integer("max_soc_iter"),
            kappa_soc=o.num("kappa_soc"),
            # the inertia-revealing device LDL^T inside the fused step
            fused_ldl=o.str_("linear_solver_dense") == "ldl_nopiv",
            # mixed precision inside the fused step: the equilibrated f32
            # LDL^T, f64 refinement, f64 refactorization only where the
            # refinement cannot certify (ReSolve's pattern,
            # RefactorizationSolver.hpp:74)
            fused_mp=o.str_("kkt_fact_dtype") == "float32",
            fused_ir_tol=min(o.num("ir_inner_tol_min"), 1e-9),
            # inertia-free curvature acceptance in the fused mp ladder
            # (hiopFactAcceptorInertiaFreeDWD)
            fused_inertia_free=o.str_("fact_acceptor") == "inertia_free",
            neg_curv_fact=o.num("neg_curv_test_fact"),
        )
        if self._fused_mode == "qn":
            consts.update(
                sigma_update_strategy=o.str_("sigma_update_strategy"),
                sigma0=o.num("sigma0"),
                recalc_lsq_duals_tol=o.num("recalc_lsq_duals_tol"),
            )
            bfgs0 = blr.init_state(
                n, o.integer("secant_memory_len"), o.num("sigma0"),
                dtype=x0.dtype, device=x0.device,
                mesh=getattr(nlp, "_mesh", None), axis_name=getattr(nlp, "_mesh_axis", "n"),
            )
            state = fn.FusedQNState(
                it=it_curr, f=f, c=c, d=d_eval, grad=grad_f, Jc=Jc, Jd=Jd, bfgs=bfgs0,
                x_prev=it_curr.x, grad_prev=grad_f, Jc_prev=Jc, Jd_prev=Jd,
                have_prev=False,
            )
        else:
            state = fn.FusedState(it=it_curr, f=f, c=c, d=d_eval, grad=grad_f, Jc=Jc, Jd=Jd)
        return state, consts

    def _fused_term(self) -> dict:
        """The termination and schedule constants of the fused solve."""
        return dict(
            eps_tol=self.eps_tol, rel_tol=self.rel_tol,
            accep_tol=self.accep_tol, accep_iters=self.accep_iters,
            max_iter=self.max_iter, kappa_eps=self.kappa_eps,
            kappa_mu=self.kappa_mu, theta_mu=self.theta_mu,
            tau_min=self.tau_min,
            comp_tol_scaled=self.comp_tol / self.nlp.scale_obj,
        )

    def _run_fused_solve(self) -> SolverResult:
        """``jit_mode=solve``: the outer mu loop, the filter and the
        termination ladder on the device (fused_newton.build_fused_solve);
        the host reads one status per iteration, folded into the step's
        first read, and the history buffer once at the end, from which the
        iteration table is printed as in the other modes."""
        from hiop_tpu_torch.optimization import fused_newton as fn

        nlp = self.nlp
        stats = nlp.runstats
        stats.tm_optimize_total.restart()
        mu = self.mu0
        tau = max(self.tau_min, 1.0 - mu)
        state, consts = self._fused_init()
        solve = fn.build_fused_solve(nlp, consts, self._fused_term(), mode=self._fused_mode)
        state, mu_dev, it_num, st, _err, hist, _carry = solve(
            state, mu, tau, self.theta_min, self.theta_max, self.max_iter,
        )
        rows = min(it_num + 1, fn.HIST_CAP)
        # the one read at the end: the history rows, mu and f
        host = torch.cat([hist[:rows].reshape(-1), mu_dev.reshape(1), state.f.reshape(1)]).tolist()
        hist = np.asarray(host[:rows * fn.HIST_COLS]).reshape(rows, fn.HIST_COLS)
        mu, f_final = host[-2], host[-1]
        err_nlp = float(hist[min(it_num, fn.HIST_CAP - 1), fn.HIST_ERR])

        # the iteration table from the history buffer
        for i in range(rows):
            self.iter_num = i
            (f_i, feas_i, opt_i, mu_i, adu_i, apr_i, lsn_i, lss_i,
             _err_i, soc_i, _f32_i, _dw_i, _nref_i, _ir_i, _socn_i) = hist[i]
            self._output_iteration(
                f_i, feas_i, opt_i, mu_i, adu_i, apr_i,
                int(lsn_i), int(lss_i) if i else -1, use_soc=int(soc_i),
            )
        self._err_nlp0 = float(hist[0, fn.HIST_ERR])
        self.iter_num = it_num
        stats.n_iters = it_num
        #: the per-iteration history (HIST_COLS, with delta_w and mp_f32);
        #: rows past min(it_num, HIST_CAP) are undefined
        self._last_fused_hist = hist
        if it_num > 0 and consts.get("fused_mp"):
            used = hist[:it_num, 10]
            stats.kkt.n_fact_total += int(used.shape[0])
            stats.kkt.n_fact_f32 += int(used.sum())

        if st in (6, 7):
            # hand the final fused iterate to the general loop (resume, not
            # restart: see _run_loop's handoff block)
            self._fused_handoff = (state.it, mu, it_num)
        if st == 6:
            raise _FusedFallback("factorization needs regularization")
        if st == 7:
            raise _FusedFallback("line search rejected (SOC/FR needed)")
        self.solver_status = {
            1: SolveStatus.Solve_Success,
            2: SolveStatus.Solve_Success_RelTol,
            3: SolveStatus.Solve_Acceptable_Level,
            4: SolveStatus.Max_Iter_Exceeded,
            5: SolveStatus.Iterates_Diverging,
        }.get(st, SolveStatus.Unknown)
        return self._fused_result(state, f_final, err_nlp, mu, "fused solve")

    def _fused_result(self, state, f_final: float, err_nlp: float, mu: float, what: str):
        nlp = self.nlp
        obj = nlp.unscaled_obj(f_final)
        nlp.runstats.tm_optimize_total.stop()
        nlp.user_callback_solution(
            self.solver_status, state.it.x, state.it.zl, state.it.zu,
            torch.cat([state.c, state.d]) if nlp.m else state.c,
            (state.it.yc, state.it.yd), obj,
        )
        self.log.printf(
            Verbosity.SUMMARY,
            "Solver status: %s, objective %.12e, iterations %d (%s)",
            self.solver_status.name, obj, self.iter_num, what,
        )
        return SolverResult(
            status=self.solver_status, x=self._result_x(state.it.x), obj=obj,
            iterations=self.iter_num, err_nlp=err_nlp, mu=mu,
        )

    def _run_fused(self) -> SolverResult:
        """``jit_mode=iteration``: one fused step per iteration
        (fused_newton.build_fused_step), the O(1) decisions on the host from
        one read of the step's scalar bundle; the filter is a host array,
        mirrored on the device for the step's trial tests."""
        from hiop_tpu_torch.optimization import fused_newton as fn

        nlp = self.nlp
        stats = nlp.runstats
        stats.tm_optimize_total.restart()
        mu = self.mu0
        tau = max(self.tau_min, 1.0 - mu)

        state, consts = self._fused_init()
        step = fn.build_fused_step(nlp, consts, mode=self._fused_mode)

        x0 = state.it.x
        filt = np.full((fn.FILTER_CAP, 2), np.inf)
        filt[0] = (self.theta_max, -np.inf)
        filt_dev = torch.full((fn.FILTER_CAP, 2), math.inf, dtype=x0.dtype, device=x0.device)
        filt_dev[0, 0] = self.theta_max
        filt_dev[0, 1] = -math.inf
        filt_len = 1
        self.solver_status = SolveStatus.NlpSolve_Pending
        self.iter_num = 0

        dw_last = x0.new_zeros(())
        while True:
            new_state, s, dw_next = step(
                state, mu, tau, filt_dev, filt_len, self.theta_min, dw_last,
            )
            sh = fn.read_scalars(s)
            err_nlp = sh.err_nlp
            if self._err_nlp0 is None:
                self._err_nlp0 = err_nlp
            self._output_iteration(
                sh.f, sh.nlp_feasib, sh.nlp_optim, mu,
                sh.alpha_dual, sh.alpha_primal,
                int(sh.ls_count), int(sh.ls_status) if self.iter_num else -1,
                use_soc=int(sh.use_soc),
            )
            # the user callback (scalars; arrays on request)
            info = IterateCallbackInfo(
                iter=self.iter_num, obj_value=nlp.unscaled_obj(sh.f),
                logbar_obj_value=sh.phi, x=state.it.x,
                z_L=state.it.zl, z_U=state.it.zu, s=state.it.d, g=state.c,
                yc=state.it.yc, yd=state.it.yd,
                inf_pr=sh.nlp_feasib, inf_du=sh.nlp_optim,
                onenorm_pr=sh.theta, mu=mu,
                alpha_du=sh.alpha_dual, alpha_pr=sh.alpha_primal,
                ls_trials=int(sh.ls_count),
            )
            if not nlp.user_callback_iterate(info):
                self.solver_status = SolveStatus.User_Stopped
                break

            term = self._check_termination(err_nlp, sh)
            if term is not None:
                self.solver_status = term
                break

            if not sh.fact_ok:
                self._fused_handoff = (state.it, mu, self.iter_num)
                raise _FusedFallback("factorization needs regularization")
            if int(sh.ls_status) == 0:
                self._fused_handoff = (state.it, mu, self.iter_num)
                raise _FusedFallback("line search rejected (SOC/FR needed)")

            # the mu schedule (one reduction per iteration; catch-up
            # happens over the following iterations)
            if sh.err_log <= self.kappa_eps * mu:
                changed, mu, tau = self._update_mu(mu)
                if changed:
                    filt[0] = (self.theta_max, -np.inf)
                    filt_len = 1
            if sh.filter_add and filt_len < fn.FILTER_CAP:
                filt[filt_len] = (sh.theta_add, sh.phi_add)
                filt_dev[filt_len, 0] = sh.theta_add
                filt_dev[filt_len, 1] = sh.phi_add
                filt_len += 1

            state = new_state
            dw_last = dw_next
            self.iter_num += 1
            stats.n_iters = self.iter_num
            if consts.get("fused_mp"):
                stats.kkt.n_fact_total += 1
                stats.kkt.n_fact_f32 += int(bool(sh.mp_f32))

        return self._fused_result(state, float(state.f), err_nlp, mu, "fused")


class FilterIPMQuasiNewton(FilterIPMBase):
    """IPM with a limited-memory BFGS Hessian for dense-constrained NLPs
    (hiopAlgFilterIPMQuasiNewton, hpp:349). Always in "safe mode"
    (cpp:1085); the KKT system is the low-rank Schur solve."""

    _fused_mode = "qn"

    def _make_strategy(self):
        return _LowRankStrategy(self.nlp)


class FilterIPMNewton(FilterIPMBase):
    """IPM with exact second order (hiopAlgFilterIPMNewton, hpp:446).

    The KKT class ladder (decideAndCreateLinearSystem, cpp:1848-1901), in
    ``hiop_tpu``'s order: MDS formulations take :class:`_MdsStrategy`;
    sparse ones with ``KKTLinsys=condensed`` take
    :class:`_CondensedMatfreeStrategy` over matrix-free Jacobians, and
    :class:`_CondensedSparseDeviceStrategy` without equalities from
    n = 2000 on (the dense condensed class when its symbolic analysis
    refuses the pattern; ``linear_solver_sparse=device_ldl`` makes the
    Jacobians matrix-free, so the CG class takes it first);
    :class:`_SparseFullStrategy` for ``KKTLinsys=full``, and
    :class:`_SparseDirectStrategy` for a named registry solver or, with
    ``linear_solver_sparse=auto``, from n + m = 2000 on; everything else the
    dense :class:`_NewtonDenseStrategy` (the Hessian assembled from the
    triplets for sparse problems). Another formulation class raises."""

    _fused_mode = "newton"

    def _make_strategy(self):
        from hiop_tpu_torch.formulation.dense import NlpDenseConstraints
        from hiop_tpu_torch.formulation.mds import NlpMDS
        from hiop_tpu_torch.formulation.sparse import NlpSparse

        nlp, o = self.nlp, self.opts
        if isinstance(nlp, NlpMDS):
            return _MdsStrategy(nlp, self.log, nlp.runstats)
        sparse = isinstance(nlp, NlpSparse)
        kkt = o.str_("KKTLinsys")
        ls = o.str_("linear_solver_sparse")
        if sparse and kkt == "condensed" and nlp.matrix_free:
            return _CondensedMatfreeStrategy(nlp, self.log, nlp.runstats)
        if (
            sparse and kkt == "condensed" and nlp.m_eq == 0
            # replace the dense materialization from the densification
            # threshold on, or on request: HiOp's CSR condensed class
            # (hiopKKTLinSysSparseCondensed.hpp:105)
            and (nlp.n >= 2000 or ls == "device_ldl")
        ):
            try:
                return _CondensedSparseDeviceStrategy(nlp, self.log, nlp.runstats)
            except ValueError as e:
                # the pair, fill or op guards refused the pattern: the
                # dense condensed class
                self.log.printf(
                    Verbosity.SCALARS,
                    "sparse condensed device path unavailable (%s); using "
                    "the dense condensed realization", e,
                )
        if sparse and kkt == "full":
            return _SparseFullStrategy(nlp, self.log, nlp.runstats)
        if sparse and kkt in ("auto", "xdycyd", "xycyd"):
            from hiop_tpu_torch.linalg import solver_registry

            if ls != "auto" and solver_registry.has_solver(ls):
                return _SparseDirectStrategy(nlp, self.log, nlp.runstats)
            # auto: above this size the dense XDYcYd assembly and
            # factorization are O(N^2)/O(N^3) while the sparse-direct path
            # is fill-limited (hiopKKTLinSysSparse.cpp)
            if ls == "auto" and nlp.n + nlp.m_eq + nlp.m_ineq >= 2000:
                return _SparseDirectStrategy(nlp, self.log, nlp.runstats)
        if sparse or isinstance(nlp, NlpDenseConstraints):
            return _NewtonDenseStrategy(nlp, self.log, nlp.runstats)
        raise _unknown_formulation("FilterIPMNewton", nlp)
