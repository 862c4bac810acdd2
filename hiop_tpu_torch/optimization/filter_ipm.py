"""Filter line-search interior-point solver (Newton, MDS formulation).

Counterpart of ``hiop_tpu/optimization/filter_ipm.py`` (reference
hiopAlgFilterIPMBase / hiopAlgFilterIPMNewton, hiopAlgFilterIPM.hpp:83,446).
The outer algorithm (mu loop, filter line search, second-order correction,
dual updates, termination) runs in Python at iteration granularity, while
the O(n)/O(n*m) math (residuals, KKT factorizations and solves,
fraction-to-the-boundary) runs as torch operations and hand-written
kernels on the solver's device.

Algorithm skeleton (cpp:955-1552): startingProcedure -> loop {
errors/termination -> mu update loop -> KKT update -> search direction ->
fraction-to-boundary -> backtracking filter line search (with SOC) -> dual
update -> re-evals }.

The port covers the general loop (``jit_mode=kernels``) with the MDS
strategy: the quick Cholesky tier and the safe ladder (the native bordered
sparse LDL^T on the host, device no-pivot LDL^T, host LU + eigen inertia),
in f64 or with ``kkt_fact_dtype=float32``: f32 factorizations through the
same kernels, each solve certified by f64 FGMRES refinement
(:mod:`hiop_tpu_torch.linalg.krylov`) under the ``mp_schedule`` policy, and
on the card an f32 device LDL^T in place of every safe tier until the
first rejection or failed certification demotes f32. Options and paths
that need modules not ported yet raise :class:`NotImplementedError` naming
the ROADMAP.md item that will port them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from hiop_tpu_torch.backends.execspace import on_accelerator, resolve_device
from hiop_tpu_torch.formulation.base import NlpFormulation, to_numpy
from hiop_tpu_torch.interface.base import IterateCallbackInfo
from hiop_tpu_torch.kkt import mds as kkt_mds
from hiop_tpu_torch.linalg import krylov
from hiop_tpu_torch.native import ldl as native_ldl
from hiop_tpu_torch.optimization import duals_update as du
from hiop_tpu_torch.optimization import iterate as it_mod
from hiop_tpu_torch.optimization import residual as res_mod
from hiop_tpu_torch.optimization.filter import Filter
from hiop_tpu_torch.optimization.iterate import Bounds, Iterate
from hiop_tpu_torch.optimization.perturbation import make_perturbation
from hiop_tpu_torch.status import SolveStatus
from hiop_tpu_torch.utils.logger import Verbosity


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


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to hiop_tpu_torch yet (ROADMAP.md section 1, {item})"
    )


#: options whose non-default values need code this slice does not port
_UNPORTED_OPTIONS = (
    ("jit_mode", ("iteration", "solve"), "jit_mode=iteration/solve", "item 13: fused modes"),
    ("elastic_mode", ("tighten_bound", "correct_it", "correct_it_adjust_bound"),
     "elastic_mode", "item 12: robustness"),
    ("checkpoint_save", ("yes",), "checkpointing", "item 12: utils/checkpoint.py"),
    ("checkpoint_load_on_start", ("yes",), "checkpointing", "item 12: utils/checkpoint.py"),
    ("write_kkt", ("yes",), "write_kkt", "item 12: utils/kkt_io.py"),
    ("deepchecks", ("yes",), "deepchecks", "item 12: the deepchecks option"),
    ("force_resto", ("yes",), "feasibility restoration",
     "item 12: optimization/fr_problem.py"),
)


# =====================================================================
# search-direction strategy
# =====================================================================
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
        stacked_rows = np.concatenate([
            np.asarray(nlp.jac_sp_eq_rows, dtype=np.int64),
            nlp.m_eq + np.asarray(nlp.jac_sp_in_rows, dtype=np.int64),
        ])
        stacked_cols = np.concatenate([
            np.asarray(nlp.jac_sp_eq_cols, dtype=np.int64),
            np.asarray(nlp.jac_sp_in_cols, dtype=np.int64),
        ])
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
        return out

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
        o = self.opts
        for name, bad, what, item in _UNPORTED_OPTIONS:
            if o.str_(name) in bad:
                raise _not_ported(what, item)
        if o.str_("profile_dir"):
            raise _not_ported("profile_dir", "item 16: tracing surface")
        return self._run_general()

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

        alpha_primal = alpha_dual = 0.0
        ls_status, ls_num, use_soc = -1, 0, 0
        disable_ls = o.str_("accept_every_trial_step") == "yes"
        self.solver_status = SolveStatus.NlpSolve_Pending
        self.iter_num = 0

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

            # ------------- mu update loop (cpp:1168) -----------------------
            while err_log <= self.kappa_eps * mu:
                changed, mu, tau = self._update_mu(mu)
                if not changed:
                    break
                self.log.printf(Verbosity.SCALARS, "barrier params reduced: mu=%g tau=%g", mu, tau)
                resid, norms = self._update_residual(it_curr, c, d_eval, grad_f, Jc, Jd, b, mu)
                err_nlp, err_log, cons_viol = self._errors(it_curr, norms)
                self.filter.reinitialize(self.theta_max)

            # ------------- search direction --------------------------------
            stats.kkt.start_iter()
            with stats.kkt.tm_total:
                strategy.prepare(it_curr, grad_f, Jc, Jd, b, mu)
                dir_, _dir_ok = strategy.compute_direction(resid, it_curr, b)
            if o.str_("time_kkt") == "on":
                self.log.printf(Verbosity.SUMMARY, "%s", stats.kkt.summary_last_iter())

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

            if small_step:
                if err_nlp <= self.accep_tol:
                    self.solver_status = SolveStatus.Solve_Acceptable_Level
                    break
                raise _not_ported(
                    "feasibility restoration (soft and full)",
                    "item 12: optimization/fr_problem.py",
                )

            # filter augmentation (cpp:1383-1420)
            if ls_status == 1:
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
            # ordering mirrors hiopDualsLsqUpdate::go: step the duals,
            # safeguard the bound duals, THEN least-squares-recompute yc/yd
            # from the *old* derivatives (cpp:1463-1476)
            infeas_nrm_trial = theta_trial
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
            x=to_numpy(it_curr.x),
            obj=obj,
            iterations=self.iter_num,
            err_nlp=err_nlp,
            mu=mu,
        )

    # -------------------------------------------------------------- helpers
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


class FilterIPMQuasiNewton(FilterIPMBase):
    """IPM with limited-memory BFGS Hessian (hiopAlgFilterIPMQuasiNewton,
    hpp:349): not ported yet."""

    def __init__(self, nlp: NlpFormulation):
        raise _not_ported("FilterIPMQuasiNewton", "item 10: the QN path")


class FilterIPMNewton(FilterIPMBase):
    """IPM with exact second order (hiopAlgFilterIPMNewton, hpp:446). This
    slice takes MDS formulations (:class:`~hiop_tpu_torch.formulation.mds.NlpMDS`)."""

    def _make_strategy(self):
        from hiop_tpu_torch.formulation.mds import NlpMDS

        if isinstance(self.nlp, NlpMDS):
            return _MdsStrategy(self.nlp, self.log, self.nlp.runstats)
        raise _not_ported(
            f"FilterIPMNewton over {type(self.nlp).__name__}",
            "items 9 and 11: dense and sparse KKT classes",
        )
