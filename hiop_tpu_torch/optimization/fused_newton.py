"""The fused modes: ``jit_mode=iteration`` and ``jit_mode=solve``.

Counterpart of ``hiop_tpu/optimization/fused_newton.py``. ``hiop_tpu``
compiles one IPM iteration (``jit_mode=iteration``), or the whole solve
(``jit_mode=solve``), into one XLA program: evaluations, Hessian, the
factorization with an on-device regularization ladder, the direction, the
first trial, second-order correction and backtracking filter line search
(``lax.while_loop`` each, the filter a fixed-size buffer), the dual update
and safeguards, and for ``solve`` also the mu/tau schedule, the filter
updates and the termination ladder.

Here the same algorithm runs eagerly on the solver's device and makes the
same decisions:

- each ``lax.while_loop`` (the regularization ladder, the SOC rounds, the
  backtracking trials, the whole solve) is a Python loop whose
  continue-test is one host read per trip (:class:`_HostReads`: the
  values of one test are stacked and copied by one ``tolist``);
- a ``lax.cond`` becomes a Python branch after the read that decides it,
  and a ``jnp.where`` that only keeps the traced program branch-free
  becomes a branch on a value already read, choosing the same value;
- everything else stays on the device: the factorizations (the
  hand-written Cholesky and LDL^T kernels on a card), the regularization
  deltas with their cross-iteration memory ``dw_last``, the filter test
  of every trial, and in ``jit_mode=solve`` the mu/tau schedule, the
  filter buffer, the termination ladder and the history buffer.

What a fused iteration reads from the host, besides the KKT solves' own
refinement steps (one read per step, :mod:`hiop_tpu_torch.kkt.mds`): one
read per factorization of the ladder, one for the first trial, one per SOC
round and per backtracking trial; ``jit_mode=iteration`` adds one read of
the :class:`FusedScalars` bundle, ``jit_mode=solve`` folds its status into
the first of them. Nothing is captured in a CUDA graph here (ROADMAP.md
item 13b). A parametric problem (batch_solve's scenario parameter) has no
single-problem fused step, as in ``hiop_tpu``: its family runs through
:func:`hiop_tpu_torch.optimization.batch_solve.solve_batched`. A
mesh-sharded QN state raises, naming ROADMAP item 15.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch

from hiop_tpu_torch.linalg.vector_ops import scatter_add_
from hiop_tpu_torch.optimization import iterate as it_mod
from hiop_tpu_torch.optimization import residual as res_mod
from hiop_tpu_torch.optimization.iterate import Iterate

FILTER_CAP = 128
MAX_LS = 30

#: columns of the per-iteration history buffer of the fused solve
#: (jit_mode=solve): f, nlp_feasib, nlp_optim, mu, alpha_du, alpha_pr,
#: ls_count, ls_status, err_nlp, use_soc, mp_f32 (the iteration's
#: factorization stayed in certified f32), delta_w (accepted primal
#: regularization), n_refact (regularization-ladder refactorizations),
#: ir_primary (IR/FGMRES iterations on the primary solve), soc_rounds
#: (second-order-correction re-solves)
HIST_COLS = 15
HIST_ERR = 8
#: rows of the history buffer; runs past it keep solving, and only their
#: last row is overwritten
HIST_CAP = 1024


class FusedScalars(NamedTuple):
    """Per-iteration scalars of a fused step. A field is a device tensor
    until read, or a Python number where the step already read it (the
    loop counters and the line-search outcome); :func:`read_scalars` reads
    the tensors of a bundle in one host read."""

    f: object
    err_nlp: object
    err_log: object
    nlp_optim: object
    nlp_feasib: object
    theta: object
    phi: object
    alpha_primal: object
    alpha_dual: object
    ls_count: object
    ls_status: object        # 0 rejected (needs the general loop), 1/2/3 accepted kinds
    use_soc: object          # step accepted via second-order correction
    fact_ok: object
    filter_add: object       # the trial (theta_add, phi_add) goes into the filter
    theta_add: object
    phi_add: object
    mp_f32: object           # factorization used certified f32 (mixed precision)
    delta_w: object          # accepted primal regularization this iteration
    n_refact: object         # regularization-ladder refactorizations
    ir_primary: object       # IR/FGMRES iterations on the primary solve
    soc_rounds: object       # second-order-correction re-solves
    folded: object = None    # host values of the step's ``fold`` tensor
    host_reads: int = 0      # host reads the step made


class _FusedLdlFactors(NamedTuple):
    """LDL factors of the fused ladder: ``ok`` folds the pivot-sign
    inertia acceptance (n_neg == m_eq + m_ineq) into the regularization
    loop's retry test."""
    L: torch.Tensor
    d: torch.Tensor
    ok: torch.Tensor


class FusedState(NamedTuple):
    it: Iterate
    f: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    grad: torch.Tensor
    Jc: torch.Tensor
    Jd: torch.Tensor


class FusedQNState(NamedTuple):
    """Fused quasi-Newton state: the Newton state, the BFGS memory and the
    previous accepted point's derivatives (for the secant update).
    ``have_prev`` is a host bool: whether a step was accepted is read by
    the line search anyway."""

    it: Iterate
    f: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    grad: torch.Tensor
    Jc: torch.Tensor
    Jd: torch.Tensor
    bfgs: object             # hessian_lowrank.BfgsState
    x_prev: torch.Tensor
    grad_prev: torch.Tensor
    Jc_prev: torch.Tensor
    Jd_prev: torch.Tensor
    have_prev: bool


class _HostReads:
    """The host reads of one fused step. Each :meth:`get` is one read: its
    tensors and the deferred ones are stacked as f64 and copied by one
    ``tolist``; numbers pass through unread. A deferred tensor (one the
    step needs on the host later, or the caller's ``fold``) rides along
    with the next read."""

    def __init__(self) -> None:
        self.n = 0
        self.values: dict = {}
        self._deferred: list = []

    def defer(self, key: str, value) -> None:
        if isinstance(value, torch.Tensor):
            self._deferred.append((key, value))
        else:
            self.values[key] = value

    def get(self, *values):
        tensors = [v for v in values if isinstance(v, torch.Tensor)]
        pending, self._deferred = self._deferred, []
        if not tensors and not pending:
            return list(values)
        parts = [t.reshape(-1).to(torch.float64) for t in tensors]
        parts += [t.reshape(-1).to(torch.float64) for _, t in pending]
        host = torch.cat(parts).tolist()
        self.n += 1
        pos = 0
        out = []
        for v in values:
            if isinstance(v, torch.Tensor):
                out.append(host[pos])
                pos += 1
            else:
                out.append(v)
        for key, t in pending:
            k = t.numel()
            self.values[key] = host[pos] if t.dim() == 0 else host[pos:pos + k]
            pos += k
        return out

    def flush(self) -> None:
        if self._deferred:
            self.get()


def read_scalars(s: FusedScalars) -> FusedScalars:
    """The bundle with every tensor field read, in one host read."""
    reads = _HostReads()
    vals = reads.get(*s[:-2])   # every field but folded and host_reads
    return FusedScalars(*vals, folded=s.folded, host_reads=s.host_reads + reads.n)


def _not_ported(what: str, item: str):
    from hiop_tpu_torch.optimization.filter_ipm import _not_ported as np_

    return np_(what, item)


def build_fused_step(nlp, consts, mode: str = "newton"):
    """Returns step(state, mu, tau, filt, filt_len, theta_min, dw_last,
    fold=None) -> (new_state, FusedScalars, dw_next); dw_last/dw_next carry
    the regularization ladder's last successful delta across iterations
    (device scalars). ``filt`` is the (FILTER_CAP, 2) filter on the device,
    ``filt_len`` a number or a device int; mu and tau are numbers or device
    scalars. ``fold(err_nlp, nlp_feasib)``, when given, returns a device
    scalar that is read with the step's first host read (its value in
    ``FusedScalars.folded``). mode='newton' is the exact-Hessian path,
    mode='qn' carries the compact-BFGS memory in the state
    (FusedQNState), with the low-rank Schur direction and the LSQ dual
    update. Cached on the formulation, keyed on the option constants."""
    key = (mode, tuple(sorted(consts.items())))
    cached = getattr(nlp, "_fused_step_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    step = _build_fused_step_uncached(nlp, consts, mode)
    nlp._fused_step_cache = (key, step)
    return step


def build_fused_solve(nlp, consts, term, mode: str = "newton"):
    """The ``jit_mode=solve`` loop: the fused step wrapped in a loop that
    also carries what the host manages in ``jit_mode=iteration``, on the
    device: the mu/tau schedule (update_log_barrier_params), the filter
    buffer with its reset on a mu change and its augmentation by the
    trial point, the acceptable-tolerance counter, the termination tests
    of ``FilterIPMBase._check_termination`` and the history buffer. The
    host reads the status once per iteration, folded into the step's
    first read.

    ``term`` carries eps_tol, rel_tol, accep_tol, accep_iters, max_iter,
    kappa_eps, kappa_mu, theta_mu, tau_min, comp_tol_scaled and optionally
    diverg_tol.

    Returns ``solve(state0, mu0, tau0, theta_min, theta_max, max_iter,
    carry_in=None, it_stop=None)`` -> ``(state, mu, iter_num, status_code,
    err_nlp, hist, carry)``: ``status_code`` is 1 Solve_Success,
    2 Solve_Success_RelTol, 3 Solve_Acceptable_Level, 4 Max_Iter_Exceeded,
    5 Iterates_Diverging, 6/7 needs-host (failed factorization / rejected
    line search: the caller goes on in the general loop), 0 stopped by
    ``it_stop`` (call again with ``carry_in``); ``hist`` is the
    (HIST_CAP, HIST_COLS) device history (rows past ``iter_num``
    undefined); mu, err_nlp and hist are device tensors, iter_num and the
    status numbers."""
    key = (
        mode,
        tuple(sorted(consts.items())),
        tuple(sorted((k, v) for k, v in term.items() if k != "max_iter")),
    )
    cached = getattr(nlp, "_fused_solve_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]

    raw_step = _build_fused_step_uncached(nlp, consts, mode)
    eps_tol = term["eps_tol"]
    rel_tol = term["rel_tol"]
    accep_tol = term["accep_tol"]
    accep_iters = int(term["accep_iters"])
    kappa_eps = term["kappa_eps"]
    kappa_mu = term["kappa_mu"]
    theta_mu = term["theta_mu"]
    tau_min = term["tau_min"]
    mu_floor = min(eps_tol, term["comp_tol_scaled"]) / 11.0
    diverg_tol = term.get("diverg_tol", 1e20)

    def solve(state0, mu0, tau0, theta_min, theta_max, max_iter,
              carry_in=None, it_stop=None):
        if carry_in is not None:
            carry = carry_in
        else:
            x0 = state0.it.x
            dt, dev = x0.dtype, x0.device
            filt0 = torch.full((FILTER_CAP, 2), math.inf, dtype=dt, device=dev)
            filt0[0, 1] = -math.inf
            filt0[0, 0] = float(theta_max)
            carry = (
                state0,
                torch.full((), float(mu0), dtype=dt, device=dev),
                torch.full((), float(tau0), dtype=dt, device=dev),
                filt0,
                torch.ones((), dtype=torch.int64, device=dev),
                0,
                torch.full((), math.inf, dtype=dt, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros((HIST_CAP, HIST_COLS), dtype=dt, device=dev),
                torch.zeros((), dtype=dt, device=dev),
                0,
            )
        stop = it_stop if it_stop is not None else math.inf
        (state, mu, tau, filt, filt_len, it_num, err0, n_accep, hist,
         dw_last, st) = carry
        st = 0
        while st == 0 and it_num < stop:
            upd: dict = {}

            def fold(err_nlp, nlp_feasib, it_num=it_num, err0=err0, n_accep=n_accep):
                # the termination ladder, in _check_termination's order
                err0 = err_nlp if it_num == 0 else err0
                acc = err_nlp <= accep_tol
                n_acc = torch.where(acc, n_accep + 1, 0)
                code = torch.zeros((), dtype=torch.int64, device=err_nlp.device)

                def claim(code, cond, k):
                    return torch.where((code == 0) & cond, k, code)

                code = claim(code, err_nlp <= eps_tol, 1)
                if rel_tol > 0:
                    code = claim(code, err_nlp <= rel_tol * err0, 2)
                code = claim(code, acc & (n_acc >= accep_iters), 3)
                if it_num >= max_iter:
                    code = torch.where(code == 0, 4, code)
                code = claim(code, nlp_feasib > diverg_tol, 5)
                upd.update(err0=err0, n_accep=n_acc)
                return code

            new_state, s, dw_next = raw_step(
                state, mu, tau, filt, filt_len, theta_min, dw_last, fold=fold,
            )
            err0, n_accep = upd["err0"], upd["n_accep"]
            # the needs-host claims 6 and 7 come last; fact_ok and
            # ls_status are on the host already
            st = int(s.folded)
            if st == 0 and not s.fact_ok:
                st = 6
            elif st == 0 and s.ls_status == 0:
                st = 7
            running = st == 0

            dt = hist.dtype
            row = torch.stack([_on_device(v, dt, mu) for v in (
                s.f, s.nlp_feasib, s.nlp_optim, mu, s.alpha_dual, s.alpha_primal,
                s.ls_count, s.ls_status, s.err_nlp, s.use_soc, s.mp_f32,
                s.delta_w, s.n_refact, s.ir_primary, s.soc_rounds,
            )])
            hist[min(it_num, HIST_CAP - 1)] = row

            if running:
                # mu/tau schedule with the filter reset
                # (update_log_barrier_params), on the device
                new_mu = torch.clamp(torch.minimum(kappa_mu * mu, mu ** theta_mu), min=0.0)
                new_mu = torch.clamp(new_mu, min=mu_floor)
                do_mu = (s.err_log <= kappa_eps * mu) & ((new_mu - mu).abs() >= 1e-16)
                mu = torch.where(do_mu, new_mu, mu)
                tau = torch.where(do_mu, torch.clamp(1.0 - new_mu, min=tau_min), tau)
                filt_len = torch.where(do_mu, 1, filt_len)
                # the filter augmentation with the trial point
                if s.filter_add is not False:
                    do_add = (filt_len < FILTER_CAP) & s.filter_add
                    pos = torch.clamp(filt_len, max=FILTER_CAP - 1).reshape(1)
                    add_row = torch.stack([s.theta_add, s.phi_add]).to(dt)
                    filt_upd = filt.index_copy(0, pos, add_row[None, :])
                    filt = torch.where(do_add, filt_upd, filt)
                    filt_len = torch.where(do_add, filt_len + 1, filt_len)
                # advance only while running: on exit the state is the
                # pre-step one (the host loop's break-before-assign)
                state = new_state
                dw_last = dw_next
                it_num += 1
        carry = (state, mu, tau, filt, filt_len, it_num, err0, n_accep, hist,
                 dw_last, st)
        err_nlp = hist[min(it_num, HIST_CAP - 1), HIST_ERR]
        return state, mu, it_num, st, err_nlp, hist, carry

    nlp._fused_solve_cache = (key, solve)
    return solve


def _on_device(v, dt, like):
    """v as a 0-dim ``dt`` tensor on ``like``'s device: a cast of a device
    scalar, a fill for a number (no host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(dt)
    return torch.full((), float(v), dtype=dt, device=like.device)


def _build_fused_step_uncached(nlp, consts, mode: str = "newton"):
    if getattr(nlp, "parametric", False):
        raise NotImplementedError(
            "a parametric problem (batch_solve's scenario parameter) has no "
            "single-problem fused solve; solve its family with "
            "hiop_tpu_torch.optimization.batch_solve.solve_batched"
        )
    if mode == "qn" and getattr(nlp, "_mesh", None) is not None:
        raise _not_ported(
            "a mesh-sharded fused quasi-Newton state",
            "item 15: distribution",
        )
    from hiop_tpu_torch.formulation.mds import NlpMDS

    b = nlp.bounds
    crhs = nlp.crhs
    kappa_d = consts["kappa_d"]
    kappa_sigma = consts["kappa_Sigma"]
    gamma_theta = consts["gamma_theta"]
    gamma_phi = consts["gamma_phi"]
    s_theta = consts["s_theta"]
    s_phi = consts["s_phi"]
    delta = consts["delta"]
    eta_phi = consts["eta_phi"]
    min_step = consts["min_step_size"]
    smax = consts["smax"]
    n, m = nlp.n, nlp.m
    dev = crhs.device
    f64 = torch.float64

    def evals(x):
        return nlp.eval_f(x), *nlp.eval_cons(x)

    def derivs(x):
        return nlp.eval_grad_f(x), *nlp.eval_jac(x)

    is_mds = isinstance(nlp, NlpMDS)
    ns = nlp.n_sparse if is_mds else 0

    # operator-form mixed-precision plan (MDS only): the sparse block's
    # triplet structure and same-column Schur pairs once at build time; the
    # f64 refactorization fallback only where its two extra f64 (nd+m)^2
    # buffers fit the budget (else certification failures go to the
    # general loop). The budget is hiop_tpu's (12e9 bytes, or
    # HIOP_TPU_FUSED_MEM_BUDGET), so that both packages route alike.
    js_struct = None
    mds_f64_fallback = True
    if is_mds and bool(consts.get("fused_mp", False)):
        from hiop_tpu_torch.kkt import mds as _kkt_mds

        js_struct = _kkt_mds.mds_js_struct(nlp)
        nsad = nlp.n_dense + nlp.m_eq + nlp.m_ineq
        budget = float(os.environ.get("HIOP_TPU_FUSED_MEM_BUDGET", 12e9))
        base = 8 * nsad * nsad + 16 * (nlp.m_eq + nlp.m_ineq) * nlp.n
        mds_f64_fallback = (base + 32 * nsad * nsad) < budget

    def logbar_phi(it, f, mu):
        val = f - mu * it_mod.eval_logbar(it, b)
        return val + it_mod.linear_damping_term(it, b, mu, kappa_d)

    def theta_of(it, c, d):
        return (crhs - c).abs().sum() + (it.d - d).abs().sum()

    filt_idx = torch.arange(FILTER_CAP, device=dev)

    def filter_contains(filt, filt_len, theta, phi):
        dom = (theta >= filt[:, 0]) & (phi >= filt[:, 1]) & (filt_idx < filt_len)
        return dom.any()

    is_qn = mode == "qn"
    if is_qn:
        from hiop_tpu_torch.kkt import lowrank as kkt_lowrank
        from hiop_tpu_torch.optimization import duals_update as du_mod
        from hiop_tpu_torch.optimization import hessian_lowrank as blr

        sigma_strategy = consts.get("sigma_update_strategy", "sty")
        sigma0 = consts.get("sigma0", 1.0)
        recalc_lsq_tol = consts.get("recalc_lsq_duals_tol", 1e-6)

    delta0 = consts.get("delta_0_bar", 1e-4)
    kappa_plus_bar = consts.get("kappa_w_plus_bar", 100.0)
    kappa_plus = consts.get("kappa_w_plus", 8.0)
    kappa_minus = consts.get("kappa_w_minus", 1.0 / 3.0)
    delta_w_min = consts.get("delta_w_min_bar", 1e-20)
    delta_c_bar = consts.get("delta_c_bar", 1e-8)
    kappa_c = consts.get("kappa_c", 0.25)
    MAX_REG = 10
    # linear_solver_dense=ldl_nopiv: the inertia-revealing no-pivot LDL^T
    # of the partly reduced MDS saddle inside the fused step, its
    # pivot-sign inertia folded into the ladder's ok (MDS only: the
    # XDYcYd ordering of dense formulations leads with an indefinite block
    # that the no-pivot factorization breaks down on)
    use_ldl = bool(consts.get("fused_ldl", False)) and is_mds
    # kkt_fact_dtype=float32: the equilibrated f32 LDL^T, every solve
    # certified by f64 refinement, an f64 refactorization only where the
    # certification fails (mp_schedule=adaptive on the device)
    fused_mp = bool(consts.get("fused_mp", False)) and use_ldl
    ir_tol = consts.get("fused_ir_tol", 1e-9)
    max_soc = int(consts.get("max_soc_iter", 4))
    kappa_soc = consts.get("kappa_soc", 0.99)

    def step(state, mu, tau, filt, filt_len, theta_min, dw_last, fold=None):
        reads = _HostReads()
        if is_qn:
            (it, f, c, d_eval, grad, Jc, Jd, bfgs,
             x_prev, grad_prev, Jc_prev, Jd_prev, have_prev) = state
            # the secant update at iteration start (hiopHessianLowRank::update)
            if have_prev:
                s_new = it.x - x_prev
                y_new = grad - grad_prev
                if m:
                    y_new = y_new + (Jc - Jc_prev).T @ it.yc + (Jd - Jd_prev).T @ it.yd
                bfgs = blr.update(bfgs, s_new, y_new, sigma0, strategy=sigma_strategy)
        else:
            it, f, c, d_eval, grad, Jc, Jd = state
        dt = it.x.dtype
        zero = it.x.new_zeros(())

        # residual and errors at the current point; for MDS problems with
        # the triplet structure J^T y runs through the sparse-block
        # triplets and the small dense border
        if is_mds and js_struct is not None and m:
            js_rows, js_cols, _ = js_struct
            jv = []
            if nlp.m_eq:
                jv.append(Jc[nlp._jac_eq_rc_t])
            if nlp.m_ineq:
                jv.append(Jd[nlp._jac_in_rc_t])
            jv = torch.cat(jv)

            def jac_t(y_stacked, j_dense):
                sp = scatter_add_(it.x.new_zeros((ns,)), js_cols, jv * y_stacked[js_rows])
                return torch.cat([sp, j_dense])

            jacT_yc = jac_t(torch.cat([it.yc, it.x.new_zeros((nlp.m_ineq,))]),
                            Jc[:, ns:].T @ it.yc)
            jacT_yd = jac_t(torch.cat([it.x.new_zeros((nlp.m_eq,)), it.yd]),
                            Jd[:, ns:].T @ it.yd)
        else:
            jacT_yc = Jc.T @ it.yc if m else torch.zeros_like(it.x)
            jacT_yd = Jd.T @ it.yd if m else torch.zeros_like(it.x)
        resid, norms = res_mod.update_residual(
            it, c, d_eval, grad, jacT_yc, jacT_yd, crhs, b, mu, kappa_d
        )
        eq1, bnd1 = it_mod.norm_one_of_duals(it)
        sd = torch.clamp(torch.clamp((bnd1 + eq1) / max(n + m, 1), min=smax) / smax, max=1e8)
        sc = torch.clamp(torch.clamp(bnd1 / n, min=smax) / smax, max=1e8)
        err_nlp = torch.maximum(
            norms.nlp_optim / sd, torch.maximum(norms.cons_violation, norms.nlp_complem / sc)
        )
        err_log = torch.maximum(
            norms.bar_optim / sd, torch.maximum(norms.cons_violation, norms.bar_complem / sc)
        )
        if fold is not None:
            reads.defer("fold", fold(err_nlp, norms.nlp_feasib))

        mu_t = mu if isinstance(mu, torch.Tensor) else torch.full((), float(mu), dtype=dt, device=dev)
        dw_last = dw_last.to(dt)

        def ladder_start():
            """(dc, start, grow) of hiopPDPerturbation's curve: delta_0_bar
            the first time ever, afterwards kappa_w_minus times the last
            accepted delta; growth kappa_w_plus_bar before any success,
            kappa_w_plus after."""
            dc = torch.full((), delta_c_bar, dtype=dt, device=dev) * mu_t ** kappa_c
            first = dw_last == 0
            start = torch.where(first, delta0, torch.clamp(dw_last * kappa_minus, min=delta_w_min))
            grow = torch.where(first, dw_last.new_full((), kappa_plus_bar), kappa_plus)
            return dc, start, grow

        def fact_with_reg(fact_fn):
            """The on-device regularization ladder with the reference's full
            hiopPDPerturbation curve: try delta = 0, then the curve of
            :func:`ladder_start`, up to MAX_REG refactorizations; one host
            read of ``ok`` per factorization (none where the factorization
            returns ``ok`` already read). Returns (factors, delta_w, delta_c,
            dw_next, n_refact, ok)."""
            fct = fact_fn(zero, zero)
            dc, start, grow = ladder_start()
            (ok,) = reads.get(fct.ok)
            k, dw = 0, zero
            while not ok and k < MAX_REG:
                dw = start if k == 0 else dw * grow
                k += 1
                fct = fact_fn(dw, dc)
                (ok,) = reads.get(fct.ok)
            ok = bool(ok)
            # update_fact_ok: remember the accepted positive delta
            dw_next = dw if (ok and k > 0) else dw_last
            return fct, dw, (dc if k > 0 else zero), dw_next, k, ok

        mp_f32 = False
        dw_next = dw_last
        delta_w_used = zero
        n_refact = 0
        ir_primary = 0
        # primary_fn, when a branch sets it, gives the direction for the
        # current residual from the certification probe's solution
        primary_fn = None

        Dx, Dd = res_mod.barrier_diagonals(it, b)
        if is_qn:
            kdata = kkt_lowrank.LowRankKKTData(bfgs, Dx, Dd, Jc, Jd)

            def solve_compressed(rx_t, rd_t, ryc, ryd):
                return kkt_lowrank.solve_compressed(kdata, rx_t, rd_t, ryc, ryd)

            fct_ok = True
        elif is_mds:
            from hiop_tpu_torch.kkt import mds as kkt_mds

            hss, Hdd = nlp.eval_hess_blocks(it.x, 1.0, it.yc, it.yd)
            Jc_s, Jc_d, Jd_s, Jd_d = Jc[:, :ns], Jc[:, ns:], Jd[:, :ns], Jd[:, ns:]
            Dxs, Dxd = Dx[:ns], Dx[ns:]
            use_op = js_struct is not None
            if use_op:
                js_rows, js_cols, js_pairs = js_struct
                jv_parts = []
                if nlp.m_eq:
                    jv_parts.append(Jc[nlp._jac_eq_rc_t])
                if nlp.m_ineq:
                    jv_parts.append(Jd[nlp._jac_in_rc_t])
                js_vals_now = torch.cat(jv_parts) if jv_parts else it.x.new_zeros((0,))

            def fact64(dw, dc):
                return kkt_mds.factorize_saddle_device(
                    hss, Hdd, Dxs, Dxd, Dd, Jc_s, Jc_d, Jd_s, Jd_d, dw, dw, dc, dc,
                )

            def solve64(fct, rx_t, rd_t, ryc, ryd):
                return kkt_mds.solve_saddle_device(fct, rx_t[:ns], rx_t[ns:], rd_t, ryc, ryd)

            def mp_factorize(dw, dc, count_inertia=True):
                """The operator-form (triplet IR, no f64 dense saddle) or
                the dense mixed-precision factorization."""
                if use_op:
                    return kkt_mds.factorize_saddle_device_mp_op(
                        hss, Hdd, Dxs, Dxd, Dd, Jc_d, Jd_d, js_vals_now, js_pairs,
                        dw, dw, dc, dc, count_inertia=count_inertia,
                    )
                return kkt_mds.factorize_saddle_device_mp(
                    hss, Hdd, Dxs, Dxd, Dd, Jc_s, Jc_d, Jd_s, Jd_d,
                    dw, dw, dc, dc, count_inertia=count_inertia,
                )

            def mp_solve(fct, rx_t, rd_t, ryc, ryd):
                """(dxs, dxd, dd, dyc, dyd, certified, n_ir); certified and
                n_ir are read by the refinement loop."""
                if use_op:
                    return kkt_mds.solve_saddle_device_mp_op(
                        fct, js_rows, js_cols, rx_t[:ns], rx_t[ns:], rd_t, ryc, ryd, ir_tol,
                    )
                out = kkt_mds.solve_saddle_device_mp(
                    fct, rx_t[:ns], rx_t[ns:], rd_t, ryc, ryd, ir_tol
                )
                return (*out, 0)

            if use_ldl and fused_mp and consts.get("fused_inertia_free"):
                # inertia-free curvature acceptance
                # (hiopFactAcceptorInertiaFreeDWD): factorize without the
                # pivot count, solve the primary rhs, accept when the
                # regularized curvature along the direction is positive
                neg_curv_fact = consts.get("neg_curv_fact", 1e-11)
                rx0, rd0, ryc0, ryd0 = res_mod.compress_rhs_xdycyd(resid, it, b)
                dc, start, grow = ladder_start()

                def fact_solve_test(dw):
                    fct = mp_factorize(dw, dc, count_inertia=False)
                    sol = mp_solve(fct, rx0, rd0, ryc0, ryd0)
                    dxs, dxd, dd_, _dyc, _dyd, cert, n_ir = sol
                    curv = (
                        ((hss + Dxs + dw) * dxs * dxs).sum()
                        + dxd @ (Hdd @ dxd) + ((Dxd + dw) * dxd * dxd).sum()
                        + ((Dd + dw) * dd_ * dd_).sum()
                    )
                    nrm2 = dxs @ dxs + dxd @ dxd + dd_ @ dd_
                    good = cert and bool(reads.get(fct.ok & (curv >= neg_curv_fact * nrm2))[0])
                    return fct, sol[:5], good, n_ir

                fct32, sol_fin, good, ir_primary = fact_solve_test(zero)
                k, dw = 0, zero
                while not good and k < MAX_REG:
                    dw = start if k == 0 else dw * grow
                    k += 1
                    fct32, sol_fin, good, ir_primary = fact_solve_test(dw)
                n_refact = k
                delta_w_used = dw
                dw_next = dw if (good and k > 0) else dw_last
                mp_f32 = good
                fct32 = fct32._replace(ok=good)
                fct_ok = good

                def solve_compressed(rx_t, rd_t, ryc, ryd):
                    dxs, dxd, dd_, dyc, dyd = mp_solve(fct32, rx_t, rd_t, ryc, ryd)[:5]
                    return torch.cat([dxs, dxd]), dd_, dyc, dyd

                def primary_fn():
                    # the accepted ladder trial's solution is the direction
                    dxs, dxd, dd_, dyc, dyd = sol_fin
                    return res_mod.recover_direction(
                        resid, it, b, torch.cat([dxs, dxd]), dd_, dyc, dyd
                    )
            elif use_ldl and fused_mp:
                # f32 pivot signs are noisy near zero pivots: where the f32
                # count disagrees with the target, the f64 factorization's
                # pivot signs decide (only contested trials pay for it;
                # gated on the same memory plan as the f64 fallback)
                def mp_fact_verified(dw, dc):
                    if not mds_f64_fallback:
                        return mp_factorize(dw, dc)
                    fct = mp_factorize(dw, dc, count_inertia=False)
                    ok, count_ok = reads.get(fct.ok, fct.n_neg == m)
                    if not ok:
                        return fct._replace(ok=False)
                    if count_ok:
                        return fct._replace(ok=True)
                    return fct._replace(ok=fact64(dw, dc).ok)

                fct32, dw_fin, dc_fin, dw_next, n_refact, ok32 = fact_with_reg(mp_fact_verified)
                delta_w_used = dw_fin
                # certification probe on the primary rhs: where the f32
                # factors and the f64 refinement (and FGMRES) cannot
                # deliver it to ir_tol, refactorize in f64 at the ladder's
                # final deltas (if it fits), else exit to the general loop
                rx0, rd0, ryc0, ryd0 = res_mod.compress_rhs_xdycyd(resid, it, b)
                probe = mp_solve(fct32, rx0, rd0, ryc0, ryd0)
                cert, ir_primary = bool(probe[5]), int(probe[6])
                need64 = ok32 and not cert
                mp_f32 = ok32 and cert
                fct64 = None
                if mds_f64_fallback:
                    if need64:
                        fct64 = fact64(dw_fin, dc_fin)
                        fct_ok = fct64.ok
                    else:
                        fct_ok = ok32
                else:
                    fct_ok = ok32 and cert
                    need64 = False

                def solve_compressed(rx_t, rd_t, ryc, ryd):
                    if need64:
                        dxs, dxd, dd_, dyc, dyd = solve64(fct64, rx_t, rd_t, ryc, ryd)
                    else:
                        dxs, dxd, dd_, dyc, dyd = mp_solve(fct32, rx_t, rd_t, ryc, ryd)[:5]
                    return torch.cat([dxs, dxd]), dd_, dyc, dyd

                def primary_fn():
                    # the probe's certified f32 solution; only an f64
                    # demotion solves again
                    if need64:
                        dxs, dxd, dd_, dyc, dyd = solve64(fct64, rx0, rd0, ryc0, ryd0)
                    else:
                        dxs, dxd, dd_, dyc, dyd = probe[:5]
                    return res_mod.recover_direction(
                        resid, it, b, torch.cat([dxs, dxd]), dd_, dyc, dyd
                    )
            elif use_ldl:
                fct, dw_fin, _dc, dw_next, n_refact, fct_ok = fact_with_reg(fact64)
                delta_w_used = dw_fin

                def solve_compressed(rx_t, rd_t, ryc, ryd):
                    dxs, dxd, dd_, dyc, dyd = solve64(fct, rx_t, rd_t, ryc, ryd)
                    return torch.cat([dxs, dxd]), dd_, dyc, dyd
            else:
                fct, dw_fin, _dc, dw_next, n_refact, fct_ok = fact_with_reg(
                    lambda dw, dc: kkt_mds.factorize(
                        hss, Hdd, Dxs, Dxd, Dd, Jc_s, Jc_d, Jd_s, Jd_d, dw, dw, dc, dc,
                    )
                )
                delta_w_used = dw_fin

                def solve_compressed(rx_t, rd_t, ryc, ryd):
                    dxs, dxd, dd_, dyc, dyd = kkt_mds.solve(
                        fct, rx_t[:ns], rx_t[ns:], rd_t, ryc, ryd
                    )
                    return torch.cat([dxs, dxd]), dd_, dyc, dyd
        else:
            from hiop_tpu_torch.kkt import newton_dense as kkt_nd

            H = nlp.eval_hess(it.x, 1.0, it.yc, it.yd)
            fct, dw_fin, _dc, dw_next, n_refact, fct_ok = fact_with_reg(
                lambda dw, dc: kkt_nd.factorize_quick(H, Dx, Dd, Jc, Jd, dw, dw, dc, dc)
            )
            delta_w_used = dw_fin

            def solve_compressed(rx_t, rd_t, ryc, ryd):
                return kkt_nd.solve_quick(fct, rx_t, rd_t, ryc, ryd)

        # an f64 fallback's ok is read with the first trial
        reads.defer("fact_ok", fct_ok)

        def solve_dir(res):
            """The direction for residual ``res`` from the live
            factorization (re-used by the second-order correction)."""
            rx_t, rd_t, ryc, ryd = res_mod.compress_rhs_xdycyd(res, it, b)
            dx, dd_, dyc, dyd = solve_compressed(rx_t, rd_t, ryc, ryd)
            return res_mod.recover_direction(res, it, b, dx, dd_, dyc, dyd)

        dir_ = primary_fn() if primary_fn is not None else solve_dir(resid)

        ap_max, ad = it_mod.fraction_to_the_boundary(it, dir_, tau, b)
        theta_curr = theta_of(it, c, d_eval)
        phi_curr = logbar_phi(it, f, mu)
        gx = it_mod.add_logbar_grad_x(grad, it, b, mu)
        gx = it_mod.add_damping_grad_x(gx, b, mu, kappa_d)
        gd = it_mod.add_logbar_grad_d(torch.zeros_like(it.d), it, b, mu)
        gd = it_mod.add_damping_grad_d(gd, b, mu, kappa_d)
        grad_phi_dx = gx @ dir_.x + gd @ dir_.d

        # ---------------- backtracking filter line search ------------------
        def ls_accept(theta_t, phi_t, alpha):
            """The acceptance code on the device: 0 rejected, 1 (far) or
            2 (near) sufficient decrease, 3 Armijo."""
            far = theta_curr >= theta_min
            suff = (theta_t <= (1 - gamma_theta) * theta_curr) | (
                phi_t <= phi_curr - gamma_phi * theta_curr
            )
            in_filter = filter_contains(filt, filt_len, theta_t, phi_t)
            sw = (grad_phi_dx < 0) & (
                alpha * (-grad_phi_dx) ** s_phi > delta * theta_curr ** s_theta
            )
            armijo = phi_t <= phi_curr + eta_phi * alpha * grad_phi_dx
            code_far = torch.where(suff & ~in_filter, 1, 0)
            code_near = torch.where(
                sw, torch.where(armijo & ~in_filter, 3, 0), torch.where(suff & ~in_filter, 2, 0)
            )
            return torch.where(far, code_far, code_near)

        def trial_at(alpha):
            it_t = it_mod.take_step_primals(it, dir_, alpha)
            it_t, _ = it_mod.compute_safe_slacks(it_t, it, b, mu)
            f_t, c_t, d_t = evals(it_t.x)
            return it_t, f_t, c_t, d_t

        def coded(it_t, f_t, c_t, d_t, alpha):
            th_ = theta_of(it_t, c_t, d_t)
            ph = logbar_phi(it_t, f_t, mu)
            return th_, ph, torch.where(torch.isfinite(f_t), ls_accept(th_, ph, alpha), 0)

        # the first trial at the full fraction-to-the-boundary step
        it_t1, f_t1, c_t1, d_t1 = trial_at(ap_max)
        theta_t1, phi_t1, code1_t = coded(it_t1, f_t1, c_t1, d_t1, ap_max)
        code1, soc_worth, ap_max_h = reads.get(code1_t, theta_curr <= theta_t1, ap_max)
        code1 = int(code1)
        fct_ok = bool(reads.values["fact_ok"])

        # second-order correction (apply_second_order_correction,
        # hiopAlgFilterIPM.cpp:2949): when the first trial fails without
        # improving infeasibility, correct the constraint residual with
        # the trial's violation and re-solve on the same factorization, up
        # to max_soc_iter times while theta contracts by kappa_soc;
        # acceptance uses the original alpha and directional derivative
        k_soc, soc_code = 0, 0
        alpha_soc, theta_soc = ap_max, theta_t1
        it_soc, f_soc, c_soc_t, d_soc_t, phi_soc, dir_soc, ad_soc = (
            it_t1, f_t1, c_t1, d_t1, phi_t1, dir_, ad)
        if code1 == 0 and soc_worth and max_soc > 0:
            c_soc, d_soc = crhs - c, it.d - d_eval
            contracted = True
            while soc_code == 0 and k_soc < max_soc and (k_soc == 0 or contracted):
                c_soc = alpha_soc * c_soc + (crhs - c_soc_t)
                d_soc = alpha_soc * d_soc + (it.d - d_soc_t)
                dir_soc = solve_dir(resid._replace(ryc=c_soc, ryd=d_soc))
                alpha_soc, ad_soc = it_mod.fraction_to_the_boundary(it, dir_soc, tau, b)
                it_soc = it_mod.take_step_primals(it, dir_soc, alpha_soc)
                it_soc, _ = it_mod.compute_safe_slacks(it_soc, it, b, mu)
                f_soc, c_soc_t, d_soc_t = evals(it_soc.x)
                th_prev = theta_soc
                theta_soc, phi_soc, code_s = coded(it_soc, f_soc, c_soc_t, d_soc_t, ap_max)
                k_soc += 1
                soc_code, contracted = reads.get(code_s, theta_soc <= kappa_soc * th_prev)
                soc_code = int(soc_code)
        soc_ok = soc_code > 0

        # backtracking from alpha/2 when neither the first trial nor the
        # SOC was accepted (the host mirrors alpha exactly: halving is exact)
        pre_code = code1 if code1 > 0 else (soc_code if soc_ok else 0)
        alpha_bt, alpha_h = ap_max * 0.5, ap_max_h * 0.5
        ls_count, bt_code = 1, pre_code
        it_bt, f_bt, c_bt, d_bt, theta_bt, phi_bt = it_t1, f_t1, c_t1, d_t1, theta_t1, phi_t1
        while bt_code == 0 and alpha_h >= min_step and ls_count < MAX_LS:
            it_bt, f_bt, c_bt, d_bt = trial_at(alpha_bt)
            theta_bt, phi_bt, code_t = coded(it_bt, f_bt, c_bt, d_bt, alpha_bt)
            ls_count += 1
            bt_code = int(reads.get(code_t)[0])
            if bt_code == 0:
                alpha_bt, alpha_h = alpha_bt * 0.5, alpha_h * 0.5

        # the accepted trial: first trial > SOC > backtracking
        use_soc = soc_ok and code1 == 0
        if code1 > 0:
            it_t, f_t, c_t, d_t, theta_t, phi_t = it_t1, f_t1, c_t1, d_t1, theta_t1, phi_t1
            alpha_p, ls_code = ap_max, code1
        elif use_soc:
            it_t, f_t, c_t, d_t, theta_t, phi_t = it_soc, f_soc, c_soc_t, d_soc_t, theta_soc, phi_soc
            alpha_p, ls_code, dir_, ad = alpha_soc, soc_code, dir_soc, ad_soc
        else:
            it_t, f_t, c_t, d_t, theta_t, phi_t = it_bt, f_bt, c_bt, d_bt, theta_bt, phi_bt
            alpha_p, ls_code = alpha_bt, bt_code
        if not (code1 == 0 and not soc_ok):
            ls_count = 1
        accepted = ls_code > 0

        # the filter augmentation decision (code 1 adds unless the
        # switching and Armijo conditions hold at the accepted alpha)
        if accepted and ls_code == 1:
            sw_acc = (grad_phi_dx < 0) & (
                alpha_p * (-grad_phi_dx) ** s_phi > delta * theta_curr ** s_theta
            )
            armijo_acc = phi_t <= phi_curr + eta_phi * alpha_p * grad_phi_dx
            filter_add = ~(sw_acc & armijo_acc)
        else:
            filter_add = accepted and ls_code == 2

        # ---------------- dual update + safeguards -------------------------
        it_new = it_mod.take_step_duals(it_t, dir_, alpha_p, ad)
        it_new = it_mod.adjust_duals(it_new, b, mu, kappa_sigma)
        if is_qn and m:
            # LSQ recompute of yc/yd from the pre-step derivatives when the
            # infeasibility is small (hiopDualsLsqUpdate::go ordering)
            yc_lsq, yd_lsq = du_mod.lsq_duals(
                Jc, Jd, grad, it_new.zl, it_new.zu, it_new.vl, it_new.vu
            )
            use_lsq = theta_t <= recalc_lsq_tol
            it_new = it_new._replace(
                yc=torch.where(use_lsq, yc_lsq, it_new.yc),
                yd=torch.where(use_lsq, yd_lsq, it_new.yd),
            )
        grad_n, Jc_n, Jd_n = derivs(it_new.x)

        # keep the old state when the step was not accepted (the general
        # loop takes over)
        if is_qn:
            if accepted:
                state_new = FusedQNState(
                    it_new, f_t, c_t, d_t, grad_n, Jc_n, Jd_n, bfgs,
                    it.x, grad, Jc, Jd, True,
                )
            else:
                state_new = FusedQNState(
                    it, f, c, d_eval, grad, Jc, Jd, bfgs,
                    x_prev, grad_prev, Jc_prev, Jd_prev, have_prev,
                )
        elif accepted:
            state_new = FusedState(it_new, f_t, c_t, d_t, grad_n, Jc_n, Jd_n)
        else:
            state_new = FusedState(it, f, c, d_eval, grad, Jc, Jd)
        reads.flush()
        scal = FusedScalars(
            f=f, err_nlp=err_nlp, err_log=err_log,
            nlp_optim=norms.nlp_optim, nlp_feasib=norms.nlp_feasib,
            theta=theta_curr, phi=phi_curr,
            alpha_primal=alpha_p, alpha_dual=ad,
            ls_count=ls_count, ls_status=ls_code if accepted else 0,
            use_soc=use_soc and accepted,
            fact_ok=fct_ok, filter_add=filter_add,
            theta_add=theta_t, phi_add=phi_t,
            mp_f32=mp_f32, delta_w=delta_w_used,
            n_refact=n_refact, ir_primary=ir_primary, soc_rounds=k_soc,
            folded=reads.values.get("fold"), host_reads=reads.n,
        )
        return state_new, scal, dw_next

    return step
