"""Batched NLP solves: every scenario of a parametric family, in lockstep.

Counterpart of ``hiop_tpu/optimization/batch_solve.py``, which solves a
family of same-shape NLPs (PriDec recourse subproblems, contingency
screening, parameter sweeps) as ``jax.jit(jax.vmap(one))`` over the
``jit_mode=solve`` program. Its semantics are those of ``vmap`` over
``lax.while_loop``: each loop (the solve loop, the regularization ladder,
the SOC rounds, the backtracking trials) runs while *any* lane's test
holds, and a lane whose test is false keeps its state, so each lane makes
exactly the decisions it would make alone.

Here the same program runs eagerly with a leading lane axis of size S on
every state tensor (the iterate, f/c/d/grad/Jacobians, the regularization
deltas and ``dw_last``, mu and tau, theta_min/theta_max, the filter buffer
and its length, the iteration counter, the status and the history):

- the straight-line parts of a step (residual, Hessian, factorization,
  direction, trial points, dual update) run over the lanes with
  ``torch.func.vmap`` of the per-scenario hooks ``eval_f(x, th)`` and the
  rest, and of the fused step's own helpers;
- under vmap the factorizations of :mod:`hiop_tpu_torch.kkt.mds` and
  :mod:`hiop_tpu_torch.kkt.newton_dense` reach the Cholesky and LDL^T
  wrappers' vmap rules, so every factorization of a loop trip is one
  batched kernel launch over all S lanes, as ``pallas_call``'s batching
  rule makes one batched launch under ``jax.vmap``;
- each loop's test is an (S,) vector on the device, read by the host once
  per trip for the whole batch; a lane whose test is false is held with
  ``torch.where``. There is no Python loop over lanes.

The branches are those ``build_batched_solve`` reaches in ``hiop_tpu``:
mode ``newton`` with ``fused_ldl`` and without ``fused_mp`` in the
constants, i.e. the dense quick Cholesky ladder on K, the MDS quick ladder
on K_d and S, the MDS ``ldl_nopiv`` ladder with pivot-sign inertia, the
first trial, second-order correction and backtracking, the termination
ladder with the mu/tau schedule, and the starting procedure of
``init(th)``. Frozen lanes (finished, or not in a loop's test) are still
factored with the others and their results discarded, as under vmap.

Completed scenarios idle until the whole batch is done, so batching pays
most for families with similar iteration counts, the PriDec recourse case.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

from hiop_tpu_torch.formulation.dense import NlpDenseConstraints
from hiop_tpu_torch.formulation.mds import NlpMDS
from hiop_tpu_torch.interface.base import AutoDiffNlpProblem
from hiop_tpu_torch.optimization import duals_update as du
from hiop_tpu_torch.optimization import fused_newton as fn
from hiop_tpu_torch.optimization import iterate as it_mod
from hiop_tpu_torch.optimization import residual as res_mod
from hiop_tpu_torch.optimization.filter_ipm import FilterIPMBase
from hiop_tpu_torch.optimization.iterate import Iterate
from hiop_tpu_torch.status import SolveStatus
from hiop_tpu_torch.utils.options import NlpOptions


def _tree_map(fn_, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn_, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn_, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn_, v) for v in tree)
    return fn_(tree)


def tree_on(tree, device):
    """A parameter pytree (dicts, tuples, lists of arrays, tensors or
    numbers) with every leaf an f64 tensor on ``device``."""
    def leaf(a):
        if isinstance(a, np.ndarray) and not a.flags.writeable:
            a = a.copy()   # a broadcast view: torch takes writable arrays
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    return _tree_map(leaf, tree)


def _bound_th(th0):
    """A closure's view of th0 on the device of the evaluation point."""
    cache: dict = {}

    def on(x):
        key = str(x.device)
        if key not in cache:
            cache[key] = tree_on(th0, x.device)
        return cache[key]

    return on


class ParametricDenseNlp(NlpDenseConstraints):
    """A family of dense-constrained NLPs indexed by a parameter pytree.

    ``f(x, th) -> scalar`` and ``c(x, th) -> (m,)`` are torch functions
    that ``torch.func`` can transform; the derivatives are ``grad``,
    ``jacfwd`` and ``hessian`` of them, and every hook runs under
    ``torch.func.vmap`` over the lanes. ``th0`` is a representative
    parameter used only to size and validate the family. Bounds, the
    eq/ineq split of the constraints and the starting-point rule are shared
    by all members. Problem scaling is off (a scale factor would couple the
    scenarios)."""

    parametric = True

    def __init__(self, f: Callable, c: Callable, xl, xu, cl, cu, x0, th0,
                 options: Optional[NlpOptions] = None,
                 x0_of_th: Optional[Callable] = None):
        self._f_p = f
        self._c_p = c
        self._x0_of_th = x0_of_th
        th_at = _bound_th(th0)
        prob = AutoDiffNlpProblem(
            f=lambda x: f(x, th_at(x)),
            c=lambda x: c(x, th_at(x)),
            xl=xl, xu=xu, cl=cl, cu=cu, x0=x0,
        )
        o = options if options is not None else NlpOptions()
        o.set("scaling_type", "none", mark_user=False)
        super().__init__(prob, o)
        self.finalize_initialization()
        eq, ineq = self._eq_idx_t, self._ineq_idx_t

        def c_eq_ineq(x, th):
            c_all = c(x, th)
            return c_all[eq], c_all[ineq]

        self._c_split = c_eq_ineq
        self._grad_f = grad(f, argnums=0)

        def lagr(x, th, obj_factor, yc, yd):
            ce, ci = c_eq_ineq(x, th)
            return obj_factor * f(x, th) + yc @ ce + yd @ ci

        self._hess_lagr = hessian(lagr, argnums=0)
        self._jac_all = jacfwd(c, argnums=0)

    # -- parametric eval hooks (signature: +th) -----------------------------
    def eval_f(self, x, th):
        return self._f_p(x, th)

    def eval_grad_f(self, x, th):
        return self._grad_f(x, th)

    def eval_cons(self, x, th):
        return self._c_split(x, th)

    def eval_jac(self, x, th):
        J = self._jac_all(x, th)
        return J[self._eq_idx_t, :], J[self._ineq_idx_t, :]

    def eval_hess(self, x, obj_factor, yc, yd, th):
        return self._hess_lagr(x, th, obj_factor, yc, yd)

    def starting_point(self, th):
        if self._x0_of_th is not None:
            return self._x0_of_th(th)
        return self.get_starting_point()


class _BoundThMds:
    """Adapter binding a parametric MDS template to one parameter th0 for
    the (non-parametric) formulation's calls: finalization, and the
    general-loop solve of one scenario."""

    jittable = True

    def __init__(self, p, th0):
        self._pp = p
        self._th_at = _bound_th(th0)

    def __getattr__(self, k):
        return getattr(self._pp, k)

    def eval_f(self, z):
        return self._pp.eval_f(z, self._th_at(z))

    def eval_grad_f(self, z):
        return self._pp.eval_grad_f(z, self._th_at(z))

    def eval_cons(self, z):
        return self._pp.eval_cons(z, self._th_at(z))

    def eval_jac_blocks(self, z):
        return self._pp.eval_jac_blocks(z, self._th_at(z))

    def eval_hess_blocks(self, z, obj_factor, lam):
        return self._pp.eval_hess_blocks(z, obj_factor, lam, self._th_at(z))


class ParametricMdsNlp(NlpMDS):
    """A family of mixed dense-sparse NLPs indexed by a parameter pytree.

    The template ``problem`` is an :class:`~hiop_tpu_torch.interface.base.MdsProblem`
    whose evaluation hooks take a trailing scenario parameter:
    ``eval_f(z, th)``, ``eval_grad_f(z, th)``, ``eval_cons(z, th)``,
    ``eval_jac_blocks(z, th)``, ``eval_hess_blocks(z, obj_factor, lam, th)``,
    written so that ``torch.func.vmap`` can batch them. Sizes, bounds, the
    sparse-block structure and the starting-point rule are shared by all
    members; ``th0`` is a representative parameter used for finalization.
    Scaling is off (a scale factor would couple the scenarios)."""

    parametric = True

    def __init__(self, problem, th0, options: Optional[NlpOptions] = None,
                 x0_of_th: Optional[Callable] = None):
        self._p = problem
        self._x0_of_th = x0_of_th
        o = options if options is not None else NlpOptions()
        o.set("scaling_type", "none", mark_user=False)
        super().__init__(_BoundThMds(problem, th0), o)
        self.finalize_initialization()

    # -- parametric eval hooks (signature: +th) -----------------------------
    def eval_f(self, x, th):
        return self._p.eval_f(x, th)

    def eval_grad_f(self, x, th):
        return self._p.eval_grad_f(x, th)

    def eval_cons(self, x, th):
        c_all = self._p.eval_cons(x, th)
        return c_all[self._eq_idx_t], c_all[self._ineq_idx_t]

    def eval_jac(self, x, th):
        sp_vals, dense_blk = self._p.eval_jac_blocks(x, th)
        ns = self.n_sparse

        def rows(rc, pos, idx, k):
            # out of place, so that either block may carry the lane axis
            sp = x.new_zeros((k, ns)).index_put(rc, sp_vals[pos], accumulate=True)
            return torch.cat([sp, dense_blk[idx, :]], dim=1)

        Jc = (rows(self._jac_eq_rc_t, self._jac_eq_pos_t, self._eq_idx_t, self.m_eq)
              if self.m_eq else x.new_zeros((0, self.n)))
        Jd = (rows(self._jac_in_rc_t, self._jac_in_pos_t, self._ineq_idx_t, self.m_ineq)
              if self.m_ineq else x.new_zeros((0, self.n)))
        return Jc, Jd

    def eval_hess_blocks(self, x, obj_factor, yc, yd, th=None):
        if th is None:
            return super().eval_hess_blocks(x, obj_factor, yc, yd)
        lam = x.new_zeros((self.m,))
        if self.m_eq:
            lam = lam.index_put((self._eq_idx_t,), yc)
        if self.m_ineq:
            lam = lam.index_put((self._ineq_idx_t,), yd)
        return self._p.eval_hess_blocks(x, obj_factor, lam, th)

    def starting_point(self, th):
        if self._x0_of_th is not None:
            return self._x0_of_th(th)
        return self.get_starting_point()


class BatchResult(NamedTuple):
    """Per-scenario results; the leading axis is the scenario axis."""

    status: np.ndarray      # SolveStatus of each lane (object array)
    x: torch.Tensor         # (S, n)
    obj: np.ndarray         # (S,)
    iterations: np.ndarray  # (S,)
    err_nlp: np.ndarray     # (S,)
    yc: torch.Tensor
    yd: torch.Tensor


_STATUS_MAP = {
    1: SolveStatus.Solve_Success,
    2: SolveStatus.Solve_Success_RelTol,
    3: SolveStatus.Solve_Acceptable_Level,
    4: SolveStatus.Max_Iter_Exceeded,
    5: SolveStatus.Iterates_Diverging,
    6: SolveStatus.Err_Step_Computation,   # needs-host: regularization
    7: SolveStatus.Steplength_Too_Small,   # needs-host: SOC/FR
}


class BatchStats:
    """What one batched solve did, for the caller to read: outer trips,
    host reads (each one ``tolist`` of a loop test or the status), and the
    lanes whose test held, summed over the trips of each loop."""

    def __init__(self) -> None:
        self.trips = 0
        self.reads = 0
        self.lanes_live = 0       # lanes still solving, summed over the outer trips
        self.ladder_trips = 0     # refactorization trips of the ladder
        self.ladder_lanes = 0
        self.soc_trips = 0
        self.soc_lanes = 0
        self.bt_trips = 0
        self.bt_lanes = 0

    def as_dict(self) -> dict:
        return dict(vars(self))


def _lanes(mask, like):
    """An (S,) mask broadcast against a lane-stacked tensor."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def _where(mask, new, old):
    """Per lane: ``new`` where ``mask`` holds, else ``old`` (leaf by leaf)."""
    if isinstance(new, torch.Tensor):
        return torch.where(_lanes(mask, new), new, old)
    parts = [_where(mask, a, b) for a, b in zip(new, old)]
    return type(new)(*parts) if hasattr(new, "_fields") else type(new)(parts)


#: the per-scenario hooks the batched solve calls under torch.func.vmap
_HOOKS = ("starting_point", "eval_f", "eval_grad_f", "eval_cons", "eval_jac",
          "eval_hess", "eval_hess_blocks")


def _lane_hooks(pnlp) -> dict:
    """The family's hooks by name, each raising with its name where it
    cannot run batched over the scenarios (an in-place write into a tensor
    without the lane axis, a host read, an operation vmap does not batch)."""
    def named(name, fn):
        def call(*args):
            try:
                return fn(*args)
            except (RuntimeError, NotImplementedError, ValueError) as e:
                raise RuntimeError(
                    f"batch_solve: the parametric hook {name} of {type(pnlp).__name__} cannot "
                    f"run batched over the scenarios (torch.func.vmap): {e}"
                ) from e
        return call

    return {k: named(k, getattr(pnlp, k)) for k in _HOOKS if hasattr(pnlp, k)}


def build_batched_solve(pnlp):
    """Returns ``batched(params) -> (state, mu, it_num, status, err, hist)``
    with a leading scenario axis on every output (``state`` is ``(th,
    FusedState)``, ``status`` the fused solve's codes 1-7): the whole family
    solved in lockstep. ``params`` is a pytree whose leaves have a leading
    scenario axis. ``pnlp`` is a :class:`ParametricDenseNlp` or
    :class:`ParametricMdsNlp`. ``batched.stats`` holds the last call's
    :class:`BatchStats`."""
    o = pnlp.options
    a = FilterIPMBase  # Wachter-Biegler constants (class attributes)
    consts = dict(
        kappa_d=a.kappa_d, kappa_Sigma=a.kappa_Sigma,
        gamma_theta=a.gamma_theta, gamma_phi=a.gamma_phi,
        s_theta=a.s_theta, s_phi=a.s_phi, delta=a.delta,
        eta_phi=o.num("eta_phi"), min_step_size=o.num("min_step_size"),
        smax=o.num("smax"),
        max_soc_iter=o.integer("max_soc_iter"), kappa_soc=o.num("kappa_soc"),
        fused_ldl=o.str_("linear_solver_dense") == "ldl_nopiv",
    )
    term = dict(
        eps_tol=o.num("tolerance"), rel_tol=o.num("rel_tolerance"),
        accep_tol=o.num("acceptable_tolerance"),
        accep_iters=o.integer("acceptable_iterations"),
        max_iter=o.integer("max_iter"), kappa_eps=o.num("kappa_eps"),
        kappa_mu=o.num("kappa_mu"), theta_mu=o.num("theta_mu"),
        tau_min=o.num("tau_min"), comp_tol_scaled=o.num("comp_tol"),
    )
    init = _build_init(pnlp)
    solve = _build_lane_solve(pnlp, consts, term)
    mu0 = o.num("mu0")
    tau0 = max(o.num("tau_min"), 1.0 - mu0)

    def batched(params):
        params = tree_on(params, pnlp.device)
        state0, theta_min, theta_max = init(params)
        out = solve(params, state0, mu0, tau0, theta_min, theta_max, term["max_iter"])
        batched.stats = solve.stats
        return out

    batched.stats = None
    return batched


def _build_init(pnlp):
    """``init(th)`` over the lanes: ``hiop_tpu``'s ``init`` of
    ``build_batched_solve`` (the starting procedure of
    ``FilterIPMBase._fused_init`` for one scenario, branch-free) under
    ``torch.func.vmap``. Returns (state, theta_min, theta_max), stacked."""
    o = pnlp.options
    kappa1, kappa2 = o.num("kappa1"), o.num("kappa2")
    lsq_init = o.str_("duals_init") == "lsq"
    lsq_max = o.num("duals_lsq_ini_max")
    theta_max_fact = o.num("theta_max_fact")
    theta_min_fact = o.num("theta_min_fact")
    b = pnlp.bounds
    crhs = pnlp.crhs
    n, m_eq, m_ineq = pnlp.n, pnlp.m_eq, pnlp.m_ineq
    h = _lane_hooks(pnlp)

    def one(th):
        x_user = h["starting_point"](th)
        _c0, d0_eval = h["eval_cons"](x_user, th)
        x0, d0 = it_mod.starting_point_primal(x_user, d0_eval, b, kappa1, kappa2)
        f = h["eval_f"](x0, th)
        c, d_eval = h["eval_cons"](x0, th)

        def ones(k):
            return x0.new_ones((k,))

        it = Iterate(
            x=x0, d=d0,
            sxl=ones(n), sxu=ones(n), sdl=ones(m_ineq), sdu=ones(m_ineq),
            yc=x0.new_zeros((m_eq,)), yd=x0.new_zeros((m_ineq,)),
            zl=b.ixl * ones(n), zu=b.ixu * ones(n),
            vl=b.idl * ones(m_ineq), vu=b.idu * ones(m_ineq),
        )
        it = it_mod.determine_slacks(it, b)
        grad_f = h["eval_grad_f"](x0, th)
        Jc, Jd = h["eval_jac"](x0, th)
        if lsq_init and (m_eq or m_ineq):
            # LSQ duals with the duals_lsq_ini_max cap, branch-free
            yc, yd = du.lsq_duals(Jc, Jd, grad_f, it.zl, it.zu, it.vl, it.vu)
            zero = x0.new_zeros(())
            ynrm = torch.maximum(
                yc.abs().max() if m_eq else zero,
                yd.abs().max() if m_ineq else zero,
            )
            keep = ynrm <= lsq_max
            it = it._replace(
                yc=torch.where(keep, yc, torch.zeros_like(yc)),
                yd=torch.where(keep, yd, torch.zeros_like(yd)),
            )
        theta0 = (crhs - c).abs().sum() + (it.d - d_eval).abs().sum()
        theta_ref = torch.clamp(theta0, min=1.0)
        state = fn.FusedState(it=it, f=f, c=c, d=d_eval, grad=grad_f, Jc=Jc, Jd=Jd)
        return state, theta_min_fact * theta_ref, theta_max_fact * theta_ref

    return vmap(one)


def _build_lane_solve(pnlp, consts, term):
    """The lane-batched ``jit_mode=solve`` loop with its fused step."""
    from hiop_tpu_torch.kkt import mds as kkt_mds
    from hiop_tpu_torch.kkt import newton_dense as kkt_nd

    b = pnlp.bounds
    crhs = pnlp.crhs
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
    max_soc = int(consts.get("max_soc_iter", 4))
    kappa_soc = consts.get("kappa_soc", 0.99)
    n, m = pnlp.n, pnlp.m
    dev = crhs.device
    is_mds = isinstance(pnlp, NlpMDS)
    ns = pnlp.n_sparse if is_mds else 0
    use_ldl = bool(consts.get("fused_ldl", False)) and is_mds

    delta0 = 1e-4          # the fused ladder's hiopPDPerturbation curve
    kappa_plus_bar = 100.0
    kappa_plus = 8.0
    kappa_minus = 1.0 / 3.0
    delta_w_min = 1e-20
    delta_c_bar = 1e-8
    kappa_c = 0.25
    MAX_REG = 10

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
    filt_idx = torch.arange(fn.FILTER_CAP, device=dev)
    h = _lane_hooks(pnlp)

    # -- one lane: the fused step's helpers over one scenario ---------------
    def evals(x, th):
        c, d = h["eval_cons"](x, th)
        return h["eval_f"](x, th), c, d

    def logbar_phi(it, f, mu):
        return f - mu * it_mod.eval_logbar(it, b) + it_mod.linear_damping_term(it, b, mu, kappa_d)

    def theta_of(it, c, d):
        return (crhs - c).abs().sum() + (it.d - d).abs().sum()

    def residual(th, state, mu):
        """Residual, errors, barrier diagonals, Hessian, theta and phi at
        the lane's current point."""
        it, f, c, d_eval, grad_f, Jc, Jd = state
        jacT_yc = Jc.T @ it.yc if m else torch.zeros_like(it.x)
        jacT_yd = Jd.T @ it.yd if m else torch.zeros_like(it.x)
        resid, norms = res_mod.update_residual(
            it, c, d_eval, grad_f, jacT_yc, jacT_yd, crhs, b, mu, kappa_d
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
        Dx, Dd = res_mod.barrier_diagonals(it, b)
        if is_mds:
            hess = h["eval_hess_blocks"](it.x, 1.0, it.yc, it.yd, th)
        else:
            hess = (h["eval_hess"](it.x, 1.0, it.yc, it.yd, th),)
        return (resid, norms.nlp_optim, norms.nlp_feasib, err_nlp, err_log, Dx, Dd, hess,
                theta_of(it, c, d_eval), logbar_phi(it, f, mu))

    def factor(hess, Dx, Dd, Jc, Jd, dw, dc):
        if not is_mds:
            return kkt_nd.factorize_quick(hess[0], Dx, Dd, Jc, Jd, dw, dw, dc, dc)
        hss, Hdd = hess
        blocks = (hss, Hdd, Dx[:ns], Dx[ns:], Dd, Jc[:, :ns], Jc[:, ns:], Jd[:, :ns], Jd[:, ns:])
        if use_ldl:
            return kkt_mds.factorize_saddle_device(*blocks, dw, dw, dc, dc)
        return kkt_mds.factorize(*blocks, dw, dw, dc, dc)

    def solve_dir(fct, res, it):
        """The direction for residual ``res`` from the lane's factors."""
        rx_t, rd_t, ryc, ryd = res_mod.compress_rhs_xdycyd(res, it, b)
        if not is_mds:
            dx, dd_, dyc, dyd = kkt_nd.solve_quick(fct, rx_t, rd_t, ryc, ryd)
        else:
            solve_ = kkt_mds.solve_saddle_device if use_ldl else kkt_mds.solve
            dxs, dxd, dd_, dyc, dyd = solve_(fct, rx_t[:ns], rx_t[ns:], rd_t, ryc, ryd)
            dx = torch.cat([dxs, dxd])
        return res_mod.recover_direction(res, it, b, dx, dd_, dyc, dyd)

    def ls_accept(ctx, theta_t, phi_t, alpha):
        """The acceptance code: 0 rejected, 1 (far) or 2 (near) sufficient
        decrease, 3 Armijo."""
        theta_curr, phi_curr, grad_phi_dx, filt, filt_len, theta_min = ctx
        far = theta_curr >= theta_min
        suff = (theta_t <= (1 - gamma_theta) * theta_curr) | (
            phi_t <= phi_curr - gamma_phi * theta_curr
        )
        dom = (theta_t >= filt[:, 0]) & (phi_t >= filt[:, 1]) & (filt_idx < filt_len)
        in_filter = dom.any()
        sw = (grad_phi_dx < 0) & (
            alpha * (-grad_phi_dx) ** s_phi > delta * theta_curr ** s_theta
        )
        armijo = phi_t <= phi_curr + eta_phi * alpha * grad_phi_dx
        code_far = torch.where(suff & ~in_filter, 1, 0)
        code_near = torch.where(
            sw, torch.where(armijo & ~in_filter, 3, 0), torch.where(suff & ~in_filter, 2, 0)
        )
        return torch.where(far, code_far, code_near)

    def trial(th, it, dir_, alpha, mu, ctx, alpha_test):
        """The trial point at step ``alpha`` and its acceptance code
        (tested at ``alpha_test``; non-finite f rejects)."""
        it_t = it_mod.take_step_primals(it, dir_, alpha)
        it_t, _ = it_mod.compute_safe_slacks(it_t, it, b, mu)
        f_t, c_t, d_t = evals(it_t.x, th)
        th_t = theta_of(it_t, c_t, d_t)
        ph_t = logbar_phi(it_t, f_t, mu)
        code = torch.where(torch.isfinite(f_t), ls_accept(ctx, th_t, ph_t, alpha_test), 0)
        return it_t, f_t, c_t, d_t, th_t, ph_t, code

    def direction_and_first_trial(th, fct, resid, state, mu, tau, filt, filt_len,
                                  theta_min, theta_curr, phi_curr):
        it, f, c, d_eval, grad_f, _Jc, _Jd = state
        dir_ = solve_dir(fct, resid, it)
        ap_max, ad = it_mod.fraction_to_the_boundary(it, dir_, tau, b)
        gx = it_mod.add_logbar_grad_x(grad_f, it, b, mu)
        gx = it_mod.add_damping_grad_x(gx, b, mu, kappa_d)
        gd = it_mod.add_logbar_grad_d(torch.zeros_like(it.d), it, b, mu)
        gd = it_mod.add_damping_grad_d(gd, b, mu, kappa_d)
        grad_phi_dx = gx @ dir_.x + gd @ dir_.d
        ctx = (theta_curr, phi_curr, grad_phi_dx, filt, filt_len, theta_min)
        first = trial(th, it, dir_, ap_max, mu, ctx, ap_max)
        return dir_, ap_max, ad, grad_phi_dx, first

    def soc_round(th, fct, resid, state, mu, tau, ctx, ap_max, carry):
        """One second-order-correction round (apply_second_order_correction,
        hiopAlgFilterIPM.cpp:2949): the constraint residual corrected by the
        last trial's violation, re-solved on the same factors; acceptance
        at the original alpha."""
        it, _f, c, d_eval = state[:4]
        (k, _code, c_soc, d_soc, alpha_soc, _th_prev, th_tr,
         _it_t, _f_t, c_t, d_t, _ph_t, _dsoc, _ad_s) = carry
        c_soc = alpha_soc * c_soc + (crhs - c_t)
        d_soc = alpha_soc * d_soc + (it.d - d_t)
        dsoc = solve_dir(fct, resid._replace(ryc=c_soc, ryd=d_soc), it)
        ap_s, ad_s = it_mod.fraction_to_the_boundary(it, dsoc, tau, b)
        it_s, f_s, c_s, d_s, th_s, ph_s, code_s = trial(th, it, dsoc, ap_s, mu, ctx, ap_max)
        return (k + 1, code_s, c_soc, d_soc, ap_s, th_tr, th_s,
                it_s, f_s, c_s, d_s, ph_s, dsoc, ad_s)

    def backtrack(th, state, dir_, mu, ctx, carry):
        """One backtracking trial: halve alpha while rejected."""
        alpha, count = carry[0], carry[1]
        it_t, f_t, c_t, d_t, th_, ph, code = trial(th, state[0], dir_, alpha, mu, ctx, alpha)
        next_alpha = torch.where(code == 0, alpha * 0.5, alpha)
        return (next_alpha, count + 1, code, it_t, f_t, c_t, d_t, th_, ph)

    def finish(th, state, it_t, dir_, alpha_p, ad, mu):
        """The dual step, the safeguard and the derivatives at the new point."""
        it_new = it_mod.take_step_duals(it_t, dir_, alpha_p, ad)
        it_new = it_mod.adjust_duals(it_new, b, mu, kappa_sigma)
        g_n = h["eval_grad_f"](it_new.x, th)
        Jc_n, Jd_n = h["eval_jac"](it_new.x, th)
        return it_new, g_n, Jc_n, Jd_n

    v_residual = vmap(residual)
    v_factor = vmap(factor)
    v_first = vmap(direction_and_first_trial)
    v_soc = vmap(soc_round)
    v_bt = vmap(backtrack)
    v_finish = vmap(finish)

    def read(stats: BatchStats, *tensors):
        """One host read: the (S,) tensors stacked and copied by one
        ``tolist``."""
        stats.reads += 1
        host = torch.stack([t.to(torch.int64) for t in tensors]).tolist()
        return [[bool(v) for v in row] for row in host]

    # -- the batched step ----------------------------------------------------
    def step(th, state, mu, tau, filt, filt_len, theta_min, dw_last, live, stats):
        """One fused iteration of every lane. The first host read carries
        ``live`` (the loop's test, computed by the caller); returns None when
        no lane is live."""
        (resid, nlp_optim, nlp_feasib, err_nlp, err_log, Dx, Dd, hess,
         theta_curr, phi_curr) = v_residual(th, state, mu)
        it, f, c, d_eval, grad_f, Jc, Jd = state
        dt = it.x.dtype
        S = it.x.shape[0]
        zero = it.x.new_zeros((S,))

        # the regularization ladder (hiopPDPerturbation's curve): delta = 0,
        # then delta_0_bar the first time ever or kappa_w_minus times the
        # last accepted delta, growing by kappa_w_plus_bar before any
        # success and kappa_w_plus after; one batched factorization per trip
        fct = v_factor(hess, Dx, Dd, Jc, Jd, zero, zero)
        dc = delta_c_bar * mu ** kappa_c
        first_ever = dw_last == 0
        start = torch.where(first_ever, delta0, torch.clamp(dw_last * kappa_minus, min=delta_w_min))
        grow = torch.where(first_ever, kappa_plus_bar, kappa_plus)
        k_reg = torch.zeros((S,), dtype=torch.int64, device=dev)
        dw = zero
        trying = live & ~fct.ok & (k_reg < MAX_REG)
        live_h, trying_h = read(stats, live, trying)
        if not any(live_h):
            return None
        stats.trips += 1
        stats.lanes_live += sum(live_h)
        while any(trying_h):
            stats.ladder_trips += 1
            stats.ladder_lanes += sum(trying_h)
            dw_new = torch.where(k_reg == 0, start, dw * grow)
            fct = _where(trying, v_factor(hess, Dx, Dd, Jc, Jd, dw_new, dc), fct)
            dw = torch.where(trying, dw_new, dw)
            k_reg = torch.where(trying, k_reg + 1, k_reg)
            trying = live & ~fct.ok & (k_reg < MAX_REG)
            (trying_h,) = read(stats, trying)
        fct_ok = fct.ok
        dw_next = torch.where(fct_ok & (dw > 0), dw, dw_last)

        # the direction and the first trial at the full fraction-to-the-
        # boundary step
        dir_, ap_max, ad, grad_phi_dx, first = v_first(
            th, fct, resid, state, mu, tau, filt, filt_len, theta_min, theta_curr, phi_curr)
        it_t1, f_t1, c_t1, d_t1, theta_t1, phi_t1, code1 = first
        ctx = (theta_curr, phi_curr, grad_phi_dx, filt, filt_len, theta_min)

        # second-order correction when the first trial fails without
        # improving infeasibility, up to max_soc_iter rounds while theta
        # contracts by kappa_soc; the backtracking loop's first test rides
        # along with each read
        do_soc = (code1 == 0) & (theta_curr <= theta_t1) & (max_soc > 0)
        soc = (torch.zeros((S,), dtype=torch.int64, device=dev), torch.zeros_like(code1),
               crhs - c, it.d - d_eval, ap_max,
               torch.full((S,), math.inf, dtype=dt, device=dev), theta_t1,
               it_t1, f_t1, c_t1, d_t1, phi_t1, dir_, ad)

        def soc_test(soc):
            k, code, _cs, _ds, _a, th_prev, th_tr = soc[:7]
            return live & do_soc & (code == 0) & (k < max_soc) & (
                (k == 0) | (th_tr <= kappa_soc * th_prev))

        def bt_start(soc):
            soc_code = soc[1]
            pre = torch.where(code1 > 0, code1, torch.where(soc_code > 0, soc_code, 0))
            return pre, live & (pre == 0) & (ap_max * 0.5 >= min_step) & (1 < fn.MAX_LS)

        soc_go = soc_test(soc)
        pre_code, bt_go = bt_start(soc)
        soc_h, bt_h = read(stats, soc_go, bt_go)
        while any(soc_h):
            stats.soc_trips += 1
            stats.soc_lanes += sum(soc_h)
            soc = _where(soc_go, v_soc(th, fct, resid, state, mu, tau, ctx, ap_max, soc), soc)
            soc_go = soc_test(soc)
            pre_code, bt_go = bt_start(soc)
            soc_h, bt_h = read(stats, soc_go, bt_go)
        (k_soc, soc_code, _cs, _ds, alpha_soc, _thp, theta_soc,
         it_soc, f_soc, c_soc_t, d_soc_t, phi_soc, dir_soc, ad_soc) = soc
        soc_ok = soc_code > 0

        # backtracking from alpha/2 when neither the first trial nor the SOC
        # was accepted
        bt = (ap_max * 0.5, torch.ones((S,), dtype=torch.int64, device=dev), pre_code,
              it_t1, f_t1, c_t1, d_t1, theta_t1, phi_t1)
        while any(bt_h):
            stats.bt_trips += 1
            stats.bt_lanes += sum(bt_h)
            bt = _where(bt_go, v_bt(th, state, dir_, mu, ctx, bt), bt)
            alpha, count, code = bt[:3]
            bt_go = live & (code == 0) & (alpha >= min_step) & (count < fn.MAX_LS)
            (bt_h,) = read(stats, bt_go)
        alpha_bt, ls_count, bt_code, it_bt, f_bt, c_bt, d_bt, theta_bt, phi_bt = bt

        # the accepted trial: first trial > SOC > backtracking
        use_soc = soc_ok & (code1 == 0)
        use_bt = (code1 == 0) & ~soc_ok
        take1 = code1 > 0

        def pick3(x1, xs, xb):
            return _where(take1, x1, _where(use_soc, xs, xb))

        it_t = pick3(it_t1, it_soc, it_bt)
        f_t = pick3(f_t1, f_soc, f_bt)
        c_t = pick3(c_t1, c_soc_t, c_bt)
        d_t = pick3(d_t1, d_soc_t, d_bt)
        theta_t = pick3(theta_t1, theta_soc, theta_bt)
        phi_t = pick3(phi_t1, phi_soc, phi_bt)
        alpha_p = pick3(ap_max, alpha_soc, alpha_bt)
        ls_code = pick3(code1, soc_code, bt_code)
        dir_p = pick3(dir_, dir_soc, dir_)
        ad_p = pick3(ad, ad_soc, ad)
        ls_count = torch.where(use_bt, ls_count, 1)
        accepted = ls_code > 0

        # the filter augmentation decision
        sw_acc = (grad_phi_dx < 0) & (
            alpha_p * (-grad_phi_dx) ** s_phi > delta * theta_curr ** s_theta
        )
        armijo_acc = phi_t <= phi_curr + eta_phi * alpha_p * grad_phi_dx
        add1 = (ls_code == 1) & ~(sw_acc & armijo_acc)
        filter_add = accepted & (add1 | (ls_code == 2))

        # the dual update and safeguard; the old state where the step was
        # rejected (the solve loop then exits that lane)
        it_new, g_n, Jc_n, Jd_n = v_finish(th, state, it_t, dir_p, alpha_p, ad_p, mu)
        new_state = _where(accepted, fn.FusedState(it_new, f_t, c_t, d_t, g_n, Jc_n, Jd_n), state)
        scal = fn.FusedScalars(
            f=f, err_nlp=err_nlp, err_log=err_log, nlp_optim=nlp_optim,
            nlp_feasib=nlp_feasib, theta=theta_curr, phi=phi_curr,
            alpha_primal=alpha_p, alpha_dual=ad_p, ls_count=ls_count,
            ls_status=torch.where(accepted, ls_code, 0),
            use_soc=use_soc & accepted, fact_ok=fct_ok, filter_add=filter_add,
            theta_add=theta_t, phi_add=phi_t, mp_f32=torch.zeros_like(accepted),
            delta_w=dw, n_refact=k_reg, ir_primary=torch.zeros_like(k_reg),
            soc_rounds=k_soc,
        )
        return new_state, scal, dw_next

    # -- the batched solve loop ----------------------------------------------
    def solve(th, state0, mu0, tau0, theta_min, theta_max, max_iter):
        x0 = state0.it.x
        S, dt = x0.shape[0], x0.dtype
        stats = BatchStats()
        lane = torch.arange(S, device=dev)
        mu = torch.full((S,), float(mu0), dtype=dt, device=dev)
        tau = torch.full((S,), float(tau0), dtype=dt, device=dev)
        filt = torch.full((S, fn.FILTER_CAP, 2), math.inf, dtype=dt, device=dev)
        filt[:, 0, 1] = -math.inf
        filt[:, 0, 0] = theta_max
        filt_len = torch.ones((S,), dtype=torch.int64, device=dev)
        it_num = torch.zeros((S,), dtype=torch.int64, device=dev)
        err0 = torch.full((S,), math.inf, dtype=dt, device=dev)
        n_accep = torch.zeros((S,), dtype=torch.int64, device=dev)
        hist = torch.zeros((S, fn.HIST_CAP, fn.HIST_COLS), dtype=dt, device=dev)
        dw_last = torch.zeros((S,), dtype=dt, device=dev)
        st = torch.zeros((S,), dtype=torch.int64, device=dev)
        state = state0
        while True:
            live = st == 0
            out = step(th, state, mu, tau, filt, filt_len, theta_min, dw_last, live, stats)
            if out is None:
                break
            new_state, s, dw_next = out
            row = torch.stack([v.to(dt) for v in (
                s.f, s.nlp_feasib, s.nlp_optim, mu, s.alpha_dual, s.alpha_primal,
                s.ls_count, s.ls_status, s.err_nlp, s.use_soc, s.mp_f32,
                s.delta_w, s.n_refact, s.ir_primary, s.soc_rounds,
            )], dim=1)
            pos = torch.clamp(it_num, max=fn.HIST_CAP - 1)
            hist[lane, pos] = torch.where(live[:, None], row, hist[lane, pos])

            # the termination ladder, in _check_termination's order, then
            # the needs-host claims 6 and 7
            err0 = torch.where(live & (it_num == 0), s.err_nlp, err0)
            acc = s.err_nlp <= accep_tol
            n_acc = torch.where(acc, n_accep + 1, 0)
            n_accep = torch.where(live, n_acc, n_accep)
            code = torch.zeros_like(st)

            def claim(code, cond, k):
                return torch.where((code == 0) & cond, k, code)

            code = claim(code, s.err_nlp <= eps_tol, 1)
            if rel_tol > 0:
                code = claim(code, s.err_nlp <= rel_tol * err0, 2)
            code = claim(code, acc & (n_acc >= accep_iters), 3)
            code = claim(code, it_num >= max_iter, 4)
            code = claim(code, s.nlp_feasib > diverg_tol, 5)
            code = claim(code, ~s.fact_ok, 6)
            code = claim(code, s.ls_status == 0, 7)
            st = torch.where(live, code, st)
            running = live & (st == 0)

            # the mu/tau schedule with the filter reset
            # (update_log_barrier_params), then the filter augmentation
            new_mu = torch.clamp(torch.minimum(kappa_mu * mu, mu ** theta_mu), min=0.0)
            new_mu = torch.clamp(new_mu, min=mu_floor)
            do_mu = running & (s.err_log <= kappa_eps * mu) & ((new_mu - mu).abs() >= 1e-16)
            mu = torch.where(do_mu, new_mu, mu)
            tau = torch.where(do_mu, torch.clamp(1.0 - new_mu, min=tau_min), tau)
            filt_len = torch.where(do_mu, 1, filt_len)
            do_add = running & s.filter_add & (filt_len < fn.FILTER_CAP)
            fpos = torch.clamp(filt_len, max=fn.FILTER_CAP - 1)
            add_row = torch.stack([s.theta_add, s.phi_add], dim=1).to(dt)
            filt[lane, fpos] = torch.where(do_add[:, None], add_row, filt[lane, fpos])
            filt_len = torch.where(do_add, filt_len + 1, filt_len)

            # advance only the running lanes: a lane that stops keeps its
            # pre-step state (the host loop's break-before-assign)
            state = _where(running, new_state, state)
            dw_last = torch.where(running, dw_next, dw_last)
            it_num = torch.where(running, it_num + 1, it_num)
        err_nlp = hist[lane, torch.clamp(it_num, max=fn.HIST_CAP - 1), fn.HIST_ERR]
        solve.stats = stats
        return (th, state), mu, it_num, st, err_nlp, hist

    solve.stats = None
    return solve


def solve_batched(pnlp, params) -> BatchResult:
    """Solve every scenario of the family in lockstep and return the
    per-scenario results. ``params``: a pytree with a leading scenario axis
    (tensors, numpy arrays, or numbers in dicts, tuples and lists)."""
    batched = getattr(pnlp, "_batched_solve_cache", None)
    if batched is None:
        batched = build_batched_solve(pnlp)
        pnlp._batched_solve_cache = batched
    state, _mu, it_num, st, err, _hist = batched(params)
    _th, core = state
    host = torch.stack([st.to(torch.float64), it_num.to(torch.float64), err,
                        core.f.to(torch.float64)]).cpu().numpy()
    return BatchResult(
        status=np.asarray(
            [_STATUS_MAP.get(int(s), SolveStatus.Unknown) for s in host[0]], dtype=object,
        ),
        x=core.it.x,
        obj=host[3],
        iterations=host[1].astype(np.int64),
        err_nlp=host[2],
        yc=core.it.yc,
        yd=core.it.yd,
    )
