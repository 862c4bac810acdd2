"""Cross-validation adapter to scipy.optimize.

Counterpart of ``hiop_tpu/utils/scipy_adapter.py`` (reference IpoptAdapter,
IpoptAdapter.hpp:48): any problem of the port is handed to an independent
solver, scipy's SLSQP or trust-constr, to cross-check a result. It covers
the reference adapter's surface:

- dense-constrained, sparse (triplets densified) and MDS problems (blocks
  flattened);
- the exact Lagrangian Hessian forwarded to trust-constr when the problem
  has one (``eval_hess_lagr``, ``eval_hess_vals``, ``eval_hess_blocks``);
- :func:`cross_validate`: the independent solve and a round-trip report
  (both objectives, the primal gap, and the KKT stationarity of THEIR
  solution under OUR derivatives).

The port's problems evaluate on the device of ``x``. scipy is host work,
so the adapter hands every evaluation a CPU f64 tensor and reads each
result back to numpy (:func:`_np`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from hiop_tpu_torch.interface.base import INF


def _x(x) -> torch.Tensor:
    """scipy's iterate as the CPU f64 tensor the problems evaluate on."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _np(v) -> np.ndarray:
    """An evaluation's result (a tensor, a numpy array or a number) as
    float64 numpy."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=float)


def _dense_jac_fn(problem, n, m):
    """Dense (m, n) Jacobian from whichever surface the problem offers:
    dense, sparse triplets, or MDS blocks."""
    if hasattr(problem, "eval_jac_blocks"):
        ns, _nd = problem.get_sparse_dense_blocks_info()
        jr, jc = (np.asarray(a) for a in problem.jac_sparse_structure())

        def jac(x):
            sp_vals, dense_blk = problem.eval_jac_blocks(_x(x))
            J = np.zeros((m, n))
            np.add.at(J, (jr, jc), _np(sp_vals))
            J[:, ns:] = _np(dense_blk)
            return J

        return jac
    if hasattr(problem, "eval_jac_cons"):
        return lambda x: _np(problem.eval_jac_cons(_x(x)))
    rows, cols = (np.asarray(a) for a in problem.jac_structure())

    def jac(x):
        J = np.zeros((m, n))
        np.add.at(J, (rows, cols), _np(problem.eval_jac_vals(_x(x))))
        return J

    return jac


def _dense_hess_fn(problem, n, m):
    """Dense (n, n) Lagrangian Hessian H(x, obj_factor, lam) from whichever
    exact second-order surface the problem offers (the reference forwards
    eval_h to Ipopt); None if it has none."""
    if hasattr(problem, "eval_hess_blocks") and hasattr(problem, "get_sparse_dense_blocks_info"):
        ns, _nd = problem.get_sparse_dense_blocks_info()

        def hess(x, obj_factor, lam):
            hss, hdd = problem.eval_hess_blocks(_x(x), float(obj_factor), _x(lam))
            H = np.zeros((n, n))
            H[np.arange(ns), np.arange(ns)] = _np(hss)
            H[ns:, ns:] = _np(hdd)
            return H

        return hess
    if hasattr(problem, "hess_structure") and hasattr(problem, "eval_hess_vals"):
        hr, hc = (np.asarray(a) for a in problem.hess_structure())
        off = hr != hc

        def hess(x, obj_factor, lam):
            vals = _np(problem.eval_hess_vals(_x(x), float(obj_factor), _x(lam)))
            H = np.zeros((n, n))
            np.add.at(H, (hr, hc), vals)
            np.add.at(H, (hc[off], hr[off]), vals[off])
            return H

        return hess
    if hasattr(problem, "eval_hess_lagr"):
        from hiop_tpu_torch.interface.base import NlpProblem

        if type(problem).eval_hess_lagr is getattr(NlpProblem, "eval_hess_lagr", None):
            return None

        def hess(x, obj_factor, lam):
            return _np(problem.eval_hess_lagr(_x(x), float(obj_factor), _x(lam)))

        return hess
    return None


def solve_with_scipy(problem, method: str = "SLSQP", maxiter: int = 1000,
                     x0=None, use_hessian: Optional[bool] = None):
    """Solve a problem with ``scipy.optimize.minimize``; returns scipy's
    OptimizeResult. Takes dense-constrained, sparse (triplets densified)
    and MDS (blocks flattened) problems; with ``method='trust-constr'`` and
    an exact second-order problem the Lagrangian Hessian is forwarded
    (``use_hessian=False`` turns that off)."""
    from scipy.optimize import NonlinearConstraint, minimize

    n, m = problem.get_prob_sizes()
    xl, xu = (_np(a) for a in problem.get_vars_info())
    cl, cu = (_np(a) for a in problem.get_cons_info())

    def f(x):
        return float(problem.eval_f(_x(x)))

    def g(x):
        return _np(problem.eval_grad_f(_x(x)))

    def c(x):
        out = problem.eval_cons(_x(x))
        if isinstance(out, tuple):
            # a split (c_eq, c_ineq): the adapter's row order is [eq; ineq]
            return np.concatenate([_np(out[0]), _np(out[1])])
        return _np(out)

    jac = _dense_jac_fn(problem, n, m)
    bounds = [(None if lo <= -INF else lo, None if hi >= INF else hi) for lo, hi in zip(xl, xu)]
    constraints = []
    if m:
        if method == "SLSQP":
            eq = cl == cu
            if eq.any():
                idx = np.nonzero(eq)[0]
                constraints.append({"type": "eq",
                                    "fun": lambda x, i=idx: c(x)[i] - cl[i],
                                    "jac": lambda x, i=idx: jac(x)[i]})
            for bound, sign in ((cl, 1.0), (cu, -1.0)):
                sel = np.nonzero(~eq & (np.abs(bound) < INF))[0]
                if sel.size:
                    constraints.append({"type": "ineq",
                                        "fun": lambda x, i=sel, b=bound, s=sign: s * (c(x)[i] - b[i]),
                                        "jac": lambda x, i=sel, s=sign: s * jac(x)[i]})
        else:
            hess_l = _dense_hess_fn(problem, n, m) if use_hessian is not False else None
            if hess_l is not None:
                constraints.append(NonlinearConstraint(c, cl, cu, jac=jac,
                                                       hess=lambda x, v: hess_l(x, 0.0, v)))
            else:
                constraints.append(NonlinearConstraint(c, cl, cu, jac=jac))

    x_start = _np(x0 if x0 is not None else problem.get_starting_point())
    kwargs = {}
    if method != "SLSQP" and use_hessian is not False:
        hess_l = _dense_hess_fn(problem, n, m)
        if hess_l is not None:
            zero_lam = np.zeros(m)
            kwargs["hess"] = lambda x: hess_l(x, 1.0, zero_lam)
    return minimize(
        f, x_start, jac=g, bounds=bounds, constraints=constraints, method=method,
        options={"maxiter": maxiter, "ftol": 1e-12} if method == "SLSQP" else {"maxiter": maxiter},
        **kwargs,
    )


@dataclass
class CrossValidationReport:
    """Round trip against the independent solver: objective agreement,
    primal gap, and the KKT stationarity of THEIR solution under OUR
    derivatives (with their multipliers)."""

    ours_obj: float
    theirs_obj: float
    obj_rel_gap: float
    primal_inf_gap: float
    their_kkt_stationarity: float
    their_success: bool
    agrees: bool


def cross_validate(problem, ours_obj: float, ours_x=None,
                   method: str = "trust-constr", maxiter: int = 2000,
                   tol: float = 1e-5, x0=None) -> CrossValidationReport:
    """Run the independent solve and check both directions.

    ``their_kkt_stationarity`` is || grad f + J^T v + z ||_inf at the
    independent solution with the independent multipliers but OUR
    gradient and Jacobian: a check of the derivatives that no objective
    comparison gives."""
    res = solve_with_scipy(problem, method=method, maxiter=maxiter, x0=x0)
    n, m = problem.get_prob_sizes()
    x = np.asarray(res.x, dtype=float)
    stat = _np(problem.eval_grad_f(_x(x))).copy()
    v = getattr(res, "v", None)
    if m and v:
        # trust-constr: v[0] are the NonlinearConstraint's multipliers
        stat = stat + _dense_jac_fn(problem, n, m)(x).T @ np.asarray(v[0], dtype=float)
    if v is not None and len(v) > 1:
        # the bound multipliers (scipy appends the variable-bound constraint)
        stat = stat + np.asarray(v[1], dtype=float)
    gap = abs(float(ours_obj) - float(res.fun)) / max(1.0, abs(float(res.fun)))
    primal = (float(np.linalg.norm(np.asarray(ours_x, dtype=float) - x, np.inf))
              if ours_x is not None else float("nan"))
    return CrossValidationReport(
        ours_obj=float(ours_obj),
        theirs_obj=float(res.fun),
        obj_rel_gap=gap,
        primal_inf_gap=primal,
        their_kkt_stationarity=float(np.linalg.norm(stat, np.inf)),
        their_success=bool(res.success),
        # agreement is the objective gap; trust-constr often stops at
        # maxiter with the objective converged far below tol
        agrees=gap <= tol,
    )
