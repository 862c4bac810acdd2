"""Plain NumPy reference of HiOp's dense-constrained example 2
(``NlpDenseConsEx2``), and the first-order certificate that judges a
solver's answer to it.

FROZEN. This is a copy, made once and never to follow later edits of the
program, of ``hiop_tpu_torch/examples/dense_ex2.py``: the objective and its
gradient (``DenseConsEx2.eval_f``, ``eval_grad_f``, lines 104-108, the ``f``
of ``autodiff_problem``, lines 124-135), the constant Jacobian
(``ex2_jacobian``, lines 53-62) and the bounds (``ex2_bounds``, lines
65-77). It imports nothing of the program, of torch, of JAX, or of the JAX
package, and takes nothing the program made: the benchmark gives it the
size n and the program's answers, which it only judges.

The problem (x0 = 0)::

  min   sum 1/4 (x_i - 1)^4
  s.t.  sum x_i = n+1
        5 <= 2 x_1 + sum_{i>=2} x_i
        1 <= 2 x_1 + 0.5 x_2 + sum_{i>=3} x_i <= 2n
             4 x_1 + 2 x_2 + 2 x_3 + sum_{i>=4} x_i <= 4n
        x_1 free; x_2 >= 0; 1.5 <= x_3 <= 10; x_i >= 0.5 (i >= 4)

A bound at or beyond 1e20 in magnitude is absent, as in HiOp; here it is
an infinity. A solver that reports a solution hands its primal point x and
the multipliers lam of the four constraints, in their order, for the
Lagrangian f + lam'c. With HiOp's sign convention (grad f + J'lam - zl + zu
= 0 in x; lam = vu - vl in the constraints' values) the certificate's
numbers are:

- ``feas``: the largest violation of a constraint or a bound at x;
- ``stat``: the part of the dual residual r = grad f + J'lam that no
  multiplier of a bound that exists can take: all of r at the free x_1,
  its negative part where x has a lower bound alone, and likewise for the
  rows: a multiplier of the wrong sign on a one-sided inequality. Nought
  where (x, lam) is stationary and the multipliers' signs are right;
- ``comp``: over the bounds that exist, r split the least way into zl, zu
  >= 0 (zl = max(r, 0), zu = max(-r, 0)), and over the three inequality
  rows lam split the same way into vl = max(-lam, 0), vu = max(lam, 0);
  the largest complementarity product zl (x - xl), zu (xu - x),
  vl (c - cl), vu (cu - c): nought at a KKT point, large where a multiplier
  pushes away from a bound that is not active;
- ``obj_gap``: abs(reported objective - f(x)) / max(1, abs(f(x))): the
  objective the solver reports is that of the point it hands back.
"""

from __future__ import annotations

import numpy as np

#: the magnitude from which a bound is absent (HiOp's, the port's ``INF``)
INF = 1e20


def objective(x: np.ndarray) -> float:
    return float(0.25 * np.sum((x - 1.0) ** 4))


def gradient(x: np.ndarray) -> np.ndarray:
    return (x - 1.0) ** 3


def jacobian(n: int) -> np.ndarray:
    """The constant (4, n) constraint Jacobian."""
    J = np.ones((4, n))
    J[1, 0] = 2.0
    J[2, 0] = 2.0
    J[2, 1] = 0.5
    J[3, 0] = 4.0
    J[3, 1] = 2.0
    J[3, 2] = 2.0
    return J


def bounds(n: int):
    """(xl, xu, cl, cu), an absent bound as an infinity."""
    xl = 0.5 * np.ones(n)
    xu = np.full(n, np.inf)
    xl[0] = -np.inf
    xl[1] = 0.0
    xl[2] = 1.5
    xu[2] = 10.0
    cl = np.array([n + 1.0, 5.0, 1.0, -np.inf])
    cu = np.array([n + 1.0, np.inf, 2.0 * n, 4.0 * n])
    return xl, xu, cl, cu


def _judge(s, v, lo, hi):
    """(unabsorbed, products) of one block: ``s`` the residual that the
    lower bound's multiplier takes where positive and the upper's where
    negative, ``v`` the values, ``lo``/``hi`` the bounds."""
    has_lo, has_hi = np.isfinite(lo), np.isfinite(hi)
    unabsorbed = (np.where(has_lo, 0.0, np.maximum(s, 0.0))
                  + np.where(has_hi, 0.0, np.maximum(-s, 0.0)))
    with np.errstate(invalid="ignore"):
        gap_lo = np.where(has_lo, np.maximum(v - lo, 0.0), 0.0)
        gap_hi = np.where(has_hi, np.maximum(hi - v, 0.0), 0.0)
    prod = (np.where(has_lo, np.maximum(s, 0.0) * gap_lo, 0.0)
            + np.where(has_hi, np.maximum(-s, 0.0) * gap_hi, 0.0))
    return unabsorbed, prod


def certificate(grid: dict, p_load, line: int, x, y, obj_reported: float) -> dict:
    """The certificate of one answer to the problem of size ``grid["n"]``
    (``p_load`` and ``line`` are the grid references' and ignored here);
    ``y`` None (no multipliers handed back) fails every number but feas and
    obj_gap."""
    n = int(grid["n"])
    J = jacobian(n)
    xl, xu, cl, cu = bounds(n)
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    lam = np.full(4, np.nan) if y is None else np.asarray(y, dtype=np.float64).reshape(-1)
    c = J @ x
    feas = float(np.max(np.maximum(np.concatenate([xl - x, x - xu, cl - c, c - cu]), 0.0)))
    r = gradient(x) + J.T @ lam
    un_x, prod_x = _judge(r, x, xl, xu)
    ineq = cl < cu                      # the equality row takes any multiplier
    un_c, prod_c = _judge(-lam[ineq], c[ineq], cl[ineq], cu[ineq])
    stat = float(np.max(np.concatenate([un_x, un_c])))     # a NaN stays a NaN
    comp = float(np.max(np.concatenate([prod_x, prod_c])))
    f = objective(x)
    gap = abs(float(obj_reported) - f) / max(1.0, abs(f))
    out = dict(feas=feas, stat=stat, comp=comp, obj_gap=gap)
    return {k: (v if np.isfinite(v) else np.inf) for k, v in out.items()}
