"""Dense-constrained example 2 (reference NlpDenseConsEx2.hpp:18-30), with
its evaluations in torch on the solver's device.

Counterpart of ``examples/dense_ex2.py``: bounds and constraints of all
types,

  min   sum 1/4 (x_i - 1)^4
  s.t.  sum x_i = n+1
        5 <= 2 x_1 + sum_{i>=2} x_i
        1 <= 2 x_1 + 0.5 x_2 + sum_{i>=3} x_i <= 2n
             4 x_1 + 2 x_2 + 2 x_3 + sum_{i>=4} x_i <= 4n
        x_1 free; x_2 >= 0; 1.5 <= x_3 <= 10; x_i >= 0.5 (i>=4)
  x0 = 0, and an unconstrained variant (m=0).

The quasi-Newton solve (:func:`solve`) is HiOp's example; :func:`solve_newton`
takes the same f and c through :class:`AutoDiffNlpProblem` (derivatives
from ``torch.func``, the dense n x n Lagrangian Hessian) into the exact
Newton solver over the dense KKT.

The saved objectives are ``hiop_tpu``'s table (``examples/dense_ex2.py``):
the reference's (NlpDenseConsEx2Driver.cpp:124-125,154-155), except the
constrained n=500 entry, which is the independently verified optimum.

Run: ``python -m hiop_tpu_torch.examples.dense_ex2 500 -selfcheck`` (on
cuda:0; ``-cpu`` for the CPU, ``-unconstrained`` for m=0, ``-newton`` for
the exact-Hessian solver).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hiop_tpu_torch import (
    AutoDiffNlpProblem,
    DenseConstraintsProblem,
    FilterIPMNewton,
    FilterIPMQuasiNewton,
    NlpDenseConstraints,
    NlpOptions,
)
from hiop_tpu_torch.backends.execspace import resolve_device
from hiop_tpu_torch.examples.dense_ex1 import selfcheck_ok
from hiop_tpu_torch.interface.base import INF
from hiop_tpu_torch.utils.carry import DeviceCache

SELFCHECK = {500: (1.5625000125e-02, 1e-6), 5000: (1.56251019995139e-02, 1e-4), 50000: (1.56251028980352e-02, 1e-4)}
SELFCHECK_UNCON = {500: (1.56250004019985e-02, 1e-6), 5000: (1.56250035348275e-02, 1e-6), 50000: (1.56250304912460e-02, 1e-6)}


def ex2_jacobian(n: int) -> np.ndarray:
    """The constant (4, n) constraint Jacobian."""
    J = np.ones((4, n))
    J[1, 0] = 2.0
    J[2, 0] = 2.0
    J[2, 1] = 0.5
    J[3, 0] = 4.0
    J[3, 1] = 2.0
    J[3, 2] = 2.0
    return J


def ex2_bounds(n: int):
    """(xl, xu, cl, cu) of the constrained problem."""
    xl = 0.5 * np.ones(n)
    xu = INF * np.ones(n)
    xl[0] = -INF
    xl[1] = 0.0
    xl[2] = 1.5
    xu[2] = 10.0
    cl = np.array([n + 1.0, 5.0, 1.0, -INF])
    cu = np.array([n + 1.0, INF, 2.0 * n, 4.0 * n])
    return xl, xu, cl, cu


class DenseConsEx2(DenseConstraintsProblem):
    jittable = True
    jac_constant = True  # all constraints are linear (hiopLinear)

    def __init__(self, n: int = 1000, unconstrained: bool = False):
        assert n >= 4
        self.n = n
        self.unconstrained = unconstrained
        self._data = DeviceCache(J=ex2_jacobian(n) if not unconstrained else np.zeros((0, n)))

    def get_prob_sizes(self):
        return self.n, 0 if self.unconstrained else 4

    def get_vars_info(self):
        xl, xu, _, _ = ex2_bounds(self.n)
        return xl, xu

    def get_cons_info(self):
        if self.unconstrained:
            return np.zeros(0), np.zeros(0)
        _, _, cl, cu = ex2_bounds(self.n)
        return cl, cu

    def get_starting_point(self):
        return np.zeros(self.n)

    def eval_f(self, x):
        return 0.25 * torch.sum((x - 1.0) ** 4)

    def eval_grad_f(self, x):
        return (x - 1.0) ** 3

    def eval_cons(self, x):
        return self._data.on(x.device)["J"] @ x

    def eval_jac_cons(self, x):
        return self._data.on(x.device)["J"]


def solve(n: int = 1000, unconstrained: bool = False, **opts):
    o = NlpOptions()
    o.update(**opts)
    nlp = NlpDenseConstraints(DenseConsEx2(n, unconstrained), o)
    return FilterIPMQuasiNewton(nlp).run()


def autodiff_problem(n: int, device) -> AutoDiffNlpProblem:
    """DenseConsEx2's f and c (constrained) as an :class:`AutoDiffNlpProblem`
    whose Jacobian constant lives on ``device`` (the solver's)."""
    J = torch.as_tensor(ex2_jacobian(n), device=device)
    xl, xu, cl, cu = ex2_bounds(n)
    return AutoDiffNlpProblem(
        f=lambda x: 0.25 * torch.sum((x - 1.0) ** 4),
        c=lambda x: J @ x,
        xl=xl, xu=xu, cl=cl, cu=cu, x0=np.zeros(n), name="dense_ex2",
    )


def solve_newton(n: int = 500, solver_cls=FilterIPMNewton, **opts):
    """The exact-Newton solve of :func:`autodiff_problem` over the dense KKT."""
    o = NlpOptions()
    o.update(Hessian="analytical_exact", **opts)
    problem = autodiff_problem(n, resolve_device(o.str_("compute_mode")))
    return solver_cls(NlpDenseConstraints(problem, o)).run()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")]
    n = int(pos[0]) if pos else 500
    unconstrained = "-unconstrained" in argv
    extra = dict(compute_mode="cpu") if "-cpu" in argv else {}
    if "-newton" in argv:
        if unconstrained:
            print("-newton takes the constrained problem only")
            return 1
        r = solve_newton(n, **extra)
    else:
        r = solve(n, unconstrained, **extra)
    print(f"Objective: {r.obj:.12e} status {r.status.name} iters {r.iterations}")
    if "-selfcheck" in argv:
        table = SELFCHECK_UNCON if unconstrained else SELFCHECK
        if n not in table:
            print(f"selfcheck: no saved objective for n={n}")
            return 1
        ref, tol = table[n]
        if not r.status.is_success:
            print(f"selfcheck FAILED: solver status {r.status.name}")
            return 1
        if not selfcheck_ok(r.obj, ref, tol):
            print(f"selfcheck FAILED: obj {r.obj} vs saved {ref}")
            return 1
        print("selfcheck OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
