"""Dense-constrained example 3 (reference NlpDenseConsEx3.hpp:15-25,65-140),
with its evaluations in torch on the solver's device.

Counterpart of ``examples/dense_ex3.py``: fixed variables and corner cases,

  min   sum 1/4 (x_i - 1)^4
  s.t.  sum x_i = n+1
        5 <= 2 x_1 + sum_{i>=2} x_i
        x_1 = 1.5 fixed (xl = xu = 1.5)
        x_2 >= 0; 1.5 <= x_3 <= 10
        x_i >= 0.5 (i >= 4), additionally x_i <= 0.5 (fixed) for i > 3n/4
  x0 = 0. Exercised with option fixed_var in {'relax', 'remove'}.

The saved objectives are ``hiop_tpu``'s table: the reference's
(NlpDenseConsEx3Driver.cpp:147-148), except n=500, which is the
independently verified optimum.

Run: ``python -m hiop_tpu_torch.examples.dense_ex3 500 -selfcheck`` (on
cuda:0; ``-cpu`` for the CPU).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hiop_tpu_torch import DenseConstraintsProblem, FilterIPMQuasiNewton, NlpDenseConstraints, NlpOptions
from hiop_tpu_torch.examples.dense_ex1 import selfcheck_ok
from hiop_tpu_torch.interface.base import INF
from hiop_tpu_torch.utils.carry import DeviceCache

SELFCHECK = {500: (2.0578828266732687e+00, 1e-6), 5000: (2.02870382737020e+01, 1e-4), 50000: (2.02578703828247e+02, 1e-4)}


class DenseConsEx3(DenseConstraintsProblem):
    jittable = True
    jac_constant = True  # all constraints are linear (hiopLinear)

    def __init__(self, n: int = 500):
        assert n >= 4
        self.n = n
        J = np.ones((2, n))
        J[1, 0] = 2.0
        self._data = DeviceCache(J=J)

    def get_prob_sizes(self):
        return self.n, 2

    def get_vars_info(self):
        n = self.n
        xl = 0.5 * np.ones(n)
        xu = INF * np.ones(n)
        xl[0], xu[0] = 1.5, 1.5
        xl[1] = 0.0
        xl[2], xu[2] = 1.5, 10.0
        idx = np.arange(n)
        fixed_tail = (idx + 1) > 3 * (n / 4.0)
        fixed_tail[:3] = False
        xu[fixed_tail] = 0.5
        return xl, xu

    def get_cons_info(self):
        return np.array([self.n + 1.0, 5.0]), np.array([self.n + 1.0, INF])

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


def solve(n: int = 500, fixed_var: str = "relax", **opts):
    o = NlpOptions()
    o.update(fixed_var=fixed_var, **opts)
    nlp = NlpDenseConstraints(DenseConsEx3(n), o)
    return FilterIPMQuasiNewton(nlp).run()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")]
    n = int(pos[0]) if pos else 500
    extra = dict(compute_mode="cpu") if "-cpu" in argv else {}
    r = solve(n, **extra)
    print(f"Objective: {r.obj:.12e} status {r.status.name} iters {r.iterations}")
    if "-selfcheck" in argv:
        if n not in SELFCHECK:
            print(f"selfcheck: no saved objective for n={n}")
            return 1
        ref, tol = SELFCHECK[n]
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
