"""Dense-constrained example 4 (reference NlpDenseConsEx4.hpp:15-24), with
its evaluations in torch on the solver's device.

Counterpart of ``examples/dense_ex4.py``: a tiny concave NLP with
nonlinear constraints,

  min  -3 x^2 - 2 y^2
  s.t. y - 0.06 x^2 >= 0
       y + 0.05 x^2 <= 10
       y^2 <= 64
       x^2 <= 100
       0 <= x <= 11, 0 <= y <= 11,  x0 = 0

optimum at x^2 = 1000/11, y = 60/11; saved objective -3.32231409044575e+02
(NlpDenseConsEx4Driver.cpp:99, relerr 1e-6). The unconstrained variant
(m=0) ends at the corner x = y = 11, objective -605.

Run: ``python -m hiop_tpu_torch.examples.dense_ex4 -selfcheck`` (on
cuda:0; ``-cpu`` for the CPU, ``-unconstrained`` for m=0).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hiop_tpu_torch import DenseConstraintsProblem, FilterIPMQuasiNewton, NlpDenseConstraints, NlpOptions
from hiop_tpu_torch.examples.dense_ex1 import selfcheck_ok
from hiop_tpu_torch.interface.base import INF

SELFCHECK_OBJ = -3.32231409044575e02
UNCONSTRAINED_OBJ = -605.0


class DenseConsEx4(DenseConstraintsProblem):
    jittable = True

    def __init__(self, unconstrained: bool = False):
        self.unconstrained = unconstrained

    def get_prob_sizes(self):
        return 2, 0 if self.unconstrained else 4

    def get_vars_info(self):
        return np.zeros(2), np.full(2, 11.0)

    def get_cons_info(self):
        if self.unconstrained:
            return np.zeros(0), np.zeros(0)
        cl = np.array([0.0, -INF, -INF, -INF])
        cu = np.array([INF, 10.0, 64.0, 100.0])
        return cl, cu

    def get_starting_point(self):
        return np.zeros(2)

    def eval_f(self, z):
        x, y = z[0], z[1]
        return -3.0 * x * x - 2.0 * y * y

    def eval_grad_f(self, z):
        return torch.stack([-6.0 * z[0], -4.0 * z[1]])

    def eval_cons(self, z):
        if self.unconstrained:
            return z.new_zeros((0,))
        x, y = z[0], z[1]
        return torch.stack([y - 0.06 * x * x, y + 0.05 * x * x, y * y, x * x])

    def eval_jac_cons(self, z):
        if self.unconstrained:
            return z.new_zeros((0, 2))
        x, y = z[0], z[1]
        one, zero = torch.ones_like(x), torch.zeros_like(x)
        return torch.stack([
            torch.stack([-0.12 * x, one]), torch.stack([0.10 * x, one]),
            torch.stack([zero, 2.0 * y]), torch.stack([2.0 * x, zero]),
        ])


def solve(unconstrained: bool = False, **opts):
    o = NlpOptions()
    # the reference example's options (NlpDenseConsEx4Driver.cpp:64-66): the
    # linear dual update, mu0 = 0.1
    o.update(duals_update_type="linear", mu0=0.1)
    o.update(**opts)
    nlp = NlpDenseConstraints(DenseConsEx4(unconstrained), o)
    return FilterIPMQuasiNewton(nlp).run()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    unconstrained = "-unconstrained" in argv
    extra = dict(compute_mode="cpu") if "-cpu" in argv else {}
    r = solve(unconstrained, **extra)
    print(f"Objective: {r.obj:.12e} status {r.status.name} iters {r.iterations}")
    if "-selfcheck" in argv:
        ref = UNCONSTRAINED_OBJ if unconstrained else SELFCHECK_OBJ
        if not r.status.is_success:
            print(f"selfcheck FAILED: solver status {r.status.name}")
            return 1
        if not selfcheck_ok(r.obj, ref, 1e-6):
            print(f"selfcheck FAILED: obj {r.obj} vs saved {ref}")
            return 1
        print("selfcheck OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
