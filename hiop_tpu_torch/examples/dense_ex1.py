"""Dense-constrained example 1 (reference NlpDenseConsEx1.hpp:22-38), with
its evaluations in torch on the solver's device.

Counterpart of ``examples/dense_ex1.py``: an infinite-dimensional QP on
x:[0,1]->R,

  min   <c,x> + 1/2 <x,x>          (L2 inner products on a 1-D mesh)
  s.t.  integral(x) = 0.5
        0.1 <= x(t) <= 1.0
  c(t) = -1 + 10 t for t in [0, 0.1], 0 otherwise,

discretized on a (possibly distorted) mesh of n elements with mass
m_k = m1 + k*h, m1 = 2r/((1+r)n), h = 2(1-r)/((1+r)n(n-1)), r the ratio of
the smallest to the largest element.

Self-check objectives (NlpDenseConsEx1Driver.cpp:139-140):
  n=500: 8.6156700e-2, n=5000: 8.6156106e-2, n=50000: 8.6161001e-2.

Run: ``python -m hiop_tpu_torch.examples.dense_ex1 500 -selfcheck`` (on
cuda:0; ``-cpu`` for the CPU; a second number is the mesh ratio).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hiop_tpu_torch import DenseConstraintsProblem, FilterIPMQuasiNewton, NlpDenseConstraints, NlpOptions
from hiop_tpu_torch.utils.carry import DeviceCache

SELFCHECK = {500: (8.6156700e-2, 1e-6), 5000: (8.6156106e-02, 1e-6), 50000: (8.6161001e-02, 1e-6)}


def selfcheck_ok(obj: float, ref: float, tol: float) -> bool:
    """The reference examples' test: |ref - obj| / (1 + ref) <= tol."""
    return abs((ref - obj) / (1 + ref)) <= tol


class DenseConsEx1(DenseConstraintsProblem):
    jittable = True
    jac_constant = True  # all constraints are linear (hiopLinear)

    def __init__(self, n: int = 1000, ratio: float = 1.0):
        self.n = n
        m1 = 2 * ratio / ((1 + ratio) * n)
        h = 0.0 if n == 1 else 2 * (1 - ratio) / (1 + ratio) / (n - 1) / n
        k = np.arange(n)
        mass = m1 + k * h
        # function argument: the midpoint of element k (reference
        # Ex1Meshing1D::getFunctionArgument: t = ((2k+1) m1 + k^2 h)/2)
        t = 0.5 * ((2 * k + 1) * m1 + k * k * h)
        c = np.where(t <= 0.1, -1.0 + 10.0 * t, 0.0)
        self._data = DeviceCache(mass=mass, c=c)

    def _t(self, x):
        return self._data.on(x.device)

    def get_prob_sizes(self):
        return self.n, 1

    def get_vars_info(self):
        return 0.1 * np.ones(self.n), 1.0 * np.ones(self.n)

    def get_cons_info(self):
        return np.array([0.5]), np.array([0.5])

    def get_starting_point(self):
        return 0.5 * np.ones(self.n)

    def eval_f(self, x):
        t = self._t(x)
        return torch.sum(t["mass"] * t["c"] * x) + 0.5 * torch.sum(t["mass"] * x * x)

    def eval_grad_f(self, x):
        t = self._t(x)
        return t["mass"] * (x + t["c"])

    def eval_cons(self, x):
        return torch.sum(self._t(x)["mass"] * x)[None]

    def eval_jac_cons(self, x):
        return self._t(x)["mass"][None, :]


def solve(n: int = 1000, ratio: float = 1.0, **opts):
    o = NlpOptions()
    o.update(**opts)
    nlp = NlpDenseConstraints(DenseConsEx1(n, ratio), o)
    return FilterIPMQuasiNewton(nlp).run()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")]
    n = int(pos[0]) if pos else 20000
    ratio = float(pos[1]) if len(pos) > 1 else 1.0
    extra = dict(compute_mode="cpu") if "-cpu" in argv else {}
    r = solve(n, ratio, **extra)
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
