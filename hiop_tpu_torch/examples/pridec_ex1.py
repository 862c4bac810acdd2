"""PriDec example 1 — a two-stage stochastic toy (reference
NlpPriDecEx1.hpp:7-20), with its evaluations in torch on the solver's
device.

Counterpart of ``examples/pridec_ex1.py``::

  basecase:  min sum 0.5 (x_i - 1)^2   s.t. x >= 0
  recourse:  r = 1/S sum_{i=1..S} 0.5 |x + S e_i|^2, (S e_i)_j = S if j==i<=nx
             else 0

Analytic optimum: x* = 0, total objective 0.5*S*nx + 0.5*nx
(NlpPriDecEx1Driver.cpp:169, selfcheck tol 1e-5).

The master problem is solved with the Newton IPM on an autodiff problem;
the scenario batch is evaluated by one call of ``torch.func.vmap`` of the
recourse value and of its ``torch.func.grad``.

Run: ``python -m hiop_tpu_torch.examples.pridec_ex1 20 100 -selfcheck``
(on cuda:0; add ``-cpu`` for the CPU).
"""

from __future__ import annotations

import sys

import numpy as np
import torch
from torch.func import grad, vmap

from hiop_tpu_torch import (
    AutoDiffNlpProblem,
    FilterIPMNewton,
    NlpDenseConstraints,
    NlpOptions,
    PriDecOptions,
    PriDecProblem,
    PriDecSolver,
)
from hiop_tpu_torch.backends.execspace import resolve_device
from hiop_tpu_torch.interface.base import INF


class PriDecEx1(PriDecProblem):
    batched = True

    def __init__(self, nx: int = 20, S: int = 100, compute_mode: str = "auto"):
        self.nx = nx
        self.S = S
        self.compute_mode = compute_mode
        self.device = resolve_device(compute_mode)

        def rterm(i, x):
            shift = torch.where(torch.arange(nx, device=x.device) == i, float(S), 0.0)
            z = x + shift
            return 0.5 * (z @ z)

        self._rterm_val = vmap(rterm, in_dims=(0, None))
        self._rterm_grad = vmap(grad(rterm, argnums=1), in_dims=(0, None))

    def get_num_rterms(self):
        return self.S

    def get_num_vars(self):
        return self.nx

    def solve_master(self, x, include_r, evaluator=None):
        nx = self.nx

        if include_r and evaluator is not None:
            def f(z):
                return 0.5 * torch.sum((z - 1.0) ** 2) + evaluator.eval_f(z)
        else:
            def f(z):
                return 0.5 * torch.sum((z - 1.0) ** 2)
        p = AutoDiffNlpProblem(
            f=f,
            c=None,
            xl=np.zeros(nx),
            xu=np.full(nx, INF),
            cl=np.zeros(0),
            cu=np.zeros(0),
            x0=np.asarray(x),
        )
        o = NlpOptions()
        o.update(Hessian="analytical_exact", verbosity_level=0, tolerance=1e-8,
                 compute_mode=self.compute_mode)
        r = FilterIPMNewton(NlpDenseConstraints(p, o)).run()
        return r.x, r.obj

    def eval_rterms_batched(self, idxs, x):
        xt = torch.as_tensor(np.asarray(x, np.float64), device=self.device)
        it = torch.as_tensor(np.asarray(idxs), dtype=torch.int64, device=self.device)
        return self._rterm_val(it, xt), self._rterm_grad(it, xt)

    def eval_f_rterm(self, idx, x):
        shift = np.zeros(self.nx)
        if idx < self.nx:
            shift[idx] = self.S
        z = np.asarray(x) + shift
        return 0.5 * float(z @ z)

    def eval_grad_rterm(self, idx, x):
        shift = np.zeros(self.nx)
        if idx < self.nx:
            shift[idx] = self.S
        return np.asarray(x) + shift


def solve(nx: int = 20, S: int = 100, compute_mode: str = "auto", **opts):
    o = PriDecOptions()
    o.update(**opts)
    return PriDecSolver(PriDecEx1(nx, S, compute_mode), o)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")]
    nx = int(pos[0]) if pos else 20
    S = int(pos[1]) if len(pos) > 1 else 100
    solver = solve(nx, S, "cpu" if "-cpu" in argv else "auto")
    r = solver.run()
    obj_true = 0.5 * S * nx + 0.5 * nx
    print(
        f"Objective: {r.obj:.12e} status {r.status.name} iters {r.iterations} "
        f"(analytic {obj_true:.6e})"
    )
    if "-selfcheck" in argv:
        if abs(r.obj - obj_true) > 1e-5:
            print(f"selfcheck FAILED: obj {r.obj} vs analytic {obj_true}")
            return 1
        print("selfcheck OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
