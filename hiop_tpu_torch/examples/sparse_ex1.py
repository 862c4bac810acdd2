"""Sparse example 1 (reference NlpSparseEx1.hpp), with its evaluations in
torch on the solver's device.

Counterpart of ``examples/sparse_ex1.py``::

  min   scal * sum 1/4 (x_i - 1)^4
  s.t.  scal*(4 x_1 + 2 x_2) == scal*10
        scal*5  <= scal*2 x_1 + scal*x_3
        scal*1  <= scal*2 x_1 + 0.5*scal*x_i <= scal*2n,  i = 4..n
        x_1 free; x_2 >= 0; 1.5 <= x_3 <= 10; x_i >= 0.5 (i >= 4)
  x0 = 0; m = n - 1 constraints, sparse Jacobian (2 nnz/row), diagonal
  Hessian 3*scal*(x_i-1)^2.

Self-check (NlpSparseEx1Driver.cpp:295-296):
  n=50: 1.10351564683176e-01, 500: 1.10351566513480e-01,
  5000: 1.10351578644469e-01.

From n + m = 2000 on (n = 5000 here) ``FilterIPMNewton`` takes the host
sparse-direct KKT (SuperLU); below it, the dense Newton KKT over the
Hessian and Jacobian assembled from the triplets.

Run: ``python -m hiop_tpu_torch.examples.sparse_ex1 5000 -selfcheck`` (on
cuda:0; ``-cpu`` for the CPU; a second number is ``scal``; ``-device_ldl``
for ``linear_solver_sparse=device_ldl``, ``-condensed`` for
``KKTLinsys=condensed``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hiop_tpu_torch import FilterIPMNewton, NlpOptions, NlpSparse, SparseProblem
from hiop_tpu_torch.interface.base import INF
from hiop_tpu_torch.utils.carry import DeviceCache

SELFCHECK = {
    50: (1.10351564683176e-01, 1e-6),
    500: (1.10351566513480e-01, 1e-6),
    5000: (1.10351578644469e-01, 1e-6),
}


def selfcheck_ok(obj: float, ref: float, tol: float) -> bool:
    """HiOp's examples' test: |ref - obj| / (1 + |ref|) <= tol."""
    return abs((ref - obj) / (1 + abs(ref))) <= tol


class SparseEx1(SparseProblem):
    jittable = True
    jac_constant = True  # all constraints are linear (hiopLinear)

    def __init__(self, n: int = 50, scal: float = 1.0):
        if n < 3:
            raise ValueError("SparseEx1 needs n >= 3")
        self.n = n
        self.m = 2 + max(n - 3, 0)
        self.scal = scal
        # static Jacobian structure: rows [0,0,1,1,2,2,...], 2 nnz per row
        rows = [0, 0, 1, 1]
        cols = [0, 1, 0, 2]
        vals = [4 * scal, 2 * scal, 2 * scal, 1 * scal]
        for k, i in enumerate(range(3, n)):
            rows += [2 + k, 2 + k]
            cols += [0, i]
            vals += [2 * scal, 0.5 * scal]
        self._jr = np.asarray(rows)
        self._jc = np.asarray(cols)
        self._data = DeviceCache(jv=np.asarray(vals, dtype=np.float64))

    def get_prob_sizes(self):
        return self.n, self.m

    def get_vars_info(self):
        n = self.n
        xl = 0.5 * np.ones(n)
        xu = INF * np.ones(n)
        xl[0] = -INF
        xl[1] = 0.0
        xl[2], xu[2] = 1.5, 10.0
        return xl, xu

    def get_cons_info(self):
        s, n = self.scal, self.n
        cl = np.concatenate([[10.0 * s, 5.0 * s], np.full(max(n - 3, 0), 1.0 * s)])
        cu = np.concatenate([[10.0 * s, INF], np.full(max(n - 3, 0), 2.0 * n * s)])
        return cl, cu

    def get_starting_point(self):
        return np.zeros(self.n)

    def get_sparse_blocks_info(self):
        return self.n, self._jr.size, self.n

    def jac_structure(self):
        return self._jr, self._jc

    def eval_jac_vals(self, x):
        return self._data.on(x.device)["jv"]

    def hess_structure(self):
        idx = np.arange(self.n)
        return idx, idx

    def eval_hess_vals(self, x, obj_factor, lam):
        return self.scal * obj_factor * 3.0 * (x - 1.0) ** 2

    def eval_f(self, x):
        return self.scal * 0.25 * torch.sum((x - 1.0) ** 4)

    def eval_grad_f(self, x):
        return self.scal * (x - 1.0) ** 3

    def eval_cons(self, x):
        head = torch.stack([4 * x[0] + 2 * x[1], 2 * x[0] + x[2]])
        return self.scal * torch.cat([head, 2 * x[0] + 0.5 * x[3:]])


def solve(n: int = 50, scal: float = 1.0, **opts):
    o = NlpOptions()
    o.update(Hessian="analytical_exact", **opts)
    nlp = NlpSparse(SparseEx1(n, scal), o)
    return FilterIPMNewton(nlp).run()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")]
    n = int(pos[0]) if pos else 50
    scal = float(pos[1]) if len(pos) > 1 else 1.0
    opts = dict(compute_mode="cpu") if "-cpu" in argv else {}
    if "-inertiafree" in argv:
        opts["fact_acceptor"] = "inertia_free"
    if "-stable" in argv:
        opts["linsol_mode"] = "stable"
    if "-device_ldl" in argv:
        opts["linear_solver_sparse"] = "device_ldl"
    if "-condensed" in argv:
        opts["KKTLinsys"] = "condensed"
    r = solve(n, scal, **opts)
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
