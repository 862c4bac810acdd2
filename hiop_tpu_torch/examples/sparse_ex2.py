"""Sparse example 2: nonconvex objective, rank-deficient Jacobian option
(reference NlpSparseEx2.hpp:1-30), with its evaluations in torch on the
solver's device.

Counterpart of ``examples/sparse_ex2.py``::

  min   (2*convex_obj-1)*scal_neg_obj * sum 1/4 (x_i-1)^4 + 0.5 x^T x
  s.t.  4 x_1 + 2 x_2 == 10
        5 <= 2 x_1 + x_3
        1 <= 2 x_1 + 0.5 x_i <= 2n,  i = 4..n
        x_1 free; x_2 >= 0; 1.0 <= x_3 <= 10; x_i >= 0.5 (i >= 4)
  optionally (defaults on, making the Jacobian rank-deficient):
        -inf <= 4 x_1 + 2 x_3 <= 19      (rnkdef-con1, inequality)
        4 x_1 + 2 x_2 == 10              (rnkdef-con2, duplicate equality)

Exercises the dual (delta_c) regularization and, being nonconvex, the
inertia-revealing safe tier of the Newton KKT.

Self-check (NlpSparseEx2Driver.cpp:348-350, defaults convex_obj=false,
rank-deficient rows on, scal_neg_obj=0.1):
  n=50: 8.7754974e+00, 500: 6.4322371e+01, 5000: 1.2369786e+03.

Run: ``python -m hiop_tpu_torch.examples.sparse_ex2 500 -selfcheck`` (on
cuda:0; ``-cpu`` for the CPU).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hiop_tpu_torch import FilterIPMNewton, NlpOptions, NlpSparse, SparseProblem
from hiop_tpu_torch.examples.sparse_ex1 import selfcheck_ok
from hiop_tpu_torch.interface.base import INF
from hiop_tpu_torch.utils.carry import DeviceCache

SELFCHECK = {50: (8.7754974e00, 1e-6), 500: (6.4322371e01, 1e-6), 5000: (1.2369786e03, 1e-6)}


class SparseEx2(SparseProblem):
    jittable = True
    jac_constant = True  # all constraints are linear (hiopLinear)

    def __init__(
        self,
        n: int = 50,
        convex_obj: bool = False,
        rankdefic_eq: bool = True,
        rankdefic_ineq: bool = True,
        scal_neg_obj: float = 0.1,
    ):
        if n < 3:
            raise ValueError("SparseEx2 needs n >= 3")
        self.n = n
        self.convex = convex_obj
        self.rd_eq = rankdefic_eq
        self.rd_ineq = rankdefic_ineq
        self.scal = scal_neg_obj
        self.m = 2 + max(n - 3, 0) + int(rankdefic_eq) + int(rankdefic_ineq)

        rows = [0, 0, 1, 1]
        cols = [0, 1, 0, 2]
        vals = [4.0, 2.0, 2.0, 1.0]
        r = 2
        for i in range(3, n):
            rows += [r, r]
            cols += [0, i]
            vals += [2.0, 0.5]
            r += 1
        if rankdefic_ineq:
            rows += [r, r]
            cols += [0, 2]
            vals += [4.0, 2.0]
            r += 1
        if rankdefic_eq:
            rows += [r, r]
            cols += [0, 1]
            vals += [4.0, 2.0]
            r += 1
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
        xl[2], xu[2] = 1.0, 10.0
        return xl, xu

    def get_cons_info(self):
        n = self.n
        cl = [10.0, 5.0] + [1.0] * max(n - 3, 0)
        cu = [10.0, INF] + [2.0 * n] * max(n - 3, 0)
        if self.rd_ineq:
            cl += [-INF]
            cu += [19.0]
        if self.rd_eq:
            cl += [10.0]
            cu += [10.0]
        return np.asarray(cl), np.asarray(cu)

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
        sgn = 2 * self.convex - 1
        return obj_factor * (sgn * self.scal * 3.0 * (x - 1.0) ** 2 + 1.0)

    def eval_f(self, x):
        sgn = 2 * self.convex - 1
        return sgn * self.scal * 0.25 * torch.sum((x - 1.0) ** 4) + 0.5 * torch.sum(x * x)

    def eval_grad_f(self, x):
        sgn = 2 * self.convex - 1
        return sgn * self.scal * (x - 1.0) ** 3 + x

    def eval_cons(self, x):
        parts = [torch.stack([4 * x[0] + 2 * x[1], 2 * x[0] + x[2]]), 2 * x[0] + 0.5 * x[3:]]
        if self.rd_ineq:
            parts.append((4 * x[0] + 2 * x[2]).reshape(1))
        if self.rd_eq:
            parts.append((4 * x[0] + 2 * x[1]).reshape(1))
        return torch.cat(parts)


def solve(n: int = 50, **opts):
    kw = {}
    for key in ("convex_obj", "rankdefic_eq", "rankdefic_ineq", "scal_neg_obj"):
        if key in opts:
            kw[key] = opts.pop(key)
    o = NlpOptions()
    o.update(Hessian="analytical_exact", **opts)
    nlp = NlpSparse(SparseEx2(n, **kw), o)
    return FilterIPMNewton(nlp).run()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")]
    n = int(pos[0]) if pos else 50
    opts = dict(compute_mode="cpu") if "-cpu" in argv else {}
    if "-inertiafree" in argv:
        opts["fact_acceptor"] = "inertia_free"
    r = solve(n, **opts)
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
