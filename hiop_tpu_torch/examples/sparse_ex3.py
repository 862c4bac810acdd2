"""Sparse example 3: a degenerate or infeasible constraint stress test
(reference NlpSparseEx3.hpp:1-14), with its evaluations in torch on the
solver's device.

Counterpart of ``examples/sparse_ex3.py``::

  min sum x_i   s.t.   x >= 0, and (n-1) copies of the SAME row x_1 + x_n
  constrained as equalities/inequalities by flags:
    eq_feas:    x_1 + x_n == 10    (1 + (n-2) duplicated rows)
    eq_infeas:  adds x_1 + x_n == 15 rows  -> infeasible
    ineq_feas:  10-a <= x_1+x_n <= 10+a and (n-2) rows in [10-a, 15+a]
    ineq_infeas: rows in [3-a, 5-a]        -> infeasible with the above
  a = 1e-6. A zero-Hessian LP with a maximally rank-deficient Jacobian: it
  exercises the dual regularization and the infeasibility detection paths.

HiOp's self-check values (n=50: 7.5655668, 500: 82.842, 5000: 806.61,
NlpSparseEx3Driver.cpp:219) are points where HiOp's IPM terminates on this
degenerate LP, not the LP optimum (10 - a for the ineq_feas
configuration); as in ``hiop_tpu``, the self-check here is the true
optimum, and HiOp's values are kept for the record.

Run: ``python -m hiop_tpu_torch.examples.sparse_ex3 500 -selfcheck`` (on
cuda:0; ``-cpu`` for the CPU; flags ``-eq_feas`` ... choose the rows).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hiop_tpu_torch import FilterIPMNewton, NlpOptions, NlpSparse, SparseProblem
from hiop_tpu_torch.interface.base import INF

SELFCHECK_REFERENCE = {50: 7.565566821330e00, 500: 8.284201575839e01, 5000: 8.066106777964e02}

#: the LP optimum of the ineq_feas configuration (a = 1e-6) and the
#: self-check's absolute tolerance
LP_OPTIMUM = 10.0 - 1e-6
LP_TOL = 1e-4


class SparseEx3(SparseProblem):
    jittable = True
    jac_constant = True  # all constraints are linear (hiopLinear)

    def __init__(
        self,
        n: int = 50,
        a: float = 1e-6,
        eq_feas: bool = False,
        eq_infeas: bool = False,
        ineq_feas: bool = True,
        ineq_infeas: bool = False,
    ):
        if n < 3:
            raise ValueError("SparseEx3 needs n >= 3")
        self.n = n
        self.a = a
        self.flags = (eq_feas, eq_infeas, ineq_feas, ineq_infeas)
        m = 0
        if eq_feas or eq_infeas:
            m += 1
        if eq_feas:
            m += n - 2
        if eq_infeas:
            m += n - 2
        if ineq_feas or ineq_infeas:
            m += 1
        if ineq_feas:
            m += n - 2
        if ineq_infeas:
            m += n - 2
        self.m = m
        self._jr = np.repeat(np.arange(m), 2)
        self._jc = np.tile(np.array([0, n - 1]), m)

    def get_prob_sizes(self):
        return self.n, self.m

    def get_vars_info(self):
        return np.zeros(self.n), np.full(self.n, INF)

    def get_cons_info(self):
        eqf, eqi, inf_, ini = self.flags
        a, n = self.a, self.n
        cl, cu = [], []
        if eqf or eqi:
            cl += [10.0]
            cu += [10.0]
        if eqf:
            cl += [10.0] * (n - 2)
            cu += [10.0] * (n - 2)
        if eqi:
            cl += [15.0] * (n - 2)
            cu += [15.0] * (n - 2)
        if inf_ or ini:
            cl += [10.0 - a]
            cu += [10.0 + a]
        if inf_:
            cl += [10.0 - a] * (n - 2)
            cu += [15.0 + a] * (n - 2)
        if ini:
            cl += [3.0 - a] * (n - 2)
            cu += [5.0 - a] * (n - 2)
        return np.asarray(cl), np.asarray(cu)

    def get_starting_point(self):
        return np.zeros(self.n)

    def get_sparse_blocks_info(self):
        return self.n, self._jr.size, self.n

    def jac_structure(self):
        return self._jr, self._jc

    def eval_jac_vals(self, x):
        return x.new_ones((self._jr.size,))

    def hess_structure(self):
        idx = np.arange(self.n)
        return idx, idx

    def eval_hess_vals(self, x, obj_factor, lam):
        return x.new_zeros((self.n,))

    def eval_f(self, x):
        return torch.sum(x)

    def eval_grad_f(self, x):
        return torch.ones_like(x)

    def eval_cons(self, x):
        return (x[0] + x[self.n - 1]).expand(self.m).clone()


def solve(n: int = 50, **opts):
    kw = {}
    for key in ("a", "eq_feas", "eq_infeas", "ineq_feas", "ineq_infeas"):
        if key in opts:
            kw[key] = opts.pop(key)
    o = NlpOptions()
    # the options of HiOp's example (NlpSparseEx3Driver.cpp:177-181)
    o.update(Hessian="analytical_exact", mu0=0.1)
    o.update(**opts)
    nlp = NlpSparse(SparseEx3(n, **kw), o)
    return FilterIPMNewton(nlp).run()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")]
    n = int(pos[0]) if pos else 50
    kw = dict(compute_mode="cpu") if "-cpu" in argv else {}
    for flag in ("eq_feas", "eq_infeas", "ineq_feas", "ineq_infeas"):
        if f"-{flag}" in argv:
            kw[flag] = True
    r = solve(n, **kw)
    print(f"Objective: {r.obj:.12e} status {r.status.name} iters {r.iterations}")
    if "-selfcheck" in argv:
        if not r.status.is_success or abs(r.obj - LP_OPTIMUM) > LP_TOL:
            print(f"selfcheck FAILED: obj {r.obj} vs LP optimum {LP_OPTIMUM} "
                  f"(HiOp terminated at {SELFCHECK_REFERENCE.get(n)})")
            return 1
        print("selfcheck OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
