"""Sparse example 4: a tiny concave QP exercising negative curvature and
inertia correction (reference NlpSparseEx4.hpp:11-19,
NlpSparseEx4.cpp:80-135), with its evaluations in torch on the solver's
device.

Counterpart of ``examples/sparse_ex4.py``::

  min   scal * (-3 x^2 - 2 y^2)
  s.t.  scal * (y - 0.06 x^2) >= 0
        scal * (y + 0.05 x^2) <= 10
        scal * y^2            <= 64
        scal * x^2            <= 100
        0 <= x <= 11, 0 <= y <= 11

The objective is concave and every constraint's curvature is indefinite in
the Lagrangian, so the KKT system needs primal regularization (delta_w) at
most iterates: HiOp's smallest stress test for hiopPDPerturbation and the
inertia(-free) acceptors. ``hiop_tpu``'s notes on the reference apply:
``scal`` scales the derivatives too (HiOp's example uses scal=1), constraint 2
is ``y + 0.05 x^2`` as the code has it, and HiOp's self-check table for
this example is Ex1's, so the check is the global optimum:
x* = sqrt(10/0.11), y* = 60/11, f* = -40200/121 (scal=1).

Run: ``python -m hiop_tpu_torch.examples.sparse_ex4 -selfcheck`` (on
cuda:0; ``-cpu`` for the CPU; ``-fr`` forces a feasibility restoration).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hiop_tpu_torch import FilterIPMNewton, NlpOptions, NlpSparse, SparseProblem
from hiop_tpu_torch.examples.sparse_ex1 import selfcheck_ok
from hiop_tpu_torch.interface.base import INF

# the verified global optimum, keyed by n as the other examples' tables are
SELFCHECK = {2: (-40200.0 / 121.0, 1e-6)}


class SparseEx4(SparseProblem):
    jittable = True

    def __init__(self, scal: float = 1.0):
        self.n = 2
        self.m = 4
        self.scal = scal

    def get_prob_sizes(self):
        return self.n, self.m

    def get_vars_info(self):
        return np.zeros(2), np.full(2, 11.0)

    def get_cons_info(self):
        s = self.scal
        cl = np.array([0.0, -INF, -INF, -INF])
        cu = np.array([INF, 10.0 * s, 64.0 * s, 100.0 * s])
        return cl, cu

    def get_starting_point(self):
        return np.zeros(2)

    def get_sparse_blocks_info(self):
        return self.n, 6, 2

    def jac_structure(self):
        return np.array([0, 0, 1, 1, 2, 3]), np.array([0, 1, 0, 1, 1, 0])

    def eval_jac_vals(self, x):
        s = self.scal
        one = x.new_ones(())
        return torch.stack([-0.12 * s * x[0], s * one, 0.1 * s * x[0], s * one,
                            2.0 * s * x[1], 2.0 * s * x[0]])

    def hess_structure(self):
        return np.array([0, 1]), np.array([0, 1])

    def eval_hess_vals(self, x, obj_factor, lam):
        s = self.scal
        hxx = obj_factor * (-6.0 * s) + s * (-0.12 * lam[0] + 0.1 * lam[1] + 2.0 * lam[3])
        hyy = obj_factor * (-4.0 * s) + s * (2.0 * lam[2])
        return torch.stack([hxx, hyy])

    def eval_f(self, x):
        return self.scal * (-3.0 * x[0] ** 2 - 2.0 * x[1] ** 2)

    def eval_grad_f(self, x):
        return self.scal * torch.stack([-6.0 * x[0], -4.0 * x[1]])

    def eval_cons(self, x):
        return self.scal * torch.stack([
            x[1] - 0.06 * x[0] ** 2,
            x[1] + 0.05 * x[0] ** 2,
            x[1] ** 2,
            x[0] ** 2,
        ])


def solve(scal: float = 1.0, **opts):
    o = NlpOptions()
    # the options of HiOp's example (NlpSparseEx4Driver.cpp:206-215)
    defaults = dict(
        Hessian="analytical_exact",
        duals_update_type="linear",
        KKTLinsys="xdycyd",
        mu0=0.1,
    )
    defaults.update(opts)
    o.update(**defaults)
    nlp = NlpSparse(SparseEx4(scal), o)
    return FilterIPMNewton(nlp).run()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    opts = dict(compute_mode="cpu") if "-cpu" in argv else {}
    if "-inertiafree" in argv:
        opts["fact_acceptor"] = "inertia_free"
    if "-fr" in argv:
        opts["force_resto"] = "yes"
    r = solve(**opts)
    print(f"Objective: {r.obj:.12e} status {r.status.name} iters {r.iterations}")
    if "-selfcheck" in argv:
        ref, tol = SELFCHECK[2]
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
