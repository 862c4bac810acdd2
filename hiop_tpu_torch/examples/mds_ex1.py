"""Mixed dense-sparse example 1 (reference NlpMdsEx1.hpp:26-56), with its
evaluations in torch on the solver's device.

Counterpart of ``examples/mds_ex1.py``::

  min  sum 0.5 x_i (x_i - 1) + 0.5 y' Qd y + 0.5 s' s
  s.t. x + s + Md y = 0                    (ns equalities)
       -2   <= x_1 + e's + e'y <= 2
       -inf <= x_2       + e'y <= 2
       -2   <= x_3       + e'y <= inf
       x <= 3;  s >= 0;  -4 <= y_1 <= 4, rest of y free
  x0 = all ones. Sparse variables [x, s] (2*ns), dense variables y (nd).

Self-check (NlpMdsEx1Driver.cpp:149): ns=400, nd=100 ->
  obj = -4.9994906229741609e+01 (abs tol 1e-6).

Run: ``python -m hiop_tpu_torch.examples.mds_ex1 400 100 -selfcheck``
(on cuda:0; add ``-cpu`` for the CPU, ``-pallas`` for mixed precision:
``kkt_fact_dtype=float32``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hiop_tpu_torch import FilterIPMNewton, MdsProblem, NlpMDS, NlpOptions
from hiop_tpu_torch.interface.base import INF
from hiop_tpu_torch.utils.carry import DeviceCache

SELFCHECK_OBJ = -4.9994906229741609e01  # ns=400, nd=100


def ex1_matrices(ns: int, nd: int):
    """(Qd, Md) of the example as numpy arrays."""
    Q = np.full((nd, nd), 1e-8)
    Q += 2.0 * np.eye(nd)
    for i in range(1, nd - 1):
        Q[i, i + 1] += 1.0
        Q[i + 1, i] += 1.0
    return Q, np.full((ns, nd), -1.0)


class MdsEx1(MdsProblem):
    jac_constant = True  # all constraints are linear (hiopLinear)

    def __init__(self, ns: int = 400, nd: int = 100, empty_sp_row: bool = False):
        """empty_sp_row=True drops x_2 from the second inequality, leaving a
        constraint row with no sparse-block entries."""
        if ns % 4 != 0:
            ns = 4 * ((4 + ns) // 4)
        self.ns = ns
        self.nd = nd
        self.empty_sp_row = empty_sp_row
        self.n_sp = 2 * ns   # [x, s]
        self.m = ns + 3
        Qd, Md = ex1_matrices(ns, nd)
        # sparse-block Jacobian structure over [x, s]
        rows = list(range(ns)) + list(range(ns))          # eq: x_i, s_i
        cols = list(range(ns)) + list(range(ns, 2 * ns))
        rows += [ns] + [ns] * ns
        cols += [0] + list(range(ns, 2 * ns))
        if not empty_sp_row:
            rows += [ns + 1]
            cols += [1]
        rows += [ns + 2]
        cols += [2]
        self._jr = np.asarray(rows)
        self._jc = np.asarray(cols)
        self._data = DeviceCache(
            Qd=Qd, Md=Md, jv=np.ones(self._jr.size),
            dense=np.concatenate([Md, np.ones((3, nd))], axis=0),
        )

    # -- interface ----------------------------------------------------------
    def get_prob_sizes(self):
        return self.n_sp + self.nd, self.m

    def get_sparse_dense_blocks_info(self):
        return self.n_sp, self.nd

    def get_vars_info(self):
        ns, nd = self.ns, self.nd
        xl = np.concatenate([np.full(ns, -INF), np.zeros(ns), np.full(nd, -INF)])
        xu = np.concatenate([np.full(ns, 3.0), np.full(ns, INF), np.full(nd, INF)])
        xl[2 * ns] = -4.0
        xu[2 * ns] = 4.0
        return xl, xu

    def get_cons_info(self):
        ns = self.ns
        cl = np.concatenate([np.zeros(ns), [-2.0, -INF, -2.0]])
        cu = np.concatenate([np.zeros(ns), [2.0, 2.0, INF]])
        return cl, cu

    def get_starting_point(self):
        return np.ones(self.n_sp + self.nd)

    # -- evaluations --------------------------------------------------------
    def _split(self, z):
        ns = self.ns
        return z[:ns], z[ns:2 * ns], z[2 * ns:]

    def eval_f(self, z):
        x, s, y = self._split(z)
        Qd = self._data.on(z.device)["Qd"]
        return 0.5 * torch.sum(x * (x - 1.0)) + 0.5 * y @ (Qd @ y) + 0.5 * torch.sum(s * s)

    def eval_grad_f(self, z):
        x, s, y = self._split(z)
        Qd = self._data.on(z.device)["Qd"]
        return torch.cat([x - 0.5, s, Qd @ y])

    def eval_cons(self, z):
        x, s, y = self._split(z)
        Md = self._data.on(z.device)["Md"]
        eq = x + s + Md @ y
        ey = torch.sum(y)
        row1 = ey if self.empty_sp_row else x[1] + ey
        ineq = torch.stack([x[0] + torch.sum(s) + ey, row1, x[2] + ey])
        return torch.cat([eq, ineq])

    def jac_sparse_structure(self):
        return self._jr, self._jc

    def eval_jac_blocks(self, z):
        t = self._data.on(z.device)
        return t["jv"], t["dense"]

    def eval_hess_blocks(self, z, obj_factor, lam):
        hss = obj_factor * torch.ones((self.n_sp,), dtype=z.dtype, device=z.device)
        hdd = obj_factor * self._data.on(z.device)["Qd"]
        return hss, hdd


def solve(ns: int = 400, nd: int = 100, reference_options: bool = True,
          empty_sp_row: bool = False, **opts):
    """reference_options=True takes the settings of HiOp's NlpMdsEx1 example
    (its NlpMdsEx1Driver.cpp:129-140: tol 1e-5, mu0 0.1, duals_init zero)."""
    o = NlpOptions()
    o.update(Hessian="analytical_exact", KKTLinsys="xdycyd")
    if reference_options:
        o.update(tolerance=1e-5, mu0=0.1, duals_init="zero", duals_update_type="linear")
    o.update(**opts)
    nlp = NlpMDS(MdsEx1(ns, nd, empty_sp_row), o)
    return FilterIPMNewton(nlp).run()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")]
    ns = int(pos[0]) if pos else 400
    nd = int(pos[1]) if len(pos) > 1 else 100
    extra = dict(compute_mode="cpu") if "-cpu" in argv else {}
    if "-pallas" in argv:
        # mixed precision: the f32 factorizations through the hand-written
        # kernels (the role of HiOp's RAJA/GPU example NlpMdsRajaEx1); the
        # flag keeps the name it has in the JAX example, whose kernels were Pallas
        extra["kkt_fact_dtype"] = "float32"
    r = solve(ns, nd, **extra)
    print(f"Objective: {r.obj:.12e} status {r.status.name} iters {r.iterations}")
    if "-selfcheck" in argv:
        if not r.status.is_success:
            print(f"selfcheck FAILED: solver status {r.status.name}")
            return 1
        if (ns, nd) != (400, 100):
            print("selfcheck: saved objective only for ns=400 nd=100")
            return 1
        if abs(r.obj - SELFCHECK_OBJ) > 1e-6:
            print(f"selfcheck FAILED: obj {r.obj} vs saved {SELFCHECK_OBJ}")
            return 1
        print("selfcheck OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
