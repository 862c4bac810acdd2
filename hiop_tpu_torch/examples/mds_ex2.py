"""Mixed dense-sparse example 2: highly nonconvex, optionally
rank-deficient (reference NlpMdsEx2.hpp:26-55), with its evaluations in
torch on the solver's device.

Counterpart of ``examples/mds_ex2.py``::

  min  sgn * 0.5 sum x_i (x_i - 1) + 0.5 y' Q y + 0.5 s' s
       (sgn = -1 nonconvex default; Q = sgn*2*I + 1 on the
        (i,i+1)/(i+1,i) off-diagonals for i=1..nd-2)
  s.t. x + s + Md y = 0
       -2 <= x_1 + e's + e'y <= 2;  x_2 + e'y <= 2;  -2 <= x_3 + e'y
       -10 <= x <= 3;  s >= 0;  -4 <= y <= 4
  optional rank-deficient rows (rnkdef):
       x_1 + e's + x_2 + 2 e'y <= 4
       -4 <= x_1 + e's + x_3 + 2 e'y
       x + s + Md y = 0  (duplicate equality block)

Sparse variables [x, s] (2*ns), dense variables y (nd). The main path's
nonconvex example: its dense block is indefinite, so the quick tier's
Cholesky regularizes and the safe ladder takes over.

Self-check (NlpMdsEx2Driver.cpp test 3: nonconvex, full-rank, linear duals,
mu0=0.1): ns=400, nd=100 -> obj = -3.160999998751e+03 (rel 1e-6).

Run: ``python -m hiop_tpu_torch.examples.mds_ex2 400 100 -selfcheck`` (on
cuda:0; ``-cpu`` for the CPU; ``-withrdJ`` adds the rank-deficient rows).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hiop_tpu_torch import FilterIPMNewton, MdsProblem, NlpMDS, NlpOptions
from hiop_tpu_torch.interface.base import INF
from hiop_tpu_torch.utils.carry import DeviceCache

SELFCHECK_OBJ = -3.160999998751e03  # ns=400, nd=100, test-3 configuration


class MdsEx2(MdsProblem):
    jittable = True
    jac_constant = True  # all constraints are linear (hiopLinear)

    def __init__(
        self,
        ns: int = 400,
        nd: int = 100,
        convex_obj: bool = False,
        rankdefic_eq: bool = False,
        rankdefic_ineq: bool = False,
    ):
        if ns % 4 != 0:
            ns = 4 * ((4 + ns) // 4)
        self.ns = ns
        self.nd = nd
        self.sgn = 2 * int(convex_obj) - 1
        self.rd_eq = rankdefic_eq
        self.rd_ineq = rankdefic_ineq
        self.n_sp = 2 * ns
        self.m = ns + 3 + 2 * int(rankdefic_ineq) + ns * int(rankdefic_eq)

        Q = self.sgn * 2.0 * np.eye(nd)
        for i in range(1, nd - 1):
            Q[i, i + 1] += 1.0
            Q[i + 1, i] += 1.0
        Md = np.full((ns, nd), -1.0)

        rows = list(range(ns)) + list(range(ns))
        cols = list(range(ns)) + list(range(ns, 2 * ns))
        r = ns
        rows += [r] + [r] * ns + [r + 1] + [r + 2]
        cols += [0] + list(range(ns, 2 * ns)) + [1] + [2]
        r += 3
        if rankdefic_ineq:
            rows += [r] + [r] * ns + [r]
            cols += [0] + list(range(ns, 2 * ns)) + [1]
            r += 1
            rows += [r] + [r] * ns + [r]
            cols += [0] + list(range(ns, 2 * ns)) + [2]
            r += 1
        if rankdefic_eq:
            rows += list(range(r, r + ns)) + list(range(r, r + ns))
            cols += list(range(ns)) + list(range(ns, 2 * ns))
            r += ns
        self._jr = np.asarray(rows)
        self._jc = np.asarray(cols)
        blocks = [Md, np.ones((3, nd))]
        if rankdefic_ineq:
            blocks.append(np.full((2, nd), 2.0))
        if rankdefic_eq:
            blocks.append(Md)
        self._data = DeviceCache(
            Qd=Q, Md=Md, jv=np.ones(self._jr.size), dense=np.concatenate(blocks, axis=0),
            hss=np.concatenate([np.full(ns, float(self.sgn)), np.ones(ns)]),
        )

    def get_prob_sizes(self):
        return self.n_sp + self.nd, self.m

    def get_sparse_dense_blocks_info(self):
        return self.n_sp, self.nd

    def get_vars_info(self):
        ns, nd = self.ns, self.nd
        xl = np.concatenate([np.full(ns, -10.0), np.zeros(ns), np.full(nd, -4.0)])
        xu = np.concatenate([np.full(ns, 3.0), np.full(ns, INF), np.full(nd, 4.0)])
        return xl, xu

    def get_cons_info(self):
        ns = self.ns
        cl = [0.0] * ns + [-2.0, -INF, -2.0]
        cu = [0.0] * ns + [2.0, 2.0, INF]
        if self.rd_ineq:
            cl += [-INF, -4.0]
            cu += [4.0, INF]
        if self.rd_eq:
            cl += [0.0] * ns
            cu += [0.0] * ns
        return np.asarray(cl), np.asarray(cu)

    def get_starting_point(self):
        return np.ones(self.n_sp + self.nd)

    def _split(self, z):
        ns = self.ns
        return z[:ns], z[ns:2 * ns], z[2 * ns:]

    def eval_f(self, z):
        x, s, y = self._split(z)
        Qd = self._data.on(z.device)["Qd"]
        return (
            self.sgn * 0.5 * torch.sum(x * (x - 1.0))
            + 0.5 * y @ (Qd @ y)
            + 0.5 * torch.sum(s * s)
        )

    def eval_grad_f(self, z):
        x, s, y = self._split(z)
        Qd = self._data.on(z.device)["Qd"]
        return torch.cat([self.sgn * (x - 0.5), s, Qd @ y])

    def eval_cons(self, z):
        x, s, y = self._split(z)
        eq = x + s + self._data.on(z.device)["Md"] @ y
        ey = torch.sum(y)
        es = torch.sum(s)
        parts = [eq, torch.stack([x[0] + es + ey, x[1] + ey, x[2] + ey])]
        if self.rd_ineq:
            parts.append(torch.stack([x[0] + es + x[1] + 2 * ey, x[0] + es + x[2] + 2 * ey]))
        if self.rd_eq:
            parts.append(eq)
        return torch.cat(parts)

    def jac_sparse_structure(self):
        return self._jr, self._jc

    def eval_jac_blocks(self, z):
        t = self._data.on(z.device)
        return t["jv"], t["dense"]

    def eval_hess_blocks(self, z, obj_factor, lam):
        t = self._data.on(z.device)
        return obj_factor * t["hss"], obj_factor * t["Qd"]


def solve(ns: int = 400, nd: int = 100, **opts):
    kw = {}
    for key in ("convex_obj", "rankdefic_eq", "rankdefic_ineq"):
        if key in opts:
            kw[key] = opts.pop(key)
    o = NlpOptions()
    # test-3 options of HiOp's example (NlpMdsEx2Driver.cpp): linear duals, mu0=0.1
    o.update(Hessian="analytical_exact", duals_update_type="linear", mu0=0.1)
    o.update(**opts)
    nlp = NlpMDS(MdsEx2(ns, nd, **kw), o)
    return FilterIPMNewton(nlp).run()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")]
    ns = int(pos[0]) if pos else 400
    nd = int(pos[1]) if len(pos) > 1 else 100
    opts = dict(compute_mode="cpu") if "-cpu" in argv else {}
    if "-withrdJ" in argv:
        opts.update(rankdefic_eq=True, rankdefic_ineq=True)
    r = solve(ns, nd, **opts)
    print(f"Objective: {r.obj:.12e} status {r.status.name} iters {r.iterations}")
    if "-selfcheck" in argv:
        if not r.status.is_success:
            print(f"selfcheck FAILED: solver status {r.status.name}")
            return 1
        if abs((r.obj - SELFCHECK_OBJ) / SELFCHECK_OBJ) > 1e-6:
            print(f"selfcheck FAILED: obj {r.obj} vs saved {SELFCHECK_OBJ}")
            return 1
        print("selfcheck OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
