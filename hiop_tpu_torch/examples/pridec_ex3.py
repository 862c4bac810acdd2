"""PriDec example 3 — the extensive form of PriDec Ex2 solved directly
(reference NlpPriDecEx3Sparse.hpp), with its evaluations in torch on the
solver's device.

Counterpart of ``examples/pridec_ex3.py``::

  min  sum 1/4 (x_i-1)^4 + 1/S sum_i 0.5 ||y^i - x||^2
  s.t. the SparseEx1 constraints on x, and for each scenario i:
       (1 - y^i_1 + xi_1)^2 + sum_{k=2..nS}(y^i_k + xi_k)^2
                            + sum_{k>nS} (y^i_k)^2 >= 1
       y^i_k - y^i_{k-1} >= 0,  y^i_1 >= 0

One monolithic NLP over [x, y^1, ..., y^S], the ground truth the PriDec
decomposition must reproduce (``-selfcheck`` compares it with PriDec Ex2's
saved objective).

Run: ``python -m hiop_tpu_torch.examples.pridec_ex3 20 5 -selfcheck``
(on cuda:0; add ``-cpu`` for the CPU).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hiop_tpu_torch import AutoDiffNlpProblem, FilterIPMNewton, NlpDenseConstraints, NlpOptions
from hiop_tpu_torch.interface.base import INF


def build_problem(nx: int = 20, nS: int = 5, S: int = 5):
    ny = nx
    n = nx + S * ny
    xi_np = np.ones(nS)

    def split(z):
        return z[:nx], z[nx:].reshape(S, ny)

    def f(z):
        x, Y = split(z)
        base = 0.25 * torch.sum((x - 1.0) ** 4)
        rec = 0.5 * torch.sum((Y - x[None, :]) ** 2) / S
        return base + rec

    def cons(z):
        x, Y = split(z)
        head = torch.stack([4 * x[0] + 2 * x[1], 2 * x[0] + x[2]])
        tail = 2 * x[0] + 0.5 * x[3:]
        xi = torch.as_tensor(xi_np, dtype=z.dtype, device=z.device)

        def ball(y):
            return (
                (1.0 - y[0] + xi[0]) ** 2
                + torch.sum((y[1:nS] + xi[1:]) ** 2)
                + torch.sum(y[nS:] ** 2)
            )

        balls = torch.stack([ball(Y[i]) for i in range(S)])
        mono = torch.cat([Y[i, 1:] - Y[i, :-1] for i in range(S)])
        return torch.cat([head, tail, balls, mono])

    xl = np.concatenate([
        np.concatenate([[-INF, 0.0, 1.5], np.full(nx - 3, 0.5)]),
        np.tile(np.concatenate([[0.0], np.full(ny - 1, -INF)]), S),
    ])
    xu = np.full(n, INF)
    xu[2] = 10.0
    cl = np.concatenate([
        [10.0, 5.0], np.full(nx - 3, 1.0),
        np.ones(S), np.zeros(S * (ny - 1)),
    ])
    cu = np.concatenate([
        [10.0, INF], np.full(nx - 3, 2.0 * nx),
        np.full(S, INF), np.full(S * (ny - 1), INF),
    ])
    x0 = np.concatenate([np.zeros(nx), np.tile(np.linspace(0.1, 1.0, ny), S)])
    return AutoDiffNlpProblem(f=f, c=cons, xl=xl, xu=xu, cl=cl, cu=cu, x0=x0)


def solve(nx: int = 20, nS: int = 5, S: int = 5, **opts):
    o = NlpOptions()
    o.update(Hessian="analytical_exact", verbosity_level=0)
    o.update(**opts)
    nlp = NlpDenseConstraints(build_problem(nx, nS, S), o)
    return FilterIPMNewton(nlp).run()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")]
    nx = int(pos[0]) if pos else 20
    S = int(pos[1]) if len(pos) > 1 else 5
    extra = dict(compute_mode="cpu") if "-cpu" in argv else {}
    r = solve(nx, 5, S, **extra)
    print(f"Objective: {r.obj:.12e} status {r.status.name} iters {r.iterations}")
    if "-selfcheck" in argv:
        from hiop_tpu_torch.examples.pridec_ex2 import SELFCHECK_OBJ

        if not r.status.is_success or abs(r.obj - SELFCHECK_OBJ) > 1e-4:
            print(f"selfcheck FAILED: extensive form {r.obj} vs PriDec {SELFCHECK_OBJ}")
            return 1
        print("selfcheck OK (matches the PriDec decomposition)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
