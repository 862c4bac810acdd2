"""PriDec example 2 — a two-stage program with NLP recourse solves
(reference NlpPriDecEx2Sparse.*, NlpPriDecEx2UserBasecase.hpp,
NlpPriDecEx2UserRecourseSparse.hpp), with its evaluations in torch on the
solver's device.

Counterpart of ``examples/pridec_ex2.py``::

  basecase: the SparseEx1 NLP (n = nx, scal = 1)
  recourse: r_i(x) = min_y 0.5 ||y - x||^2  s.t.
              (1 - y_1 + xi_1)^2 + sum_{k=2..nS} (y_k + xi_k)^2
                                 + sum_{k>nS} y_k^2 >= 1
              y_k - y_{k-1} >= 0 (k = 2..ny),  y_1 >= 0
            with xi = 1 (the reference sets the samples to 1.0), ny = nx
  grad r_i = x - y*   (envelope theorem; eval_grad_rterm)

:class:`PriDecEx2` solves each scenario's recourse NLP on its own (the
host loop); :class:`PriDecEx2Batched` solves them all as one lane-batched
solve (:mod:`hiop_tpu_torch.optimization.batch_solve`), with per-scenario
samples ``xis``. Self-check (NlpPriDecEx2SparseDriver.cpp:173): nx=20,
S=5 -> master objective 0.2633379371706 (abs tol 1e-5).

Run: ``python -m hiop_tpu_torch.examples.pridec_ex2 20 5 -selfcheck``
(on cuda:0; add ``-cpu`` for the CPU, ``-batched`` for the batched
recourse).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

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

SELFCHECK_OBJ = 0.2633379371706  # nx=20, S=5, abs tol 1e-5


def _basecase_f(x, evaluator=None):
    f = 0.25 * torch.sum((x - 1.0) ** 4)
    if evaluator is not None:
        f = f + evaluator.eval_f(x)
    return f


def _basecase_cons(x):
    head = torch.stack([4 * x[0] + 2 * x[1], 2 * x[0] + x[2]])
    tail = 2 * x[0] + 0.5 * x[3:]
    return torch.cat([head, tail])


def _ball(y, xi, nS):
    """The recourse's ball constraint, a (1,) tensor."""
    t1 = (1.0 - y[0] + xi[0]) ** 2
    t2 = torch.sum((y[1:nS] + xi[1:]) ** 2)
    t3 = torch.sum(y[nS:] ** 2)
    return (t1 + t2 + t3)[None]


def _recourse_bounds(ny: int):
    """(xl, xu, cl, cu) of the recourse NLP."""
    xl = np.full(ny, -INF)
    xl[0] = 0.0
    cl = np.concatenate([[1.0], np.zeros(ny - 1)])
    return xl, np.full(ny, INF), cl, np.full(ny, INF)


class PriDecEx2(PriDecProblem):
    batched = False  # scenarios are NLP solves; host loop

    def __init__(self, nx: int = 20, nS: int = 5, S: int = 5, compute_mode: str = "auto"):
        self.nx = nx
        self.ny = nx
        self.nS = nS
        self.S = S
        self.xi = np.ones(nS)
        self.compute_mode = compute_mode
        self.device = resolve_device(compute_mode)

    def get_num_rterms(self):
        return self.S

    def get_num_vars(self):
        return self.nx

    def _options(self, **kw) -> NlpOptions:
        o = NlpOptions()
        o.update(Hessian="analytical_exact", verbosity_level=0,
                 compute_mode=self.compute_mode, **kw)
        return o

    # ---- master (basecase + quadratic recourse model) ---------------------
    def solve_master(self, x, include_r, evaluator=None):
        n = self.nx
        xl = 0.5 * np.ones(n)
        xu = INF * np.ones(n)
        xl[0] = -INF
        xl[1] = 0.0
        xl[2], xu[2] = 1.5, 10.0
        cl = np.concatenate([[10.0, 5.0], np.full(max(n - 3, 0), 1.0)])
        cu = np.concatenate([[10.0, INF], np.full(max(n - 3, 0), 2.0 * n)])
        ev = evaluator if include_r else None
        p = AutoDiffNlpProblem(
            f=lambda z: _basecase_f(z, ev),
            c=_basecase_cons,
            xl=xl, xu=xu, cl=cl, cu=cu, x0=np.asarray(x),
        )
        r = FilterIPMNewton(NlpDenseConstraints(p, self._options())).run()
        return r.x, r.obj

    # ---- recourse NLP per scenario ----------------------------------------
    def _solve_recourse(self, x):
        ny, nS = self.ny, self.nS
        xt = torch.as_tensor(np.asarray(x, np.float64), device=self.device)
        xi = torch.as_tensor(self.xi, dtype=torch.float64, device=self.device)

        def cons(y):
            return torch.cat([_ball(y, xi, nS), y[1:] - y[:-1]])

        xl, xu, cl, cu = _recourse_bounds(ny)
        p = AutoDiffNlpProblem(
            f=lambda y: 0.5 * torch.sum((y - xt) ** 2),
            c=cons,
            xl=xl, xu=xu, cl=cl, cu=cu,
            x0=np.maximum(np.asarray(x), 0.0),
        )
        return FilterIPMNewton(NlpDenseConstraints(p, self._options(tolerance=1e-10))).run()

    def eval_f_rterm(self, idx, x):
        return self._solve_recourse(x).obj

    def eval_grad_rterm(self, idx, x):
        y_star = np.asarray(self._solve_recourse(x).x)
        return np.asarray(x) - y_star


class PriDecEx2Batched(PriDecEx2):
    """Ex2 with the recourse NLP solves batched: all S scenario
    interior-point solves advance in lockstep as one lane-batched solve
    (:func:`hiop_tpu_torch.optimization.batch_solve.solve_batched`), the
    counterpart of the reference's one-CPU-solve-per-MPI-worker pattern
    (hiopAlgPrimalDecomp.cpp:1017+). Takes per-scenario samples ``xis`` of
    shape (S, nS) (the reference fixes xi = 1 for every scenario)."""

    batched = True

    def __init__(self, nx: int = 20, nS: int = 5, S: int = 5, xis=None,
                 compute_mode: str = "auto"):
        super().__init__(nx, nS, S, compute_mode)
        self.xis = (
            np.tile(self.xi, (S, 1)) if xis is None else np.asarray(xis, np.float64)
        )
        assert self.xis.shape == (S, nS)
        from hiop_tpu_torch.optimization.batch_solve import ParametricDenseNlp

        ny = self.ny

        def f(y, th):
            x, _xi = th
            return 0.5 * torch.sum((y - x) ** 2)

        def c(y, th):
            _x, xi = th
            return torch.cat([_ball(y, xi, nS), y[1:] - y[:-1]])

        xl, xu, cl, cu = _recourse_bounds(ny)
        self._pnlp = ParametricDenseNlp(
            f, c, xl=xl, xu=xu, cl=cl, cu=cu, x0=np.zeros(ny),
            th0=(np.zeros(self.nx), self.xis[0]),
            options=self._options(tolerance=1e-10),
            x0_of_th=lambda th: torch.clamp(th[0], min=0.0),
        )

    def eval_rterms_batched(self, idxs, x):
        from hiop_tpu_torch.optimization.batch_solve import solve_batched

        idxs = np.asarray(idxs)
        xs = np.tile(np.asarray(x, np.float64), (idxs.size, 1))
        res = solve_batched(self._pnlp, (xs, self.xis[idxs]))
        grads = torch.as_tensor(xs, device=res.x.device) - res.x  # envelope theorem
        return res.obj, grads


def solve(nx: int = 20, nS: int = 5, S: int = 5, batched: bool = False,
          compute_mode: str = "auto", **opts):
    o = PriDecOptions()
    o.update(**opts)
    cls = PriDecEx2Batched if batched else PriDecEx2
    return PriDecSolver(cls(nx, nS, S, compute_mode=compute_mode), o)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")]
    nx = int(pos[0]) if pos else 20
    S = int(pos[1]) if len(pos) > 1 else 5
    solver = solve(nx, 5, S, batched="-batched" in argv,
                   compute_mode="cpu" if "-cpu" in argv else "auto")
    r = solver.run()
    print(f"Objective: {r.obj:.12e} status {r.status.name} iters {r.iterations}")
    if "-selfcheck" in argv:
        if abs(r.obj - SELFCHECK_OBJ) > 1e-5:
            print(f"selfcheck FAILED: obj {r.obj} vs saved {SELFCHECK_OBJ}")
            return 1
        print("selfcheck OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
