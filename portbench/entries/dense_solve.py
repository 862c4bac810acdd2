"""One dense exact-Newton solve per request: HiOp's ``NlpDenseConsEx2`` at
the configuration's n, from x0 = 0, through the port's general filter-IPM
loop.

The entry the window drives is ``dense_ex2.solve_newton``'s own path:
``dense_ex2.autodiff_problem`` (f and c in torch, their derivatives and the
dense n x n Lagrangian Hessian from ``torch.func``) under
``NlpDenseConstraints`` and ``FilterIPMNewton(...).run()``, with the
configuration's options. The multipliers come from the problem's
``solution_callback``, which the formulation calls at the end of the solve
with the scaled (yc, yd); the formulation's own ``_lam_user_order`` puts
them into the constraints' order, and the objective's scale is taken off,
so that they are the multipliers of f + lam'c.

The problem has no data to draw: every request is the same instance, and
the seed orders nothing. This entry owns its request stream (``warmup``,
``requests``), which the harness takes in place of
:mod:`portbench.traffic`'s grid snapshots.

:data:`FAULTS` are the ways ``calibrate.py --fault`` and the tests break
the program underneath this entry (:mod:`portbench.faults`).
"""

from __future__ import annotations

import numpy as np

from hiop_tpu_torch import FilterIPMNewton, NlpDenseConstraints, NlpOptions
from hiop_tpu_torch.backends.execspace import resolve_device
from hiop_tpu_torch.examples import dense_ex2
from hiop_tpu_torch.interface.base import AutoDiffNlpProblem
from hiop_tpu_torch.status import SolveStatus

from portbench.entries import Answer, Served
from portbench.faults import _patch
from portbench.traffic import Request


def grid(config: dict, reference) -> dict:
    """The instance both sides are given: its size. The port's Jacobian and
    bounds are checked against the reference's own."""
    n = int(config["n"])
    port = dict(zip(("xl", "xu", "cl", "cu"), dense_ex2.ex2_bounds(n)), J=dense_ex2.ex2_jacobian(n))
    ref = dict(zip(("xl", "xu", "cl", "cu"), reference.bounds(n)), J=reference.jacobian(n))
    for k, v in port.items():
        v = np.where(np.abs(v) >= reference.INF, np.sign(v) * np.inf, v)
        if not (v.shape == ref[k].shape and (v == ref[k]).all()):
            raise RuntimeError(f"the port's problem differs from the reference's in {k}")
    return {"n": n}


def warmup(traffic: dict, grid: dict, reference) -> Request:
    """The warm-up request: the instance itself."""
    return Request(-1, -1, None, [-1])


def requests(traffic: dict, grid: dict, reference, seed: int, fresh: bool = False):
    """The endless stream of requests of ``seed``: the same instance each
    time, whatever the seed (``fresh`` has nothing to draw either)."""
    k = 0
    while True:
        yield Request(k, -1, None, [-1])
        k += 1


def serve(config: dict, request, device: str, **changes) -> Served:
    opts = NlpOptions()
    opts.update(**dict(config["options"], **changes))
    if device == "cpu":
        opts.update(compute_mode="cpu")
    problem = dense_ex2.autodiff_problem(int(config["n"]), resolve_device(opts.str_("compute_mode")))
    got: dict = {}
    problem.solution_callback = lambda status, x, zl, zu, g, lam, obj: got.update(lam=lam)
    nlp = NlpDenseConstraints(problem, opts)
    res = FilterIPMNewton(nlp).run()
    lam = nlp._lam_user_order(*got["lam"]) / nlp.scale_obj if "lam" in got else None
    ok = res.status == SolveStatus.Solve_Success
    return Served([Answer(res.status.name, ok, res.x, lam, float(res.obj), -1, None)],
                  iterations=int(res.iterations))


# -- faults planted underneath this entry (portbench.faults)

def unchanged(_=None):
    """A solve that returns its state unchanged: the starting point claimed
    as the solution."""
    orig = FilterIPMNewton.run

    def run(self):
        res = orig(self)
        res.x = np.zeros_like(res.x)
        return res

    return _patch(FilterIPMNewton, "run", run)


def altered(_=None):
    """The answer altered where it is produced: one entry of x moved by
    1e-3."""
    orig = FilterIPMNewton.run

    def run(self):
        res = orig(self)
        res.x = res.x.copy()
        res.x[3] += 1e-3
        return res

    return _patch(FilterIPMNewton, "run", run)


def grad_f(spec=None):
    """A 1 % error in the gradient that reaches the solver, f left right:
    ``spec`` ``rel`` or ``rel@i`` (0.01 at entry 0 unless given) adds rel
    times the gradient's largest entry to its entry i, so that
    ||error||_inf = abs(rel) ||grad f||_inf. At the free x_1 (i = 0) the
    solve ends Solve_Success with x_1 about 0.1 off, which the residual at
    x_1 shows (``stat``); at x_4 with rel < 0 (i = 3, bounded below only,
    not active) x_4 ends about 0.1 above where it belongs, and the
    multiplier its bound would need shows as a complementarity product
    (``comp``). (A gradient taken 1 + rel times too large in every entry is
    no such fault: it is the gradient of (1 + rel) f, whose minimiser is
    the same, and the answer stays right.)"""
    orig = AutoDiffNlpProblem.eval_grad_f
    rel, _, at = (spec or "0.01").partition("@")
    rel, at = float(rel), int(at or 0)

    def eval_grad_f(self, x):
        g = orig(self, x).clone()
        g[at] += rel * g.abs().max()
        return g

    return _patch(AutoDiffNlpProblem, "eval_grad_f", eval_grad_f)


FAULTS = {f.__name__: f for f in (unchanged, altered, grad_f)}
