"""Faults planted underneath the timed path. ``calibrate.py --fault`` reads
the numbers that decide ``correct`` with one planted, on the card at a
cell's own size; the tests drive whole runs with one planted and see
``correct`` come out false. The benchmark's own runs never plant one.

    with faults.plant("cost_gradient=0.01"):
        ...

An entry may hold the faults of its own path, in a dict ``FAULTS`` of the
same kind (``entries/dense_solve.py``); :func:`plant` given such an entry
plants one of those. The faults here break the batched screening solve
(``entries/acopf_screen.py``), each in one way, where the answer is
produced:

- ``unchanged``: a solve that returns its state unchanged, every lane's
  starting point claimed as its solution;
- ``half``: half of a family left out, the first half's answers standing
  in for the rest;
- ``altered_lane``: one entry of every lane's answer moved by 1e-3;
- ``cost_gradient``: the generators' linear cost taken ``1 + rel`` times
  too large in the gradient (``rel`` 0.01 unless given), the objective
  left right: the solve ends feasible and stationary in the variables
  without bounds, and reports the objective of its point, at a dispatch
  that is not optimal.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch


@contextmanager
def _patch(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def unchanged(_=None):
    from hiop_tpu_torch.optimization import batch_solve

    orig = batch_solve.solve_batched

    def solve(pnlp, params):
        res = orig(pnlp, params)
        x0 = torch.as_tensor(np.asarray(pnlp._p.get_starting_point(), dtype=np.float64))
        x = x0.to(res.x).expand_as(res.x).clone()
        return res._replace(x=x, yc=torch.zeros_like(res.yc))

    return _patch(batch_solve, "solve_batched", solve)


def half(_=None):
    from hiop_tpu_torch.optimization import batch_solve

    orig = batch_solve.solve_batched

    def solve(pnlp, params):
        S = len(params["gv"])
        h = S // 2
        res = orig(pnlp, {k: v[:h] for k, v in params.items()})
        idx = [i % h for i in range(S)]
        return batch_solve.BatchResult(
            status=res.status[idx], x=res.x[idx], obj=res.obj[idx],
            iterations=res.iterations[idx], err_nlp=res.err_nlp[idx],
            yc=res.yc[idx], yd=res.yd[idx])

    return _patch(batch_solve, "solve_batched", solve)


def altered_lane(_=None):
    from hiop_tpu_torch.optimization import batch_solve

    orig = batch_solve.solve_batched

    def solve(pnlp, params):
        res = orig(pnlp, params)
        x = res.x.clone()
        x[:, 3] += 1e-3
        return res._replace(x=x)

    return _patch(batch_solve, "solve_batched", solve)


def cost_gradient(rel=None):
    from hiop_tpu_torch.examples import acopf_mds

    scale = 1.0 + (0.01 if rel is None else float(rel))

    def grad_dense(self, g):
        t = self.t(g)
        return t["Q"] @ g + scale * t["c"]

    return _patch(acopf_mds._AcopfCore, "grad_dense", grad_dense)


FAULTS = {f.__name__: f for f in (unchanged, half, altered_lane, cost_gradient)}


def plant(spec: str, entry=None):
    """The context manager of the fault ``name`` or ``name=value``, of the
    entry's own ``FAULTS`` where it has them, else of this module's."""
    name, _, value = spec.partition("=")
    found = getattr(entry, "FAULTS", FAULTS)
    if name not in found:
        raise KeyError(f"no fault {name!r} (have {sorted(found)})")
    return found[name](value or None)
