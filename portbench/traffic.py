"""The grid-snapshot request generator, and the :class:`Request` that
every stream yields. A traffic mix is a file of parameters
(``traffic/<name>.json``) that a generator reads.

This generator serves the configurations that are ACOPF grids. An entry
that serves another kind of instance defines ``warmup`` and ``requests``
of its own, with this module's signatures, and the harness takes those
instead (``run.stream``); its mix still names the entry and the
``factor_kernel`` and holds the warm-up, and the entry reads any other
parameter of it. A field of :class:`Request` that the instance has no use
for is None or -1.

A request here is one load snapshot of the configuration's grid, and the
lines out in each of its lanes: one lane (the basecase) for a dispatch, the
basecase and ring-line outages for a screening family. Parameters of a mix:

- ``entry``: the module under ``entries/`` that hands a request to the
  program;
- ``factor_kernel``: the wrapper of the factorization that the entry's
  path launches (the per-layer readers count and time its launches);
- ``lanes``: lanes per request (1: the basecase alone);
- ``loads``: ``[low, high]``, each bus's load is the grid's times a factor
  drawn uniformly from that range;
- ``pool``, ``pool_seed``: the number of distinct snapshots, drawn once
  from ``pool_seed``; every ``--seed`` serves the same pool, in an order of
  its own, cycled, so that every seed does the same work;
- ``warmup``: the warm-up requests, each at the grid's own loads with its
  iteration cap (``max_iter``), so that set-up reaches every path and size
  the window's requests can.

Each request puts its lanes in an order drawn from the seed and its index.
The same seed gives the same requests. ``fresh=True`` (the calibration's
``--fresh`` alone) draws each request's snapshot from the seed and its
index instead, so that readings span more than the pool.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Request:
    index: int
    snapshot: int           # the pool's snapshot (-1: drawn for this request alone, or none)
    p_load: np.ndarray      # (B,) the snapshot's loads (None: an instance that is no grid)
    lines: list             # the line out in each lane (-1: none)


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([k % 2 ** 63 for k in key]))


def _factors(traffic: dict, rng: np.random.Generator, n_bus: int) -> np.ndarray:
    lo, hi = traffic["loads"]
    return rng.uniform(lo, hi, n_bus)


def lanes(traffic: dict, n_bus: int, reference) -> list:
    """The line out in each lane of every request (one lane: the basecase)."""
    return reference.contingency_lines(n_bus, int(traffic["lanes"]))


def warmup(traffic: dict, grid: dict, reference) -> Request:
    """The warm-up request: the grid's own loads, the mix's lanes. The
    same for every seed, so that set-up does the same work."""
    return Request(-1, -1, np.array(grid["p_load"], dtype=np.float64),
                   lanes(traffic, grid["n_bus"], reference))


def requests(traffic: dict, grid: dict, reference, seed: int, fresh: bool = False):
    """The endless stream of requests of ``seed``."""
    n_bus = grid["n_bus"]
    base = np.asarray(grid["p_load"], dtype=np.float64)
    outs = lanes(traffic, n_bus, reference)
    pool = int(traffic["pool"])
    snaps = [_factors(traffic, _rng(int(traffic["pool_seed"]), j), n_bus) for j in range(pool)]
    order = _rng(seed).permutation(pool)
    k = 0
    while True:
        j = -1 if fresh else int(order[k % pool])
        f = _factors(traffic, _rng(seed, k), n_bus) if fresh else snaps[j]
        lines = [outs[i] for i in _rng(seed, k, 1).permutation(len(outs))]
        yield Request(k, j, base * f, lines)
        k += 1
