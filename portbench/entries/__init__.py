"""The entries: how a request of a traffic mix reaches the program.

An entry module has ``grid(config, reference)``, the instance that both the
program and the reference are given, and ``serve(config, request, device,
**changes)``, which runs one request through the program's entry point,
with the configuration's options updated by ``changes`` (a warm-up's), and
returns its :class:`Served`.

An entry whose instance is not a grid snapshot also defines
``warmup(traffic, grid, reference)`` and ``requests(traffic, grid,
reference, seed, fresh=False)``, with :mod:`portbench.traffic`'s
signatures; the harness then takes its requests from the entry
(``run.stream``). It may hold the faults of its own path in a dict
``FAULTS`` (:mod:`portbench.faults`).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Answer:
    """One solve's or one lane's answer, as the program reports it."""
    status: str
    ok: bool                # the status is Solve_Success
    x: object               # primal point (tensor or array)
    y: object               # equality multipliers (tensor or array)
    obj: float              # the objective the program reports
    line: int               # the line out (-1: none)
    p_load: object          # the snapshot's loads


@dataclass
class Served:
    answers: list
    iterations: int         # outer iterations (a family: trips of its batched loop)
