"""The readings that a cell's limits are set from (not run by the
benchmark's own runs).

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 [--fresh] [--requests k]
                                   [--fault name[=value]]

In one process (one set-up), for each seed it serves the first ``k``
requests of the seed's stream through the cell's entry, as a run's window
does, and reads every certificate number twice over the answers that claim
success:

- ``sound``: the program's answers as they are;
- ``control``: the same answers rounded to float32, the best that a
  computation in the nearest precision below the configuration's float64
  could hand back.

``--fresh`` draws every request's snapshot from its seed and index instead
of serving the mix's fixed pool, so that the readings span the inputs and
not one pool. ``--fault`` plants one of :mod:`portbench.faults` first: the
answers are then the fault's, read as they are (``fault``). It prints one
line per seed and, last, a JSON object: the lower reading of each number
(the largest sound one), the upper (the smallest control one), or with
``--fault`` the smallest reading of the fault's answers.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import sys
import time

from portbench import device, faults, judge, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--requests", type=int, default=1)
    p.add_argument("--fresh", action="store_true")
    p.add_argument("--fault", help="plant a fault of portbench.faults (name or name=value)")
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--set", action="append", default=[])
    args = p.parse_args(argv)
    try:
        cell, dev, grid = run.prepare(args)
    except device.NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    with faults.plant(args.fault, cell.entry) if args.fault else contextlib.nullcontext():
        return _read(args, cell, dev, grid)


def _read(args, cell, dev: str, grid: dict) -> int:
    run.warm_up(cell, dev, grid)
    mine, control = {}, {}
    first = "fault" if args.fault else "sound"
    for seed in (int(s) for s in args.seeds.split(",")):
        reqs = run.stream(cell).requests(cell.traffic, grid, cell.reference, seed, fresh=args.fresh)
        answers, t0 = [], time.perf_counter()
        for req in itertools.islice(reqs, args.requests):
            answers += cell.entry.serve(cell.config, req, dev).answers
        seconds = time.perf_counter() - t0
        answers = judge.host_answers(answers)
        s = judge.numbers(answers, grid, cell.reference)
        c = judge.numbers(answers, grid, cell.reference, rounding=judge.as_float32)
        for k, v in s.items():
            mine[k] = (min if args.fault else max)(mine.get(k, v), v)
        for k, v in c.items():
            control[k] = min(control.get(k, float("inf")), v)
        statuses = [a.status for a in answers]
        print(json.dumps({"seed": seed, "seconds": seconds, "ok": sum(a.ok for a in answers),
                          "answers": len(answers), first: s, "control": c,
                          "failed": sorted(set(statuses) - {"Solve_Success"})}), flush=True)
    if device.forbidden_loaded():
        print(f"portbench: JAX loaded: {device.forbidden_loaded()}", file=sys.stderr)
        return 3
    summary = {"workload": args.workload, "fresh": args.fresh}
    if args.fault:
        summary.update(fault=args.fault, lowest=mine)
    else:
        summary.update(lower=mine, upper=control)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
