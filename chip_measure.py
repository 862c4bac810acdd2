#!/usr/bin/env python3
"""Measurements of ``hiop_tpu_torch`` on one CUDA card beyond the smoke run.

Run from the root of a checkout: ``python3 chip_measure.py``. Prints one
JSON object per line:

- ``ladder``: ACOPF B=512 on the main path (``linear_solver_dense=auto``)
  capped at 8 and at 16 iterations. The first 8 run the quick tier and the
  device LDL^T tier; iterations 9-16 run the host ``lu_eig`` tier, so the
  difference of the two walls over 8 is that tier's cost per iteration;
- ``ldl_only``: ACOPF B=512 with ``linear_solver_dense=ldl_nopiv`` (the
  device LDL^T as the only safe tier) until it stops, twice, and whether
  the two runs are identical (status, iterations, objective bits, launches);
- ``host_lu_eig``: the host tier's two scipy/numpy calls alone, at the
  saddle sizes of B=32 and B=512;
- ``b32_host_tier``: ACOPF B=32 on the main path to convergence, with the
  calls and seconds of its host ``lu_eig`` factorizations;
- ``profile``: the capped main-path run under ``torch.profiler``: the
  device's busy time (summed kernel durations), its idle share of the
  wall, and the kernels that take the most device time.

Every timed solve ends in ``torch.cuda.synchronize()``; kernel times are
summed CUDA events around each launch. Imports nothing of JAX or of
``hiop_tpu``.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _solve(torch, K, acopf_mds, **opts):
    """One B=512 solve; a path the port does not have yet (feasibility
    restoration) ends the run and is reported as its status."""
    torch.cuda.synchronize()
    K.stats.reset()
    K.stats.timing = True
    t0 = time.perf_counter()
    try:
        r = acopf_mds.solve(512, verbosity_level=0, **opts)
        out = dict(status=r.status.name, iterations=r.iterations, obj=r.obj)
    except NotImplementedError as e:
        out = dict(status=f"NotImplementedError: {e}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kms = K.stats.device_ms()
    K.stats.timing = False
    its = out.get("iterations", 0)
    return dict(out, wall_s=wall, s_per_iter=wall / its if its else None, kernel_ms=kms,
                launches=dict(K.stats.launches),
                sizes={f"{k[0]}:{k[1]}:{k[2]}": v for k, v in K.stats.sizes.items()})


def main() -> int:
    import numpy as np
    import scipy.linalg as sla
    import torch

    if not torch.cuda.is_available():
        print("chip_measure: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import _nvidia_smi
    from hiop_tpu_torch.examples import acopf_mds
    from hiop_tpu_torch.linalg import kernels as K

    card = {"kind": torch.cuda.get_device_name(0), "nvidia_smi": _nvidia_smi()}
    K.load()

    runs = {n: _solve(torch, K, acopf_mds, linear_solver_dense="auto", max_iter=n) for n in (8, 16)}
    tier = (runs[16]["wall_s"] - runs[8]["wall_s"]) / max(runs[16]["iterations"] - runs[8]["iterations"], 1)
    print(json.dumps({"ladder": runs, "lu_eig_tier_s_per_iter": tier, "card": card}), flush=True)

    twice = [_solve(torch, K, acopf_mds, linear_solver_dense="ldl_nopiv") for _ in range(2)]
    same = all(twice[0].get(k) == twice[1].get(k) for k in ("status", "iterations", "obj", "launches"))
    print(json.dumps({"ldl_only": twice, "two_runs_identical": same,
                      "saved_obj": acopf_mds.SELFCHECK[512][0], "card": card}), flush=True)

    rng = np.random.default_rng(0)
    host = {}
    for n in (294, 4710):
        A = rng.standard_normal((n, n))
        A = A + A.T
        t0 = time.perf_counter()
        sla.lu_factor(A)
        t1 = time.perf_counter()
        np.linalg.eigvalsh(A)
        host[n] = {"lu_factor_s": t1 - t0, "eigvalsh_s": time.perf_counter() - t1}
    print(json.dumps({"host_lu_eig": host, "cpu_count": os.cpu_count(), "card": card}), flush=True)

    from hiop_tpu_torch.kkt import mds as kkt_mds

    lu_eig, calls = kkt_mds._lu_with_inertia, []

    def timed_lu_eig(*a):
        t0 = time.perf_counter()
        out = lu_eig(*a)
        calls.append(time.perf_counter() - t0)
        return out

    kkt_mds._lu_with_inertia = timed_lu_eig
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = acopf_mds.solve(32, verbosity_level=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        kkt_mds._lu_with_inertia = lu_eig
    print(json.dumps({"b32_host_tier": {
        "status": r.status.name, "iterations": r.iterations, "wall_s": wall,
        "lu_eig_calls": len(calls), "lu_eig_s": sum(calls)}, "card": card}), flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = _solve(torch, K, acopf_mds, linear_solver_dense="auto", max_iter=8)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    print(json.dumps({"profile": {
        "run": run, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (run["wall_s"] * 1e3),
        "top": [{"kernel": k[:90], "launches": n, "ms": us / 1e3} for k, (n, us) in top]},
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
