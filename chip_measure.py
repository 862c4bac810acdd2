#!/usr/bin/env python3
"""Measurements of ``hiop_tpu_torch`` on one CUDA card beyond the smoke run.

Run from the root of a checkout: ``python3 chip_measure.py``. Prints one
JSON object per line:

- ``ladder``: ACOPF B=512 on the main path (``linear_solver_dense=auto``,
  the card's ladder with the native ``schur_sparse_ldl`` tier first) capped
  at ``LADDER_MAX_ITER`` iterations: iterations, s/iter, and for each tier
  (quick, schur_sparse_ldl, ldl_nopiv, lu_eig) the iterations that started
  on it and their wall time;
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

``python3 chip_measure.py --breakdown ROOT`` prints one ``breakdown`` line
instead: the device time of one Cholesky at 4608^2 and one no-pivot LDL^T
at 4736^2 (f64, the main path's largest shapes) split by ``torch.profiler``
into diagonal-block, panel, trailing-update and other kernels, and the gaps
between them (CUDA-event wall minus the kernels' summed time), for the
kernels of the checkout at ROOT. Run it on two checkouts in one call to
compare two versions of the kernels on one card.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: ACOPF B=512 ladder run: iteration cap. On the card's ladder, iterations
#: 0-3 run the quick tier, 4-7 schur_sparse_ldl, 8-11 the device LDL^T and
#: 12 on the host lu_eig tier (chip_smoke.B512_MAX_ITER), which costs
#: seconds per iteration at 4710^2: 16 iterations measure every tier
LADDER_MAX_ITER = 16


def _part(name: str) -> str:
    """The part of a blocked factorization that a kernel name belongs to."""
    if "diag_factor" in name:
        return "diag"
    if "panel" in name:
        return "panel"
    if "update" in name:
        return "trailing"
    return "other"


def breakdown(root: str) -> dict:
    """Per-part device time of the f64 factorizations at the main path's
    largest shapes, for the kernels of the checkout at ``root``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.abspath(root))
    from chip_smoke import _saddle, _spd
    from hiop_tpu_torch.linalg import cholesky as chol
    from hiop_tpu_torch.linalg import kernels as K
    from hiop_tpu_torch.linalg import ldl_blocked as ldl

    K.load()
    dev = torch.device("cuda", 0)
    reps = 5
    out = {"root": root}
    A = _spd(torch, 4608, 4608, torch.float64, dev)
    M = ldl._pad_sym(_saddle(torch, 4710, 4710, torch.float64, dev)[0], 4736)
    for name, fn in (("cholesky", lambda: chol.cholesky(A)), ("ldl_nopiv", lambda: ldl.ldl_nopiv(M))):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        wall_ms = start.elapsed_time(end) / reps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        parts: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                p = _part(e.name)
                n, us = parts.get(p, (0, 0.0))
                parts[p] = (n + 1, us + e.time_range.elapsed_us())
        busy = sum(us for _, us in parts.values()) / 1e3 / reps
        out[name] = dict(
            n=A.shape[0] if name == "cholesky" else M.shape[0], wall_ms=wall_ms, kernels_ms=busy,
            gaps_ms=wall_ms - busy,
            parts={p: {"launches": n / reps, "ms": us / 1e3 / reps} for p, (n, us) in parts.items()})
    return out


def _tier_timeline(torch, fipm):
    """Patch the MDS strategy so that each iteration's start time and the
    tier of its first factorization are recorded; returns (log, undo)."""
    log = []
    prepare, factorize = fipm._MdsStrategy.prepare, fipm._MdsStrategy._factorize

    def timed_prepare(self, *a, **k):
        torch.cuda.synchronize()
        log.append([time.perf_counter(), None])
        return prepare(self, *a, **k)

    def tagged_factorize(self):
        if log and log[-1][1] is None:
            log[-1][1] = self._safe_tiers[self._safe_mode - 1] if self._safe_mode else "quick"
        return factorize(self)

    fipm._MdsStrategy.prepare, fipm._MdsStrategy._factorize = timed_prepare, tagged_factorize

    def undo():
        fipm._MdsStrategy.prepare, fipm._MdsStrategy._factorize = prepare, factorize

    return log, undo


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
    if len(sys.argv) == 3 and sys.argv[1] == "--breakdown":
        import torch

        if not torch.cuda.is_available():
            print("chip_measure: no CUDA device is visible", file=sys.stderr)
            return 2
        from chip_smoke import _nvidia_smi

        print(json.dumps({"breakdown": breakdown(sys.argv[2]), "card": _nvidia_smi()}), flush=True)
        return 0
    import numpy as np
    import scipy.linalg as sla
    import torch

    if not torch.cuda.is_available():
        print("chip_measure: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import B512_MAX_ITER, _nvidia_smi
    from hiop_tpu_torch.examples import acopf_mds
    from hiop_tpu_torch.linalg import kernels as K

    card = {"kind": torch.cuda.get_device_name(0), "nvidia_smi": _nvidia_smi()}
    K.load()

    from hiop_tpu_torch.optimization import filter_ipm

    log, undo = _tier_timeline(torch, filter_ipm)
    try:
        run = _solve(torch, K, acopf_mds, linear_solver_dense="auto", max_iter=LADDER_MAX_ITER)
    finally:
        undo()
    t_end = time.perf_counter()
    tiers: dict = {}
    for i, (t0, tier) in enumerate(log):
        t1 = log[i + 1][0] if i + 1 < len(log) else t_end
        n, s = tiers.get(tier, (0, 0.0))
        tiers[tier] = (n + 1, s + (t1 - t0))
    print(json.dumps({"ladder": dict(
        run, max_iter=LADDER_MAX_ITER, tier_by_iteration=[t for _, t in log],
        tiers={t: {"iterations": n, "wall_s": s, "s_per_iter": s / n} for t, (n, s) in tiers.items()}),
        "card": card}), flush=True)

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
        run = _solve(torch, K, acopf_mds, linear_solver_dense="auto", max_iter=B512_MAX_ITER)
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
