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
  wall, and the kernels that take the most device time;
- ``mp``: ACOPF B=512 with ``kkt_fact_dtype=float32`` toward convergence,
  stopped at ``MP_MAX_ITER`` iterations or after ``MP_WALL_S`` seconds
  (status User_Stopped), whichever comes first: the factorization slot
  and dtype that started each iteration, s/iter by slot, the f32
  fraction, the demotions of f32 with the iteration of each, the inner
  FGMRES iterations and the kernel ms by kernel and dtype;
- ``dense``: the dense-constrained path: the quasi-Newton ``dense_ex1`` at
  n = ``chip_smoke.QN_N`` and the exact-Newton DenseConsEx2 (through
  ``AutoDiffNlpProblem``) at n = 5000 and 10000 on the quick tier, after
  the cold and warm times of a fresh process's first Hessian, Cholesky
  kernel and triangular solve at n = 5000. For each solve: the cold wall
  (the first at its shapes), iterations, s/iter, kernel ms per iteration,
  host synchronizations per iteration (``.item()``, ``.tolist()``,
  ``bool``/``float``/``int`` of a CUDA tensor, ``.cpu()``), the device's
  busy time under ``torch.profiler`` and its idle share of the unprofiled
  wall, and for Newton the time and extra memory of one
  ``torch.func.hessian``. Says whether the path is kernel- or host-bound.

- ``pridec``: SC-ACOPF PriDec (``examples/acopf_pridec``) at B=32 with 8
  line outages to convergence, against ``hiop_tpu``'s result on the CPU
  (``chip_smoke.PRIDEC_WIDE_REF``): PriDec iterations, the objective, the
  lanes that left the batched solve for a host solve, and the seconds in
  master solves, batched recourse and host recourse. ``chip_smoke.py``
  phase 33 runs the example's driver default (B=16, 4 outages).

``python3 chip_measure.py RUN ...`` runs only the named runs (default:
all, in the order above).

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

#: ACOPF B=512 mixed-precision run: iteration cap and wall budget. The
#: host lu_eig tier costs 6-9 s per iteration at 4710^2, so the budget,
#: not the cap, ends a run that reaches it and stays there
MP_MAX_ITER = 400
MP_WALL_S = 900.0


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
    slot and dtype of its first factorization (``chip_smoke.fact_label``)
    are recorded; returns (log, undo)."""
    from chip_smoke import fact_label

    log = []
    prepare, factorize = fipm._MdsStrategy.prepare, fipm._MdsStrategy._factorize

    def timed_prepare(self, *a, **k):
        torch.cuda.synchronize()
        log.append([time.perf_counter(), None])
        return prepare(self, *a, **k)

    def tagged_factorize(self):
        if log and log[-1][1] is None:
            log[-1][1] = fact_label(self, torch.float32)
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


def _by_tier(log, t_end) -> dict:
    tiers: dict = {}
    for i, (t0, tier) in enumerate(log):
        t1 = log[i + 1][0] if i + 1 < len(log) else t_end
        n, s = tiers.get(tier, (0, 0.0))
        tiers[tier] = (n + 1, s + (t1 - t0))
    return {t: {"iterations": n, "wall_s": s, "s_per_iter": s / n} for t, (n, s) in tiers.items()}


def mp_run(torch, K, acopf_mds) -> dict:
    """ACOPF B=512 with kkt_fact_dtype=float32 until it converges, stops,
    reaches MP_MAX_ITER or spends MP_WALL_S (see the module docstring)."""
    from hiop_tpu_torch import FilterIPMNewton, NlpMDS
    from hiop_tpu_torch.linalg import krylov
    from hiop_tpu_torch.optimization import filter_ipm

    deadline = [0.0]

    class Budgeted(acopf_mds.AcopfMds):
        def iterate_callback(self, info) -> bool:
            return time.perf_counter() < deadline[0]

    log, undo = _tier_timeline(torch, filter_ipm)
    demotions, ir_inner = [], [0]
    demote, fgmres = filter_ipm._mp_demote, krylov.fgmres

    def demoted(strategy, why):
        if strategy._mp_f32_ok:
            demotions.append({"iteration": len(log) - 1, "why": why})
        return demote(strategy, why)

    def counted(*a, **k):
        x, info = fgmres(*a, **k)
        ir_inner[0] += info.iters
        return x, info

    filter_ipm._mp_demote, krylov.fgmres = demoted, counted
    nlp = NlpMDS(Budgeted(512), acopf_mds.acopf_options(
        verbosity_level=0, kkt_fact_dtype="float32", max_iter=MP_MAX_ITER))
    torch.cuda.synchronize()
    K.stats.reset()
    K.stats.timing = True
    t0 = time.perf_counter()
    deadline[0] = t0 + MP_WALL_S
    try:
        r = FilterIPMNewton(nlp).run()
        out = dict(status=r.status.name, iterations=r.iterations, obj=r.obj)
    except NotImplementedError as e:
        out = dict(status=f"NotImplementedError: {e}", iterations=len(log) - 1)
    finally:
        undo()
        filter_ipm._mp_demote, krylov.fgmres = demote, fgmres
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    kms = K.stats.device_ms(by_dtype=True)
    K.stats.timing = False
    kkt = nlp.runstats.kkt
    its = out["iterations"]
    return dict(
        out, max_iter=MP_MAX_ITER, wall_budget_s=MP_WALL_S, wall_s=t_end - t0,
        s_per_iter=(t_end - t0) / its if its else None,
        n_fact_total=kkt.n_fact_total, n_fact_f32=kkt.n_fact_f32,
        f32_fraction=kkt.n_fact_f32 / max(kkt.n_fact_total, 1),
        demotions=demotions, ir_inner_iterations=ir_inner[0],
        tier_by_iteration=[t for _, t in log], tiers=_by_tier(log, t_end),
        kernel_ms={f"{k}:{d}": v for (k, d), v in kms.items()},
        sizes={f"{k[0]}:{k[1]}:{k[2]}": v for k, v in K.stats.sizes.items()})


RUNS = ("ladder", "ldl_only", "host_lu_eig", "b32_host_tier", "profile", "mp", "dense", "pridec")


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
    from chip_smoke import _nvidia_smi
    from hiop_tpu_torch.examples import acopf_mds
    from hiop_tpu_torch.linalg import kernels as K

    runs = [a for a in sys.argv[1:] if a in RUNS] or list(RUNS)
    card = {"kind": torch.cuda.get_device_name(0), "nvidia_smi": _nvidia_smi()}
    K.load()

    from hiop_tpu_torch.optimization import filter_ipm

    if "ladder" in runs:
        log, undo = _tier_timeline(torch, filter_ipm)
        try:
            run = _solve(torch, K, acopf_mds, linear_solver_dense="auto", max_iter=LADDER_MAX_ITER)
        finally:
            undo()
        print(json.dumps({"ladder": dict(
            run, max_iter=LADDER_MAX_ITER, tier_by_iteration=[t for _, t in log],
            tiers=_by_tier(log, time.perf_counter())), "card": card}), flush=True)
    if "ldl_only" in runs:
        ldl_only(torch, K, acopf_mds, card)
    if "host_lu_eig" in runs:
        host_lu_eig(np, sla, card)
    if "b32_host_tier" in runs:
        b32_host_tier(torch, acopf_mds, card)
    if "profile" in runs:
        profile_run(torch, K, acopf_mds, card)
    if "mp" in runs:
        print(json.dumps({"mp": mp_run(torch, K, acopf_mds), "card": card}), flush=True)
    if "dense" in runs:
        dense_run(torch, K, card)
    if "pridec" in runs:
        pridec_run(torch, K, card)
    return 0


def pridec_run(torch, K, card) -> None:
    from chip_smoke import PRIDEC_WIDE_REF
    from hiop_tpu_torch.examples import acopf_pridec

    B, S = PRIDEC_WIDE_REF["B"], PRIDEC_WIDE_REF["S"]
    prob = acopf_pridec.AcopfPriDec(B, S, verbosity=0)
    K.stats.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = acopf_pridec.solve(problem=prob, verbosity_level=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(json.dumps({"pridec": dict(
        B=B, S=S, status=r.status.name, iterations=r.iterations, obj=r.obj,
        rel_diff_hiop_tpu=abs(r.obj - PRIDEC_WIDE_REF["obj"]) / abs(PRIDEC_WIDE_REF["obj"]),
        hiop_tpu=PRIDEC_WIDE_REF, wall_s=wall, seconds=prob.seconds,
        batched_evaluations=prob.n_evals, host_fallbacks=prob.host_fallbacks,
        launches=dict(K.stats.launches),
        batched_launches={f"{k[0]}:{k[1]}:{k[2]}:{k[3]}": v for k, v in K.stats.batches.items()},
    ), "card": card}), flush=True)


def _dense_case(torch, K, run) -> dict:
    """One solve four times: cold (the first in the process at its shapes),
    timed warm (kernel events on), counting host synchronizations, and
    under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    K.stats.reset()
    K.stats.timing = True
    t0 = time.perf_counter()
    r = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kms = K.stats.device_ms()
    K.stats.timing = False
    sizes = {f"{k[0]}:{k[1]}:{k[2]}": v for k, v in sorted(K.stats.sizes.items())}
    its = max(r.iterations, 1)
    from chip_smoke import _count_syncs

    with _count_syncs(torch) as counts:
        r2 = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
    return {
        "status": r.status.name, "iterations": r.iterations, "obj": r.obj, "cold_wall_s": cold, "wall_s": wall,
        "s_per_iter": wall / its, "kernel_ms_per_iter": {k: v / its for k, v in kms.items()},
        "launches": sizes, "syncs_per_iter": counts["syncs"] / max(r2.iterations, 1),
        "device_busy_ms": busy_us / 1e3, "idle_share": 1.0 - busy_us / 1e3 / (wall * 1e3),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


def dense_run(torch, K, card) -> None:
    from chip_smoke import QN_N
    from hiop_tpu_torch.examples import dense_ex1, dense_ex2

    # the first calls in the process, each timed alone and in this order: f
    # itself, its gradient, a vmap, the Hessian of f and of the Lagrangian
    # (torch.func), the Cholesky kernel at n^2 (its CUDA graph is captured
    # at the first call) and the triangular solves (cuSOLVER)
    dev = torch.device("cuda", 0)
    n0 = 5000
    p = dense_ex2.autodiff_problem(n0, dev)
    x = torch.full((n0,), 1.1, dtype=torch.float64, device=dev)
    lam = torch.ones(4, dtype=torch.float64, device=dev)
    first = {}

    def first_call(name, fn):
        for key in ("cold_ms", "warm_ms"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            first.setdefault(name, {})[key] = (time.perf_counter() - t0) * 1e3
        return out

    from hiop_tpu_torch.linalg.cholesky import cholesky

    f = lambda v: 0.25 * torch.sum((v - 1.0) ** 4)  # noqa: E731
    first_call("elementwise f", lambda: f(x))
    first_call("torch.func.grad", lambda: torch.func.grad(f)(x))
    first_call("torch.func.vmap", lambda: torch.func.vmap(lambda v: v * x)(x[:64, None].expand(64, n0)))
    first_call("torch.func.hessian of f", lambda: torch.func.hessian(f)(x))
    H = first_call("hessian", lambda: p.eval_hess_lagr(x, 1.0, lam)).contiguous()
    H.diagonal().add_(1.0)
    L = first_call("cholesky kernel", lambda: cholesky(H))
    first_call("cholesky_solve", lambda: torch.cholesky_solve(torch.ones(n0, 5, dtype=H.dtype, device=dev), L))
    del H, L
    out = {"first calls at n=%d" % n0: first}
    out["qn dense_ex1 n=%d" % QN_N] = _dense_case(
        torch, K, lambda: dense_ex1.solve(QN_N, verbosity_level=0))
    for n in (5000, 10000):
        case = _dense_case(torch, K, lambda: dense_ex2.solve_newton(n, verbosity_level=0))
        p = dense_ex2.autodiff_problem(n, dev)
        x = torch.full((n,), 1.1, dtype=torch.float64, device=dev)
        lam = torch.ones(4, dtype=torch.float64, device=dev)
        p.eval_hess_lagr(x, 1.0, lam)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            p.eval_hess_lagr(x, 1.0, lam)
        torch.cuda.synchronize()
        case["hessian_ms"] = (time.perf_counter() - t0) * 1e3 / 3
        case["hessian_extra_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        out["newton dense_ex2 n=%d" % n] = case
    print(json.dumps({"dense": out, "card": card}), flush=True)


def ldl_only(torch, K, acopf_mds, card) -> None:
    twice = [_solve(torch, K, acopf_mds, linear_solver_dense="ldl_nopiv") for _ in range(2)]
    same = all(twice[0].get(k) == twice[1].get(k) for k in ("status", "iterations", "obj", "launches"))
    print(json.dumps({"ldl_only": twice, "two_runs_identical": same,
                      "saved_obj": acopf_mds.SELFCHECK[512][0], "card": card}), flush=True)


def host_lu_eig(np, sla, card) -> None:
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


def b32_host_tier(torch, acopf_mds, card) -> None:
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


def profile_run(torch, K, acopf_mds, card) -> None:
    from chip_smoke import B512_MAX_ITER
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


if __name__ == "__main__":
    sys.exit(main())
