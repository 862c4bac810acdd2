#!/usr/bin/env python3
"""Smoke run of ``hiop_tpu_torch`` on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and the CUDA toolkit (``nvcc``); it imports nothing of JAX or of
the ``hiop_tpu`` package. Phases, in order (any failed check raises, and
the script exits nonzero):

1. device: the card's name and power limit;
2. build: compile the hand-written kernels from ``hiop_tpu_torch/csrc``,
   and the native host library (``hiop_tpu_torch/native``, ``g++``), which
   must load: without it the safe ladder loses its ``schur_sparse_ldl``
   tier and no longer follows ``hiop_tpu``'s;
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card, in f64 and f32, at small ragged sizes and at the main path's
   shapes; a second factorization of each main-path matrix must repeat the
   first bit for bit; breakdown semantics; CUDA-event timings beside the
   bound and, where one exists, the one PyTorch call that computes the same
   function;
4. main path, ``mds_ex1`` 400/100 (the options of HiOp's NlpMdsEx1 example):
   Solve_Success at the saved objective, through the Cholesky kernel;
5. main path, ACOPF B=32 to convergence with ``linear_solver_dense=auto``
   (safe ladder: the native bordered sparse LDL^T on the host, the device
   no-pivot LDL^T, host LU): the saved objective, through both kernels and
   at least one ``schur_sparse_ldl`` factorization; prints the safe tiers
   in the order they ran;
6. main path at full width, ACOPF B=512 (S is 4608^2, the saddle 4710^2),
   capped at ``B512_MAX_ITER`` iterations: both kernels at those sizes, a
   finite objective, per-iteration times. ``chip_measure.py`` runs the
   longer B=512 solves.

Each main-path phase sets the launch counts to zero just before the solve
and reads them just after. The last three lines of standard output are the
``kernels`` JSON line, the ``nvidia-smi`` name/power-limit line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks used for the bounds (NVIDIA's data sheet, dense): FP64
#: through the tensor cores (DMMA), FP32 outside them, HBM3 bandwidth
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

#: ACOPF B=512 phase: iteration cap. On the card's ladder with the native
#: library, iterations 0-3 run the quick tier (the Cholesky of S, 4608^2),
#: 4-7 the bordered sparse tier (schur_sparse_ldl, host), 8-11 the device
#: LDL^T (the 4710^2 saddle, padded to 4736^2), and from iteration 12 on the
#: host LU + eigen inertia (lu_eig), seconds per iteration at 4710^2
#: (test_acopf512_card_ladder_native_tiers_match_jax, the same sequence in
#: hiop_tpu and the port on the CPU). The cap stops inside the device
#: LDL^T stretch
B512_MAX_ITER = 10


def _log(*a) -> None:
    print(*a, flush=True)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _bound_ms(n: int, itemsize: int, dtype: str):
    """Least time for an n x n dense factorization: n^3/3 flops at the
    type's peak against reading the input and writing the factor once."""
    t_ops = (n ** 3 / 3.0) / PEAK_FLOPS[dtype] * 1e3
    t_bytes = 2.0 * n * n * itemsize / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _event_ms(torch, fn, reps: int) -> float:
    for _ in range(3):  # the first call captures a kernel's graph; then the clocks ramp
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _spd(torch, n: int, seed: int, dtype, dev):
    g = torch.Generator().manual_seed(seed)
    G = torch.randn(n, n, generator=g, dtype=torch.float64)
    return (G @ G.T / n + torch.eye(n, dtype=torch.float64)).to(dtype).to(dev)


def _saddle(torch, n: int, seed: int, dtype, dev):
    """A random equilibrated saddle [[K_d, J^T], [J, -C]] shaped like
    ``factorize_safe``'s M at the ACOPF ratio n_d : m ~ 1 : 45 (K_d SPD,
    C = J_s K_s^-1 J_s^T + diag), symmetrically row-max scaled."""
    g = torch.Generator().manual_seed(seed)
    nd = max(n // 46, 3)
    m = n - nd
    G = torch.randn(nd, nd, generator=g, dtype=torch.float64)
    Kd = G @ G.T / nd + torch.eye(nd, dtype=torch.float64)
    J = torch.randn(m, nd, generator=g, dtype=torch.float64)
    Js = torch.randn(m, 8, generator=g, dtype=torch.float64)
    C = Js @ Js.T / 8 + torch.diag(torch.rand(m, generator=g, dtype=torch.float64) + 0.1)
    M = torch.cat([torch.cat([Kd, J.T], 1), torch.cat([J, -C], 1)], 0)
    s = 1.0 / M.abs().max(1).values.sqrt()
    return (s[:, None] * M * s[None, :]).to(dtype).to(dev), m


def _rel(torch, a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def phase_kernels(torch, dev):
    from hiop_tpu_torch.linalg import cholesky as chol
    from hiop_tpu_torch.linalg import ldl_blocked as ldl

    rows = {"cholesky": [], "ldl_nopiv": []}
    tol = {torch.float64: 1e-10, torch.float32: 1e-4}
    tol_ldl = {torch.float64: 1e-9, torch.float32: 1e-3}
    for dt in (torch.float64, torch.float32):
        dname = str(dt).replace("torch.", "")
        itemsize = torch.empty((), dtype=dt).element_size()
        # --- Cholesky: ragged/aligned small n and the main path's K_d, S
        for n in (1, 37, 128, 300, 102, 4608):
            A = _spd(torch, n, n, dt, dev)
            L = chol.cholesky(A)
            L2 = chol.cholesky(A)
            Lp = chol.cholesky_plain(A)
            torch.cuda.synchronize()
            err = _rel(torch, L, Lp)
            _check(err <= tol[dt], f"cholesky {dname} n={n}: rel err {err:.3e}")
            _check(torch.equal(L, L2), f"cholesky {dname} n={n}: two factorizations differ")
            big = n >= 1000
            ms = _event_ms(torch, lambda: chol.cholesky(A), 10 if big else 50)
            plain_ms = _event_ms(torch, lambda: chol.cholesky_plain(A), 1 if big else 3)
            lib_ms = _event_ms(torch, lambda: torch.linalg.cholesky(A), 10 if big else 50)
            bms, by = _bound_ms(n, itemsize, dname)
            rows["cholesky"].append(dict(
                n=n, dtype=dname, max_abs_err=float((L - Lp).abs().max()), rel_err=err,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by))
            _log(f"  cholesky {dname:7s} n={n:5d} rel_err={err:.2e} kernel {ms:9.3f} ms  "
                 f"plain {plain_ms:9.3f} ms  torch.linalg.cholesky {lib_ms:8.3f} ms  "
                 f"bound {bms:.4f} ms ({by})")
        for n in (3, 300):
            if n == 3:
                A = torch.tensor([[1.0, 2, 0], [2, 1, 0], [0, 0, 1]], dtype=dt, device=dev)
            else:
                A = _spd(torch, n, 7, dt, dev)
                A[200, 200] = -1.0
            L = chol.cholesky(A)
            lower = torch.tril(torch.ones(n, n, dtype=torch.bool, device=dev))
            _check(bool(torch.isnan(L[lower]).all()) and bool((L[~lower] == 0).all()),
                   f"cholesky {dname}: non-PD input of size {n} must give an all-NaN lower triangle")
        # --- no-pivot LDL^T: the safe tier's saddles at B=16, 32, 512
        for n in (148, 294, 4710):
            M, m = _saddle(torch, n, n, dt, dev)
            f = ldl.ldl_factor(M)
            f2 = ldl.ldl_factor(M)
            n_p = f.L.shape[0]
            A = ldl._pad_sym(M, n_p)
            Lp, dp = ldl.ldl_nopiv_plain(A)
            fp = ldl.ldl_factors(M, Lp, dp)
            torch.cuda.synchronize()
            eL, ed = _rel(torch, f.L, Lp), _rel(torch, f.d, dp)
            _check(bool(f.ok) == bool(fp.ok) and int(f.n_neg) == int(fp.n_neg),
                   f"ldl {dname} n={n}: ok/n_neg {bool(f.ok)}/{int(f.n_neg)} vs plain "
                   f"{bool(fp.ok)}/{int(fp.n_neg)}")
            _check(bool(f.ok) and int(f.n_neg) == m, f"ldl {dname} n={n}: inertia {int(f.n_neg)} != {m}")
            _check(max(eL, ed) <= tol_ldl[dt], f"ldl {dname} n={n}: rel err L {eL:.3e} d {ed:.3e}")
            _check(torch.equal(f.L, f2.L) and torch.equal(f.d, f2.d),
                   f"ldl {dname} n={n}: two factorizations differ")
            big = n >= 1000
            ms = _event_ms(torch, lambda: ldl.ldl_nopiv(A), 10 if big else 50)
            plain_ms = _event_ms(torch, lambda: ldl.ldl_nopiv_plain(A), 1 if big else 3)
            bms, by = _bound_ms(n_p, itemsize, dname)
            rows["ldl_nopiv"].append(dict(
                n=n_p, n_true=n, dtype=dname,
                max_abs_err=max(float((f.L - Lp).abs().max()), float((f.d - dp).abs().max())),
                rel_err=max(eL, ed), ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bms, bound_by=by))
            _log(f"  ldl_nopiv {dname:7s} n={n:5d}->{n_p:5d} ok={bool(f.ok)} n_neg={int(f.n_neg)} "
                 f"rel_err L {eL:.2e} d {ed:.2e} kernel {ms:9.3f} ms  plain {plain_ms:9.3f} ms  "
                 f"bound {bms:.4f} ms ({by})")
        # an exact zero pivot, inside a diagonal block and across a block edge
        for k in (100, 63):
            M = torch.eye(200, dtype=dt, device=dev)
            M[k, k + 1] = M[k + 1, k] = M[k + 1, k + 1] = 1.0
            f = ldl.ldl_factor(M)
            fp = ldl.ldl_factors(M, *ldl.ldl_nopiv_plain(ldl._pad_sym(M, f.L.shape[0])))
            _check(not bool(f.ok) and not bool(fp.ok) and float(f.d[k + 1]) == 0.0,
                   f"ldl {dname}: an exact zero pivot at {k + 1} must give ok=False")
    return rows


@contextlib.contextmanager
def _tier_log(kkt_mds):
    """Record the safe tier of every safe-tier factorization in order."""
    log = []
    dense, bordered = kkt_mds.factorize_safe, kkt_mds.factorize_safe_schur

    def safe(*a, host=False, **k):
        log.append("lu_eig" if host else "ldl_nopiv")
        return dense(*a, host=host, **k)

    def schur(*a, **k):
        log.append("schur_sparse_ldl")
        return bordered(*a, **k)

    kkt_mds.factorize_safe, kkt_mds.factorize_safe_schur = safe, schur
    try:
        yield log
    finally:
        kkt_mds.factorize_safe, kkt_mds.factorize_safe_schur = dense, bordered


def _solve_phase(torch, name: str, run, need: dict):
    """Drive one main-path solve with the launch counts at zero; check that
    every kernel in ``need`` launched."""
    from hiop_tpu_torch.linalg import kernels as K

    torch.cuda.synchronize()
    K.stats.reset()
    t0 = time.perf_counter()
    r = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.stats.launches)
    sizes = {f"{k[0]}:{k[1]}:{k[2]}": v for k, v in sorted(K.stats.sizes.items())}
    its = max(r.iterations, 1)
    _log(f"  {name}: status {r.status.name} iterations {r.iterations} obj {r.obj!r} "
         f"wall {wall:.3f} s  {wall / its:.4f} s/iter  launches {launches}  by size {sizes}")
    for k, why in need.items():
        _check(launches.get(k, 0) > 0, f"{name}: the {k} kernel never launched ({why})")
    return r, wall, launches, sizes


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs only on a card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "hiop_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository (hiop_tpu_torch/ is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    _log(f"[1] device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
         f"nvidia-smi: {smi}")

    from hiop_tpu_torch.linalg import kernels as K

    t0 = time.perf_counter()
    K.load()
    _log(f"[2] build: {time.perf_counter() - t0:.2f} s "
         f"({'compiled' if K.last_build else 'already built'})")
    from hiop_tpu_torch.native import ldl as native_ldl

    t0 = time.perf_counter()
    _check(native_ldl.native_available(),
           "the native host library (hiop_tpu_torch/native, g++) did not build or load")
    _log(f"  native host library loaded ({time.perf_counter() - t0:.2f} s)")

    _log("[3] kernels vs plain on the card")
    rows = phase_kernels(torch, dev)

    _log("[4] main path: mds_ex1 400/100")
    from hiop_tpu_torch.examples import acopf_mds, mds_ex1

    r, _, _, _ = _solve_phase(
        torch, "mds_ex1", lambda: mds_ex1.solve(400, 100, verbosity_level=0),
        {"cholesky": "quick tier"})
    _check(r.status.is_success, f"mds_ex1: status {r.status.name}")
    _check(abs(r.obj - mds_ex1.SELFCHECK_OBJ) <= 1e-6,
           f"mds_ex1: obj {r.obj!r} vs saved {mds_ex1.SELFCHECK_OBJ!r}")

    _log("[5] main path: ACOPF B=32, linear_solver_dense=auto")
    from hiop_tpu_torch.kkt import mds as kkt_mds

    with _tier_log(kkt_mds) as tiers:
        r, _, _, _ = _solve_phase(
            torch, "acopf B=32",
            lambda: acopf_mds.solve(32, verbosity_level=0, linear_solver_dense="auto"),
            {"cholesky": "quick tier", "ldl_nopiv": "device safe tier"})
    runs = []
    for t in tiers:
        if runs and runs[-1][0] == t:
            runs[-1][1] += 1
        else:
            runs.append([t, 1])
    _log("  acopf B=32 safe tiers in order: " + ", ".join(f"{t} x{k}" for t, k in runs))
    _check("schur_sparse_ldl" in tiers, "acopf B=32: no schur_sparse_ldl factorization")
    ref, tol = acopf_mds.SELFCHECK[32]
    _check(r.status.is_success, f"acopf B=32: status {r.status.name}")
    _check(abs(r.obj - ref) <= tol * max(1.0, abs(ref)), f"acopf B=32: obj {r.obj!r} vs saved {ref!r}")

    _log(f"[6] main path at full width: ACOPF B=512 (S 4608^2, saddle 4710^2 padded to 4736^2), "
         f"capped at max_iter={B512_MAX_ITER}: past the escalation to the device LDL^T tier, "
         f"before the host lu_eig tier")
    torch.cuda.reset_peak_memory_stats()
    K.stats.timing = True
    r, wall, launches, sizes = _solve_phase(
        torch, "acopf B=512",
        lambda: acopf_mds.solve(512, verbosity_level=0, linear_solver_dense="auto",
                                max_iter=B512_MAX_ITER),
        {"cholesky": "quick tier", "ldl_nopiv": "device safe tier"})
    kms = K.stats.device_ms()
    K.stats.timing = False
    its = max(r.iterations, 1)
    _check(sizes.get("cholesky:4608:float64", 0) > 0, "acopf B=512: no Cholesky of S at 4608")
    _check(sizes.get("ldl_nopiv:4736:float64", 0) > 0, "acopf B=512: no LDL^T of the 4710 saddle")
    _check(r.obj == r.obj and abs(r.obj) < float("inf"), f"acopf B=512: objective {r.obj!r}")
    ref, tol = acopf_mds.SELFCHECK[512]
    _log(f"  acopf B=512: {r.status.name} after {r.iterations} iterations, {wall / its:.4f} s/iter; "
         f"kernel ms/iter cholesky {kms.get('cholesky', 0.0) / its:.3f} ldl_nopiv "
         f"{kms.get('ldl_nopiv', 0.0) / its:.3f}; obj {r.obj!r} (saved {ref!r}, "
         f"|diff| {abs(r.obj - ref):.3e}); max_memory_allocated "
         f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if r.status.is_success:
        _check(abs(r.obj - ref) <= tol * max(1.0, abs(ref)),
               f"acopf B=512 converged to obj {r.obj!r}, saved {ref!r}")

    src = {"cholesky": ("hiop_tpu_torch/csrc/cholesky.cu", "hiop_tpu/linalg/cholesky.py:85"),
           "ldl_nopiv": ("hiop_tpu_torch/csrc/ldl_nopiv.cu", "hiop_tpu/linalg/ldl_blocked.py:214")}
    main_n = {"cholesky": 4608, "ldl_nopiv": 4736}
    kernels = []
    for name, (source, replaces) in src.items():
        head = next(x for x in rows[name] if x["n"] == main_n[name] and x["dtype"] == "float64")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches.get(name, 0), max_abs_err=head["max_abs_err"],
            ms=head["ms"], kernel_ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
            n=head["n"], dtype="float64", ms_per_iter_b512=kms.get(name, 0.0) / its,
            shapes=rows[name]))
    _log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
