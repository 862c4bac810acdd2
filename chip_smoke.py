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
   longer B=512 solves;
7. mixed precision (``kkt_fact_dtype=float32``), ACOPF B=32 to convergence
   at ``SELFCHECK[32]``: both kernels launch in f32; prints the
   tier/dtype sequence, the f32 fraction, the demotions, the inner
   FGMRES iterations and why the first rejected f32 device factorization
   was rejected;
8. mixed precision at full width, ACOPF B=512 capped at
   ``B512_MP_MAX_ITER``: the f32 Cholesky of S (4608^2) and the f32
   device LDL^T of the saddle (4736^2) launch; s/iter, f32 kernel ms per
   iteration, peak memory, and the same rejection diagnosis;
9. the operator-form mixed-precision KKT (``factorize_saddle_device_mp_op``
   / ``solve_saddle_device_mp_op``) at phase 8's last iterate: the f32
   LDL^T at 4736^2, a certified direction that agrees with the f64
   ``factorize_saddle_device`` one to ``OP_FORM_RTOL``.

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

#: ACOPF B=512 with kkt_fact_dtype=float32: iteration cap. Iterations 0-3
#: run the quick tier in f32 (the f32 Cholesky of S); at iteration 4 the
#: f32 device LDL^T of the saddle is tried in the first safe slot, and
#: rejected, after which the f64 ladder runs (``chip_measure.py mp``)
B512_MP_MAX_ITER = 10

#: phase 9: the op-form direction against the f64 device saddle's, relative
#: to each block's largest entry (both certified to ~1e-9 in residual)
OP_FORM_RTOL = 1e-6


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


def phase_mixed_precision(torch, dev) -> dict:
    """Phases 7-9: the main path with kkt_fact_dtype=float32, and the
    operator-form mixed-precision KKT at a B=512 iterate."""
    from hiop_tpu_torch.examples import acopf_mds
    from hiop_tpu_torch.kkt import mds as kkt_mds
    from hiop_tpu_torch.linalg import kernels as K
    from hiop_tpu_torch.linalg import krylov
    from hiop_tpu_torch.optimization import filter_ipm

    _check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
           and torch.get_float32_matmul_precision() == "highest",
           "TF32 is on: the f32 factorizations and solves must stay IEEE FP32")
    out = {}

    _log("[7] mixed precision: ACOPF B=32, kkt_fact_dtype=float32, to convergence")
    with _mp_log(filter_ipm, krylov) as log:
        r, wall, _, sizes = _solve_phase(
            torch, "acopf B=32 f32",
            lambda: acopf_mds.solve(32, verbosity_level=0, kkt_fact_dtype="float32"),
            {"cholesky": "quick tier in f32", "ldl_nopiv": "f32 device safe tier"})
    n_f32 = sum(1 for t in log["fact"] if "f32" in t)
    _log(f"  acopf B=32 f32: factorizations in order: {_runs(log['fact'])}")
    _log(f"  acopf B=32 f32: {n_f32} of {len(log['fact'])} factorizations in f32 "
         f"({n_f32 / max(len(log['fact']), 1):.3f}); demotions {log['demotions']}; "
         f"inner FGMRES iterations {log['ir_inner']}; {wall / max(r.iterations, 1):.4f} s/iter")
    for k in ("cholesky", "ldl_nopiv"):
        _check(any(key.startswith(k + ":") and key.endswith(":float32") for key in sizes),
               f"acopf B=32 f32: no f32 launch of {k}")
    ref, tol = acopf_mds.SELFCHECK[32]
    _log(f"  acopf B=32 f32: first rejected f32 device factorization: "
         f"{_why_rejected(torch, kkt_mds, log['rejected'])}")
    _check(r.status.is_success, f"acopf B=32 f32: status {r.status.name}")
    _check(abs(r.obj - ref) <= tol * max(1.0, abs(ref)), f"acopf B=32 f32: obj {r.obj!r} vs saved {ref!r}")

    _log(f"[8] mixed precision at full width: ACOPF B=512, kkt_fact_dtype=float32, "
         f"capped at max_iter={B512_MP_MAX_ITER}")
    torch.cuda.reset_peak_memory_stats()
    K.stats.timing = True
    with _mp_log(filter_ipm, krylov) as log:
        r, wall, launches, sizes = _solve_phase(
            torch, "acopf B=512 f32",
            lambda: acopf_mds.solve(512, verbosity_level=0, kkt_fact_dtype="float32",
                                    max_iter=B512_MP_MAX_ITER),
            {"cholesky": "quick tier in f32", "ldl_nopiv": "f32 device safe tier"})
    kms = K.stats.device_ms(by_dtype=True)
    K.stats.timing = False
    its = max(r.iterations, 1)
    for key in ("cholesky:4608:float32", "ldl_nopiv:4736:float32"):
        _check(sizes.get(key, 0) > 0, f"acopf B=512 f32: no launch {key}")
    _check(r.obj == r.obj and abs(r.obj) < float("inf"), f"acopf B=512 f32: objective {r.obj!r}")
    n_f32 = sum(1 for t in log["fact"] if "f32" in t)
    out["launches_f32"] = {k: sum(v for key, v in sizes.items() if key.startswith(k + ":")
                                  and key.endswith(":float32")) for k in ("cholesky", "ldl_nopiv")}
    out["f32_ms_per_iter"] = {k: kms.get((k, "float32"), 0.0) / its for k in ("cholesky", "ldl_nopiv")}
    _log(f"  acopf B=512 f32: {r.status.name} after {r.iterations} iterations, {wall / its:.4f} s/iter; "
         f"factorizations in order: {_runs(log['fact'])}; {n_f32} of {len(log['fact'])} in f32; "
         f"demotions {log['demotions']}; inner FGMRES iterations {log['ir_inner']}; f32 kernel ms/iter "
         f"cholesky {out['f32_ms_per_iter']['cholesky']:.3f} ldl_nopiv "
         f"{out['f32_ms_per_iter']['ldl_nopiv']:.3f} (f64: cholesky "
         f"{kms.get(('cholesky', 'float64'), 0.0) / its:.3f} ldl_nopiv "
         f"{kms.get(('ldl_nopiv', 'float64'), 0.0) / its:.3f}); obj {r.obj!r}; max_memory_allocated "
         f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    _log(f"  acopf B=512 f32: first rejected f32 device factorization: "
         f"{_why_rejected(torch, kkt_mds, log['rejected'])}")
    log["rejected"] = None

    _log("[9] operator-form mixed-precision KKT at the last B=512 iterate of phase 8")
    st = log["strategy"]
    d, p = st._data, st.perturb
    deltas = (p.delta_wx, p.delta_wd, p.delta_cc, p.delta_cd)
    js_rows, js_cols, pairs = kkt_mds.mds_js_struct(st.nlp)
    g = torch.Generator().manual_seed(9)
    rhs = tuple(torch.randn(k, generator=g, dtype=torch.float64).to(dev) for k in (
        st.ns, d["Hdd"].shape[0], d["Dd"].shape[0], d["Jc_d"].shape[0], d["Dd"].shape[0]))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    K.stats.reset()
    f_op, fact_ms = timed(lambda: kkt_mds.factorize_saddle_device_mp_op(
        d["hss"], d["Hdd"], d["Dxs"], d["Dxd"], d["Dd"], d["Jc_d"], d["Jd_d"],
        d["js_vals"], pairs, *deltas))
    op, solve_ms = timed(lambda: kkt_mds.solve_saddle_device_mp_op(f_op, js_rows, js_cols, *rhs))
    torch.cuda.synchronize()
    op_sizes = dict(K.stats.sizes)
    _, fact_ms_2 = timed(lambda: kkt_mds.factorize_saddle_device_mp_op(
        d["hss"], d["Hdd"], d["Dxs"], d["Dxd"], d["Dd"], d["Jc_d"], d["Jd_d"],
        d["js_vals"], pairs, *deltas))
    _, solve_ms_2 = timed(lambda: kkt_mds.solve_saddle_device_mp_op(f_op, js_rows, js_cols, *rhs))
    _check(op_sizes.get(("ldl_nopiv", 4736, "float32"), 0) > 0,
           "op-form: the f32 LDL^T of the 4710 saddle did not launch")
    f64, f64_fact_ms = timed(lambda: kkt_mds.factorize_saddle_device(
        d["hss"], d["Hdd"], d["Dxs"], d["Dxd"], d["Dd"], d["Jc_s"], d["Jc_d"], d["Jd_s"], d["Jd_d"],
        *deltas))
    ref, f64_solve_ms = timed(lambda: kkt_mds.solve_saddle_device(f64, *rhs))
    _, f64_fact_ms_2 = timed(lambda: kkt_mds.factorize_saddle_device(
        d["hss"], d["Hdd"], d["Dxs"], d["Dxd"], d["Dd"], d["Jc_s"], d["Jc_d"], d["Jd_s"], d["Jd_d"],
        *deltas))
    _, f64_solve_ms_2 = timed(lambda: kkt_mds.solve_saddle_device(f64, *rhs))
    errs = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-300)) if b.numel() else 0.0
            for a, b in zip(op[:5], ref)]
    mc_md = d["Jc_d"].shape[0] + d["Jd_d"].shape[0]
    _log(f"  op-form: ok {bool(f_op.ok)} (n_neg {int(f_op.n_neg)}, mc+md {mc_md}); certified {op[5]} "
         f"after n_ir {op[6]}; factorization {fact_ms:.3f} ms (again {fact_ms_2:.3f}), solve "
         f"{solve_ms:.3f} ms (again {solve_ms_2:.3f}); f64 device saddle: ok {bool(f64.ok)}, "
         f"factorization {f64_fact_ms:.3f} ms (again {f64_fact_ms_2:.3f}), solve {f64_solve_ms:.3f} ms "
         f"(again {f64_solve_ms_2:.3f}); "
         f"direction rel diff by block (dxs, dxd, dd, dyc, dyd) {['%.2e' % e for e in errs]} "
         f"(tolerance {OP_FORM_RTOL:g})")
    _check(op[5], "op-form: the f32 direction was not certified")
    _check(max(errs) <= OP_FORM_RTOL, f"op-form: direction differs from the f64 one by {max(errs):.3e}")
    return out


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


def fact_label(strategy, f32) -> str:
    """The slot and dtype of an MDS strategy's next factorization
    (``f32``: the package's float32 dtype): ``quick-f32``, ``lu_eig-f64``,
    or ``device-f32[schur_sparse_ldl]`` for the f32 device LDL^T that
    stands in a safe tier's slot."""
    slot = strategy._safe_tiers[strategy._safe_mode - 1] if strategy._safe_mode else "quick"
    if strategy.fact_dtype != f32:
        return slot + "-f64"
    return f"device-f32[{slot}]" if strategy._safe_mode else "quick-f32"


@contextlib.contextmanager
def _mp_log(filter_ipm, krylov):
    """Record, in order, each factorization's (slot, dtype) as
    ``quick-f32``, ``schur_sparse_ldl-f64``, ``device-f32[lu_eig]`` (the f32
    device LDL^T in that safe tier's slot) ..., each demotion of f32, the
    inner FGMRES iterations, the last strategy that prepared a KKT, and the
    arguments and factors of the first f32 device factorization that was
    not ``ok`` (for :func:`_why_rejected`)."""
    import torch

    log = {"fact": [], "demotions": [], "ir_inner": 0, "strategy": None, "rejected": None}
    S = filter_ipm._MdsStrategy
    factorize, prepare, demote, fgmres = S._factorize, S.prepare, filter_ipm._mp_demote, krylov.fgmres
    safe = filter_ipm.kkt_mds.factorize_safe

    def kept_safe(*a, **k):
        f = safe(*a, **k)
        if a[1].dtype == torch.float32 and not f.ok and log["rejected"] is None:
            log["rejected"] = (a, k, f)
        return f

    def tagged(self):
        log["fact"].append(fact_label(self, torch.float32))
        return factorize(self)

    def kept(self, *a, **k):
        log["strategy"] = self
        return prepare(self, *a, **k)

    def demoted(strategy, why):
        if strategy._mp_f32_ok:
            log["demotions"].append(why)
        return demote(strategy, why)

    def counted(*a, **k):
        x, info = fgmres(*a, **k)
        log["ir_inner"] += info.iters
        return x, info

    S._factorize, S.prepare, filter_ipm._mp_demote, krylov.fgmres = tagged, kept, demoted, counted
    filter_ipm.kkt_mds.factorize_safe = kept_safe
    try:
        yield log
    finally:
        S._factorize, S.prepare, filter_ipm._mp_demote, krylov.fgmres = factorize, prepare, demote, fgmres
        filter_ipm.kkt_mds.factorize_safe = safe


def _why_rejected(torch, kkt_mds, rejected) -> str:
    """Which part of a rejected f32 device factorization's ``ok`` failed
    (a null K_s entry, a non-finite factor, pivots at or below
    eps_f32 * max(|M|, 1) * 1e-2), and whether the equilibrated op-form f32
    factorization of the same operands is finite and free of breakdown (the
    f32 safe tier's acceptance, which does not count the inertia). Runs
    after a phase's launch counts are read."""
    if rejected is None:
        return "no f32 device factorization was rejected"
    a, k, f = rejected
    if f.fact is None:
        return "a null entry of the eliminated diagonal K_s"
    M = kkt_mds._dense_saddle(*a[:13], k.get("js_vals"), k.get("js_pairs"))[-1]
    lf = f.fact
    m_max = float(M.abs().max())
    thresh = torch.finfo(M.dtype).eps * max(m_max, 1.0) * 1e-2
    d = lf.d[: lf.n]
    finite = bool(torch.isfinite(lf.L).all()) and bool(torch.isfinite(lf.d).all())
    up = [x.to(torch.float64) for x in a[:9]]
    op = kkt_mds.factorize_saddle_device_mp_op(
        up[0], up[1], up[2], up[3], up[4], up[6], up[8], k["js_vals"].to(torch.float64),
        k["js_pairs"], *a[9:13], count_inertia=False)
    return (f"saddle {lf.n}: finite factor {finite}; max|M| {m_max:.3e}, breakdown threshold "
            f"{thresh:.3e}, min |pivot| {float(d.abs().min()):.3e}, pivots at or below it "
            f"{int((d.abs() <= thresh).sum())}; equilibrated op-form f32 factorization of the same "
            f"operands: finite without breakdown {bool(op.ok)}, n_neg {int(op.n_neg)} "
            f"(m = {M.shape[0] - a[1].shape[0]})")


def _runs(seq) -> str:
    """``a x3, b x1, a x2`` for the sequence a a a b a a."""
    out = []
    for t in seq:
        if out and out[-1][0] == t:
            out[-1][1] += 1
        else:
            out.append([t, 1])
    return ", ".join(f"{t} x{k}" for t, k in out)


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
    _log("  acopf B=32 safe tiers in order: " + _runs(tiers))
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

    mp = phase_mixed_precision(torch, dev)

    src = {"cholesky": ("hiop_tpu_torch/csrc/cholesky.cu", "hiop_tpu/linalg/cholesky.py:85"),
           "ldl_nopiv": ("hiop_tpu_torch/csrc/ldl_nopiv.cu", "hiop_tpu/linalg/ldl_blocked.py:214")}
    main_n = {"cholesky": 4608, "ldl_nopiv": 4736}
    kernels = []
    for dname, suffix in (("float64", ""), ("float32", "_f32")):
        for name, (source, replaces) in src.items():
            head = next(x for x in rows[name] if x["n"] == main_n[name] and x["dtype"] == dname)
            if dname == "float64":
                n_launch, per_iter = launches.get(name, 0), kms.get(name, 0.0) / its
            else:
                n_launch, per_iter = mp["launches_f32"].get(name, 0), mp["f32_ms_per_iter"].get(name, 0.0)
            kernels.append(dict(
                name=name + suffix, route="cuda", source=source, replaces=replaces,
                launches=n_launch, max_abs_err=head["max_abs_err"],
                ms=head["ms"], kernel_ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
                n=head["n"], dtype=dname, ms_per_iter_b512=per_iter,
                shapes=[x for x in rows[name] if x["dtype"] == dname]))
    _log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
