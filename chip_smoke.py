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
   ``factorize_saddle_device`` one to ``OP_FORM_RTOL``;
10. the quasi-Newton (L-BFGS) path, ``FilterIPMQuasiNewton`` over
    ``NlpDenseConstraints``: HiOp's four dense examples at their largest
    published size (n = ``QN_N``; ``dense_ex4`` has n = 2), each at its
    saved objective by the examples' own test, through the Cholesky kernel
    of the m x m low-rank Schur system where m > 0; iterations, s/iter and
    peak memory;
11. the dense exact-Newton path, ``FilterIPMNewton`` over
    ``NlpDenseConstraints``: DenseConsEx2's f and c through
    ``AutoDiffNlpProblem`` (``torch.func`` derivatives, the dense
    n x n Lagrangian Hessian) at n = ``NEWTON_N`` on the default ladder, at
    ``SELFCHECK[NEWTON_N]``, through the Cholesky kernel at n^2; prints the
    tier sequence, s/iter, kernel ms per iteration, whether the host
    ``lu_eig`` tier ran, the ``torch.func.hessian`` time and memory; run
    twice, and the two runs must give the same bits;
12. the same with the device safe tier pinned from the first iteration
    (``linear_solver_dense=ldl_nopiv``, ``_safe_mode = 1``): the no-pivot
    LDL^T of the XDYcYd saddle (n + 7, padded to a multiple of 128), the
    negative-pivot count of each accepted factorization beside m_c + m_d,
    and whether the three-mismatch switch to the curvature test fired;
13. the same as 11 with ``kkt_fact_dtype=float32``: the f32 Cholesky at
    n^2, the f32 fraction, the demotions and the inner FGMRES iterations;
14. forced feasibility restoration (``force_resto=yes``), ACOPF B=32 f64 to
    convergence at ``SELFCHECK[32]``: the nested FR solve (an ``NlpMDS``
    over the MDS FR problem) runs the Cholesky kernel; prints the nested
    iterations, the nested tiers, whether a soft restoration ran, and the
    kernel launches inside the nested solve;
15. forced restoration at full width, ACOPF B=512 capped at
    ``B512_MAX_ITER``: inside the nested solve (n = 14 438, m = 4608) the
    Cholesky of S at 4608^2, the device LDL^T at 4736^2 if a device safe
    tier runs, and the f32 matrix-free LSQ initialization (its Jacobian has
    6.65e7 entries); prints the nested s/iter, the peak memory and whether
    the restoration was accepted within the cap; then the same with the
    nested solve pinned to the device LDL^T tier, which must launch the
    LDL^T of the 4710 saddle (padded to 4736) inside the nested solve;
16. forced restoration on the dense paths: quasi-Newton ``dense_ex1`` at
    n = ``QN_N`` at its saved objective, and exact-Newton ``dense_ex2`` at
    n = ``NEWTON_N`` at ``SELFCHECK[NEWTON_N]``, whose nested solve
    factorizes K at (n + 2m)^2 = 5008^2;
17. checkpoints, ``write_kkt`` and ``deepchecks`` on mds_ex1 400/100: a
    solve that saves every 2 iterations and stops at 5, resumed from its
    file, gives the same bits as the uninterrupted solve; three iterations
    with ``write_kkt`` write three dumps; ``deepchecks`` gives the same bits
    as phase 4. Files go under ``build/chip_smoke/`` in the checkout;
18. the sparse formulation (``NlpSparse``): HiOp's sparse Ex1 at
    n = ``SPARSE_N`` with default options, the host sparse-direct KKT
    (SuperLU) at its saved objective; prints the backend by iteration,
    ``n_fact_no_inertia``, host syncs per iteration and the seconds in the
    host factorizations, the host solves and the copies;
19. the same with ``KKTLinsys=normaleqn``: the Cholesky kernel at
    (n-1)^2 = 4999^2, per launch in the solve (CUDA events) and alone beside
    its plain version, ``torch.linalg.cholesky`` and the bound;
20. the dense Newton ladder of sparse problems: sparse Ex2 at
    n = ``SPARSE_SMALL_N`` and sparse Ex4 at their saved objectives, with at
    least one device LDL^T launch between them (else Ex2 again with the
    safe tier pinned); sparse Ex3 (ineq_feas) at n = ``SPARSE_N`` (the
    sparse-direct route) at its LP optimum; the nonconvex MDS example 2 at
    400/100 at its saved objective;
21. ACOPF through ``AcopfSparse`` on the sparse-direct path: B=256 to
    convergence at ``SELFCHECK[256]``, then B=``FULL_B`` capped at
    ``B512_MAX_ITER`` (finite objective; ``SELFCHECK[512]`` if it
    converges); s/iter, backends, peak memory;
22. forced restoration over sparse Ex1 at n = ``SPARSE_SMALL_N`` through
    ``SparseFeasibilityRestorationProblem``, at its saved objective;
    prints the nested iterations and whether the base accepted the nested
    point;
23. the device sparse LDL^T alone (``linalg/sparse_device.py``) on sparse
    Ex1's XDYcYd system at n = ``DEVICE_LDL_N`` (f32, three delta pairs)
    and on the AcopfSparse B=``FULL_B`` pattern (f64): symbolic seconds,
    levels, lnz, launches per numeric factorization and per solve sweep,
    ms of each eager and replayed from its CUDA graph; the inertia is
    (., m_eq + m_ineq, 0) unless pivots were clamped, a repeat gives the
    same bits, the f64 pivots and inertia agree with the native host
    LDL^T of the same permuted matrix to ``DEVICE_LDL_D_RTOL``, and a
    certified solve has a relative residual under 1e-8;
24. sparse Ex1 at n = ``SPARSE_N`` with ``linear_solver_sparse=device_ldl``
    in f64 and with ``kkt_fact_dtype=float32``: ``SELFCHECK[SPARSE_N]``, no
    fallback to SuperLU; iterations, s/iter, host syncs per iteration and
    the device ms in the numeric factorizations and in the solves beside
    phase 18's; the device's idle share of one profiled solve on each of
    ``device_ldl`` and ``splu``;
25. AcopfSparse with ``device_ldl``: B=256 to convergence at
    ``SELFCHECK[256]``, B=``FULL_B`` capped at ``B512_MAX_ITER``; beside
    phase 21's s/iter, with the peak memory;
26. the condensed classes: sparse Ex1 at n = ``SPARSE_N`` with
    ``KKTLinsys=condensed`` (the sparse condensed device class refuses the
    pattern, and the dense condensed class runs, as in ``hiop_tpu``); the
    sparse condensed device class forced at n = ``CONDENSED_DEVICE_N``,
    capped; ``KKTLinsys=condensed linear_solver_sparse=cg`` at n = ``CG_N``
    to the JAX package's objective test, with CG iterations and host syncs
    per solve. Each of phases 24-26 checks the strategy class it runs;
27. the fused modes in ACOPF's production options (``bench_subs.py``:
    ``jit_mode=solve``, ``kkt_fact_dtype=float32``,
    ``linear_solver_dense=ldl_nopiv``, ``mp_schedule=adaptive``), capped at
    ``FUSED_MAX_ITER``: B=256 at ``SELFCHECK[256]``, B=``FULL_B`` at
    ``SELFCHECK[512]`` if it converges (a finite objective either way);
    the f32 LDL^T launches at the padded saddle size and the f64
    refactorizations, the f32 fraction, the history's mean ladder
    refactorizations, IR steps and SOC rounds per iteration, s/iter, host
    reads per iteration and peak memory;
28. the same B=``FULL_B`` options under ``jit_mode=kernels``, ``iteration``
    and ``solve``, each capped at ``MODES_MAX_ITER``: s/iter, host reads
    per iteration, kernel launches and the device's idle share of one
    profiled solve;
29. the fused modes on the other paths beside ``jit_mode=kernels`` in the
    same call: ``mds_ex1`` 400/100 under ``iteration`` and ``solve`` (the
    Cholesky quick tier, at ``SELFCHECK_OBJ``), dense Newton ex2 at
    n = ``NEWTON_N`` and QN ``dense_ex1`` at n = ``QN_N`` under ``solve``,
    at their saved objectives: iterations, s/iter, host reads per
    iteration and the idle share of one profiled solve;
30. the batched launches of both kernels alone (``gridDim.z = S``), f64
    and f32, S in ``BATCH_S`` at the padded saddles of ACOPF B=32 and
    B=256 (384 and 2432): each matrix bit for bit the single-matrix
    kernel's (the Cholesky's NaN fill, the LDL^T's n_neg/ok per matrix),
    the batched plain versions at 384, ms of one batched launch against S
    single launches and, for the Cholesky, ``torch.linalg.cholesky`` of
    the stack, beside the bound;
31. SC-ACOPF contingency screening at the driver default (B=32, the
    basecase and 7 line outages, ``solve_contingencies``), every lane's
    fused solve in lockstep: status, iterations and objective per lane
    against ``hiop_tpu``'s on the CPU (``CONT_REF``; succeeding lanes to
    1e-8), each lane against the same scenario solved alone (S=1) on the
    card, except a lane ``hiop_tpu`` itself decides by rounding
    (``CONT_ROUNDING_DECIDED``, printed), batched launches and host reads
    per batched iteration;
32. full width: B=256 with the basecase and 31 outages, capped at
    ``WIDE_MAX_ITER``: per-lane status and iterations, s per batched
    iteration and time to solution, host reads per batched iteration,
    batched LDL^T launches and their summed ms, peak memory, the basecase
    lane at ``SELFCHECK[256]``, four lanes alone (S=1) and the idle share
    of one profiled solve (capped at ``WIDE_PROFILE_ITER``);
33. PriDec on the card: ``pridec_ex1`` 20/100 and ``pridec_ex2 -batched``
    20/5 to their self-checks, SC-ACOPF PriDec (``acopf_pridec``) at its
    driver default, B=16 with 4 outages, to ``hiop_tpu``'s objective
    (``PRIDEC_REF``): PriDec iterations, the lanes solved alone on the
    host, seconds in master solves against batched and host recourse
    (``chip_measure.py pridec`` runs B=32 with 8 outages).

Each main-path phase sets the launch counts to zero just before each solve
and reads them just after; phases 14-16 also read them around each nested
FR solve (``fr_path_launches`` in the ``kernels`` line) and time the
kernels there (``fr_path_kernel_ms``); phases 18-22 give theirs as
``sparse_path_launches`` and ``sparse_path_kernel_ms``, phases 27-29 as
``fused_path_launches``, phases 31-33 their batched launches as
``batched_path_launches`` (by ``name:n:dtype:S``), and phase 30's rows
as ``batched_shapes``. The last three lines of
standard output are the ``kernels`` JSON line, the ``nvidia-smi``
name/power-limit line, and ``{"ok": true, "device": {...}}``.
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

#: phase 10: the dense examples' largest published size
#: (NlpDenseConsEx{1,2,3}Driver.cpp self-check tables)
QN_N = 50000

#: phases 11-13: the dense exact-Newton size (a 5000^2 f64 Hessian, 200 MB)
NEWTON_N = 5000

#: phase 15: the full-width ACOPF size of the forced restoration (m = 9 B
#: constraints, n_d = max(4, B // 5) dense variables; the nested FR problem
#: has n = 10 B + n_d + 2 m variables)
FULL_B = 512

#: phases 18-19: HiOp's sparse examples at their largest self-check size
#: (NlpSparseEx1Driver.cpp:295-296): n + m = 9999 >= 2000, the host
#: sparse-direct KKT; with KKTLinsys=normaleqn the (n-1)^2 Cholesky
SPARSE_N = 5000

#: phases 20 and 22: the size below n + m = 2000 at which the sparse
#: examples take the dense Newton KKT (and its device safe tier)
SPARSE_SMALL_N = 500


#: phase 23: the device sparse LDL^T's scale proof, sparse Ex1's XDYcYd
#: system at this n (ntot = 3 n - 3; tests/test_sparse_device.py:117-173 of
#: the JAX package)
DEVICE_LDL_N = 200_000

#: phase 23: relative agreement of the card's f64 pivots with the native
#: host LDL^T of the same permuted matrix
DEVICE_LDL_D_RTOL = 1e-10

#: phase 26: the matrix-free condensed size of the JAX package's test
#: (tests/test_kkt_variants.py:143-150) and its objective test
CG_N = 20000
CG_OBJ, CG_OBJ_TOL = 1.10351e-01, 1e-4

#: phase 26: the forced sparse condensed device class (sparse Ex1 below the
#: densification threshold), capped: it does not converge, in hiop_tpu too
CONDENSED_DEVICE_N, CONDENSED_DEVICE_ITERS = 500, 20


_T0 = time.perf_counter()


def _log(*a) -> None:
    """Print a line; a phase's header (``[N] ...``) carries the seconds
    since the script started."""
    if a and isinstance(a[0], str) and a[0].startswith("["):
        a = (f"{a[0]}  (t={time.perf_counter() - _T0:.1f} s)",) + a[1:]
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


def _xdycyd_saddle(torch, n: int, seed: int, dtype, dev):
    """A random XDYcYd matrix shaped like the dense Newton safe tier's at
    DenseConsEx2 (m_c = 1, m_d = 3: size n + 7): an SPD Hessian block, a
    positive barrier diagonal, a dense Jacobian. Its inertia has
    m_c + m_d = 4 negative eigenvalues."""
    from hiop_tpu_torch.kkt import newton_dense as kkt_nd

    g = torch.Generator().manual_seed(seed)
    G = torch.randn(n, n, generator=g, dtype=torch.float64)
    H = G @ G.T / n + torch.eye(n, dtype=torch.float64)
    Dx = torch.rand(n, generator=g, dtype=torch.float64)
    Dd = torch.rand(3, generator=g, dtype=torch.float64) + 0.1
    Jc = torch.randn(1, n, generator=g, dtype=torch.float64)
    Jd = torch.randn(3, n, generator=g, dtype=torch.float64)
    M = kkt_nd.assemble_xdycyd(H, Dx, Dd, Jc, Jd, 0.0, 0.0, 0.0, 0.0)
    return M.to(dtype).to(dev), 4


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
        for n in (1, 4, 37, 128, 300, 102, 4608, NEWTON_N):
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
        for n in (148, 294, 4710, NEWTON_N + 7):
            if n == NEWTON_N + 7:
                M, m = _xdycyd_saddle(torch, NEWTON_N, n, dt, dev)
            else:
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


def phase_qn(torch) -> dict:
    """Phase 10: HiOp's dense examples through FilterIPMQuasiNewton."""
    from hiop_tpu_torch.examples import dense_ex1, dense_ex2, dense_ex3, dense_ex4

    runs = (
        ("dense_ex1", lambda: dense_ex1.solve(QN_N, verbosity_level=0), dense_ex1.SELFCHECK[QN_N]),
        ("dense_ex2", lambda: dense_ex2.solve(QN_N, verbosity_level=0), dense_ex2.SELFCHECK[QN_N]),
        ("dense_ex2 -unconstrained", lambda: dense_ex2.solve(QN_N, unconstrained=True, verbosity_level=0),
         dense_ex2.SELFCHECK_UNCON[QN_N]),
        ("dense_ex3 fixed_var=relax", lambda: dense_ex3.solve(QN_N, fixed_var="relax", verbosity_level=0),
         dense_ex3.SELFCHECK[QN_N]),
        ("dense_ex4", lambda: dense_ex4.solve(verbosity_level=0), (dense_ex4.SELFCHECK_OBJ, 1e-6)),
        ("dense_ex4 -unconstrained", lambda: dense_ex4.solve(unconstrained=True, verbosity_level=0),
         (dense_ex4.UNCONSTRAINED_OBJ, 1e-6)),
    )
    out = {}
    for name, run, (ref, tol) in runs:
        # the low-rank KKT's m x m Schur system goes through the Cholesky
        # kernel; without constraints (m = 0) there is none
        need = {} if "unconstrained" in name else {"cholesky": "the low-rank KKT's m x m Schur system"}
        torch.cuda.reset_peak_memory_stats()
        r, wall, _, sizes = _solve_phase(torch, name, run, need)
        peak = torch.cuda.max_memory_allocated() / 2**30
        _log(f"  {name}: {r.iterations} iterations, {wall / max(r.iterations, 1):.4f} s/iter, "
             f"obj {r.obj!r} (saved {ref!r}), peak memory {peak:.3f} GiB")
        _check(r.status.is_success, f"{name}: status {r.status.name}")
        _check(dense_ex1.selfcheck_ok(r.obj, ref, tol), f"{name}: obj {r.obj!r} vs saved {ref!r} (tol {tol:g})")
        out[name] = sizes
    return out


def _forced_safe_newton(filter_ipm):
    """A FilterIPMNewton whose dense strategy starts in the first safe tier
    (the JAX package's ``_ForcedSafeNewton``, tests/test_ldl_blocked.py)."""

    class ForcedSafeNewton(filter_ipm.FilterIPMNewton):
        def _make_strategy(self):
            st = super()._make_strategy()
            st._safe_mode = 1
            return st

    return ForcedSafeNewton


@contextlib.contextmanager
def _dense_log(filter_ipm, krylov):
    """Record, in order, the slot and dtype of each dense Newton
    factorization (``quick-f64``, ``ldl_nopiv-f32`` ...), the inertia of
    each safe-tier acceptance test (negative count as a tensor, m_c + m_d,
    accepted), each demotion of f32, the inner FGMRES iterations and the
    last strategy, and the time at which each iteration's KKT update began."""
    import torch

    log = {"fact": [], "inertia": [], "demotions": [], "ir_inner": 0, "strategy": None, "t": []}
    S = filter_ipm._NewtonDenseStrategy
    factorize, acceptable, prepare = S._factorize, S._factorization_acceptable, S.prepare
    demote, fgmres = filter_ipm._mp_demote, krylov.fgmres

    def tagged(self):
        slot = self._safe_tiers[self._safe_mode - 1] if self._safe_mode else "quick"
        log["fact"].append(f"{slot}-{'f32' if self.fact_dtype == torch.float32 else 'f64'}")
        return factorize(self)

    def judged(self, f):
        ok, singular = acceptable(self, f)
        if self._safe_mode:
            log["inertia"].append((f.n_neg_eig, f.mc + f.md, ok))
        return ok, singular

    def kept(self, *a, **k):
        log["strategy"] = self
        log["t"].append(time.perf_counter())
        return prepare(self, *a, **k)

    def demoted(strategy, why):
        if strategy._mp_f32_ok:
            log["demotions"].append(why)
        return demote(strategy, why)

    def counted(*a, **k):
        x, info = fgmres(*a, **k)
        log["ir_inner"] += info.iters
        return x, info

    S._factorize, S._factorization_acceptable, S.prepare = tagged, judged, kept
    filter_ipm._mp_demote, krylov.fgmres = demoted, counted
    try:
        yield log
    finally:
        S._factorize, S._factorization_acceptable, S.prepare = factorize, acceptable, prepare
        filter_ipm._mp_demote, krylov.fgmres = demote, fgmres


def _hessian_cost(torch, dense_ex2, x) -> tuple:
    """Time (ms, warm, after a synchronize) and the extra peak device memory
    (GiB) of one ``torch.func.hessian`` of DenseConsEx2's Lagrangian at x."""
    p = dense_ex2.autodiff_problem(NEWTON_N, x.device)
    lam = torch.ones(4, dtype=torch.float64, device=x.device)
    p.eval_hess_lagr(x, 1.0, lam)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        p.eval_hess_lagr(x, 1.0, lam)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 3
    return ms, (torch.cuda.max_memory_allocated() - base) / 2**30


def phase_dense_newton(torch, dev) -> dict:
    """Phases 11-13: DenseConsEx2 through AutoDiffNlpProblem and
    FilterIPMNewton at n = NEWTON_N."""
    from hiop_tpu_torch.examples import dense_ex2
    from hiop_tpu_torch.linalg import kernels as K
    from hiop_tpu_torch.linalg import krylov
    from hiop_tpu_torch.optimization import filter_ipm

    ref, tol = dense_ex2.SELFCHECK[NEWTON_N]
    n_chol, n_ldl = f"cholesky:{NEWTON_N}:float64", f"ldl_nopiv:{(NEWTON_N + 7 + 127) // 128 * 128}:float64"
    out = {}

    def solve(name, need, **opts):
        torch.cuda.reset_peak_memory_stats()
        K.stats.timing = True
        with _dense_log(filter_ipm, krylov) as log:
            r, wall, _, sizes = _solve_phase(
                torch, name, lambda: dense_ex2.solve_newton(NEWTON_N, verbosity_level=0, **opts), need)
        kms = K.stats.device_ms(by_dtype=True)
        K.stats.timing = False
        its = max(r.iterations, 1)
        kernel = {f"{k}:{d}": round(v / its, 4) for (k, d), v in sorted(kms.items())}
        steps = [b - a for a, b in zip(log["t"], log["t"][1:])]
        if steps:
            _log(f"  {name}: seconds between KKT updates: first three "
                 f"{[round(x, 4) for x in steps[:3]]}, median {sorted(steps)[len(steps) // 2]:.4f}")
        _log(f"  {name}: {r.status.name} after {r.iterations} iterations, {wall / its:.4f} s/iter; "
             f"kernel ms/iter {kernel}; factorizations in order: {_runs(log['fact'])}; host lu_eig "
             f"tier {'ran' if any(t.startswith('lu_eig') for t in log['fact']) else 'did not run'}; "
             f"obj {r.obj!r} (saved {ref!r}); max_memory_allocated "
             f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        _check(r.status.is_success, f"{name}: status {r.status.name}")
        _check(dense_ex2.selfcheck_ok(r.obj, ref, tol), f"{name}: obj {r.obj!r} vs saved {ref!r}")
        out[name] = sizes
        return r, log, sizes

    _log(f"[11] dense Newton: DenseConsEx2 through AutoDiffNlpProblem, n={NEWTON_N}, default ladder")
    r1, log, sizes = solve("dense newton", {"cholesky": "quick tier: K = H + Dx + delta_w I"})
    _check(sizes.get(n_chol, 0) > 0, f"dense newton: no launch {n_chol}")
    r2, _, _ = solve("dense newton, again", {"cholesky": "quick tier"})
    same = (r1.iterations == r2.iterations and r1.obj == r2.obj and r1.x.tobytes() == r2.x.tobytes())
    _log(f"  two runs give the same bits: {same}")
    _check(same, "dense newton: two runs differ")
    x = torch.as_tensor(r1.x, device=dev)
    h_ms, h_gib = _hessian_cost(torch, dense_ex2, x)
    _log(f"  torch.func.hessian at n={NEWTON_N}: {h_ms:.3f} ms, peak {h_gib:.3f} GiB above the live tensors")
    out["hessian"] = {"ms": h_ms, "peak_gib": h_gib}

    _log(f"[12] dense Newton with the device safe tier pinned (linear_solver_dense=ldl_nopiv, "
         f"_safe_mode=1): the XDYcYd saddle {NEWTON_N + 7}")
    _, log, sizes = solve("dense newton safe", {"ldl_nopiv": "device safe tier", "cholesky": "quick tier"},
                          linear_solver_dense="ldl_nopiv", solver_cls=_forced_safe_newton(filter_ipm))
    _check(sizes.get(n_ldl, 0) > 0, f"dense newton safe: no launch {n_ldl}")
    st = log["strategy"]
    accepted = [(int(nn), m) for nn, m, ok in log["inertia"] if ok]
    _log(f"  negative pivots of each accepted safe-tier factorization (m_c+m_d): "
         f"{[f'{nn} ({m})' for nn, m in accepted]}; rejected {sum(1 for *_, ok in log['inertia'] if not ok)}; "
         f"inertia mismatches {st._inertia_mismatches}; three-mismatch switch to the curvature test "
         f"{'fired' if st._inertia_mismatches >= 3 else 'did not fire'}")

    _log(f"[13] dense Newton with kkt_fact_dtype=float32, n={NEWTON_N}")
    _, log, sizes = solve("dense newton f32", {"cholesky": "quick tier in f32"}, kkt_fact_dtype="float32")
    f32 = f"cholesky:{NEWTON_N}:float32"
    _check(sizes.get(f32, 0) > 0, f"dense newton f32: no launch {f32}")
    n_f32 = sum(1 for t in log["fact"] if t.endswith("f32"))
    _log(f"  dense newton f32: {n_f32} of {len(log['fact'])} factorizations in f32 "
         f"({n_f32 / max(len(log['fact']), 1):.3f}); demotions {log['demotions']}; inner FGMRES "
         f"iterations {log['ir_inner']}")
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


@contextlib.contextmanager
def _fr_log(torch, filter_ipm, K):
    """Record the restorations of a solve: each soft restoration
    (iteration, accepted); per nested FR solve its iterations, status,
    acceptance, wall time and kernel launches by size; the slot and dtype
    of each factorization inside a nested solve; and the dtype and shape
    (rows, columns) of each matrix-free LSQ solve. With ``K.stats.timing``
    on, also the summed kernel milliseconds inside each nested solve."""
    from hiop_tpu_torch.optimization import duals_update as du
    from hiop_tpu_torch.optimization import fr_problem as frm

    log = {"soft": [], "full": [], "nested_fact": [], "matfree": []}
    apply, soft, matfree = frm.apply_feasibility_restoration, filter_ipm.FilterIPMBase._solve_soft_fr, \
        du.lsq_duals_matfree
    S_mds, S_dense = filter_ipm._MdsStrategy, filter_ipm._NewtonDenseStrategy
    facts = {S: S._factorize for S in (S_mds, S_dense)}

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def applied(solver, *a, **k):
        sync()
        before, ev0, t0 = dict(K.stats.sizes), len(K.stats.events), time.perf_counter()
        out = apply(solver, *a, **k)
        sync()
        wall = time.perf_counter() - t0
        kernel_ms: dict = {}
        for name, n, dname, start, end in K.stats.events[ev0:]:
            key = f"{name}:{n}:{dname}"
            kernel_ms[key] = kernel_ms.get(key, 0.0) + start.elapsed_time(end)
        log["full"].append(dict(
            iteration=solver.iter_num, nested_iterations=solver.last_fr["iterations"],
            status=solver.last_fr["status"].name, accepted=out is not None, wall=wall,
            launches={f"{key[0]}:{key[1]}:{key[2]}": v - before.get(key, 0)
                      for key, v in sorted(K.stats.sizes.items()) if v > before.get(key, 0)},
            kernel_ms=kernel_ms))
        return out

    def softened(self, *a, **k):
        out = soft(self, *a, **k)
        log["soft"].append((self.iter_num, out is not None))
        return out

    def tagged(S):
        def fact(self):
            if isinstance(self.nlp.problem, frm.FeasibilityRestorationProblem):
                slot = self._safe_tiers[self._safe_mode - 1] if self._safe_mode else "quick"
                log["nested_fact"].append(f"{slot}-{'f32' if self.fact_dtype == torch.float32 else 'f64'}")
            return facts[S](self)
        return fact

    def counted(Jc, Jd, *a, **k):
        dtype = getattr(Jc, "vals", Jc).dtype   # a TripletMatrix carries its values
        log["matfree"].append((str(dtype).replace("torch.", ""), Jc.shape[0] + Jd.shape[0], Jc.shape[1]))
        return matfree(Jc, Jd, *a, **k)

    frm.apply_feasibility_restoration, filter_ipm.FilterIPMBase._solve_soft_fr = applied, softened
    du.lsq_duals_matfree = counted
    for S in facts:
        S._factorize = tagged(S)
    try:
        yield log
    finally:
        frm.apply_feasibility_restoration, filter_ipm.FilterIPMBase._solve_soft_fr = apply, soft
        du.lsq_duals_matfree = matfree
        for S, f in facts.items():
            S._factorize = f


@contextlib.contextmanager
def _nested_on_device_safe_tier(filter_ipm):
    """Start every nested FR solve's MDS strategy in the device LDL^T safe
    tier (its ladder's ``ldl_nopiv`` slot)."""
    from hiop_tpu_torch.optimization import fr_problem as frm

    S = filter_ipm._MdsStrategy
    init = S.__init__

    def pinned(self, nlp, *a, **k):
        init(self, nlp, *a, **k)
        if isinstance(nlp.problem, frm.FeasibilityRestorationProblem):
            self._safe_mode = self._safe_tiers.index("ldl_nopiv") + 1

    S.__init__ = pinned
    try:
        yield
    finally:
        S.__init__ = init


def _fr_report(name: str, log) -> dict:
    """Print what the restorations of one solve did; returns the kernel
    launches inside its nested solves, by size."""
    launches: dict = {}
    for f in log["full"]:
        for key, v in f["launches"].items():
            launches[key] = launches.get(key, 0) + v
        _log(f"  {name}: nested FR solve at iteration {f['iteration']}: {f['status']} after "
             f"{f['nested_iterations']} nested iterations, accepted {f['accepted']}, "
             f"{f['wall']:.3f} s ({f['wall'] / max(f['nested_iterations'], 1):.4f} s per nested "
             f"iteration), launches inside it {f['launches']}"
             + (f", kernel ms inside it {({k: round(v, 3) for k, v in f['kernel_ms'].items()})}"
                if f["kernel_ms"] else ""))
    _log(f"  {name}: soft restorations (iteration, accepted) {log['soft']}; nested factorizations "
         f"in order: {_runs(log['nested_fact'])}; matrix-free LSQ solves (dtype, rows, columns) "
         f"{log['matfree']}")
    return launches


def phase_restoration(torch) -> dict:
    """Phases 14-16: forced feasibility restoration on the MDS and dense
    paths. Returns, by phase, the kernel launches inside the nested solves
    and their summed kernel milliseconds (CUDA events per launch), by size."""
    from hiop_tpu_torch.examples import acopf_mds, dense_ex1, dense_ex2
    from hiop_tpu_torch.linalg import kernels as K
    from hiop_tpu_torch.optimization import filter_ipm

    out = {}

    def forced(name, run, need, nested_need):
        K.stats.timing = True
        with _fr_log(torch, filter_ipm, K) as log:
            r, wall, _, sizes = _solve_phase(torch, name, run, need)
        K.stats.timing = False
        launches = _fr_report(name, log)
        _check(log["full"], f"{name}: no nested FR solve ran")
        for key, why in nested_need.items():
            _check(launches.get(key, 0) > 0, f"{name}: no launch {key} inside the nested solve ({why})")
        kernel_ms: dict = {}
        for f in log["full"]:
            for key, v in f["kernel_ms"].items():
                kernel_ms[key] = kernel_ms.get(key, 0.0) + v
        out[name] = dict(launches=launches, kernel_ms=kernel_ms)
        return r, wall, log, launches

    _log("[14] forced restoration: ACOPF B=32 f64, force_resto=yes, to convergence")
    r, _, _, _ = forced("acopf B=32 FR", lambda: acopf_mds.solve(32, verbosity_level=0, force_resto="yes"),
                        {"cholesky": "quick tier"}, {"cholesky:288:float64": "the nested quick tier's S"})
    ref, tol = acopf_mds.SELFCHECK[32]
    _check(r.status.is_success, f"acopf B=32 FR: status {r.status.name}")
    _check(abs(r.obj - ref) <= tol * max(1.0, abs(ref)), f"acopf B=32 FR: obj {r.obj!r} vs saved {ref!r}")

    m = 9 * FULL_B
    n_d = max(4, FULL_B // 5)
    n_fr, saddle = 10 * FULL_B + n_d + 2 * m, (n_d + m + 127) // 128 * 128
    name = f"acopf B={FULL_B} FR"
    _log(f"[15] forced restoration at full width: ACOPF B={FULL_B} (nested n = {n_fr}, m = {m}), "
         f"capped at max_iter={B512_MAX_ITER}")
    torch.cuda.reset_peak_memory_stats()
    r, wall, log, launches = forced(
        name, lambda: acopf_mds.solve(FULL_B, verbosity_level=0, force_resto="yes", max_iter=B512_MAX_ITER),
        {"cholesky": "quick tier"}, {f"cholesky:{m}:float64": "the nested quick tier's S"})
    if any(t.startswith("ldl_nopiv") for t in log["nested_fact"]):
        _check(launches.get(f"ldl_nopiv:{saddle}:float64", 0) > 0,
               f"{name}: a device safe tier ran in the nested solve without an LDL^T at {saddle}")
    _check(("float32", m, n_fr) in log["matfree"],
           f"{name}: the nested solve's LSQ initialization did not take the f32 matrix-free branch")
    _check(r.obj == r.obj and abs(r.obj) < float("inf"), f"{name}: objective {r.obj!r}")
    _log(f"  {name}: {r.status.name} after {r.iterations} iterations, "
         f"{wall / max(r.iterations, 1):.4f} s/iter over the whole solve; restoration accepted within "
         f"the cap: {log['full'][0]['accepted']}; max_memory_allocated "
         f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    # the same with the nested solve pinned to the device LDL^T safe tier
    # from its first iteration (as phase 12 pins the dense one): the
    # saddle's LDL^T inside the nested solve at full width
    torch.cuda.reset_peak_memory_stats()
    with _nested_on_device_safe_tier(filter_ipm):
        r, wall, log, launches = forced(
            name + ", nested device safe tier",
            lambda: acopf_mds.solve(FULL_B, verbosity_level=0, force_resto="yes", max_iter=B512_MAX_ITER),
            {"cholesky": "quick tier"}, {f"ldl_nopiv:{saddle}:float64": "the nested device safe tier"})
    _log(f"  {name}, nested device safe tier: {r.status.name} after {r.iterations} iterations; "
         f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    _log(f"[16] forced restoration on the dense paths: QN dense_ex1 n={QN_N}, Newton dense_ex2 n={NEWTON_N}")
    r, _, _, _ = forced("dense_ex1 FR", lambda: dense_ex1.solve(QN_N, verbosity_level=0, force_resto="yes"),
                        {"cholesky": "the low-rank KKT's m x m Schur system"}, {})
    ref, tol = dense_ex1.SELFCHECK[QN_N]
    _check(r.status.is_success, f"dense_ex1 FR: status {r.status.name}")
    _check(dense_ex1.selfcheck_ok(r.obj, ref, tol), f"dense_ex1 FR: obj {r.obj!r} vs saved {ref!r}")
    k = NEWTON_N + 2 * 4
    r, _, _, _ = forced(
        "dense newton FR", lambda: dense_ex2.solve_newton(NEWTON_N, verbosity_level=0, force_resto="yes"),
        {"cholesky": "quick tier"}, {f"cholesky:{k}:float64": f"the nested quick tier's K at {k}^2"})
    ref, tol = dense_ex2.SELFCHECK[NEWTON_N]
    _check(r.status.is_success, f"dense newton FR: status {r.status.name}")
    _check(dense_ex2.selfcheck_ok(r.obj, ref, tol), f"dense newton FR: obj {r.obj!r} vs saved {ref!r}")
    return out


def phase_aux(torch, phase4) -> None:
    """Phase 17: checkpoint save and resume, write_kkt, deepchecks."""
    from hiop_tpu_torch.examples import mds_ex1

    d = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "mds_ex1_state.npz")
    if os.path.exists(path):
        os.remove(path)

    def run(name, **opts):
        r, _, _, _ = _solve_phase(torch, name, lambda: mds_ex1.solve(400, 100, verbosity_level=0, **opts),
                                  {"cholesky": "quick tier"})
        return r

    part = run("mds_ex1 checkpointed", max_iter=5, checkpoint_save="yes", checkpoint_save_every_N_iter=2,
               checkpoint_file=path)
    _check(part.iterations == 5 and os.path.exists(path), "checkpoint: no file after 5 iterations")
    resumed = run("mds_ex1 resumed", checkpoint_load_on_start="yes", checkpoint_file=path)
    same = (resumed.status == phase4.status and resumed.iterations + 4 == phase4.iterations
            and resumed.obj == phase4.obj and resumed.x.tobytes() == phase4.x.tobytes())
    _log(f"  checkpoint at iteration 4, resumed: {resumed.iterations} more iterations; the same bits as "
         f"the uninterrupted solve (phase 4): {same}")
    _check(same, "checkpoint: the resumed solve differs from the uninterrupted one")
    cwd = os.getcwd()
    for f in os.listdir(d):
        if f.endswith(".npz") and "_kkt_iter" in f:
            os.remove(os.path.join(d, f))
    os.chdir(d)
    try:
        run("mds_ex1 write_kkt", write_kkt="yes", max_iter=3)
    finally:
        os.chdir(cwd)
    dumps = sorted(f for f in os.listdir(d) if "_kkt_iter" in f)
    _log(f"  write_kkt: {dumps}")
    _check(len(dumps) == 3, f"write_kkt: {len(dumps)} dumps for 3 iterations")
    checked = run("mds_ex1 deepchecks", deepchecks="yes")
    same = checked.obj == phase4.obj and checked.x.tobytes() == phase4.x.tobytes()
    _log(f"  deepchecks: the same bits as phase 4: {same}")
    _check(same, "deepchecks changed the solve")


@contextlib.contextmanager
def _count_syncs(torch):
    """Count the calls that make the host wait for the device: ``.item()``,
    ``.tolist()``, ``bool``/``float``/``int`` of a CUDA tensor and
    ``.cpu()`` of one."""
    counts = {"syncs": 0}
    T = torch.Tensor
    names = ("item", "tolist", "__bool__", "__float__", "__int__", "cpu")
    saved = {k: getattr(T, k) for k in names}

    def wrap(f):
        def counted(self, *a, **k):
            if self.is_cuda:
                counts["syncs"] += 1
            return f(self, *a, **k)
        return counted

    for k in names:
        setattr(T, k, wrap(saved[k]))
    try:
        yield counts
    finally:
        for k, f in saved.items():
            setattr(T, k, f)


@contextlib.contextmanager
def _sparse_direct_log(filter_ipm):
    """Record each sparse-direct iteration's backend (after the chronic
    switch), the last strategy, and the seconds spent in the host
    factorizations, the host solves, and the device<->host copies."""
    from hiop_tpu_torch.kkt import sparse_direct as sd

    log = {"backend": [], "strategy": None, "factorize": 0.0, "solve": 0.0, "copies": 0.0}
    S = filter_ipm._SparseDirectStrategy
    prepare, to_host, to_device = S.prepare, filter_ipm._to_host, filter_ipm._to_device
    saved = {(C, k): getattr(C, k)
             for C in (sd.SparseXDYcYdKKT, sd.SparseXYcYdKKT, sd.DeviceSparseXDYcYdKKT)
             for k in ("factorize", "solve")}

    def timed(key, f):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                log[key] += time.perf_counter() - t0
        return run

    def kept(self, *a, **k):
        out = prepare(self, *a, **k)
        log["backend"].append(self._solver_name)
        log["strategy"] = self
        return out

    S.prepare = kept
    filter_ipm._to_host, filter_ipm._to_device = timed("copies", to_host), timed("copies", to_device)
    for (C, k), f in saved.items():
        setattr(C, k, timed(k, f))
    try:
        yield log
    finally:
        S.prepare = prepare
        filter_ipm._to_host, filter_ipm._to_device = to_host, to_device
        for (C, k), f in saved.items():
            setattr(C, k, f)


def _sparse_phase(torch, name, run, need):
    """One solve of the sparse path with the launch counts at zero, the
    per-launch kernel events on; returns (result, wall, launches and kernel
    ms by size)."""
    from hiop_tpu_torch.linalg import kernels as K

    K.stats.timing = True
    try:
        r, wall, _, sizes = _solve_phase(torch, name, run, need)
        kernel_ms: dict = {}
        for kname, n, dname, start, end in K.stats.events:
            key = f"{kname}:{n}:{dname}"
            kernel_ms[key] = kernel_ms.get(key, 0.0) + start.elapsed_time(end)
    finally:
        K.stats.timing = False
    return r, wall, dict(launches=sizes, kernel_ms=kernel_ms)


def phase_sparse(torch, dev) -> dict:
    """Phases 18-22: the sparse formulation (``NlpSparse``) on the card.
    Returns, by phase, the kernel launches and their summed kernel
    milliseconds (CUDA events per launch), by size."""
    from hiop_tpu_torch import NlpOptions, NlpSparse
    from hiop_tpu_torch.examples import acopf_mds, mds_ex2, sparse_ex1, sparse_ex2, sparse_ex3, sparse_ex4
    from hiop_tpu_torch.kkt import mds as kkt_mds
    from hiop_tpu_torch.linalg import cholesky as chol
    from hiop_tpu_torch.linalg import kernels as K
    from hiop_tpu_torch.linalg import krylov
    from hiop_tpu_torch.linalg import ldl_blocked
    from hiop_tpu_torch.optimization import filter_ipm

    out = {}
    n = SPARSE_N
    _log(f"[18] sparse: sparse_ex1 n={n}, default options (the host sparse-direct KKT over SuperLU)")
    with _sparse_direct_log(filter_ipm) as log, _count_syncs(torch) as syncs:
        r, wall, got = _sparse_phase(torch, "sparse_ex1 splu", lambda: sparse_ex1.solve(n, verbosity_level=0), {})
    its = max(r.iterations, 1)
    st = log["strategy"]
    _check(st is not None, "sparse_ex1: the sparse-direct strategy did not run")
    ref, tol = sparse_ex1.SELFCHECK[n]
    _log(f"  sparse_ex1 splu: {r.status.name} after {r.iterations} iterations, {wall / its:.4f} s/iter; "
         f"backends by iteration: {_runs(log['backend'])}; n_fact_no_inertia "
         f"{st.stats.kkt.n_fact_no_inertia}; host syncs per iteration {syncs['syncs'] / its:.2f}; seconds "
         f"in factorize {log['factorize']:.3f}, in solve {log['solve']:.3f}, in copies {log['copies']:.3f} "
         f"(of {wall:.3f}); obj {r.obj!r} (saved {ref!r})")
    _check(r.status.is_success, f"sparse_ex1 splu: status {r.status.name}")
    _check(sparse_ex1.selfcheck_ok(r.obj, ref, tol), f"sparse_ex1 splu: obj {r.obj!r} vs saved {ref!r}")
    out["sparse_ex1 splu"] = got

    m = n - 1
    key = f"cholesky:{m}:float64"
    _log(f"[19] sparse: sparse_ex1 n={n}, KKTLinsys=normaleqn (the Cholesky kernel at {m}^2)")
    r, wall, got = _sparse_phase(
        torch, "sparse_ex1 normaleqn", lambda: sparse_ex1.solve(n, verbosity_level=0, KKTLinsys="normaleqn"),
        {"cholesky": f"the {m} x {m} normal-equations system"})
    _check(got["launches"].get(key, 0) > 0, f"sparse_ex1 normaleqn: no launch {key}")
    its = max(r.iterations, 1)
    A = _spd(torch, m, m, torch.float64, dev)
    L, Lp = chol.cholesky(A), chol.cholesky_plain(A)
    torch.cuda.synchronize()
    err = _rel(torch, L, Lp)
    _check(err <= 1e-10, f"cholesky float64 n={m}: rel err {err:.3e}")
    ms = _event_ms(torch, lambda: chol.cholesky(A), 10)
    plain_ms = _event_ms(torch, lambda: chol.cholesky_plain(A), 1)
    lib_ms = _event_ms(torch, lambda: torch.linalg.cholesky(A), 10)
    bms, by = _bound_ms(m, 8, "float64")
    n_launch = got["launches"].get(key, 0)
    per_launch = got["kernel_ms"].get(key, 0.0) / max(n_launch, 1)
    _log(f"  sparse_ex1 normaleqn: {r.status.name} after {r.iterations} iterations, {wall / its:.4f} s/iter; "
         f"{n_launch} launches at {m}^2, {per_launch:.3f} ms per launch in the solve (CUDA events); "
         f"alone: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.linalg.cholesky {lib_ms:.3f} ms, "
         f"bound {bms:.4f} ms ({by}), rel err {err:.2e}; obj {r.obj!r}")
    ref, tol = sparse_ex1.SELFCHECK[n]
    _check(r.status.is_success, f"sparse_ex1 normaleqn: status {r.status.name}")
    _check(sparse_ex1.selfcheck_ok(r.obj, ref, tol), f"sparse_ex1 normaleqn: obj {r.obj!r} vs saved {ref!r}")
    out["sparse_ex1 normaleqn"] = dict(got, alone=dict(
        n=m, dtype="float64", max_abs_err=float((L - Lp).abs().max()), ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=bms, bound_by=by, ms_per_launch_in_solve=per_launch))

    n2 = SPARSE_SMALL_N
    _log(f"[20] sparse: the dense ladder of sparse_ex2 n={n2} and sparse_ex4, sparse_ex3 n={n}, "
         f"mds_ex2 400/100")
    ldl = 0
    for name, run, ref in (
        ("sparse_ex2", lambda: sparse_ex2.solve(n2, verbosity_level=0), sparse_ex2.SELFCHECK[n2]),
        ("sparse_ex4", lambda: sparse_ex4.solve(verbosity_level=0), sparse_ex4.SELFCHECK[2]),
    ):
        with _dense_log(filter_ipm, krylov) as dlog:
            r, wall, got = _sparse_phase(torch, name, run, {"cholesky": "quick tier"})
        ldl += sum(v for k, v in got["launches"].items() if k.startswith("ldl_nopiv:"))
        _log(f"  {name}: {r.status.name} after {r.iterations} iterations; factorizations in order: "
             f"{_runs(dlog['fact'])}; obj {r.obj!r} (saved {ref[0]!r})")
        _check(r.status.is_success, f"{name}: status {r.status.name}")
        _check(sparse_ex1.selfcheck_ok(r.obj, *ref), f"{name}: obj {r.obj!r} vs saved {ref[0]!r}")
        out[name] = got
    # the LDL^T kernel alone at the size of sparse_ex2's XDYcYd saddle
    # (n + 2 m_ineq + m_eq = 1500, padded to 1536), against its plain version
    M, m_neg = _saddle(torch, 1500, 1500, torch.float64, dev)
    f = ldl_blocked.ldl_factor(M)
    n_p = f.L.shape[0]
    A = ldl_blocked._pad_sym(M, n_p)
    Lp, dp = ldl_blocked.ldl_nopiv_plain(A)
    torch.cuda.synchronize()
    err = max(_rel(torch, f.L, Lp), _rel(torch, f.d, dp))
    _check(bool(f.ok) and int(f.n_neg) == m_neg and err <= 1e-9, f"ldl float64 n=1500: rel err {err:.3e}")
    ms = _event_ms(torch, lambda: ldl_blocked.ldl_nopiv(A), 20)
    plain_ms = _event_ms(torch, lambda: ldl_blocked.ldl_nopiv_plain(A), 2)
    bms, by = _bound_ms(n_p, 8, "float64")
    _log(f"  ldl_nopiv float64 n=1500->{n_p} alone: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
         f"{bms:.4f} ms ({by}), rel err {err:.2e}")
    out["sparse_ex2"]["alone"] = dict(
        n=n_p, dtype="float64", max_abs_err=max(float((f.L - Lp).abs().max()), float((f.d - dp).abs().max())),
        ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by)
    if ldl == 0:
        _log("  neither reached the device safe tier: sparse_ex2 again with it pinned (_safe_mode = 1)")
        o = NlpOptions()
        o.update(Hessian="analytical_exact", verbosity_level=0, linear_solver_dense="ldl_nopiv")
        r, wall, got = _sparse_phase(
            torch, "sparse_ex2 safe",
            lambda: _forced_safe_newton(filter_ipm)(NlpSparse(sparse_ex2.SparseEx2(n2), o)).run(),
            {"ldl_nopiv": "device safe tier"})
        _check(r.status.is_success, f"sparse_ex2 safe: status {r.status.name}")
        out["sparse_ex2 safe"] = got
    # Ex3 at its largest self-check size, where the default route is the
    # host sparse-direct KKT: on the dense ladder of the card (n = 500) its
    # outcome is decided by rounding, in hiop_tpu too (ROADMAP section 3)
    with _sparse_direct_log(filter_ipm) as log:
        r, wall, got = _sparse_phase(torch, "sparse_ex3", lambda: sparse_ex3.solve(n, verbosity_level=0), {})
    _log(f"  sparse_ex3 ineq_feas n={n}: {r.status.name} after {r.iterations} iterations, backends "
         f"{_runs(log['backend'])}, obj {r.obj!r} (LP optimum {sparse_ex3.LP_OPTIMUM!r}; HiOp stopped at "
         f"{sparse_ex3.SELFCHECK_REFERENCE[n]!r})")
    _check(log["backend"], "sparse_ex3: the sparse-direct strategy did not run")
    _check(r.status.is_success and abs(r.obj - sparse_ex3.LP_OPTIMUM) <= sparse_ex3.LP_TOL,
           f"sparse_ex3: {r.status.name}, obj {r.obj!r}")
    out["sparse_ex3"] = got
    with _tier_log(kkt_mds) as tiers:
        r, wall, got = _sparse_phase(torch, "mds_ex2 400/100", lambda: mds_ex2.solve(400, 100, verbosity_level=0),
                                     {"cholesky": "quick tier"})
    rel = abs((r.obj - mds_ex2.SELFCHECK_OBJ) / mds_ex2.SELFCHECK_OBJ)
    _log(f"  mds_ex2 400/100: {r.status.name} after {r.iterations} iterations, "
         f"{wall / max(r.iterations, 1):.4f} s/iter, safe tiers in order: {_runs(tiers)}; obj {r.obj!r} "
         f"(saved {mds_ex2.SELFCHECK_OBJ!r}, rel {rel:.2e})")
    _check(r.status.is_success and rel <= 1e-6, f"mds_ex2: {r.status.name}, obj {r.obj!r}")
    out["mds_ex2"] = got

    _log("[21] sparse: ACOPF through AcopfSparse on the host sparse-direct path")
    for B, cap in ((256, None), (FULL_B, B512_MAX_ITER)):
        opts = dict(verbosity_level=0, sparse=True)
        if cap:
            opts["max_iter"] = cap
        torch.cuda.reset_peak_memory_stats()
        with _sparse_direct_log(filter_ipm) as log:
            r, wall, got = _sparse_phase(torch, f"acopf sparse B={B}", lambda: acopf_mds.solve(B, **opts), {})
        its = max(r.iterations, 1)
        ref, tol = acopf_mds.SELFCHECK[B]
        _log(f"  acopf sparse B={B}: {r.status.name} after {r.iterations} iterations, {wall / its:.4f} s/iter; "
             f"backends by iteration: {_runs(log['backend'])}; seconds in factorize {log['factorize']:.3f}, "
             f"solve {log['solve']:.3f}, copies {log['copies']:.3f}; obj {r.obj!r} (saved {ref!r}); "
             f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        _check(log["backend"], f"acopf sparse B={B}: the sparse-direct strategy did not run")
        _check(r.obj == r.obj and abs(r.obj) < float("inf"), f"acopf sparse B={B}: objective {r.obj!r}")
        if cap is None or r.status.is_success:
            _check(r.status.is_success, f"acopf sparse B={B}: status {r.status.name}")
            _check(abs(r.obj - ref) <= tol * max(1.0, abs(ref)), f"acopf sparse B={B}: obj {r.obj!r} vs {ref!r}")
        out[f"acopf sparse B={B}"] = got

    _log(f"[22] sparse: forced restoration (force_resto=yes), sparse_ex1 n={n2}")
    from hiop_tpu_torch.optimization import fr_problem as frm

    made = []
    init = frm.SparseFeasibilityRestorationProblem.__init__

    def spied(self, *a, **k):
        made.append(type(self).__name__)
        return init(self, *a, **k)

    frm.SparseFeasibilityRestorationProblem.__init__ = spied
    try:
        K.stats.timing = True
        with _fr_log(torch, filter_ipm, K) as log:
            r, wall, _, sizes = _solve_phase(
                torch, "sparse_ex1 FR", lambda: sparse_ex1.solve(n2, verbosity_level=0, force_resto="yes"),
                {"cholesky": "quick tier"})
    finally:
        K.stats.timing = False
        frm.SparseFeasibilityRestorationProblem.__init__ = init
    launches = _fr_report("sparse_ex1 FR", log)
    _check(made == ["SparseFeasibilityRestorationProblem"], f"sparse_ex1 FR: FR problems {made}")
    f = log["full"][0]
    _log(f"  sparse_ex1 FR: nested iterations {f['nested_iterations']}, the base accepted the nested point: "
         f"{f['accepted']}" + ("" if f["accepted"] else " (linear constraints: the acceptance test compares "
                                                      "rounding noise, ROADMAP section 3)"))
    ref, tol = sparse_ex1.SELFCHECK[n2]
    _check(r.status.is_success, f"sparse_ex1 FR: status {r.status.name}")
    _check(sparse_ex1.selfcheck_ok(r.obj, ref, tol), f"sparse_ex1 FR: obj {r.obj!r} vs saved {ref!r}")
    kernel_ms: dict = {}
    for g in log["full"]:
        for key, v in g["kernel_ms"].items():
            kernel_ms[key] = kernel_ms.get(key, 0.0) + v
    out["sparse_ex1 FR"] = dict(launches=sizes, kernel_ms=kernel_ms, nested_launches=launches)
    return out


def _launch_count(torch, fn, top: int = 0):
    """Device operations (kernels, memsets, copies) that one eager call of
    ``fn`` launches, counted by ``torch.profiler``; with ``top``, also the
    ``top`` operation names with the most device time, as (name, count,
    ms)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (k + 1, us + e.time_range.elapsed_us())
    count = sum(k for k, _ in by_name.values())
    if not top:
        return count
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return count, [(name[:60], k, us / 1e3) for name, (k, us) in ranked]


def _busy_ms(torch, run):
    """(device busy ms, wall s) of ``run()`` under ``torch.profiler``: the
    summed durations of its device operations, and the host clock."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e3, wall


def _wall_ms(torch, fn, reps: int) -> float:
    """Host milliseconds per call of ``fn`` over ``reps`` calls, ending in a
    synchronize: a launch-bound program's time is the host's."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _device_ldl_pattern(torch, dev, name, nlp, dtype, deltas_list, reps):
    """Phase 23 on one pattern: the symbolic analysis, a ladder of
    factorizations with the inertia check, bits of a repeat, the f64 pivots
    against the native host LDL^T, launches and ms per numeric and per
    solve sweep (eager and captured), a certified solve."""
    import numpy as np
    import scipy.sparse as sp

    from hiop_tpu_torch.kkt.sparse_direct import DeviceSparseXDYcYdKKT
    from hiop_tpu_torch.linalg.sparse_device import equilibrate, read_factor_stats
    from hiop_tpu_torch.native.ldl import NativeLdlFactorization

    t0 = time.perf_counter()
    kkt = DeviceSparseXDYcYdKKT(nlp)
    t_sym = time.perf_counter() - t0
    ldl = kkt._ldl
    x0 = torch.as_tensor(nlp.get_starting_point(), dtype=torch.float64, device=dev)
    yc = torch.zeros(nlp.m_eq, dtype=torch.float64, device=dev)
    yd = torch.zeros(nlp.m_ineq, dtype=torch.float64, device=dev)
    h = nlp.eval_hess_vals(x0, 1.0, yc, yd)
    je, ji = nlp.eval_jac_vals_split(x0)
    rng = np.random.default_rng(0)
    Dx = torch.as_tensor(rng.uniform(0.05, 2.0, nlp.n), device=dev)
    Dd = torch.as_tensor(rng.uniform(0.05, 2.0, nlp.m_ineq), device=dev)
    m = nlp.m_eq + nlp.m_ineq
    _log(f"  {name}: ntot {kkt.ntot}, symbolic {t_sym:.2f} s, levels {ldl.n_levels}, lnz {ldl.lnz}, "
         f"update products {ldl.n_update_ops}, factor dtype {str(dtype).replace('torch.', '')}")
    for dw, dc in deltas_list:
        deltas = (dw, dw, dc, dc)
        _check(kkt.factorize(h, Dx, Dd, je, ji, deltas), f"{name}: factorization failed at {deltas}")
        inert = kkt.last_inertia
        _log(f"    deltas (w {dw:g}, c {dc:g}): inertia {inert}" +
             (" (pivots clamped: no inertia, solves IR-certified)" if inert is None else ""))
        _check(inert is None or inert[1:] == (m, 0), f"{name}: inertia {inert}, expected (., {m}, 0)")
    # a second factorization repeats the first bit for bit
    vals = kkt.values_device(h, Dx, Dd, je, ji, deltas)
    vs, _ = equilibrate(vals, kkt._rows_t, kkt._cols_t, kkt.ntot)
    num = ldl.get_numeric(dtype)
    f1, f2 = num(vs), num(vs)
    torch.cuda.synchronize()
    _check(torch.equal(f1.Lx, f2.Lx) and torch.equal(f1.d, f2.d), f"{name}: a repeat changed the factor")
    ok, n_clamped, n_neg = read_factor_stats(f1)
    # the card's f64 pivots and inertia against the native host LDL^T of the
    # same permuted matrix (natural order after the device's permutation)
    f64 = ldl.get_numeric(torch.float64)(vs)
    A = sp.coo_matrix((vs.cpu().numpy(), (kkt._rows, kkt._cols)), shape=(kkt.ntot, kkt.ntot)).tocsc()
    if ldl._perm is not None:
        A = A[ldl._perm][:, ldl._perm]
    host = NativeLdlFactorization(A, ordering="none")
    d_rel = float(np.abs(f64.d.cpu().numpy() - host._D).max() / np.abs(host._D).max())
    ok64, clamped64, neg64 = read_factor_stats(f64)
    dev_inert = (kkt.ntot - neg64, neg64, 0)
    _log(f"    f64 pivots vs the native host LDL^T: max rel diff {d_rel:.2e}; inertia card {dev_inert} "
         f"(clamped {clamped64}), host {host.inertia()}")
    _check(ok64 and clamped64 == 0 and d_rel <= DEVICE_LDL_D_RTOL and dev_inert == host.inertia(),
           f"{name}: f64 pivots {d_rel:.2e} from the host's, inertia {dev_inert} vs {host.inertia()}")
    # launches and ms: one eager numeric and solve sweep, and their graphs
    b = torch.as_tensor(rng.standard_normal(kkt.ntot), device=dev)
    solve = ldl.get_solve()
    launches, top = _launch_count(torch, lambda: ldl._numeric(vs, dtype), top=4)
    got = dict(ntot=kkt.ntot, symbolic_s=t_sym, levels=ldl.n_levels, lnz=ldl.lnz, update_ops=ldl.n_update_ops,
               dtype=str(dtype).replace("torch.", ""), launches_numeric=launches, numeric_top=top,
               launches_sweep=_launch_count(torch, lambda: ldl._solve(f1.Lx, f1.d, b)),
               numeric_eager_ms=_wall_ms(torch, lambda: ldl._numeric(vs, dtype), reps),
               numeric_graph_ms=_wall_ms(torch, lambda: num(vs), reps),
               sweep_eager_ms=_wall_ms(torch, lambda: ldl._solve(f1.Lx, f1.d, b), reps),
               sweep_graph_ms=_wall_ms(torch, lambda: solve(f1, b), reps))
    _log(f"    launches per numeric {got['launches_numeric']}, per solve sweep {got['launches_sweep']}; ms per "
         f"numeric eager {got['numeric_eager_ms']:.3f}, captured {got['numeric_graph_ms']:.3f}; per sweep eager "
         f"{got['sweep_eager_ms']:.3f}, captured {got['sweep_graph_ms']:.3f}")
    _log("    device time of one eager numeric by operation (count, ms): "
         + "; ".join(f"{nm} x{k} {ms:.3f}" for nm, k, ms in top))
    # one certified solve at the last factorization
    rhs = [torch.as_tensor(rng.standard_normal(k), device=dev) for k in (nlp.n, nlp.m_ineq, nlp.m_eq, nlp.m_ineq)]
    _check(kkt.factorize(h, Dx, Dd, je, ji, deltas), f"{name}: refactorization failed")
    out = kkt.solve(*rhs)
    _check(out is not None, f"{name}: the solve was not certified")
    b = torch.cat(rhs)
    rel = float(torch.linalg.vector_norm(b - kkt.coo_matvec(kkt._vals64, torch.cat(out)))
                / torch.linalg.vector_norm(b))
    _log(f"    certified solve: {kkt.last_ir_steps} refinement steps, relative residual {rel:.2e}")
    _check(rel < 1e-8, f"{name}: relative residual {rel:.2e}")
    return got


def phase_device_sparse_ldl(torch, dev) -> dict:
    """Phase 23: the device sparse LDL^T alone, at sparse Ex1's n=200 000
    XDYcYd system (f32, three delta pairs) and the AcopfSparse B=512
    pattern (f64)."""
    from hiop_tpu_torch import NlpOptions, NlpSparse
    from hiop_tpu_torch.examples import acopf_mds, sparse_ex1

    out = {}
    o = NlpOptions()
    o.update(Hessian="analytical_exact", verbosity_level=0, linear_solver_sparse="device_ldl",
             kkt_fact_dtype="float32")
    nlp = NlpSparse(sparse_ex1.SparseEx1(DEVICE_LDL_N), o)
    nlp.finalize_initialization()
    name = f"sparse_ex1 n={DEVICE_LDL_N}"
    out[name] = _device_ldl_pattern(torch, dev, name, nlp, torch.float32,
                                    ((0.0, 1e-8), (1e-6, 1e-8), (1e-2, 1e-2)), 20)
    nlp = NlpSparse(acopf_mds.AcopfSparse(FULL_B), acopf_mds.acopf_options(
        verbosity_level=0, linear_solver_sparse="device_ldl"))
    nlp.finalize_initialization()
    name = f"acopf sparse B={FULL_B}"
    out[name] = _device_ldl_pattern(torch, dev, name, nlp, torch.float64, ((1e-8, 1e-8), (1e-2, 1e-2)), 5)
    return out


@contextlib.contextmanager
def _device_ldl_log(torch):
    """CUDA-event milliseconds and counts of every numeric factorization
    and solve sweep of the device sparse LDL^T while the context is open."""
    from hiop_tpu_torch.linalg.sparse_device import DeviceSparseLDL

    log = {"numeric": [], "sweep": []}
    saved = {k: getattr(DeviceSparseLDL, k) for k in ("get_numeric", "get_solve")}

    def timed(key, get):
        def make(self, *a, **k):
            fn = get(self, *a, **k)

            def run(*args):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args)
                end.record()
                log[key].append((start, end))
                return out
            return run
        return make

    DeviceSparseLDL.get_numeric = timed("numeric", saved["get_numeric"])
    DeviceSparseLDL.get_solve = timed("sweep", saved["get_solve"])
    try:
        yield log
    finally:
        for k, f in saved.items():
            setattr(DeviceSparseLDL, k, f)


def _device_sparse_solve(torch, name, run, strategy_cls, check=None):
    """One solve through the device sparse KKT with the launch counts at
    zero, the strategy class, backends, syncs and device ms recorded."""
    from hiop_tpu_torch.optimization import filter_ipm

    made, stamps = [], []
    make = filter_ipm.FilterIPMNewton._make_strategy

    def kept(self):
        t0 = time.perf_counter()
        st = make(self)
        made.append(st)
        stamps.append(time.perf_counter() - t0)
        prepare = st.prepare

        def stamped(*a, **k):
            stamps.append(time.perf_counter())
            return prepare(*a, **k)

        st.prepare = stamped
        return st

    filter_ipm.FilterIPMNewton._make_strategy = kept
    t_end = []
    try:
        with _sparse_direct_log(filter_ipm) as log, _count_syncs(torch) as syncs, _device_ldl_log(torch) as dlog:
            r, wall, got = _sparse_phase(torch, name, run, {})
            t_end.append(time.perf_counter())
    finally:
        filter_ipm.FilterIPMNewton._make_strategy = make
    classes = [type(m).__name__ for m in made]
    _check(classes[:1] == [strategy_cls], f"{name}: strategy {classes}, expected {strategy_cls}")
    its = max(r.iterations, 1)
    torch.cuda.synchronize()
    ms = {k: (len(v), sum(a.elapsed_time(b) for a, b in v)) for k, v in dlog.items()}
    st = made[0]
    # set-up: the strategy's construction (the symbolic analysis); steady:
    # from the second iteration's start on (the first captures the graphs)
    setup = stamps[0]
    ticks = stamps[1:]
    steady = (t_end[0] - ticks[1]) / (len(ticks) - 1) if len(ticks) > 2 else float("nan")
    _log(f"  {name}: {r.status.name} after {r.iterations} iterations, {wall / its:.4f} s/iter "
         f"({setup:.2f} s in the strategy's construction; {steady:.4f} s/iter from iteration 1 on); strategy "
         f"{classes[0]}" + (f", backends by iteration {_runs(log['backend'])}" if log["backend"] else "") +
         f"; host syncs per iteration {syncs['syncs'] / its:.2f}; device LDL^T numerics {ms['numeric'][0]} "
         f"({ms['numeric'][1]:.1f} ms), solve sweeps {ms['sweep'][0]} ({ms['sweep'][1]:.1f} ms); "
         + "".join(f"kernel {k} x{v} ({got['kernel_ms'].get(k, 0.0) / v:.3f} ms per launch); "
                   for k, v in got["launches"].items())
         + f"obj {r.obj!r}")
    return r, dict(got, iterations=r.iterations, s_per_iter=wall / its, setup_s=setup, steady_s_per_iter=steady,
                   syncs_per_iter=syncs["syncs"] / its,
                   backends=list(log["backend"]), numerics=ms["numeric"], sweeps=ms["sweep"],
                   strategy=classes[0], fallback=st.stats.kkt.n_device_ldl_fallback, wall=wall)


def phase_device_sparse_solves(torch, dev) -> dict:
    """Phases 24-26: whole solves through the device sparse KKT."""
    from hiop_tpu_torch.examples import acopf_mds, sparse_ex1
    from hiop_tpu_torch.kkt.condensed_matfree import CG_CHUNK
    from hiop_tpu_torch.optimization import filter_ipm

    out = {}
    n = SPARSE_N
    ref, tol = sparse_ex1.SELFCHECK[n]
    _log(f"[24] sparse_ex1 n={n}, linear_solver_sparse=device_ldl (phase 18 on splu: 27 iterations, "
         f"0.0723 s/iter, 17.44 host syncs per iteration)")
    # in f32 the pivots clamp at small deltas (no inertia), and after 4
    # regularized iterations the chronic rule switches to the host native
    # LDL^T, as in hiop_tpu; under the default ordering ('auto': natural)
    # its factorization of sparse Ex1 fills densely (35-42 s per
    # factorization), so the f32 run orders with AMD, which the device
    # LDL^T's 'auto' uses anyway
    for label, opts in (("f64", {}), ("f32", dict(kkt_fact_dtype="float32", linear_solver_sparse_ordering="amd"))):
        name = f"sparse_ex1 device_ldl {label}"
        r, got = _device_sparse_solve(
            torch, name, lambda: sparse_ex1.solve(n, verbosity_level=0, linear_solver_sparse="device_ldl", **opts),
            "_SparseDirectStrategy")
        _check(r.status.is_success and sparse_ex1.selfcheck_ok(r.obj, ref, tol),
               f"{name}: {r.status.name}, obj {r.obj!r} vs saved {ref!r}")
        _check(got["fallback"] == 0 and got["backends"][:1] == ["device_ldl"], f"{name}: backends {got['backends']}")
        if label == "f64":
            _check(set(got["backends"]) == {"device_ldl"}, f"{name}: backends {got['backends']}")
        out[name] = got
    # the device's idle share on the sparse path: one profiled solve on each
    # sparse-direct backend (summed device operation time over the wall)
    for ls in ("device_ldl", "splu"):
        busy_ms, wall = _busy_ms(torch, lambda: sparse_ex1.solve(n, verbosity_level=0, linear_solver_sparse=ls))
        _log(f"  sparse_ex1 {ls} under torch.profiler: device busy {busy_ms:.1f} ms of {wall * 1e3:.1f} ms, "
             f"idle share {1.0 - busy_ms / (wall * 1e3):.3f}")
        out[f"sparse_ex1 {ls} profile"] = dict(busy_ms=busy_ms, wall_s=wall, idle_share=1.0 - busy_ms / (wall * 1e3))

    _log("[25] AcopfSparse with linear_solver_sparse=device_ldl (phase 21 on splu: B=256 in 123 iterations at "
         "0.0436 s/iter; B=512 0.1281 s/iter)")
    for B, cap in ((256, None), (FULL_B, B512_MAX_ITER)):
        opts = dict(verbosity_level=0, sparse=True, linear_solver_sparse="device_ldl")
        if cap:
            opts["max_iter"] = cap
        torch.cuda.reset_peak_memory_stats()
        name = f"acopf sparse B={B} device_ldl"
        r, got = _device_sparse_solve(torch, name, lambda: acopf_mds.solve(B, **opts), "_SparseDirectStrategy")
        ref, tol = acopf_mds.SELFCHECK[B]
        peak = torch.cuda.max_memory_allocated() / 2**30
        _log(f"    max_memory_allocated {peak:.3f} GiB")
        _check(got["fallback"] == 0 and got["backends"][:1] == ["device_ldl"], f"{name}: backends {got['backends']}")
        _check(r.obj == r.obj and abs(r.obj) < float("inf"), f"{name}: objective {r.obj!r}")
        if cap is None or r.status.is_success:
            _check(r.status.is_success, f"{name}: status {r.status.name}")
            _check(abs(r.obj - ref) <= tol * max(1.0, abs(ref)), f"{name}: obj {r.obj!r} vs {ref!r}")
        out[name] = dict(got, peak_gib=peak)

    _log(f"[26] the condensed classes: sparse_ex1 n={n} KKTLinsys=condensed; n={CONDENSED_DEVICE_N} with the "
         f"sparse condensed device class forced; n={CG_N} KKTLinsys=condensed linear_solver_sparse=cg")
    # from n = 2000 the strategy choice tries the sparse condensed device
    # class, whose symbolic analysis refuses sparse Ex1 (the lower-only
    # J^T D J pattern orders x_1 first: complete fill, over max_ops), and the
    # dense condensed class takes over, in hiop_tpu too
    ref, tol = sparse_ex1.SELFCHECK[n]
    name = f"sparse_ex1 n={n} condensed"
    r, got = _device_sparse_solve(
        torch, name, lambda: sparse_ex1.solve(n, verbosity_level=0, KKTLinsys="condensed"), "_NewtonDenseStrategy")
    _check(r.status.is_success and sparse_ex1.selfcheck_ok(r.obj, ref, tol),
           f"{name}: {r.status.name}, obj {r.obj!r} vs saved {ref!r}")
    out[name] = got
    name = f"sparse_ex1 n={CONDENSED_DEVICE_N} condensed device (forced)"
    make = filter_ipm.FilterIPMNewton._make_strategy
    filter_ipm.FilterIPMNewton._make_strategy = lambda self: filter_ipm._CondensedSparseDeviceStrategy(
        self.nlp, self.log, self.nlp.runstats)
    try:
        r, got = _device_sparse_solve(
            torch, name, lambda: sparse_ex1.solve(CONDENSED_DEVICE_N, verbosity_level=0, KKTLinsys="condensed",
                                                  max_iter=CONDENSED_DEVICE_ITERS),
            "_CondensedSparseDeviceStrategy")
    finally:
        filter_ipm.FilterIPMNewton._make_strategy = make
    _check(got["numerics"][0] > 0 and r.obj == r.obj, f"{name}: {got['numerics']} numerics, obj {r.obj!r}")
    out[name] = got
    name = f"sparse_ex1 n={CG_N} condensed cg"
    S = filter_ipm._CondensedMatfreeStrategy
    cg_solve, read_info, n_solves, cg_syncs = S._solve, filter_ipm._read_cg_info, [], [0]

    def counted(self, *a):
        with _count_syncs(torch) as c:
            out = cg_solve(self, *a)
        cg_syncs[0] += c["syncs"]
        n_solves.append(out[3][2])  # the iteration count, read after the solve
        return out

    def read_counted(*a):
        with _count_syncs(torch) as c:
            out = read_info(*a)
        cg_syncs[0] += c["syncs"]
        return out

    S._solve, filter_ipm._read_cg_info = counted, read_counted
    try:
        r, got = _device_sparse_solve(
            torch, name, lambda: sparse_ex1.solve(CG_N, verbosity_level=0, KKTLinsys="condensed",
                                                  linear_solver_sparse="cg"), "_CondensedMatfreeStrategy")
    finally:
        S._solve, filter_ipm._read_cg_info = cg_solve, read_info
    k = max(len(n_solves), 1)
    cg_its = int(sum(int(i) for i in n_solves))
    _log(f"    {len(n_solves)} CG solves, {cg_its / k:.1f} CG iterations and {cg_syncs[0] / k:.2f} host syncs "
         f"per solve (CG steps per host read: {CG_CHUNK}); "
         f"|obj - {CG_OBJ}| = {abs(r.obj - CG_OBJ):.2e}")
    _check(r.status.is_success and abs(r.obj - CG_OBJ) < CG_OBJ_TOL, f"{name}: {r.status.name}, obj {r.obj!r}")
    out[name] = dict(got, cg_solves=len(n_solves), cg_iterations=cg_its, cg_syncs=cg_syncs[0])
    return out


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


#: phase 27: the iteration cap of the production solves (B=512 took
#: 316-349 iterations on the ldl_nopiv-only f64 ladder, PERF.md section 5)
FUSED_MAX_ITER = 600
#: phase 28: the iteration cap of the three-mode comparison at B=512
MODES_MAX_ITER = 25
#: phase 27: the ACOPF sizes, the first to convergence
FUSED_B = (256, FULL_B)
#: phase 29: mds_ex1 400/100's objective in the fused modes, as hiop_tpu's
#: fused modes reach it on the CPU (15 iterations, err_nlp 2.77e-6): one
#: barrier reduction per iteration stops them at the example's tolerance
#: 1e-5 before SELFCHECK_OBJ (14 iterations through the general loop)
MDS_EX1_FUSED_OBJ = -49.99471704279668


def _counted_solve(torch, name, build, need):
    """One solve through the fused modes (or the general loop) with the
    launch counts at zero and the host reads counted. ``build()`` returns
    (solver, formulation). Returns (result, wall, sizes, reads, solver)."""
    holder = {}

    def run():
        holder["solver"] = build()[0]
        return holder["solver"].run()

    with _count_syncs(torch) as syncs:
        r, wall, _, sizes = _solve_phase(torch, name, run, need)
    return r, wall, sizes, syncs["syncs"], holder["solver"]


def _acopf_solver(B, **opts):
    from hiop_tpu_torch import FilterIPMNewton, NlpMDS
    from hiop_tpu_torch.examples import acopf_mds

    def build():
        nlp = NlpMDS(acopf_mds.AcopfMds(B), acopf_mds.acopf_options(verbosity_level=0, **opts))
        return FilterIPMNewton(nlp), nlp

    return build


def _ms_per_launch(torch, K) -> dict:
    """Mean CUDA-event milliseconds per launch by (kernel, n, dtype) over
    the launches recorded since the counts were reset."""
    torch.cuda.synchronize()
    acc: dict = {}
    for name, n, dname, s, e in K.stats.events:
        key = f"{name}:{n}:{dname}"
        k, ms = acc.get(key, (0, 0.0))
        acc[key] = (k + 1, ms + s.elapsed_time(e))
    return {key: ms / k for key, (k, ms) in sorted(acc.items())}


def _hist_means(solver, its):
    """Per-iteration means of the fused history's phase counters."""
    h = getattr(solver, "_last_fused_hist", None)
    if h is None:
        return {}
    rows = h[: its + 1]
    return {"n_refact": float(rows[:, 12].mean()), "ir_primary": float(rows[:, 13].mean()),
            "soc_rounds": float(rows[:, 14].mean()), "f32_share": float(h[:its, 10].mean()) if its else 0.0}


def phase_fused(torch, dev) -> dict:
    """Phases 27-29: the fused modes (jit_mode=iteration/solve). Returns,
    by run, the kernel launches by size and the numbers of each run."""
    from hiop_tpu_torch.examples import acopf_mds, dense_ex1, dense_ex2, mds_ex1
    from hiop_tpu_torch.linalg import kernels as K

    # the production options of bench_subs.py:70-75 (the JAX package's
    # benchmark of the yardstick): the fused whole solve with the f32
    # device LDL^T, f64 refinement and the adaptive schedule
    prod = acopf_mds.PRODUCTION_OPTIONS
    out = {}

    _log(f"[27] ACOPF in the production options (jit_mode=solve, kkt_fact_dtype=float32, "
         f"linear_solver_dense=ldl_nopiv, mp_schedule=adaptive), max_iter={FUSED_MAX_ITER}")
    for B in FUSED_B:
        name = f"acopf B={B} production"
        torch.cuda.reset_peak_memory_stats()
        K.stats.timing = True
        r, wall, sizes, reads, solver = _counted_solve(
            torch, name, _acopf_solver(B, max_iter=FUSED_MAX_ITER, **prod),
            {"ldl_nopiv": "the fused step's f32 LDL^T of the saddle"})
        kernel_ms = _ms_per_launch(torch, K)
        K.stats.timing = False
        its = max(r.iterations, 1)
        k = solver.nlp.runstats.kkt
        handoff = solver.fused_fallback
        # the history covers the fused iterations (through a needs-host exit)
        means = _hist_means(solver, handoff[0] if handoff else r.iterations)
        n_sad = (acopf_mds.AcopfMds(B).nd + 9 * B + 127) // 128 * 128
        ref, tol = acopf_mds.SELFCHECK[B]
        got = dict(iterations=r.iterations, status=r.status.name, obj=r.obj, s_per_iter=wall / its,
                   fused_iterations=handoff[0] if handoff else r.iterations,
                   reads_per_iter=reads / its, f32_share=k.n_fact_f32 / max(k.n_fact_total, 1),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=sizes,
                   kernel_ms=kernel_ms, **{
                       f"mean_{c}": v for c, v in means.items() if c != "f32_share"})
        _log(f"  {name}: {r.status.name} after {r.iterations} iterations, {wall / its:.4f} s/iter, "
             f"{reads / its:.2f} host reads per iteration; "
             + (f"needs-host exit at iteration {handoff[0]} ({handoff[1]}), the general loop from there; "
                if handoff else "no needs-host exit; ")
             + f"f32 LDL^T at {n_sad}^2: "
             f"{sizes.get(f'ldl_nopiv:{n_sad}:float32', 0)} launches, f64 LDL^T (inertia verification, "
             f"certification fallback) {sizes.get(f'ldl_nopiv:{n_sad}:float64', 0)}; f32 fraction "
             f"{got['f32_share']:.3f} ({k.n_fact_f32} of {k.n_fact_total}); means per fused iteration: "
             f"ladder refactorizations {means.get('n_refact', 0):.3f}, IR steps "
             f"{means.get('ir_primary', 0):.3f}, SOC rounds {means.get('soc_rounds', 0):.3f}; obj "
             f"{r.obj!r} (saved {ref!r}, |diff| {abs(r.obj - ref):.3e}); max_memory_allocated "
             f"{got['peak_gib']:.3f} GiB; kernel ms per launch by size (CUDA events) "
             f"{ {k: round(v, 4) for k, v in kernel_ms.items()} }; bound ms at {n_sad}^2 "
             f"{_bound_ms(n_sad, 4, 'float32')[0]:.4f} (f32), {_bound_ms(n_sad, 8, 'float64')[0]:.4f} (f64)")
        _check(sizes.get(f"ldl_nopiv:{n_sad}:float32", 0) > 0, f"{name}: no f32 LDL^T at {n_sad}")
        _check(r.obj == r.obj and abs(r.obj) < float("inf"), f"{name}: objective {r.obj!r}")
        if B == FUSED_B[0] or r.status.is_success:
            _check(r.status.is_success, f"{name}: status {r.status.name}")
            _check(abs(r.obj - ref) <= tol * max(1.0, abs(ref)), f"{name}: obj {r.obj!r} vs saved {ref!r}")
        out[name] = got

    _log(f"[28] ACOPF B={FULL_B}, production options under jit_mode=kernels, iteration and solve, "
         f"capped at {MODES_MAX_ITER} iterations")
    for mode in ("kernels", "iteration", "solve"):
        name = f"acopf B={FULL_B} production {mode}"
        build = _acopf_solver(FULL_B, **{**prod, "jit_mode": mode, "max_iter": MODES_MAX_ITER})
        need = ({"cholesky": "the general loop's f32 quick tier"} if mode == "kernels"
                else {"ldl_nopiv": "the fused step's f32 LDL^T"})
        r, wall, sizes, reads, solver = _counted_solve(torch, name, build, need)
        busy_ms, pwall = _busy_ms(torch, lambda: build()[0].run())
        its = max(r.iterations, 1)
        got = dict(iterations=r.iterations, status=r.status.name, s_per_iter=wall / its,
                   reads_per_iter=reads / its, busy_ms=busy_ms, profiled_wall_s=pwall,
                   idle_share=1.0 - busy_ms / (pwall * 1e3), launches=sizes)
        _log(f"  {name}: {r.iterations} iterations, {wall / its:.4f} s/iter, {reads / its:.2f} host reads "
             f"per iteration; under torch.profiler device busy {busy_ms:.1f} ms of {pwall * 1e3:.1f} ms, "
             f"idle share {got['idle_share']:.3f}; obj at the cap {r.obj!r}"
             + (f"; needs-host exit at iteration {solver.fused_fallback[0]}" if solver.fused_fallback else ""))
        out[name] = got

    _log("[29] fused modes on the other paths, beside jit_mode=kernels in this call "
         "(phases 4, 10 and 11)")
    runs = (
        ("mds_ex1 400/100", lambda jm: mds_ex1.solve(400, 100, verbosity_level=0, jit_mode=jm),
         ("kernels", "iteration", "solve"), {"cholesky": "quick tier: K_d and S"},
         lambda r, jm: abs(r.obj - (mds_ex1.SELFCHECK_OBJ if jm == "kernels" else MDS_EX1_FUSED_OBJ)) <= 1e-6),
        (f"dense newton ex2 n={NEWTON_N}",
         lambda jm: dense_ex2.solve_newton(NEWTON_N, verbosity_level=0, jit_mode=jm),
         ("kernels", "solve"), {"cholesky": f"K at {NEWTON_N}^2"},
         lambda r, jm: dense_ex2.selfcheck_ok(r.obj, *dense_ex2.SELFCHECK[NEWTON_N])),
        (f"qn dense_ex1 n={QN_N}", lambda jm: dense_ex1.solve(QN_N, verbosity_level=0, jit_mode=jm),
         ("kernels", "solve"), {"cholesky": "the low-rank KKT's m x m Schur system"},
         lambda r, jm: dense_ex1.selfcheck_ok(r.obj, *dense_ex1.SELFCHECK[QN_N])),
    )
    for label, run, modes, need, right in runs:
        for mode in modes:
            name = f"{label} {mode}"
            with _count_syncs(torch) as syncs:
                r, wall, _, sizes = _solve_phase(torch, name, lambda: run(mode), need)
            its = max(r.iterations, 1)
            busy_ms, pwall = _busy_ms(torch, lambda: run(mode))
            idle = 1.0 - busy_ms / (pwall * 1e3)
            _log(f"  {name}: {r.iterations} iterations, {wall / its:.4f} s/iter, "
                 f"{syncs['syncs'] / its:.2f} host reads per iteration; under torch.profiler device "
                 f"busy {busy_ms:.1f} ms of {pwall * 1e3:.1f} ms, idle share {idle:.3f}")
            _check(r.status.is_success and right(r, mode), f"{name}: {r.status.name}, obj {r.obj!r}")
            out[name] = dict(iterations=r.iterations, s_per_iter=wall / its,
                             reads_per_iter=syncs["syncs"] / its, idle_share=idle, launches=sizes)
    return out


#: phase 30: the batched launches' sizes, the padded saddles of ACOPF B=32
#: (294 -> 384) and B=256 (2355 -> 2432), and the batches
BATCH_N = (294, 2355)
BATCH_S = (8, 32)
#: phase 31: the driver default of ``acopf_mds -contingencies`` (B=32, the
#: basecase and 7 ring-line outages), and hiop_tpu's result on the CPU in
#: f64 (``examples.acopf_mds.solve_contingencies(32, 8)``): status codes
#: (1 Solve_Success, 7 Steplength_Too_Small, a needs-host exit),
#: iterations and objectives per lane
CONT_B, CONT_S = 32, 8
CONT_REF = dict(
    lines=[-1, 0, 4, 9, 13, 18, 22, 27],
    status=[1, 7, 1, 1, 7, 1, 1, 1],
    iterations=[43, 65, 48, 61, 43, 49, 63, 34],
    obj=[20.54726213294539, 20.499600539065494, 20.63800225438471, 20.58384893892166,
         20.506890688054956, 20.56610352968363, 20.55875665054949, 20.718546349261764],
)
#: phase 31: lanes whose outcome hiop_tpu itself decides by rounding: under
#: 1 + 1e-15, 1 - 1e-15 and 1 + 1e-14 scalings of the starting point its
#: basecase lane takes 60, 62 and 62 iterations instead of 43 (all
#: Solve_Success; the other lanes keep theirs). Such a lane is not held to
#: its S=1 run (ROADMAP.md section 3).
CONT_ROUNDING_DECIDED = (0,)
#: phase 32: full width, B=256 with the basecase and 31 ring-line outages,
#: capped; the lanes also solved alone
WIDE_B, WIDE_S, WIDE_MAX_ITER = 256, 32, 300
WIDE_ALONE = (0, 1, 16, 31)
#: phase 32: the iteration cap of the profiled solve (idle share)
WIDE_PROFILE_ITER = 20
#: phase 33: SC-ACOPF PriDec at the example's driver default (B=16, 4
#: outages) and hiop_tpu's ``examples.acopf_pridec.solve(16, 4)`` on the CPU
PRIDEC_B, PRIDEC_S = 16, 4
PRIDEC_REF = dict(status="Solve_Success", iterations=3, obj=10.539369142565487)
#: ``chip_measure.py pridec``: B=32 with 8 outages (about 250 s on the card,
#: most of it in the master solves' and fallback lanes' host lu_eig tier)
#: and hiop_tpu's ``examples.acopf_pridec.solve(32, 8)`` on the CPU
PRIDEC_WIDE_REF = dict(B=32, S=8, status="Solve_Success", iterations=7, obj=41.25101888364181)


def _bound_ms_batch(n: int, S: int, itemsize: int, dtype: str):
    """Least time for S factorizations of n x n: S n^3/3 flops at the
    type's peak against S 2 n^2 itemsize bytes at the memory rate."""
    t_ops = S * (n ** 3 / 3.0) / PEAK_FLOPS[dtype] * 1e3
    t_bytes = S * 2.0 * n * n * itemsize / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_batched_kernels(torch, dev) -> dict:
    """Phase 30: the batched entry points alone. Each matrix's factor bit
    for bit the single-matrix kernel's (with the Cholesky's NaN fill and
    the LDL^T's n_neg/ok per matrix), the batched plain versions at the
    small size, and CUDA-event times of one batched launch against S
    single launches and, for the Cholesky, torch.linalg.cholesky of the
    stack. Returns the rows by kernel."""
    from hiop_tpu_torch.linalg import cholesky as chol
    from hiop_tpu_torch.linalg import ldl_blocked as ldl

    rows = {"cholesky": [], "ldl_nopiv": []}
    tol = {torch.float64: 1e-10, torch.float32: 1e-4}
    tol_ldl = {torch.float64: 1e-9, torch.float32: 1e-3}
    for dt in (torch.float64, torch.float32):
        dname = str(dt).replace("torch.", "")
        itemsize = torch.empty((), dtype=dt).element_size()
        for n_true in BATCH_N:
            n = ldl._padded_size(n_true)
            for S in BATCH_S:
                g = torch.Generator(device=dev).manual_seed(n * 100 + S)
                G = torch.randn(S, n, n, generator=g, dtype=torch.float64, device=dev)
                A = (G @ G.mT / n + torch.eye(n, dtype=torch.float64, device=dev)).to(dt)
                del G
                A_bad = A.clone()
                A_bad[1] = -A_bad[1]
                Lb = chol.cholesky_batched(A_bad)
                same = all(torch.equal(Lb[s].nan_to_num(7.0), chol.cholesky(A_bad[s]).nan_to_num(7.0))
                           for s in range(S))
                lower = torch.tril(torch.ones(n, n, dtype=torch.bool, device=dev))
                _check(same, f"cholesky_batched {dname} n={n} S={S}: a factor differs from the single launch's")
                _check(bool(torch.isnan(Lb[1][lower]).all()) and bool(torch.isfinite(Lb[0]).all()),
                       f"cholesky_batched {dname} n={n} S={S}: the NaN fill is not per matrix")
                Lb = chol.cholesky_batched(A)
                err = None
                if n_true == BATCH_N[0]:
                    err = _rel(torch, Lb, chol.cholesky_plain_batched(A))
                    _check(err <= tol[dt], f"cholesky_batched {dname} n={n} S={S}: vs plain {err:.3e}")
                ms = _event_ms(torch, lambda: chol.cholesky_batched(A), 5)
                single_ms = _event_ms(torch, lambda: [chol.cholesky(A[s]) for s in range(S)], 3)
                lib_ms = _event_ms(torch, lambda: torch.linalg.cholesky(A), 5)
                plain_ms = (_event_ms(torch, lambda: chol.cholesky_plain_batched(A), 1)
                            if n_true == BATCH_N[0] else None)
                bms, by = _bound_ms_batch(n, S, itemsize, dname)
                rows["cholesky"].append(dict(
                    n=n, S=S, dtype=dname, bitwise_single=same, rel_err_plain=err, ms=ms,
                    single_launches_ms=single_ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bms, bound_by=by))
                _log(f"  cholesky_batched {dname:7s} n={n:5d} S={S:2d} bitwise=single {same} "
                     f"rel_err_plain {err if err is None else f'{err:.2e}'} batched {ms:8.3f} ms  "
                     f"{S} singles {single_ms:8.3f} ms  torch.linalg.cholesky {lib_ms:8.3f} ms  "
                     f"bound {bms:.4f} ms ({by})")
                del A, A_bad, Lb
                Ms = [_saddle(torch, n_true, 1000 * S + s, dt, dev) for s in range(S)]
                M = torch.stack([x[0] for x in Ms])
                m = Ms[0][1]
                del Ms
                fb = ldl.ldl_factor_batched(M)
                same = True
                for s in range(S):
                    f1 = ldl.ldl_factor(M[s])
                    same &= torch.equal(fb.L[s], f1.L) and torch.equal(fb.d[s], f1.d)
                    _check(int(fb.n_neg[s]) == int(f1.n_neg) and bool(fb.ok[s]) == bool(f1.ok),
                           f"ldl_factor_batched {dname} n={n} S={S}: n_neg/ok of matrix {s}")
                _check(same, f"ldl_nopiv_batched {dname} n={n} S={S}: a factor differs from the single launch's")
                _check(bool(fb.ok.all()) and bool((fb.n_neg == m).all()),
                       f"ldl_factor_batched {dname} n={n} S={S}: inertia {fb.n_neg.tolist()} != {m}")
                P = ldl._pad_sym(M, n)
                err = None
                if n_true == BATCH_N[0]:
                    Wp, dp = ldl.ldl_nopiv_plain_batched(P)
                    err = max(_rel(torch, fb.L, Wp), _rel(torch, fb.d, dp))
                    _check(err <= tol_ldl[dt], f"ldl_nopiv_batched {dname} n={n} S={S}: vs plain {err:.3e}")
                ms = _event_ms(torch, lambda: ldl.ldl_nopiv_batched(P), 5)
                single_ms = _event_ms(torch, lambda: [ldl.ldl_nopiv(P[s]) for s in range(S)], 3)
                plain_ms = (_event_ms(torch, lambda: ldl.ldl_nopiv_plain_batched(P), 1)
                            if n_true == BATCH_N[0] else None)
                bms, by = _bound_ms_batch(n, S, itemsize, dname)
                rows["ldl_nopiv"].append(dict(
                    n=n, n_true=n_true, S=S, dtype=dname, bitwise_single=same, rel_err_plain=err,
                    ms=ms, single_launches_ms=single_ms, plain_ms=plain_ms, library_ms=None,
                    bound_ms=bms, bound_by=by))
                _log(f"  ldl_nopiv_batched {dname:7s} n={n_true:5d}->{n:5d} S={S:2d} bitwise=single {same} "
                     f"n_neg {m} x {S} rel_err_plain {err if err is None else f'{err:.2e}'} "
                     f"batched {ms:8.3f} ms  {S} singles {single_ms:8.3f} ms  "
                     f"bound {bms:.4f} ms ({by})")
                del M, P, fb
                torch.cuda.empty_cache()
    return rows


def _contingency_run(torch, B, lines, max_iter, **opts):
    """One batched contingency solve with the launch counts at zero: the
    result, its history, the batched solve's stats, the wall time and the
    launches (batched ones by (name, n, dtype, S))."""
    from hiop_tpu_torch.examples import acopf_mds
    from hiop_tpu_torch.linalg import kernels as K
    from hiop_tpu_torch.optimization import batch_solve as bs

    prob = acopf_mds.AcopfContingencyMds(B)
    pnlp = bs.ParametricMdsNlp(prob, prob.th0(), acopf_mds.contingency_options(max_iter=max_iter, **opts))
    batched = bs.build_batched_solve(pnlp)
    params = prob.contingency_params(lines)
    torch.cuda.synchronize()
    K.stats.reset()
    t0 = time.perf_counter()
    (_th, core), _mu, it, st, _err, hist = batched(params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = torch.stack([st.double(), it.double(), core.f.double()]).cpu()
    return dict(st=[int(v) for v in host[0]], it=[int(v) for v in host[1]], obj=host[2].tolist(),
                hist=hist.cpu(), stats=batched.stats, wall=wall, launches=dict(K.stats.launches),
                batches={f"{k[0]}:{k[1]}:{k[2]}:{k[3]}": v for k, v in sorted(K.stats.batches.items())})


def _decisions_part(h_a, h_b, it_a, it_b) -> int:
    """The first history row whose decisions (ls_count, ls_status,
    use_soc, n_refact, soc_rounds) differ; the shorter run's length when
    none does."""
    last = min(it_a, it_b)
    cols = [6, 7, 9, 12, 14]
    for r in range(last + 1):
        if not bool((h_a[r, cols] == h_b[r, cols]).all()):
            return r
    return last + 1


def _need_batched(name, got, kernel):
    _check(got["launches"].get(kernel, 0) > 0, f"{name}: the batched {kernel} never launched")


def phase_contingencies(torch) -> dict:
    """Phases 31-32: SC-ACOPF contingency screening, every scenario's fused
    solve in lockstep. Returns, by run, the batched launches."""
    from hiop_tpu_torch.examples import acopf_mds
    from hiop_tpu_torch.linalg import kernels as K

    out = {}
    _log(f"[31] contingency screening at the driver default: ACOPF B={CONT_B}, "
         f"{CONT_S} scenarios (basecase + {CONT_S - 1} outages), linear_solver_dense=ldl_nopiv")
    lines = acopf_mds.contingency_lines(CONT_B, CONT_S)
    _check(lines == CONT_REF["lines"], f"contingencies: lines {lines} vs {CONT_REF['lines']}")
    got = _contingency_run(torch, CONT_B, lines, 300)
    _need_batched("contingencies B=32", got, "ldl_nopiv_batched")
    s = got["stats"]
    _log(f"  B={CONT_B} x {CONT_S}: status {got['st']} iterations {got['it']} wall {got['wall']:.3f} s "
         f"({s.trips} batched iterations, {got['wall'] / s.trips:.4f} s each); batched launches "
         f"{got['batches']} ({sum(got['batches'].values()) / s.trips:.3f} per batched iteration); "
         f"host reads {s.reads} ({s.reads / s.trips:.3f} per batched iteration); lanes live per "
         f"iteration {s.lanes_live / s.trips:.2f}; stats {s.as_dict()}")
    for k, ln in enumerate(lines):
        st, it, obj = got["st"][k], got["it"][k], got["obj"][k]
        ref_st, ref_it, ref_obj = CONT_REF["status"][k], CONT_REF["iterations"][k], CONT_REF["obj"][k]
        rel = abs(obj - ref_obj) / max(1.0, abs(ref_obj))
        same = st == ref_st and it == ref_it
        _log(f"  lane {k} (outage {ln:3d}): status {st} in {it} iterations, obj {obj!r}; hiop_tpu "
             f"{ref_st} in {ref_it}, {ref_obj!r}, rel diff {rel:.2e}"
             + ("" if same else "  <- differs from hiop_tpu on the CPU"))
        if st == 1 and ref_st == 1:
            _check(rel <= 1e-8, f"contingency lane {k}: obj {obj!r} vs hiop_tpu {ref_obj!r}")
    alone_wall = 0.0
    for k, ln in enumerate(lines):
        one = _contingency_run(torch, CONT_B, [ln], 300)
        alone_wall += one["wall"]
        part = _decisions_part(got["hist"][k], one["hist"][0], got["it"][k], one["it"][0])
        same = one["st"][0] == got["st"][k] and one["it"][0] == got["it"][k]
        diff = abs(one["obj"][0] - got["obj"][k])
        _log(f"  lane {k} alone (S=1): status {one['st'][0]} in {one['it'][0]} iterations, "
             f"|obj - batch lane| {diff:.2e}, decisions equal through row {part - 1}, "
             f"{one['wall']:.3f} s")
        if k in CONT_ROUNDING_DECIDED:
            continue
        _check(same and diff <= 1e-9 * max(1.0, abs(got["obj"][k])) and part == got["it"][k] + 1,
               f"contingency lane {k}: the batch and the lone run differ")
    _log(f"  {CONT_S} lone runs {alone_wall:.3f} s against the batch's {got['wall']:.3f} s")
    out[f"contingencies B={CONT_B} x {CONT_S}"] = got["batches"]

    lines = acopf_mds.contingency_lines(WIDE_B, WIDE_S)
    _log(f"[32] full width: ACOPF B={WIDE_B} (saddle 2355 -> 2432), {WIDE_S} scenarios "
         f"(basecase + {WIDE_S - 1} outages), capped at {WIDE_MAX_ITER}")
    torch.cuda.reset_peak_memory_stats()
    K.stats.timing = True
    got = _contingency_run(torch, WIDE_B, lines, WIDE_MAX_ITER)
    kms = K.stats.device_ms()
    K.stats.timing = False
    _need_batched("contingencies B=256", got, "ldl_nopiv_batched")
    s = got["stats"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_ok = sum(1 for v in got["st"] if v == 1)
    _log(f"  B={WIDE_B} x {WIDE_S}: status {got['st']}; iterations {got['it']}; {n_ok} of {WIDE_S} "
         f"Solve_Success; time to solution {got['wall']:.3f} s, {s.trips} batched iterations, "
         f"{got['wall'] / s.trips:.4f} s each; host reads {s.reads / s.trips:.3f} per batched "
         f"iteration; lanes live per iteration {s.lanes_live / s.trips:.2f}; batched launches "
         f"{got['batches']}, ldl_nopiv_batched {kms.get('ldl_nopiv_batched', 0.0):.1f} ms in all; "
         f"max_memory_allocated {peak:.3f} GiB")
    ref, tol = acopf_mds.SELFCHECK[WIDE_B]
    _log(f"  basecase lane: status {got['st'][0]}, obj {got['obj'][0]!r} (SELFCHECK[{WIDE_B}] {ref!r})")
    if got["st"][0] == 1:
        _check(abs(got["obj"][0] - ref) <= tol * max(1.0, abs(ref)),
               f"B={WIDE_B} basecase lane: obj {got['obj'][0]!r} vs saved {ref!r}")
    out[f"contingencies B={WIDE_B} x {WIDE_S}"] = got["batches"]
    for k in WIDE_ALONE:
        one = _contingency_run(torch, WIDE_B, [lines[k]], WIDE_MAX_ITER)
        part = _decisions_part(got["hist"][k], one["hist"][0], got["it"][k], one["it"][0])
        _log(f"  lane {k} (outage {lines[k]}) alone (S=1): status {one['st'][0]} in {one['it'][0]} "
             f"iterations (batch lane: {got['st'][k]} in {got['it'][k]}), |obj diff| "
             f"{abs(one['obj'][0] - got['obj'][k]):.2e}, decisions equal through row {part - 1}; "
             f"{one['wall']:.3f} s alone ({one['wall'] / max(one['stats'].trips, 1):.4f} s per "
             f"iteration) against {got['wall'] / s.trips:.4f} s per batched iteration of {WIDE_S} lanes")
    busy, wall = _busy_ms(torch, lambda: _contingency_run(torch, WIDE_B, lines, WIDE_PROFILE_ITER))
    _log(f"  profiled solve (B={WIDE_B} x {WIDE_S}, capped at {WIDE_PROFILE_ITER}): device busy "
         f"{busy:.1f} ms of {wall * 1e3:.1f} ms, idle share {1.0 - busy / (wall * 1e3):.3f}")
    return out


def phase_pridec(torch) -> dict:
    """Phase 33: PriDec on the card. Returns, by run, the batched launches."""
    from hiop_tpu_torch.examples import acopf_pridec, pridec_ex1, pridec_ex2
    from hiop_tpu_torch.linalg import kernels as K

    out = {}
    _log("[33] PriDec on the card")

    def counted(name, run):
        torch.cuda.synchronize()
        K.stats.reset()
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        batches = {f"{k[0]}:{k[1]}:{k[2]}:{k[3]}": v for k, v in sorted(K.stats.batches.items())}
        _log(f"  {name}: status {r.status.name} in {r.iterations} PriDec iterations, obj {r.obj!r}, "
             f"convergence {r.convergence:.3e}; wall {wall:.3f} s; launches {dict(K.stats.launches)} "
             f"batched {batches}")
        out[name] = batches
        return r, dict(K.stats.launches), wall

    r, _, _ = counted("pridec_ex1 20 100", lambda: pridec_ex1.solve(20, 100, verbosity_level=0).run())
    _check(abs(r.obj - (0.5 * 100 * 20 + 0.5 * 20)) <= 1e-5, f"pridec_ex1: obj {r.obj!r}")
    r, launches, _ = counted("pridec_ex2 -batched 20 5",
                             lambda: pridec_ex2.solve(20, 5, 5, batched=True, verbosity_level=0).run())
    _check(abs(r.obj - pridec_ex2.SELFCHECK_OBJ) <= 1e-5, f"pridec_ex2 -batched: obj {r.obj!r}")
    _check(launches.get("cholesky_batched", 0) > 0, "pridec_ex2 -batched: no batched Cholesky")
    prob = acopf_pridec.AcopfPriDec(PRIDEC_B, PRIDEC_S, verbosity=0)
    r, launches, wall = counted(f"acopf_pridec B={PRIDEC_B} x {PRIDEC_S}",
                                lambda: acopf_pridec.solve(problem=prob, verbosity_level=0))
    _check(launches.get("ldl_nopiv_batched", 0) > 0, "acopf_pridec: no batched LDL^T")
    rel = abs(r.obj - PRIDEC_REF["obj"]) / abs(PRIDEC_REF["obj"])
    sec = prob.seconds
    _log(f"  acopf_pridec: hiop_tpu {PRIDEC_REF['status']} in {PRIDEC_REF['iterations']} at "
         f"{PRIDEC_REF['obj']!r} (rel diff {rel:.2e}); {prob.n_evals} batched recourse evaluations, "
         f"{len(prob.host_fallbacks)} lanes solved alone on the host {prob.host_fallbacks}; seconds: "
         f"master solves {sec['master']:.3f}, batched recourse {sec['recourse_batched']:.3f}, "
         f"host recourse {sec['recourse_host']:.3f} (wall {wall:.3f})")
    _check(r.status.name == PRIDEC_REF["status"] and r.iterations == PRIDEC_REF["iterations"],
           f"acopf_pridec: {r.status.name} in {r.iterations} PriDec iterations")
    _check(rel <= 1e-8, f"acopf_pridec: obj {r.obj!r} vs hiop_tpu {PRIDEC_REF['obj']!r}")
    return out


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

    r4, _, _, _ = _solve_phase(
        torch, "mds_ex1", lambda: mds_ex1.solve(400, 100, verbosity_level=0),
        {"cholesky": "quick tier"})
    _check(r4.status.is_success, f"mds_ex1: status {r4.status.name}")
    _check(abs(r4.obj - mds_ex1.SELFCHECK_OBJ) <= 1e-6,
           f"mds_ex1: obj {r4.obj!r} vs saved {mds_ex1.SELFCHECK_OBJ!r}")

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

    _log(f"[10] quasi-Newton: HiOp's dense examples at n={QN_N} through FilterIPMQuasiNewton")
    qn = phase_qn(torch)
    dense = phase_dense_newton(torch, dev)
    fr = phase_restoration(torch)
    _log("[17] checkpoints, write_kkt and deepchecks: mds_ex1 400/100")
    phase_aux(torch, r4)
    sparse = phase_sparse(torch, dev)
    _log(f"[23] the device sparse LDL^T alone: sparse_ex1 n={DEVICE_LDL_N} (f32) and AcopfSparse "
         f"B={FULL_B} (f64) patterns")
    phase_device_sparse_ldl(torch, dev)
    phase_device_sparse_solves(torch, dev)
    fused = phase_fused(torch, dev)
    _log(f"[30] the batched kernels alone: S = {BATCH_S} at the saddles n = {BATCH_N}")
    batched_rows = phase_batched_kernels(torch, dev)
    batched = phase_contingencies(torch)
    batched.update(phase_pridec(torch))

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
                shapes=[x for x in rows[name] if x["dtype"] == dname],
                dense_path_launches={
                    phase: {k: v for k, v in sizes.items() if k.startswith(name + ":") and k.endswith(dname)}
                    for phase, sizes in {**qn, **dense}.items() if isinstance(sizes, dict) and phase != "hessian"},
                fr_path_launches={
                    phase: {k: v for k, v in got["launches"].items()
                            if k.startswith(name + ":") and k.endswith(dname)}
                    for phase, got in fr.items()},
                fr_path_kernel_ms={
                    phase: {k: v for k, v in got["kernel_ms"].items()
                            if k.startswith(name + ":") and k.endswith(dname)}
                    for phase, got in fr.items() if got["kernel_ms"]},
                sparse_path_launches={
                    phase: {k: v for k, v in got["launches"].items()
                            if k.startswith(name + ":") and k.endswith(dname)}
                    for phase, got in sparse.items()},
                sparse_path_kernel_ms={
                    phase: {k: v for k, v in got["kernel_ms"].items()
                            if k.startswith(name + ":") and k.endswith(dname)}
                    for phase, got in sparse.items() if got["kernel_ms"]},
                fused_path_launches={
                    run: {k: v for k, v in got["launches"].items()
                          if k.startswith(name + ":") and k.endswith(dname)}
                    for run, got in fused.items()},
                batched_path_launches={
                    run: {k: v for k, v in got.items() if k.startswith(name + "_batched:")
                          and k.split(":")[2] == dname}
                    for run, got in batched.items()},
                batched_shapes=[x for x in batched_rows[name] if x["dtype"] == dname],
                **({"sparse_normaleqn_shape": sparse["sparse_ex1 normaleqn"]["alone"]}
                   if name == "cholesky" and dname == "float64" else {}),
                **({"sparse_ex2_saddle_shape": sparse["sparse_ex2"]["alone"]}
                   if name == "ldl_nopiv" and dname == "float64" else {})))
    _log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
