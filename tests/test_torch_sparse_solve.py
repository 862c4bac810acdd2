"""Whole sparse solves through the port against the JAX package, on the
CPU, in f64.

``FilterIPMNewton`` over ``NlpSparse`` on HiOp's sparse examples, on every
route of the strategy choice (``hiop_tpu/optimization/filter_ipm.py``
``FilterIPMNewton._make_strategy``): the host sparse-direct XDYcYd and
XYcYd KKT over ``splu`` and ``native_ldl`` (triplet Jacobians), the
unreduced full-space KKT over ``splu``, the device XDYcYd KKT
(``device_ldl``, with its refusal fallback to ``splu``), the condensed
classes (matrix-free CG, the sparse condensed device class), and below
n + m = 2000 the dense Newton KKT classes over the Hessian and Jacobian
assembled from the triplets; forced restoration through ``SparseFeasibilityRestorationProblem``;
``FilterIPMQuasiNewton`` over ``NlpSparse``. The standard: the same status,
the same iteration count, the objective to 1e-8 relative, and the same
sparse-direct backends and inertia reports in the same order.

Some runs are decided by rounding, in ``hiop_tpu`` itself, and their
tests hold every decision up to that point (each test says where):
sparse Ex3's maximally rank-deficient LP, ACOPF through the sparse
interface at B=16, and the matrix-free CG on sparse Ex1.
"""

import os

import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import scipy.sparse.linalg  # noqa: F401
import torch
from threadpoolctl import threadpool_limits

import examples.acopf_mds as jax_acopf
import examples.sparse_ex1 as jax_ex1
import examples.sparse_ex2 as jax_ex2
import examples.sparse_ex3 as jax_ex3
import examples.sparse_ex4 as jax_ex4
import hiop_tpu
import hiop_tpu.optimization.filter_ipm as jfi
import hiop_tpu.optimization.fr_problem as jfr
import hiop_tpu_torch
import hiop_tpu_torch.optimization.filter_ipm as tfi
import hiop_tpu_torch.optimization.fr_problem as tfr
from hiop_tpu_torch.examples import acopf_mds, sparse_ex1, sparse_ex2, sparse_ex3, sparse_ex4

# The matrices here are small: torch's intra-op thread pool costs more than it
# gains, and its spinning threads slow the other test workers.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One OpenBLAS thread for numpy/scipy inside these tests: the host
    LU/eigen and SuperLU tiers factorize small matrices, and under six
    pytest-xdist workers on an 8-core CPU OpenBLAS's spinning threads made
    the AcopfSparse test 40x slower (1134 s against 28 s). Only this
    module's tests run under the limit; it is lifted after each."""
    with threadpool_limits(limits=1):
        yield

EXAMPLES = {
    "ex1": (jax_ex1, sparse_ex1, (50,)),
    "ex2": (jax_ex2, sparse_ex2, (50,)),
    "ex3": (jax_ex3, sparse_ex3, (50,)),
    "ex4": (jax_ex4, sparse_ex4, ()),
    "acopf16": (jax_acopf, acopf_mds, (16,)),
}


def _log(fi, fr):
    """Record, in order, each direction's strategy, sparse backend, inertia
    report and safe tier; each line-search test with its inputs; and the FR
    problem class of each nested restoration."""
    log = {"dir": [], "ls": [], "fr": []}
    patches = []
    for S in (fi._SparseDirectStrategy, fi._SparseFullStrategy, fi._NewtonDenseStrategy,
              fi._CondensedMatfreeStrategy, fi._CondensedSparseDeviceStrategy):
        def compute(self, *a, _orig=S.compute_direction, **k):
            out = _orig(self, *a, **k)
            log["dir"].append((type(self).__name__, getattr(self, "_solver_name", None),
                               getattr(getattr(self, "kkt", None), "last_inertia", None),
                               getattr(self, "_safe_mode", None)))
            return out
        patches.append((S, "compute_direction", compute))
    accept = fi.FilterIPMBase._accept_line_search_conditions

    def tested(self, theta_curr, theta_trial, phi_curr, phi_trial, alpha, g):
        out = accept(self, theta_curr, theta_trial, phi_curr, phi_trial, alpha, g)
        log["ls"].append((out, float(theta_curr), float(theta_trial), float(phi_curr),
                          float(phi_trial), float(alpha), float(g), self.theta_min))
        return out

    patches.append((fi.FilterIPMBase, "_accept_line_search_conditions", tested))
    init = fr.FeasibilityRestorationProblem.__init__

    def made(self, *a, **k):
        log["fr"].append(type(self).__name__)
        return init(self, *a, **k)

    patches.append((fr.FeasibilityRestorationProblem, "__init__", made))
    return log, patches


def _solve(pkg, name, args=None, **opts):
    jmod, tmod, default_args = EXAMPLES[name]
    args = default_args if args is None else args
    fi, fr = (jfi, jfr) if pkg is hiop_tpu else (tfi, tfr)
    if pkg is hiop_tpu_torch:
        opts = dict(compute_mode="cpu", **opts)
    if name == "acopf16":
        opts = dict(sparse=True, **opts)
    log, patches = _log(fi, fr)
    with pytest.MonkeyPatch.context() as mp:
        for obj, attr, fn in patches:
            mp.setattr(obj, attr, fn)
        r = (jmod if pkg is hiop_tpu else tmod).solve(*args, verbosity_level=0, **opts)
    return r, log


#: the primal infeasibility below which a linear-constraint iterate's theta
#: is rounding noise (as in tests/test_torch_dense_newton.py)
THETA_NOISE = 1e-12


def _noise_decided(entry) -> bool:
    """Whether a line-search test was decided by rounding noise: near
    feasibility with a noise-level theta, where either the trial's theta is
    noise too (the sufficient theta reduction and, after a rejection, the
    SOC trigger theta_curr <= theta_trial compare noise with noise), or the
    switching condition alpha * (-grad_phi_dx)^s_phi > delta * theta^s_theta
    compares against delta * THETA_NOISE^s_theta or less
    (hiopAlgFilterIPM.cpp:2856-2945)."""
    _, theta, theta_trial, _, _, alpha, g, theta_min = entry
    B = tfi.FilterIPMBase
    if theta >= min(theta_min, THETA_NOISE):
        return False
    if theta_trial < THETA_NOISE:
        return True
    lhs = alpha * (-g) ** B.s_phi if g < 0 else 0.0
    return lhs <= B.delta * THETA_NOISE ** B.s_theta


def _assert_same_decisions(lt, lj):
    """Every line-search outcome the same up to the first one decided by
    rounding noise (sparse Ex1/Ex2 have linear constraints: after the first
    full step theta is noise, summed in another order in each package);
    where no test was, every outcome."""
    k = next((i for i, (a, b) in enumerate(zip(lt["ls"], lj["ls"]))
              if _noise_decided(a) or _noise_decided(b)), None)
    if k is None:
        assert [e[0] for e in lt["ls"]] == [e[0] for e in lj["ls"]]
    else:
        assert [e[0] for e in lt["ls"][:k]] == [e[0] for e in lj["ls"][:k]]


def _parting(lt, lj, rtol=1e-6) -> int:
    """Index of the first line-search test whose inputs (thetas, barrier
    objectives, step, directional derivative) part beyond ``rtol`` between
    the two runs."""
    def agree(a, b):
        return all(abs(x - y) <= rtol * max(abs(y), 1e-300) for x, y in zip(a[1:7], b[1:7]))

    return next((i for i, (a, b) in enumerate(zip(lt["ls"], lj["ls"])) if not agree(a, b)),
                min(len(lt["ls"]), len(lj["ls"])))


def _assert_same_solve(rt, rj):
    assert rt.status.name == rj.status.name
    assert rt.iterations == rj.iterations
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))


#: (example, options, the strategy its directions come from)
RUNS = {
    "ex1_splu": ("ex1", dict(linear_solver_sparse="splu"), "_SparseDirectStrategy"),
    "ex1_native_ldl": ("ex1", dict(linear_solver_sparse="native_ldl"), "_SparseDirectStrategy"),
    "ex1_xycyd_splu": ("ex1", dict(KKTLinsys="xycyd", linear_solver_sparse="splu"), "_SparseDirectStrategy"),
    # device_ldl has no XYcYd realization: hiop_tpu demotes it to splu
    "ex1_xycyd_device_ldl": ("ex1", dict(KKTLinsys="xycyd", linear_solver_sparse="device_ldl"),
                             "_SparseDirectStrategy"),
    # a registered linear_solver_sparse makes the Jacobian matrix-free, and
    # KKTLinsys=condensed over matrix-free Jacobians is the CG class, which
    # hiop_tpu's strategy choice tests first
    "ex1_condensed_device_ldl": ("ex1", dict(KKTLinsys="condensed", linear_solver_sparse="device_ldl"),
                                 "_CondensedMatfreeStrategy"),
    "ex1_full": ("ex1", dict(KKTLinsys="full"), "_SparseFullStrategy"),
    "ex1_normaleqn": ("ex1", dict(KKTLinsys="normaleqn"), "_NewtonDenseStrategy"),
    "ex1_condensed": ("ex1", dict(KKTLinsys="condensed"), "_NewtonDenseStrategy"),
    "ex1_default": ("ex1", dict(), "_NewtonDenseStrategy"),
    "ex2_splu": ("ex2", dict(linear_solver_sparse="splu"), "_SparseDirectStrategy"),
    "ex2_default": ("ex2", dict(), "_NewtonDenseStrategy"),
    "ex3_splu": ("ex3", dict(linear_solver_sparse="splu"), "_SparseDirectStrategy"),
    "ex4_full": ("ex4", dict(KKTLinsys="full"), "_SparseFullStrategy"),
    "ex4_native_ldl": ("ex4", dict(linear_solver_sparse="native_ldl"), "_SparseDirectStrategy"),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_sparse_solve_matches_jax(run):
    name, opts, strategy = RUNS[run]
    rj, lj = _solve(hiop_tpu, name, **opts)
    rt, lt = _solve(hiop_tpu_torch, name, **opts)
    assert rt.status.is_success
    _assert_same_solve(rt, rj)
    assert lt["dir"] and {d[0] for d in lt["dir"]} == {strategy}
    assert lt["dir"] == lj["dir"]
    _assert_same_decisions(lt, lj)
    if strategy == "_SparseDirectStrategy":
        # splu reports pivot-sign inertia while its no-pivot mode holds
        assert all(d[2] is not None for d in lt["dir"])


def test_forced_restoration_routes_through_the_sparse_fr_class():
    """force_resto=yes at sparse Ex1 n=50: the nested solve is an NlpSparse
    over SparseFeasibilityRestorationProblem (triplets), in both packages,
    and the solves agree."""
    rj, lj = _solve(hiop_tpu, "ex1", force_resto="yes")
    rt, lt = _solve(hiop_tpu_torch, "ex1", force_resto="yes")
    assert rt.status.is_success
    _assert_same_solve(rt, rj)
    assert lt["fr"] == lj["fr"] == ["SparseFeasibilityRestorationProblem"]
    assert lt["dir"] == lj["dir"]
    _assert_same_decisions(lt, lj)


def test_sparse_ex3_matches_jax_until_rounding_decides():
    """Sparse Ex3 (ineq_feas, n=50): 49 copies of one row, so the reduced
    KKT is singular up to the regularization and each direction amplifies
    rounding (measured: identical inputs give slack directions 5e-14 apart
    at iteration 0; inputs 5e-11 apart give directions 2e-6 apart at
    iteration 3). ``hiop_tpu`` itself takes 15, 19 and 17 iterations when its
    slack direction at iteration 3 is scaled by 1, 1 + 1e-15 and 1 - 1e-15;
    the port takes 22. So: every decision is the same as long as the two
    runs' line-search inputs agree to 1e-6 (iterations 0-2), then the same
    status, both at the LP optimum by the example's own test, with the
    objectives within the reference's own spread (1.5e-8 relative between
    its perturbed runs) at 1e-7."""
    rj, lj = _solve(hiop_tpu, "ex3")
    rt, lt = _solve(hiop_tpu_torch, "ex3")
    assert rt.status.is_success and rt.status.name == rj.status.name
    k = _parting(lt, lj)
    assert k >= 3
    assert [e[0] for e in lt["ls"][:k]] == [e[0] for e in lj["ls"][:k]]
    assert lt["dir"][:k] == lj["dir"][:k]
    for r in (rt, rj):
        assert abs(r.obj - sparse_ex3.LP_OPTIMUM) <= sparse_ex3.LP_TOL
    assert abs(rt.obj - rj.obj) <= 1e-7 * abs(rj.obj)


#: iterations over which the ACOPF B=16 sparse twin's dense route stays
#: clear of rounding-decided decisions in both packages
ACOPF16_DETERMINED = 20


def test_acopf16_sparse_matches_jax_until_rounding_decides():
    """AcopfSparse(16) amplifies rounding on both of its routes, in
    ``hiop_tpu`` itself.

    The sparse-direct route (``linear_solver_sparse=splu``; SuperLU's
    no-pivot mode fails on this KKT, so the pivoted factorization and the
    curvature test run): hiop_tpu's run and its own run with the initial
    yc scaled by 1 - 1e-15 take line-search inputs 2e-13 apart at the 5th
    test, 2e-8 at the 17th and 3e-2 at the 57th; between the packages
    (initial LSQ duals 6e-14 apart) the inputs part beyond 1e-6 at the
    14th. Every decision up to there is the same, and the runs end alike:
    the same status, 42 iterations each, the objective to 1e-8.

    The default route (n + m = 308 < 2000: the dense Newton KKT over the
    triplet-assembled Hessian, chronic escalation to the host lu_eig tier):
    hiop_tpu itself takes 61, 80, 65 and 82 iterations when its initial yc
    is scaled by 1, 1 + 1e-15, 1 - 1e-15 and 1 + 1e-14 (the port takes 65,
    with 1 - 1e-15's objective to 2e-16); the first decision that parts is
    an inertia test at iteration 23. So the first ``ACOPF16_DETERMINED``
    iterations take the same decisions (the same status at the cap, the
    same factorizations, line-search outcomes and objective to 1e-8), and
    run to the end the port converges to the objective of the
    sparse-direct route to 1e-8."""
    rj, lj = _solve(hiop_tpu, "acopf16", linear_solver_sparse="splu")
    rt, lt = _solve(hiop_tpu_torch, "acopf16", linear_solver_sparse="splu")
    assert rt.status.is_success
    _assert_same_solve(rt, rj)
    assert {d[:2] for d in lt["dir"]} == {("_SparseDirectStrategy", "splu")}
    k = _parting(lt, lj)
    assert k >= 12
    assert [e[0] for e in lt["ls"][:k]] == [e[0] for e in lj["ls"][:k]]
    assert lt["dir"][:k] == lj["dir"][:k]

    cap = dict(max_iter=ACOPF16_DETERMINED)
    rj_cap, lj_cap = _solve(hiop_tpu, "acopf16", **cap)
    rt_cap, lt_cap = _solve(hiop_tpu_torch, "acopf16", **cap)
    _assert_same_solve(rt_cap, rj_cap)
    assert rt_cap.status.name == "Max_Iter_Exceeded"
    assert lt_cap["dir"] == lj_cap["dir"]
    assert [e[0] for e in lt_cap["ls"]] == [e[0] for e in lj_cap["ls"]]
    assert any(d[3] for d in lt_cap["dir"])           # the host safe tier ran
    rt_full, _ = _solve(hiop_tpu_torch, "acopf16")
    assert rt_full.status.is_success
    assert abs(rt_full.obj - rj.obj) <= 1e-8 * abs(rj.obj)


def test_quasi_newton_over_nlp_sparse_matches_jax():
    res = []
    for pkg, ex, kw in ((hiop_tpu, jax_ex1, {}), (hiop_tpu_torch, sparse_ex1, dict(compute_mode="cpu"))):
        o = pkg.NlpOptions()
        o.update(verbosity_level=0, **kw)
        res.append(pkg.FilterIPMQuasiNewton(pkg.NlpSparse(ex.SparseEx1(30), o)).run())
    rj, rt = res
    assert rt.status.name in ("Solve_Success", "Solve_Acceptable_Level")
    _assert_same_solve(rt, rj)


@pytest.mark.parametrize("ls", ["splu", "auto"])
def test_collapsed_line_search_skips_nested_restoration_over_triplets(ls):
    """With every trial step rejected and no soft restoration, a triplet
    (matrix-free) Jacobian ends the solve without a nested restoration, and
    a dense one poses it; as in hiop_tpu."""
    out = []
    for pkg, fi, fr, ex, kw in ((hiop_tpu, jfi, jfr, jax_ex1, {}),
                                (hiop_tpu_torch, tfi, tfr, sparse_ex1, dict(compute_mode="cpu"))):
        calls = []
        apply = fr.apply_feasibility_restoration
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fi.FilterIPMBase, "_accept_line_search_conditions", lambda self, *a: 0)
            mp.setattr(fi.FilterIPMBase, "_solve_soft_fr", lambda self, *a, **k: None)
            mp.setattr(fr, "apply_feasibility_restoration",
                       lambda *a, **k: calls.append(1) or apply(*a, **k))
            r = ex.solve(50, verbosity_level=0, linear_solver_sparse=ls, max_iter=3, **kw)
        out.append((r.status.name, r.iterations, len(calls)))
    assert out[1] == out[0]
    assert (out[1][2] == 0) == (ls == "splu")


@pytest.mark.parametrize("opts,what", [
    (dict(linear_solver_sparse="device_ldl"), "DeviceSparseXDYcYdKKT"),
    (dict(KKTLinsys="condensed", linear_solver_sparse="cg"), "_CondensedMatfreeStrategy"),
    (dict(KKTLinsys="condensed", n=2000), "_CondensedSparseDeviceStrategy"),
])
def test_device_sparse_classes_raise_naming_item_11b(opts, what):
    """The three routes that raised until the device sparse KKT was ported
    now run, and choose what hiop_tpu chooses for the same options.

    - ``device_ldl`` at n=50: the device XDYcYd KKT every iteration, with
      hiop_tpu's inertia reports and decisions, status, iterations and
      objective.
    - ``condensed`` with ``cg`` at n=200: the matrix-free CG class. Its first
      solve cancels a right-hand side of norm ~1e11, and hiop_tpu itself
      takes 22, 22, 23 and 23 iterations when its first rx is scaled by 1,
      1 + 1e-15, 1 - 1e-15 and 1 + 1e-14 (objectives 5e-9 apart); the port
      takes 23 (1 - 1e-15's objective to 5e-14). So: every decision while the
      line-search inputs agree to 1e-6, then the status and the objective
      to 1e-8.
    - ``condensed`` at n=2000: the sparse condensed device class is tried
      and refuses the pattern in both packages (the J^T D J product entries
      are lower-only, so the AMD ordering sees x_1's dense column in one
      triangle and puts x_1 first: complete fill, an update-op count over
      ``max_ops``), and the dense condensed class takes over; the strategy
      choice is compared, not the 30-iteration dense solve."""
    opts = dict(opts)
    n = opts.pop("n", 200 if "cg" in opts.values() else 50)
    if n == 2000:
        made = []
        for pkg, fi, ex, kw in ((hiop_tpu, jfi, jax_ex1, {}),
                                (hiop_tpu_torch, tfi, sparse_ex1, dict(compute_mode="cpu"))):
            o = pkg.NlpOptions()
            o.update(Hessian="analytical_exact", verbosity_level=0, **opts, **kw)
            nlp = pkg.NlpSparse(ex.SparseEx1(n), o)
            nlp.finalize_initialization()
            with pytest.raises(ValueError, match="update-op count 1333333000 exceeds") as e:
                getattr(fi, what)(nlp, nlp.log, nlp.runstats)
            made.append((type(fi.FilterIPMNewton(nlp)._make_strategy()).__name__, str(e.value)))
        assert made[1] == made[0] and made[0][0] == "_NewtonDenseStrategy"
        return
    rj, lj = _solve(hiop_tpu, "ex1", (n,), **opts)
    rt, lt = _solve(hiop_tpu_torch, "ex1", (n,), **opts)
    assert rt.status.is_success and rt.status.name == rj.status.name
    assert abs(rt.obj - rj.obj) <= 1e-8 * abs(rj.obj)
    if what == "DeviceSparseXDYcYdKKT":
        assert rt.iterations == rj.iterations
        assert {d[:2] for d in lt["dir"]} == {("_SparseDirectStrategy", "device_ldl")}
        assert lt["dir"] == lj["dir"]
        _assert_same_decisions(lt, lj)
    else:
        assert {d[0] for d in lt["dir"]} == {d[0] for d in lj["dir"]} == {what}
        k = _parting(lt, lj)
        assert [e[0] for e in lt["ls"][:k]] == [e[0] for e in lj["ls"][:k]]


def test_device_ldl_f32_solve_matches_jax():
    """device_ldl with kkt_fact_dtype=float32 at n=50: f32 factors, every
    solve certified by f64 refinement. The two packages' f32 factors round
    differently (ROADMAP.md section 3), so the status and the objective."""
    opts = dict(linear_solver_sparse="device_ldl", kkt_fact_dtype="float32")
    rj, lj = _solve(hiop_tpu, "ex1", **opts)
    rt, lt = _solve(hiop_tpu_torch, "ex1", **opts)
    assert rt.status.name == rj.status.name and rt.status.name in ("Solve_Success", "Solve_Acceptable_Level")
    assert abs(rt.obj - rj.obj) <= 1e-8 * abs(rj.obj)
    assert {d[:2] for d in lt["dir"]} == {("_SparseDirectStrategy", "device_ldl")}


#: iterations of the forced sparse condensed device class on sparse Ex1
CONDENSED_DEVICE_ITERS = 20


def test_condensed_sparse_device_solve_matches_jax():
    """The sparse condensed device class over a solve (sparse Ex1, n=50, the
    class forced in both packages: below n = 2000 the strategy choice takes
    the dense condensed class), capped at ``CONDENSED_DEVICE_ITERS``
    iterations: the same factorizations, decisions, status and objective.

    Uncapped, neither package converges (Max_Iter_Exceeded after 3000
    iterations, the same objective): the AMD ordering of the lower-only
    product pattern eliminates x_1 first, one later pivot cancels below the
    static-pivot threshold at most factorizations, the SPD acceptance
    rejects every clamped factorization, and delta_w climbs to 1e4-5e5."""
    runs = []
    for pkg, fi in ((hiop_tpu, jfi), (hiop_tpu_torch, tfi)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fi.FilterIPMNewton, "_make_strategy",
                       lambda self, fi=fi: fi._CondensedSparseDeviceStrategy(self.nlp, self.log,
                                                                             self.nlp.runstats))
            runs.append(_solve(pkg, "ex1", KKTLinsys="condensed", max_iter=CONDENSED_DEVICE_ITERS))
    (rj, lj), (rt, lt) = runs
    assert rt.status.name == "Max_Iter_Exceeded"
    _assert_same_solve(rt, rj)
    assert lt["dir"] and {d[0] for d in lt["dir"]} == {"_CondensedSparseDeviceStrategy"}
    assert lt["dir"] == lj["dir"]
    assert [e[0] for e in lt["ls"]] == [e[0] for e in lj["ls"]]


def test_acopf16_device_ldl_matches_jax_until_rounding_decides():
    """AcopfSparse(16) through device_ldl amplifies rounding as its splu
    route does (test_acopf16_sparse_matches_jax_until_rounding_decides):
    every decision while the line-search inputs agree to 1e-6 (the 15th of
    42 tests here), and the runs end alike: the same status and iterations,
    the objective to 1e-8."""
    opts = dict(linear_solver_sparse="device_ldl")
    rj, lj = _solve(hiop_tpu, "acopf16", **opts)
    rt, lt = _solve(hiop_tpu_torch, "acopf16", **opts)
    assert rt.status.is_success
    _assert_same_solve(rt, rj)
    assert {d[:2] for d in lt["dir"]} == {("_SparseDirectStrategy", "device_ldl")}
    k = _parting(lt, lj)
    assert k >= 12
    assert [e[0] for e in lt["ls"][:k]] == [e[0] for e in lj["ls"][:k]]
    assert lt["dir"][:k] == lj["dir"][:k]


def test_device_ldl_refusal_falls_back_to_splu_like_jax():
    """The symbolic analysis refuses the pattern (max_ops = 1): both packages
    warn, build the host splu KKT, count the fallback, and solve alike."""
    import functools

    import hiop_tpu.linalg.sparse_device as jsdev
    import hiop_tpu_torch.kkt.sparse_direct as tsd

    out = []
    for pkg, fi, ex, kw, mod in ((hiop_tpu, jfi, jax_ex1, {}, jsdev),
                                 (hiop_tpu_torch, tfi, sparse_ex1, dict(compute_mode="cpu"), tsd)):
        o = pkg.NlpOptions()
        o.update(Hessian="analytical_exact", verbosity_level=0, linear_solver_sparse="device_ldl", **kw)
        nlp = pkg.NlpSparse(ex.SparseEx1(50), o)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "DeviceSparseLDL", functools.partial(mod.DeviceSparseLDL, max_ops=1))
            alg = pkg.FilterIPMNewton(nlp)
            strategies = []
            make = alg._make_strategy
            alg._make_strategy = lambda: strategies.append(make()) or strategies[-1]
            r = alg.run()
        out.append((r, strategies[0]._solver_name, nlp.runstats.kkt.n_device_ldl_fallback))
    (rj, sj, fj), (rt, st, ft) = out
    assert rt.status.is_success
    _assert_same_solve(rt, rj)
    assert (st, ft) == (sj, fj) == ("splu", 1)


def test_full_kkt_refuses_a_symmetric_only_solver_like_jax():
    for ex, kw in ((jax_ex1, {}), (sparse_ex1, dict(compute_mode="cpu"))):
        with pytest.raises(ValueError, match="symmetric-only"):
            ex.solve(50, verbosity_level=0, KKTLinsys="full", linear_solver_sparse="native_ldl", **kw)


def test_write_kkt_leaves_triplet_jacobians_out(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sparse_ex1.solve(50, verbosity_level=0, compute_mode="cpu", linear_solver_sparse="splu",
                     write_kkt="yes", max_iter=2)
    dumps = sorted(f for f in os.listdir(tmp_path) if "_kkt_iter" in f)
    assert len(dumps) == 2
    with np.load(tmp_path / dumps[0]) as z:
        assert "Jc" not in z.files and "Jd" not in z.files and "rx" in z.files


def test_chip_smoke_sparse_log_records_a_solve():
    """The chip script's sparse-direct logger on a CPU solve (backends by
    iteration, seconds in factorize, solve and copies, restored after), so
    that a fault in it shows here and not first on the card."""
    import chip_smoke

    to_host = tfi._to_host
    with chip_smoke._sparse_direct_log(tfi) as log:
        r = sparse_ex1.solve(50, verbosity_level=0, compute_mode="cpu", linear_solver_sparse="splu")
    assert r.status.is_success
    assert len(log["backend"]) >= r.iterations and set(log["backend"]) == {"splu"}
    assert log["factorize"] > 0 and log["solve"] > 0 and log["copies"] > 0
    assert log["strategy"].stats.kkt.n_fact_no_inertia == 0
    assert tfi._to_host is to_host
