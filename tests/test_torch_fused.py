"""The fused modes (``jit_mode=iteration`` and ``jit_mode=solve``) of the port
against the JAX package, on the CPU.

Parity in f64: the same status, the same iteration count, the objective to
1e-8 relative; the history columns ``ls_count``, ``ls_status``, ``use_soc``
and ``n_refact`` equal row by row and ``delta_w`` to 1e-10 relative (the
iteration mode's table against ``hiop_tpu``'s history), up to the first
decision that rounding noise decides (ROADMAP.md section 3). Cases: mds_ex1
(48, 16) without the example's reference options, in both modes; ACOPF B=16 with
``linear_solver_dense=ldl_nopiv``; ACOPF B=16 in the production options of
``bench_subs.py`` (``kkt_fact_dtype=float32``, ``mp_schedule=adaptive``)
with f64 arithmetic in the f32 slots of both packages, and in real f32
against ``hiop_tpu``'s objective; DenseConsEx2 through
``AutoDiffNlpProblem``; DenseConsEx1 on the quasi-Newton path in both
modes; sparse Ex1 n=50, which exits needs-host and resumes in the general
loop; sparse Ex2 n=50, which parts at its first, rounding-decided
factorization and is held to the saved objective.

Then the behaviours of ``tests/test_fused_solve.py`` on the port (the
objectives held to ``hiop_tpu``'s where the case has a reference solve),
and the host reads: each fused iteration reads the host at most once per
trip of each data-dependent loop (ladder, refinement step, SOC round,
backtracking trial) plus two, and a solve reads under half as often as
``jit_mode=kernels`` on the same problem.

Every ``hiop_tpu`` reference solve runs once, in a module-scoped fixture.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch
from threadpoolctl import threadpool_limits

import examples.acopf_mds as j_acopf
import examples.dense_ex1 as j_ex1
import examples.mds_ex1 as j_mds1
import examples.sparse_ex1 as j_sx1
import examples.sparse_ex2 as j_sx2
import hiop_tpu
import hiop_tpu.kkt.mds as jmds
import hiop_tpu_torch
import hiop_tpu_torch.kkt.mds as tmds
import hiop_tpu_torch.optimization.filter_ipm as tfi
import hiop_tpu_torch.optimization.fused_newton as tfn
from hiop_tpu_torch.examples import acopf_mds, dense_ex1, dense_ex2, mds_ex1, sparse_ex1, sparse_ex2

# The matrices here are small: torch's intra-op thread pool costs more than it
# gains, and its spinning threads slow the other test workers.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One OpenBLAS thread for numpy/scipy inside these tests: under six
    pytest-xdist workers on an 8-core CPU, OpenBLAS's spinning threads starve
    each other (tests/test_torch_sparse_solve.py). Lifted after each test."""
    with threadpool_limits(limits=1):
        yield


#: the production options of bench_subs.py:70-75
PRODUCTION = dict(kkt_fact_dtype="float32", mp_schedule="adaptive",
                  linear_solver_dense="ldl_nopiv", jit_mode="solve", max_iter=300)
#: the history columns held equal row by row, and delta_w's
COUNTERS = {"ls_count": 6, "ls_status": 7, "use_soc": 9, "n_refact": 12}
DELTA_W = 11


class _F32AsF64:
    """A module whose ``float32`` is ``float64``: patched over the f32 casts
    of both packages' ``kkt/mds.py``, it runs every decision of the
    mixed-precision path on f64 arithmetic."""

    def __init__(self, mod, f64):
        self._mod, self._f64 = mod, f64

    def __getattr__(self, name):
        return self._f64 if name == "float32" else getattr(self._mod, name)


def _formulation(pkg, case):
    """(solver class, formulation) of a case in package ``pkg``."""
    jax_side = pkg is hiop_tpu
    o = pkg.NlpOptions()
    extra = {} if jax_side else dict(compute_mode="cpu")
    name, opts = case
    if name == "mds_ex1":
        o.update(Hessian="analytical_exact", KKTLinsys="xdycyd", verbosity_level=0, **extra, **opts)
        prob = (j_mds1 if jax_side else mds_ex1).MdsEx1(48, 16)
        return pkg.FilterIPMNewton, pkg.NlpMDS(prob, o)
    if name == "acopf16":
        o.update(Hessian="analytical_exact", fixed_var="relax", tolerance=1e-6, mu0=0.1,
                 verbosity_level=0, **extra, **opts)
        prob = (j_acopf if jax_side else acopf_mds).AcopfMds(16)
        return pkg.FilterIPMNewton, pkg.NlpMDS(prob, o)
    if name == "ex2_autodiff":
        n = 20
        o.update(Hessian="analytical_exact", verbosity_level=0, **extra, **opts)
        if jax_side:
            J = jnp.asarray(dense_ex2.ex2_jacobian(n))
            xl, xu, cl, cu = dense_ex2.ex2_bounds(n)
            prob = hiop_tpu.AutoDiffNlpProblem(
                f=lambda x: 0.25 * jnp.sum((x - 1.0) ** 4), c=lambda x: J @ x,
                xl=xl, xu=xu, cl=cl, cu=cu, x0=np.zeros(n))
        else:
            prob = dense_ex2.autodiff_problem(n, "cpu")
        return pkg.FilterIPMNewton, pkg.NlpDenseConstraints(prob, o)
    if name == "ex1_qn":
        o.update(verbosity_level=0, **extra, **opts)
        prob = (j_ex1 if jax_side else dense_ex1).DenseConsEx1(200)
        return pkg.FilterIPMQuasiNewton, pkg.NlpDenseConstraints(prob, o)
    if name == "sparse_ex1":
        o.update(Hessian="analytical_exact", verbosity_level=0, **extra, **opts)
        prob = (j_sx1 if jax_side else sparse_ex1).SparseEx1(50)
        return pkg.FilterIPMNewton, pkg.NlpSparse(prob, o)
    if name == "sparse_ex2":
        o.update(Hessian="analytical_exact", verbosity_level=0, **extra, **opts)
        prob = (j_sx2 if jax_side else sparse_ex2).SparseEx2(50)
        return pkg.FilterIPMNewton, pkg.NlpSparse(prob, o)
    raise ValueError(name)


def _run(pkg, case, emulate=False):
    """One solve; returns (result, history rows or None, table rows
    (ls_count, ls_status, use_soc) as printed)."""
    cls, nlp = _formulation(pkg, case)
    solver = cls(nlp)
    table = []
    printed = solver._output_iteration

    def recorded(f, feas, opt, mu, adu, apr, ls_num, ls_status, use_soc=0):
        table.append((int(ls_num), int(ls_status), int(use_soc)))
        return printed(f, feas, opt, mu, adu, apr, ls_num, ls_status, use_soc)

    solver._output_iteration = recorded
    with pytest.MonkeyPatch.context() as mp:
        if emulate:
            mp.setattr(jmds, "jnp", _F32AsF64(jnp, jnp.float64))
            mp.setattr(tmds, "torch", _F32AsF64(torch, torch.float64))
        r = solver.run()
    hist = getattr(solver, "_last_fused_hist", None)
    return r, (None if hist is None else np.asarray(hist)), table


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


#: the primal infeasibility below which theta is rounding noise: linear
#: constraints leave inf_pr at 1e-16..3e-13 in both packages, and there the
#: switching condition alpha (-grad phi^T d)^s_phi > theta^s_theta (ls_status
#: 2 or 3) is decided by noise (ROADMAP.md section 3)
THETA_NOISE = 1e-12


def _rows(hist, table=None):
    """Per-row (ls_count, ls_status, use_soc, n_refact, delta_w) from a
    history; from a printed table the last two are None."""
    if table is not None:
        return [(a, b, c, None, None) for a, b, c in table]
    return [(int(r[6]), int(r[7]), int(r[9]), int(r[12]), float(r[DELTA_W])) for r in hist]


def _assert_same(t, j, hist=True):
    """Status, iterations and objective; the per-iteration counters row by
    row (delta_w to 1e-10 relative) up to the first decision that noise
    decides: a switching condition (ls_status 2 against 3) at an iterate
    whose theta is noise."""
    rt, ht, tab_t = t
    rj, hj, _ = j
    assert rt.status.name == rj.status.name
    assert rt.iterations == rj.iterations
    assert _rel(rt.obj, rj.obj) <= 1e-8, (rt.obj, rj.obj)
    n = rj.iterations + 1
    got = _rows(ht, None if hist else tab_t)[:n]
    want = _rows(hj)[:n]
    if not hist:
        # the first row prints ls_status -1 in both modes
        want = [(a, b if i else -1, c, None, None) for i, (a, b, c, _, _) in enumerate(want)]
    for i, (g, w) in enumerate(zip(got, want)):
        if g[1] != w[1] and {g[1], w[1]} == {2, 3} and hj[i, 1] <= THETA_NOISE:
            return
        assert g[:4] == w[:4], (i, g, w)
        if hist:
            assert abs(g[4] - w[4]) <= 1e-10 * abs(w[4]), (i, g[4], w[4])


CASES = {
    "mds_ex1": ("mds_ex1", {}),
    "acopf16_ldl": ("acopf16", dict(linear_solver_dense="ldl_nopiv", jit_mode="solve", max_iter=300)),
    "acopf16_production": ("acopf16", PRODUCTION),
    "ex2_autodiff": ("ex2_autodiff", dict(jit_mode="solve")),
    "ex1_qn": ("ex1_qn", {}),
}


@pytest.fixture(scope="module")
def jax_ref():
    """hiop_tpu's fused solves (jit_mode=solve: its history buffer), each
    once."""
    out = {}
    for key, (name, opts) in CASES.items():
        if key != "acopf16_production":
            out[key] = _run(hiop_tpu, (name, {**opts, "jit_mode": "solve"}))
    out["acopf16_production_f64"] = _run(hiop_tpu, CASES["acopf16_production"], emulate=True)
    out["sparse_ex2"] = _run(hiop_tpu, ("sparse_ex2", dict(jit_mode="iteration")))
    out["sparse_ex1"] = _run(hiop_tpu, ("sparse_ex1", dict(jit_mode="iteration")))
    return out


@pytest.mark.parametrize("mode", ["iteration", "solve"])
@pytest.mark.parametrize("key", ["mds_ex1", "ex1_qn"])
def test_fused_modes_match_jax(jax_ref, key, mode):
    name, opts = CASES[key]
    t = _run(hiop_tpu_torch, (name, {**opts, "jit_mode": mode}))
    assert t[0].status.is_success
    _assert_same(t, jax_ref[key], hist=mode == "solve")


@pytest.mark.parametrize("key", ["acopf16_ldl", "ex2_autodiff"])
def test_fused_solve_matches_jax(jax_ref, key):
    t = _run(hiop_tpu_torch, CASES[key])
    assert t[0].status.is_success
    _assert_same(t, jax_ref[key])
    if key == "acopf16_ldl":
        # the LDL^T ladder regularized somewhere, and the SOC ran
        assert t[1][: t[0].iterations + 1, COUNTERS["n_refact"]].sum() > 0


def test_production_options_logic_matches_jax(jax_ref):
    """The production options with f64 arithmetic in the f32 slots: the
    same decisions, iteration by iteration."""
    t = _run(hiop_tpu_torch, CASES["acopf16_production"], emulate=True)
    _assert_same(t, jax_ref["acopf16_production_f64"])
    assert t[1][: t[0].iterations, 10].all()   # every iteration certified in "f32"


def test_production_options_real_f32_converges(jax_ref):
    """Real f32: the two packages round differently (ROADMAP section 3), so
    only the outcome is held, to hiop_tpu's objective in these options."""
    rt, hist, _ = _run(hiop_tpu_torch, CASES["acopf16_production"])
    rj = jax_ref["acopf16_production_f64"][0]
    assert rt.status.name == "Solve_Success" == rj.status.name
    assert abs(rt.obj - rj.obj) <= 1e-6 * abs(rj.obj)
    assert hist[: rt.iterations, 10].sum() > 0


def test_needs_host_exit_resumes_in_general_loop(jax_ref, capsys):
    """sparse Ex1 n=50 (tests/test_equivalence.py:91): the fused step's
    line search is rejected at iteration 24 in both packages, and the
    general loop resumes from that iterate and mu."""
    rj = jax_ref["sparse_ex1"][0]
    o = hiop_tpu_torch.NlpOptions()
    o.update(Hessian="analytical_exact", compute_mode="cpu", jit_mode="iteration")
    rt = hiop_tpu_torch.FilterIPMNewton(hiop_tpu_torch.NlpSparse(sparse_ex1.SparseEx1(50), o)).run()
    out = capsys.readouterr().out
    assert "fused iteration bailed out (line search rejected (SOC/FR needed))" in out
    assert "resuming the general loop from the fused iterate (iteration 24, mu=9.091e-10)" in out
    assert rt.status.is_success and rt.status.name == rj.status.name
    assert rt.iterations == rj.iterations
    assert _rel(rt.obj, rj.obj) <= 1e-8


def test_sparse_ex2_fused_reaches_the_saved_objective(jax_ref):
    """sparse Ex2 n=50 (tests/test_equivalence.py:98-105). Its Jacobian is
    rank deficient by design, so the first Schur complement is singular,
    and whether its Cholesky succeeds is decided by rounding (pivot
    -1.1e-17 here, +7e-15 in hiop_tpu): the two packages part at iteration
    0 (ROADMAP.md section 3). Neither exits needs-host on the CPU; both
    reach the saved objective."""
    rj = jax_ref["sparse_ex2"][0]
    rt = sparse_ex2.solve(50, compute_mode="cpu", verbosity_level=0, jit_mode="iteration")
    ref, tol = sparse_ex2.SELFCHECK[50]
    assert rt.status.is_success and rj.status.is_success
    assert abs(rt.obj - ref) <= tol * abs(ref)
    assert _rel(rt.obj, rj.obj) <= 1e-8


# ---------------------------------------------------------------------------
# behaviours of tests/test_fused_solve.py, on the port alone
# ---------------------------------------------------------------------------
def _problem():
    return hiop_tpu_torch.AutoDiffNlpProblem(
        f=lambda x: ((x - 1.0) ** 2).sum() + 0.1 * (x ** 4).sum(),
        c=lambda x: torch.stack([x.sum(), x[0] * x[1]]),
        xl=np.full(6, -2.0), xu=np.full(6, 5.0),
        cl=np.array([2.0, -1.0]), cu=np.array([2.0, 1.0]), x0=np.full(6, 0.5),
    )


def _solve(cls, hessian, jit_mode, problem=None, **extra):
    o = hiop_tpu_torch.NlpOptions()
    o.update(jit_mode=jit_mode, Hessian=hessian, verbosity_level=0, compute_mode="cpu", **extra)
    return cls(hiop_tpu_torch.NlpDenseConstraints(problem or _problem(), o)).run()


@pytest.mark.parametrize("cls,hessian", [
    (hiop_tpu_torch.FilterIPMNewton, "analytical_exact"),
    (hiop_tpu_torch.FilterIPMQuasiNewton, "quasinewton_approx"),
], ids=["newton", "qn"])
def test_solve_mode_matches_iteration_mode(cls, hessian):
    r_it = _solve(cls, hessian, "iteration")
    r_sv = _solve(cls, hessian, "solve")
    assert r_sv.status == r_it.status and r_sv.status.is_success
    assert r_sv.iterations == r_it.iterations
    assert r_sv.obj == r_it.obj


def test_solve_mode_max_iter():
    r = _solve(hiop_tpu_torch.FilterIPMNewton, "analytical_exact", "solve", max_iter=3)
    assert r.iterations == 3 and r.status.name == "Max_Iter_Exceeded"


def test_solve_mode_callback_override_takes_the_iteration_path():
    p = _problem()
    calls = []

    class Stopper(type(p)):
        def iterate_callback(self, info):
            calls.append(info.iter)
            return info.iter < 2

    p.__class__ = Stopper
    r = _solve(hiop_tpu_torch.FilterIPMNewton, "analytical_exact", "solve", problem=p)
    assert calls == [0, 1, 2]
    assert r.status.name == "User_Stopped"


def _acopf16_solver(**opts):
    o = hiop_tpu_torch.NlpOptions()
    o.update(Hessian="analytical_exact", fixed_var="relax", tolerance=1e-6, mu0=0.1,
             verbosity_level=0, compute_mode="cpu", **{**PRODUCTION, **opts})
    nlp = hiop_tpu_torch.NlpMDS(acopf_mds.AcopfMds(16), o)
    return hiop_tpu_torch.FilterIPMNewton(nlp), nlp


def _fused_start(solver, nlp):
    mu = solver.mu0
    tau = max(solver.tau_min, 1.0 - mu)
    state, consts = solver._fused_init()
    solve = tfn.build_fused_solve(nlp, consts, solver._fused_term(), mode="newton")
    return solve, state, mu, tau


def test_resume_by_it_stop_matches_one_run():
    """Two calls chained by ``carry_in`` give the same bits as one."""
    solver, nlp = _acopf16_solver(linear_solver_dense="ldl_nopiv", kkt_fact_dtype="float64")
    solve, state, mu, tau = _fused_start(solver, nlp)
    one = solve(state, mu, tau, solver.theta_min, solver.theta_max, 12)
    part = solve(state, mu, tau, solver.theta_min, solver.theta_max, 12, it_stop=5)
    assert part[2] == 5 and part[3] == 0
    two = solve(None, None, None, solver.theta_min, solver.theta_max, 12, carry_in=part[6])
    assert one[2] == two[2] == 12 and one[3] == two[3] == 4
    assert torch.equal(one[0].it.x, two[0].it.x)
    assert torch.equal(one[5], two[5])


def test_fused_to_general_handoff_resumes(jax_ref):
    """tests/test_fused_solve.py: eight fused iterations by
    build_fused_solve(it_stop=8), then the general loop resumes from that
    iterate and mu and converges to hiop_tpu's objective in these options."""
    solver, nlp = _acopf16_solver()
    solve, state, mu, tau = _fused_start(solver, nlp)
    state, mu_dev, it_num, st, _err, _hist, _carry = solve(
        state, mu, tau, solver.theta_min, solver.theta_max, 300, it_stop=8)
    assert it_num == 8 and st == 0
    solver2 = hiop_tpu_torch.FilterIPMNewton(nlp)
    solver2._fused_handoff = (state.it, float(mu_dev), it_num)
    r = solver2._run_general()
    assert r.status.is_success and r.iterations > 8
    r_ref = jax_ref["acopf16_production_f64"][0]
    assert abs(r.obj - r_ref.obj) <= 1e-6 * max(1.0, abs(r_ref.obj))


def test_fused_solve_warm_start():
    n = 6

    def make_p():
        p = hiop_tpu_torch.AutoDiffNlpProblem(
            f=lambda x: 0.5 * (x ** 2).sum(), c=lambda x: x.sum()[None],
            xl=-1e20 * np.ones(n), xu=1e20 * np.ones(n),
            cl=np.array([1.0]), cu=np.array([1.0]), x0=np.zeros(n),
        )
        x_star = np.full(n, 1.0 / n)
        p.get_warmstart_point = lambda: (
            x_star, np.zeros(n), np.zeros(n), np.array([-1.0 / n]), np.zeros(0), None, None, None,
        )
        return p

    extra = dict(warm_start="yes", duals_update_type="linear")
    r_f = _solve(hiop_tpu_torch.FilterIPMNewton, "analytical_exact", "solve", problem=make_p(), **extra)
    r_g = _solve(hiop_tpu_torch.FilterIPMNewton, "analytical_exact", "kernels", problem=make_p(), **extra)
    assert r_f.status.is_success and r_g.status.is_success
    assert r_f.iterations <= 6
    assert abs(r_f.obj - r_g.obj) < 1e-8


def test_fused_inertia_free_acceptance_converges(jax_ref):
    """tests/test_mixed_precision.py: fact_acceptor=inertia_free inside the
    fused mixed-precision step converges to the objective of the exact
    inertia acceptance (here ACOPF B=16, hiop_tpu's)."""
    solver, nlp = _acopf16_solver(fact_acceptor="inertia_free")
    r = solver.run()
    r_ref = jax_ref["acopf16_production_f64"][0]
    assert r.status.is_success
    assert abs(r.obj - r_ref.obj) <= 1e-6 * max(1.0, abs(r_ref.obj))
    assert nlp.runstats.kkt.n_fact_total > 0 and nlp.runstats.kkt.n_fact_f32 > 0


def test_over_budget_routes_to_the_general_loop(monkeypatch):
    """Over the footprint budget the solve runs the general loop: no fused
    step is built, and the result is jit_mode=kernels'."""
    built = []
    monkeypatch.setattr(tfi.FilterIPMBase, "_fused_fits_memory", lambda self: False)
    monkeypatch.setattr(tfn, "_build_fused_step_uncached",
                        lambda *a, **k: built.append(1) or pytest.fail("fused step built"))
    r = mds_ex1.solve(48, 16, reference_options=False, compute_mode="cpu", verbosity_level=0,
                      jit_mode="solve")
    r_k = mds_ex1.solve(48, 16, reference_options=False, compute_mode="cpu", verbosity_level=0)
    assert not built
    assert (r.status, r.iterations, r.obj) == (r_k.status, r_k.iterations, r_k.obj)


# ---------------------------------------------------------------------------
# host reads
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _count_reads():
    """Count the calls that copy a tensor's values to the host (the counter
    of chip_smoke.py, on every device)."""
    counts = {"reads": 0}
    T = torch.Tensor
    names = ("item", "tolist", "__bool__", "__float__", "__int__", "cpu")
    saved = {k: getattr(T, k) for k in names}

    def wrap(f):
        def counted(self, *a, **k):
            counts["reads"] += 1
            return f(self, *a, **k)
        return counted

    for k in names:
        setattr(T, k, wrap(saved[k]))
    try:
        yield counts
    finally:
        for k, f in saved.items():
            setattr(T, k, f)


@pytest.mark.parametrize("key,mode", [
    ("mds_ex1", "iteration"), ("mds_ex1", "solve"), ("acopf16_ldl", "solve"),
])
def test_host_reads_per_fused_iteration(key, mode, monkeypatch):
    """Per fused iteration at most one read per loop trip (ladder
    factorization beyond the first, refinement step, SOC round, line-search
    trial) plus two; the trips from that iteration's counters. The whole
    solve reads under half of what jit_mode=kernels reads."""
    name, opts = CASES[key]
    marks = []   # (reads at the step's start, at its end, the step's counters)
    build = tfn._build_fused_step_uncached

    def counting_build(*a, **k):
        step = build(*a, **k)

        def counted(*sa, **sk):
            start = counter["reads"]
            out = step(*sa, **sk)
            s = out[1]
            marks.append((start, counter["reads"],
                          s.n_refact + s.soc_rounds + s.ls_count + s.ir_primary))
            return out
        return counted

    monkeypatch.setattr(tfn, "_build_fused_step_uncached", counting_build)
    with _count_reads() as counter:
        r = _run(hiop_tpu_torch, (name, {**opts, "jit_mode": mode}))[0]
        fused_total = counter["reads"]
    assert r.status.is_success and len(marks) == r.iterations + 1
    for i, (start, end, trips) in enumerate(marks):
        # an iteration runs from its step's start to the next step's start
        # (the host's decisions and the bundle read between them)
        stop = marks[i + 1][0] if i + 1 < len(marks) else end + (mode == "iteration")
        assert stop - start <= trips + 2, (i, stop - start, trips)
    with _count_reads() as counter:
        rk = _run(hiop_tpu_torch, (name, {**opts, "jit_mode": "kernels"}))[0]
        kernels_total = counter["reads"]
    assert rk.status.is_success
    assert fused_total < 0.5 * kernels_total, (fused_total, kernels_total)
