"""The quasi-Newton path of the port against the JAX package, on the CPU.

Modules: ``linalg/small_solve.solve_small``,
``optimization/hessian_lowrank`` (``update`` over an empty, a partly
filled and a full memory with all five sigma strategies and a skipped
update; ``solve``; ``times_vec``) and ``kkt/lowrank`` (``solve_compressed``
and both branches of ``_sym_solve_with_refin``), on seeded numpy inputs, in
f64 to 1e-12 (relative to the largest entry of each result).

Whole solves: ``FilterIPMQuasiNewton`` over ``NlpDenseConstraints`` for the
four dense examples (``dense_ex1`` with a uniform and a distorted mesh,
``dense_ex2`` constrained and unconstrained, ``dense_ex3`` with
``fixed_var=relax``, ``dense_ex4`` both variants) at small n, the problems
of ``tests/test_qn_solver.py`` through ``AutoDiffNlpProblem``, and the
two-call constraint convention: the same status, the same iteration count,
and the objective to 1e-8 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch
from threadpoolctl import threadpool_limits

import examples.dense_ex1 as jax_ex1
import examples.dense_ex2 as jax_ex2
import examples.dense_ex3 as jax_ex3
import examples.dense_ex4 as jax_ex4
import hiop_tpu
import hiop_tpu.kkt.lowrank as jlr
import hiop_tpu.optimization.hessian_lowrank as jblr
from hiop_tpu.linalg.small_solve import solve_small as jax_solve_small
import hiop_tpu_torch
import hiop_tpu_torch.kkt.lowrank as tlr
import hiop_tpu_torch.optimization.hessian_lowrank as tblr
from hiop_tpu_torch.examples import dense_ex1, dense_ex2, dense_ex3, dense_ex4
from hiop_tpu_torch.linalg.small_solve import solve_small

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

TOL = 1e-12


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()) if b.size else 0.0, 1e-300)
    assert float(np.abs(a - b).max() if a.size else 0.0) <= tol * max(scale, 1.0)


def _assert_same_solve(rt, rj):
    assert rt.status.name == rj.status.name
    assert rt.iterations == rj.iterations
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))


# ---------------------------------------------------------------------------
# solve_small
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,m", [(1, 0), (4, 0), (12, 0), (12, 3), (7, 2)])
def test_solve_small_matches_jax(k, m):
    rng = np.random.default_rng(100 + k + m)
    A = rng.standard_normal((k, k))
    A[0, 0] = 0.0 if k > 1 else A[0, 0]   # forces a row swap
    B = rng.standard_normal(k) if m == 0 else rng.standard_normal((k, m))
    xt = solve_small(_t(A), _t(B)).numpy()
    xj = np.asarray(jax_solve_small(jnp.asarray(A), jnp.asarray(B)))
    _close(xt, xj)
    _close(xt, np.linalg.solve(A, B), 1e-10)


def test_solve_small_singular_matches_jax():
    """A zero pivot gives 0 through the masked inverse in both."""
    A = np.array([[1.0, 2.0, 0.0], [2.0, 4.0, 0.0], [0.0, 0.0, 0.0]])
    B = np.array([1.0, 2.0, 3.0])
    _close(solve_small(_t(A), _t(B)).numpy(), np.asarray(jax_solve_small(jnp.asarray(A), jnp.asarray(B))))


# ---------------------------------------------------------------------------
# hessian_lowrank
# ---------------------------------------------------------------------------
STRATEGIES = ("sigma0", "sty", "sty_inv", "snrm_ynrm", "sty_srnm_ynrm")


def _pairs(n, count, seed):
    """Seeded (s, y) pairs with s^T y > 0, and one pair that the skip test
    rejects (s^T y < 0) at position 2."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    A = G @ G.T / n + np.eye(n)
    out = []
    for i in range(count):
        s = rng.standard_normal(n)
        y = A @ s
        if i == 2:
            y = -y
        out.append((s, y))
    return out


def _run_updates(n, l_max, strategy, steps, seed=3):
    js = jblr.init_state(n, l_max, 1.5)
    ts = tblr.init_state(n, l_max, 1.5)
    for s, y in _pairs(n, steps, seed):
        js = jblr.update(js, jnp.asarray(s), jnp.asarray(y), 1.5, strategy=strategy)
        ts = tblr.update(ts, _t(s), _t(y), 1.5, strategy=strategy)
    return ts, js


def _same_state(ts, js):
    for a, b in zip(ts, js):
        _close(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("steps", [0, 2, 3, 9], ids=["empty", "partial", "skipped", "full"])
def test_bfgs_update_solve_times_vec_match_jax(strategy, steps):
    n, l_max = 20, 6
    ts, js = _run_updates(n, l_max, strategy, steps)
    _same_state(ts, js)
    if steps == 3:
        # the third pair failed the curvature test: two rows, sigma kept
        assert float(ts.active.sum()) == 2.0
    if steps == 9:
        assert float(ts.active.sum()) == l_max
    rng = np.random.default_rng(7)
    Dx = np.abs(rng.standard_normal(n))
    rhs1 = rng.standard_normal(n)
    rhsk = rng.standard_normal((n, 3))
    for rhs in (rhs1, rhsk):
        _close(tblr.solve(ts, _t(Dx), _t(rhs)).numpy(),
               np.asarray(jblr.solve(js, jnp.asarray(Dx), jnp.asarray(rhs))))
    _close(tblr.times_vec(ts, _t(rhs1)).numpy(), np.asarray(jblr.times_vec(js, jnp.asarray(rhs1))))


def test_bfgs_skip_on_tiny_step_matches_jax():
    """||s||_inf < 100*eps: the update is skipped in both."""
    n = 8
    ts, js = _run_updates(n, 4, "sty", 2)
    s = np.full(n, 1e-15)
    y = np.ones(n)
    js = jblr.update(js, jnp.asarray(s), jnp.asarray(y), 1.0, strategy="sty")
    ts = tblr.update(ts, _t(s), _t(y), 1.0, strategy="sty")
    _same_state(ts, js)
    assert float(ts.active.sum()) == 2.0


# ---------------------------------------------------------------------------
# kkt/lowrank
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mc,md", [(0, 0), (1, 0), (2, 3), (0, 2)])
def test_lowrank_solve_compressed_matches_jax(mc, md):
    n = 25
    ts, js = _run_updates(n, 5, "sty", 4, seed=mc * 10 + md)
    rng = np.random.default_rng(mc * 7 + md)
    Dx = np.abs(rng.standard_normal(n))
    Dd = np.abs(rng.standard_normal(md)) + 0.1
    if md:
        Dd[0] = 0.0   # an inequality without finite bounds
    Jc = rng.standard_normal((mc, n))
    Jd = rng.standard_normal((md, n))
    r = [rng.standard_normal(k) for k in (n, md, mc, md)]
    out_t = tlr.solve_compressed(tlr.LowRankKKTData(ts, _t(Dx), _t(Dd), _t(Jc), _t(Jd)), *map(_t, r))
    out_j = jlr.solve_compressed(
        jlr.LowRankKKTData(js, *(jnp.asarray(a) for a in (Dx, Dd, Jc, Jd))), *map(jnp.asarray, r))
    for a, b in zip(out_t, out_j):
        _close(a.numpy(), np.asarray(b), 1e-11)


@pytest.mark.parametrize("case", ["pd", "indefinite", "bumped"])
def test_sym_solve_with_refin_branches_match_jax(case):
    """The three outcomes: Cholesky with one refinement sweep (N PD); N
    indefinite beyond the bump (identity factor); N barely indefinite, so
    that N + sqrt(eps)*max(|N|, 1)*I is PD. The bumped matrix has a
    condition number of about 1/sqrt(eps) ~ 7e7, so the two packages'
    roundings agree to about eps * 7e7 there, not to 1e-12."""
    rng = np.random.default_rng(21)
    m = 5
    G = rng.standard_normal((m, m))
    N = G @ G.T + np.eye(m)
    tol = 1e-10
    if case == "indefinite":
        N[2, 2] = -3.0
    elif case == "bumped":
        Q, _ = np.linalg.qr(G)
        N = Q @ np.diag([1.0, 2.0, 3.0, 4.0, -1e-10]) @ Q.T
        tol = 1e-7
    b = rng.standard_normal(m)
    xt = tlr._sym_solve_with_refin(_t(N), _t(b)).numpy()
    xj = np.asarray(jlr._sym_solve_with_refin(jnp.asarray(N), jnp.asarray(b)))
    _close(xt, xj, tol)
    if case != "pd":
        assert not np.all(np.isfinite(np.asarray(jnp.linalg.cholesky(jnp.asarray(N)))))


# ---------------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------------
EXAMPLES = {
    "ex1": (lambda: jax_ex1.solve(200, verbosity_level=0),
            lambda: dense_ex1.solve(200, verbosity_level=0, compute_mode="cpu")),
    "ex1_distorted": (lambda: jax_ex1.solve(200, ratio=0.2, verbosity_level=0),
                      lambda: dense_ex1.solve(200, ratio=0.2, verbosity_level=0, compute_mode="cpu")),
    "ex2": (lambda: jax_ex2.solve(200, verbosity_level=0),
            lambda: dense_ex2.solve(200, verbosity_level=0, compute_mode="cpu")),
    "ex2_unconstrained": (lambda: jax_ex2.solve(200, unconstrained=True, verbosity_level=0),
                          lambda: dense_ex2.solve(200, unconstrained=True, verbosity_level=0,
                                                  compute_mode="cpu")),
    "ex3_relax": (lambda: jax_ex3.solve(200, fixed_var="relax", verbosity_level=0),
                  lambda: dense_ex3.solve(200, fixed_var="relax", verbosity_level=0, compute_mode="cpu")),
    "ex4": (lambda: jax_ex4.solve(verbosity_level=0),
            lambda: dense_ex4.solve(verbosity_level=0, compute_mode="cpu")),
    "ex4_unconstrained": (lambda: jax_ex4.solve(unconstrained=True, verbosity_level=0),
                          lambda: dense_ex4.solve(unconstrained=True, verbosity_level=0,
                                                  compute_mode="cpu")),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_dense_example_matches_jax(name):
    run_jax, run_torch = EXAMPLES[name]
    rj = run_jax()
    rt = run_torch()
    assert rt.status.is_success
    _assert_same_solve(rt, rj)


def test_dense_ex1_500_selfcheck():
    r = dense_ex1.solve(500, verbosity_level=0, compute_mode="cpu")
    ref, tol = dense_ex1.SELFCHECK[500]
    assert r.status.is_success and dense_ex1.selfcheck_ok(r.obj, ref, tol)


def _qn_problems(ns):
    """The problems of tests/test_qn_solver.py, with the array namespace
    ``ns`` (jnp or torch) for f and c."""
    B = 1e20
    return {
        "unconstrained_quadratic": dict(
            f=lambda x: 0.5 * ((x - 1.0) ** 2).sum(), c=None,
            xl=-B * np.ones(7), xu=B * np.ones(7), cl=np.zeros(0), cu=np.zeros(0), x0=np.zeros(7)),
        "bound_constrained_quadratic": dict(
            f=lambda x: 0.5 * (x ** 2).sum(), c=None,
            xl=0.5 * np.ones(5), xu=B * np.ones(5), cl=np.zeros(0), cu=np.zeros(0), x0=np.ones(5)),
        "equality_constrained_qp": dict(
            f=lambda x: 0.5 * (x ** 2).sum(), c=lambda x: x.sum()[None],
            xl=-B * np.ones(6), xu=B * np.ones(6), cl=np.array([1.0]), cu=np.array([1.0]),
            x0=np.zeros(6)),
        "inequality_qp": dict(
            f=lambda x: 0.5 * ((x - 2.0) ** 2).sum(), c=lambda x: x.sum()[None],
            xl=-B * np.ones(4), xu=B * np.ones(4), cl=np.array([-B]), cu=np.array([1.0]),
            x0=np.zeros(4)),
        "two_sided_inequality_and_bounds": dict(
            f=lambda x: 0.25 * ((x - 1.0) ** 4).sum(), c=lambda x: x.sum()[None],
            xl=np.zeros(5), xu=0.4 * np.ones(5), cl=np.array([1.0]), cu=np.array([2.0]),
            x0=0.2 * np.ones(5)),
    }


def _qn_solve(pkg, problem, **opts):
    o = pkg.NlpOptions()
    o.update(verbosity_level=0, **opts)
    return pkg.FilterIPMQuasiNewton(pkg.NlpDenseConstraints(problem, o)).run()


@pytest.mark.parametrize("name", list(_qn_problems(jnp)))
def test_qn_solver_problem_matches_jax(name):
    rj = _qn_solve(hiop_tpu, hiop_tpu.AutoDiffNlpProblem(**_qn_problems(jnp)[name]))
    rt = _qn_solve(hiop_tpu_torch, hiop_tpu_torch.AutoDiffNlpProblem(**_qn_problems(torch)[name]),
                   compute_mode="cpu")
    assert rt.status.is_success
    _assert_same_solve(rt, rj)
    assert np.abs(rt.x - rj.x).max() <= 1e-8


def test_iterate_callback_stop_matches_jax():
    spec = dict(xl=-1e20 * np.ones(4), xu=1e20 * np.ones(4), cl=np.zeros(0), cu=np.zeros(0),
                x0=np.ones(4))
    results = []
    for pkg, ns, extra in ((hiop_tpu, jnp, {}), (hiop_tpu_torch, torch, dict(compute_mode="cpu"))):
        p = pkg.AutoDiffNlpProblem(f=lambda x: 0.5 * (x ** 2).sum(), c=None, **spec)
        calls = []
        p.iterate_callback = lambda info, calls=calls: calls.append(info.iter) or info.iter < 1
        results.append((_qn_solve(pkg, p, **extra), calls))
    (rj, cj), (rt, ct) = results
    assert rt.status.name == rj.status.name == "User_Stopped"
    assert ct == cj


def test_two_call_constraint_convention_matches_one_call():
    """The two-call eval_cons (per-eq/ineq-subset evaluation,
    hiopInterface.hpp:303-366) gives the one-call solve, as in
    tests/test_dense_examples.py."""

    class TwoCallEx1(dense_ex1.DenseConsEx1):
        one_call_used = False

        def eval_cons(self, x):
            type(self).one_call_used = True
            return super().eval_cons(x)

        def eval_cons_subset(self, x, idx_cons):
            c_all = torch.sum(self._t(x)["mass"] * x)[None]
            return c_all[torch.as_tensor(np.asarray(idx_cons, dtype=np.int64))]

    def run(problem):
        o = hiop_tpu_torch.NlpOptions()
        o.update(verbosity_level=0, compute_mode="cpu")
        return hiop_tpu_torch.FilterIPMQuasiNewton(hiop_tpu_torch.NlpDenseConstraints(problem, o)).run()

    r2 = run(TwoCallEx1(300))
    assert not TwoCallEx1.one_call_used
    r1 = run(dense_ex1.DenseConsEx1(300))
    assert r2.status.is_success
    assert r2.iterations == r1.iterations
    assert abs(r2.obj - r1.obj) <= 1e-12 * (1 + abs(r1.obj))


def test_autodiff_problem_derivatives_match_jax():
    """grad f, the Jacobian of c and the Lagrangian Hessian of
    ``AutoDiffNlpProblem`` (torch.func against jax.grad/jacfwd/hessian),
    and an unconstrained problem's (0, n) Jacobian."""
    rng = np.random.default_rng(4)
    n = 6
    x = rng.standard_normal(n)
    lam = rng.standard_normal(2)
    spec = dict(xl=-np.ones(n), xu=np.ones(n), cl=np.zeros(2), cu=np.ones(2), x0=np.zeros(n))
    pj = hiop_tpu.AutoDiffNlpProblem(
        f=lambda z: jnp.sum(jnp.cos(z) * z ** 2), c=lambda z: jnp.stack([z[0] * z[1], jnp.sum(z ** 3)]),
        **spec)
    pt = hiop_tpu_torch.AutoDiffNlpProblem(
        f=lambda z: torch.sum(torch.cos(z) * z ** 2), c=lambda z: torch.stack([z[0] * z[1], torch.sum(z ** 3)]),
        **spec)
    xj, xt = jnp.asarray(x), _t(x)
    _close(pt.eval_grad_f(xt).numpy(), np.asarray(pj.eval_grad_f(xj)))
    _close(pt.eval_cons(xt).numpy(), np.asarray(pj.eval_cons(xj)))
    _close(pt.eval_jac_cons(xt).numpy(), np.asarray(pj.eval_jac_cons(xj)))
    _close(pt.eval_hess_lagr(xt, 0.7, _t(lam)).numpy(),
           np.asarray(pj.eval_hess_lagr(xj, 0.7, jnp.asarray(lam))))
    free = hiop_tpu_torch.AutoDiffNlpProblem(
        f=lambda z: (z ** 2).sum(), c=None, xl=-np.ones(n), xu=np.ones(n),
        cl=np.zeros(0), cu=np.zeros(0), x0=np.zeros(n))
    assert tuple(free.eval_jac_cons(xt).shape) == (0, n)
    assert tuple(free.eval_cons(xt).shape) == (0,)
