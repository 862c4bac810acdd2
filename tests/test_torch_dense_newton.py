"""The dense exact-Newton path of the port against the JAX package, on the CPU.

Modules, on seeded numpy operands (f64): every function of
``kkt/newton_dense.py`` (the quick Cholesky-Schur tier with its ``ok_k`` /
``ok_s`` / ``ok`` flags and tiny-pivot test, the XDYcYd and XYcYd
assemblies and matvecs, the device no-pivot LDL^T tiers with their
inertia counts and breakdowns, the host LU + eigen tiers, the curvature
test), ``kkt/full_space.py`` (the 12-block operator, the RHS and residual
helpers, the flatten helpers, the assembled matrix, its LU and solve),
``kkt/condensed.py`` and ``kkt/normal_eqn.py``. Factors to 1e-10 and
directions to 1e-9 relative; flags and inertia counts exactly.

Whole solves (``FilterIPMNewton`` over ``NlpDenseConstraints`` through
``AutoDiffNlpProblem``): the problems of ``tests/test_newton_solver.py``,
the forced device LDL^T tier of ``tests/test_ldl_blocked.py``, DenseConsEx2
with each ``KKTLinsys`` class, and ``kkt_fact_dtype=float32`` with both
packages' ``_NewtonDenseStrategy._cast`` patched to the identity, so that
the mixed-precision decisions (f32 slots, FGMRES certification,
demotions) compare one for one on f64 arithmetic. The standard: the same
status, the same iteration count, the objective to 1e-8 relative, and
where recorded the same factorizations in the same order.

The dense path's cases on the card are in ``tests/test_torch_kernels.py``
(marked ``gpu``; they need no JAX).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch
from threadpoolctl import threadpool_limits

import hiop_tpu
import hiop_tpu.kkt.condensed as jcond
import hiop_tpu.kkt.full_space as jfull
import hiop_tpu.kkt.newton_dense as jnd
import hiop_tpu.kkt.normal_eqn as jne
import hiop_tpu.optimization.filter_ipm as jfi
import hiop_tpu_torch
import hiop_tpu_torch.kkt.condensed as tcond
import hiop_tpu_torch.kkt.full_space as tfull
import hiop_tpu_torch.kkt.newton_dense as tnd
import hiop_tpu_torch.kkt.normal_eqn as tne
import hiop_tpu_torch.optimization.filter_ipm as tfi
from hiop_tpu.optimization.iterate import Bounds as JBounds, Iterate as JIterate
from hiop_tpu.optimization.residual import Residual as JResidual
from hiop_tpu_torch.examples import dense_ex2
from hiop_tpu_torch.optimization.residual import Residual as TResidual
from hiop_tpu_torch.utils.carry import to_bounds, to_iterate

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


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _rel(a, b):
    """Largest difference relative to the largest finite entry of b; the
    non-finite entries must be the same in both (a singular host LU solves
    to NaN and inf in both packages)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    bad = ~np.isfinite(b)
    assert np.array_equal(~np.isfinite(a), bad)
    assert np.array_equal(a[bad], b[bad], equal_nan=True)
    a, b = a[~bad], b[~bad]
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _same(ts, js, tol=1e-9):
    for a, b in zip(ts, js):
        assert _rel(a.numpy() if isinstance(a, torch.Tensor) else a, np.asarray(b)) <= tol


# ---------------------------------------------------------------------------
# kkt/newton_dense
# ---------------------------------------------------------------------------
CASES = ("pd", "regularized", "indefinite", "rankdef", "zero_pivot")


def _operands(case, n=30, mc=4, md=3, seed=11):
    """(H, Dx, Dd, Jc, Jd, deltas, rhs) as numpy: a PD Hessian block, the
    same with all four regularizations, an indefinite H + Dx (wrong
    inertia), a zero row of the equality Jacobian (a singular Schur
    complement: a zero pivot), and a zero first row and column of H + Dx (a zero pivot
    of the no-pivot LDL^T)."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    H = G @ G.T / n + np.eye(n)
    Dx = np.abs(rng.standard_normal(n))
    Dd = np.abs(rng.standard_normal(md)) + 0.1
    Jc = rng.standard_normal((mc, n))
    Jd = rng.standard_normal((md, n))
    deltas = (0.0, 0.0, 0.0, 0.0)
    if case == "regularized":
        deltas = (1e-4, 2e-4, 1e-8, 3e-8)
    elif case == "indefinite":
        H = H - 4.0 * np.eye(n)
    elif case == "rankdef":
        Jc[1] = 0.0
    elif case == "zero_pivot":
        H[0, :] = H[:, 0] = 0.0
        Dx[0] = 0.0
    rhs = [rng.standard_normal(k) for k in (n, md, mc, md)]
    return H, Dx, Dd, Jc, Jd, deltas, rhs


def _both(case, **kw):
    H, Dx, Dd, Jc, Jd, deltas, rhs = _operands(case, **kw)
    jargs = tuple(jnp.asarray(a) for a in (H, Dx, Dd, Jc, Jd)) + deltas
    targs = tuple(_t(a) for a in (H, Dx, Dd, Jc, Jd)) + deltas
    return targs, jargs, [_t(r) for r in rhs], [jnp.asarray(r) for r in rhs]


@pytest.mark.parametrize("case", CASES)
def test_quick_tier_matches_jax(case):
    targs, jargs, trhs, jrhs = _both(case)
    ft, fj = tnd.factorize_quick(*targs), jnd.factorize_quick(*jargs)
    flags_t = [bool(ft.ok_k), bool(ft.ok_s), bool(ft.ok)]
    assert flags_t == [bool(fj.ok_k), bool(fj.ok_s), bool(fj.ok)]
    expect = {"pd": [True, True, True], "regularized": [True, True, True],
              "indefinite": [False, True, False], "rankdef": [True, False, False]}
    if case in expect:
        assert flags_t == expect[case]
    _same((ft.Lk, ft.Ls, ft.dd_tot), (fj.Lk, fj.Ls, fj.dd_tot), 1e-10)
    _same(tnd.solve_quick(ft, *trhs), jnd.solve_quick(fj, *jrhs))


@pytest.mark.parametrize("case", ("pd", "regularized"))
def test_assemblies_and_matvecs_match_jax(case):
    targs, jargs, trhs, jrhs = _both(case)
    _same([tnd.assemble_xdycyd(*targs)], [jnd.assemble_xdycyd(*jargs)], 1e-15)
    _same([tnd.assemble_xycyd(*targs)], [jnd.assemble_xycyd(*jargs)], 1e-15)
    _same(tnd.xdycyd_matvec(*targs, *trhs), jnd.xdycyd_matvec(*jargs, *jrhs), 1e-14)
    three_t = (trhs[0], trhs[2], trhs[3])
    three_j = (jrhs[0], jrhs[2], jrhs[3])
    _same(tnd.xycyd_matvec(*targs, *three_t), jnd.xycyd_matvec(*jargs, *three_j), 1e-14)
    M = tnd.assemble_xdycyd(*targs)
    # the matvec is the assembled matrix's product, in the [x, d, yc, yd] order
    v = torch.cat(trhs)
    out = torch.cat(tnd.xdycyd_matvec(*targs, *trhs))
    n, md, mc = trhs[0].numel(), trhs[1].numel(), trhs[2].numel()
    perm = torch.cat([out[:n], out[n:n + md], out[n + md:n + md + mc], out[n + md + mc:]])
    assert _rel(perm.numpy(), (M @ v).numpy()) <= 1e-13


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("form", ["xdycyd", "xycyd"])
def test_device_safe_tiers_match_jax(case, form):
    targs, jargs, trhs, jrhs = _both(case)
    if form == "xdycyd":
        ft, fj = tnd.factorize_safe_device(*targs), jnd.factorize_safe_device(*jargs)
    else:
        ft, fj = tnd.factorize_xycyd_safe_device(*targs), jnd.factorize_xycyd_safe_device(*jargs)
    assert bool(ft.ok) == bool(fj.ok)
    assert int(ft.n_neg_eig) == int(fj.n_neg_eig)
    mcmd = ft.mc + ft.md
    expect = {"pd": mcmd, "regularized": mcmd, "zero_pivot": -1}
    if case in expect:
        assert int(ft.n_neg_eig) == expect[case]
    if case == "indefinite":
        assert int(ft.n_neg_eig) > mcmd
    if bool(ft.ok):
        _same((ft.ldl.L, ft.ldl.d), (fj.ldl.L, fj.ldl.d), 1e-9)
        if form == "xdycyd":
            _same(tnd.solve_safe_device(ft, *trhs), jnd.solve_safe_device(fj, *jrhs))
        else:
            rt = (trhs[0], trhs[2], trhs[3])
            rj = (jrhs[0], jrhs[2], jrhs[3])
            _same(tnd.solve_xycyd_safe(ft, *rt), jnd.solve_xycyd_safe(fj, *rj))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("form", ["xdycyd", "xycyd"])
def test_host_safe_tiers_match_jax(case, form):
    targs, jargs, trhs, jrhs = _both(case)
    if form == "xdycyd":
        ft, fj = tnd.factorize_safe(*targs), jnd.factorize_safe(*jargs)
    else:
        ft, fj = tnd.factorize_xycyd_safe(*targs), jnd.factorize_xycyd_safe(*jargs)
    assert bool(ft.ok) == bool(fj.ok)
    assert int(ft.n_neg_eig) == int(fj.n_neg_eig)
    if case in ("pd", "regularized"):
        assert int(ft.n_neg_eig) == ft.mc + ft.md
    if bool(ft.ok):
        if form == "xdycyd":
            _same(tnd.solve_safe(ft, *trhs), jnd.solve_safe(fj, *jrhs))
        else:
            rt = (trhs[0], trhs[2], trhs[3])
            rj = (jrhs[0], jrhs[2], jrhs[3])
            _same(tnd.solve_xycyd_safe(ft, *rt), jnd.solve_xycyd_safe(fj, *rj))


@pytest.mark.parametrize("case", ("pd", "indefinite"))
def test_curvature_test_matches_jax(case):
    targs, jargs, trhs, jrhs = _both(case)
    H, Dx, Dd = targs[:3]
    dwx, dwd = targs[5], targs[6]
    out_t = bool(tnd.curvature_test(H, Dx, Dd, dwx, dwd, trhs[0], trhs[1], 1e-11))
    out_j = bool(jnd.curvature_test(*jargs[:3], dwx, dwd, jrhs[0], jrhs[1], 1e-11))
    assert out_t == out_j == (case == "pd")


# ---------------------------------------------------------------------------
# kkt/condensed, kkt/normal_eqn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ("pd", "regularized", "indefinite"))
def test_condensed_matches_jax(case):
    targs, jargs, trhs, jrhs = _both(case, mc=0)
    H, Dx, Dd, _, Jd = targs[:5]
    dwx, dwd, _, dcd = targs[5:]
    ft = tcond.factorize(H, Dx, Dd, Jd, dwx, dwd, dcd)
    fj = jcond.factorize(*jargs[:3], jargs[4], dwx, dwd, dcd)
    assert bool(ft.ok) == bool(fj.ok) == (case != "indefinite")
    _same(ft, fj, 1e-10)
    _same(tcond.solve(ft, trhs[0], trhs[1], trhs[3], dcd),
          jcond.solve(fj, jrhs[0], jrhs[1], jrhs[3], dcd))


@pytest.mark.parametrize("case", ("pd", "regularized", "indefinite"))
def test_normal_eqn_matches_jax(case):
    targs, jargs, trhs, jrhs = _both(case)
    hd = np.diag(np.asarray(jargs[0])).copy()
    args_t = (_t(hd),) + targs[1:]
    args_j = (jnp.asarray(hd),) + jargs[1:]
    ft, fj = tne.factorize(*args_t), jne.factorize(*args_j)
    assert bool(ft.ok) == bool(fj.ok) == (case != "indefinite")
    _same(ft, fj, 1e-10)
    _same(tne.solve(ft, *trhs), jne.solve(fj, *jrhs))


# ---------------------------------------------------------------------------
# kkt/full_space
# ---------------------------------------------------------------------------
def _full_state(seed=5, nx=12, nd=3, mc=2):
    """A seeded iterate (positive slacks and bound duals), bounds with some
    infinite entries, a residual and a direction, as numpy field dicts."""
    rng = np.random.default_rng(seed)
    ixl = (rng.random(nx) < 0.7).astype(float)
    ixu = (rng.random(nx) < 0.5).astype(float)
    idl = np.array([1.0, 0.0, 1.0])[:nd]
    idu = np.array([0.0, 1.0, 1.0])[:nd]
    b = dict(xl=-ixl, xu=ixu, ixl=ixl, ixu=ixu, dl=-idl, du=idu, idl=idl, idu=idu)
    sizes = dict(x=nx, d=nd, sxl=nx, sxu=nx, sdl=nd, sdu=nd, yc=mc, yd=nd,
                 zl=nx, zu=nx, vl=nd, vu=nd)
    it = {k: (rng.uniform(0.5, 2.0, s) if k not in ("x", "d", "yc", "yd")
              else rng.standard_normal(s)) for k, s in sizes.items()}
    d = {k: rng.standard_normal(s) for k, s in sizes.items()}
    rsizes = [nx, nd, mc, nd, nx, nx, nd, nd, nx, nx, nd, nd]
    res = [rng.standard_normal(s) for s in rsizes]
    # the stored residual is 0 in the rows of absent bounds
    for i, mask in zip(range(4, 12), (ixl, ixu, idl, idu) * 2):
        res[i] = res[i] * mask
    G = rng.standard_normal((nx, nx))
    H = G @ G.T / nx + np.eye(nx)
    Jc = rng.standard_normal((mc, nx))
    Jd = rng.standard_normal((nd, nx))
    return H, Jc, Jd, b, it, d, res


def _full_both(**kw):
    H, Jc, Jd, b, it, d, res = _full_state(**kw)
    jb = JBounds(**{k: jnp.asarray(v) for k, v in b.items()})
    jit_ = JIterate(**{k: jnp.asarray(v) for k, v in it.items()})
    jd = JIterate(**{k: jnp.asarray(v) for k, v in d.items()})
    jr = JResidual(*(jnp.asarray(r) for r in res))
    tb, tit, td = to_bounds(b, "cpu"), to_iterate(it, "cpu"), to_iterate(d, "cpu")
    tr = TResidual(*(_t(r) for r in res))
    return ((_t(H), _t(Jc), _t(Jd), tit, tb, td, tr),
            (jnp.asarray(H), jnp.asarray(Jc), jnp.asarray(Jd), jit_, jb, jd, jr))


DELTAS = (1e-3, 2e-3, 1e-6, 2e-6)


def test_full_space_operator_and_helpers_match_jax():
    (H, Jc, Jd, it, b, d, r), (jH, jJc, jJd, jit_, jb, jd, jr) = _full_both()
    _same(tfull.full_kkt_matvec(H, Jc, Jd, it, b, *DELTAS, d),
          jfull.full_kkt_matvec(jH, jJc, jJd, jit_, jb, *DELTAS, jd), 1e-14)
    _same(tfull.residual_to_rhs(r), jfull.residual_to_rhs(jr), 0.0)
    _same(tfull.direction_residual(H, Jc, Jd, it, b, DELTAS, r, d),
          jfull.direction_residual(jH, jJc, jJd, jit_, jb, DELTAS, jr, jd), 1e-14)
    _same(tfull.direction_residual_norms(H, Jc, Jd, it, b, *DELTAS, r, d),
          jfull.direction_residual_norms(jH, jJc, jJd, jit_, jb, *DELTAS, jr, jd), 1e-14)
    flat = tfull._flatten_dir(d)
    _same([flat, tfull._flatten_res(r)], [jfull._flatten_dir(jd), jfull._flatten_res(jr)], 0.0)
    back = tfull._unflatten_dir(flat, it)
    _same(back, jfull._unflatten_dir(jfull._flatten_dir(jd), jit_), 0.0)


def test_full_space_assembly_lu_and_solve_match_jax():
    (H, Jc, Jd, it, b, d, r), (jH, jJc, jJd, jit_, jb, jd, jr) = _full_both()
    A = tfull.assemble_full(H, Jc, Jd, it, b, *DELTAS)
    _same([A], [jfull.assemble_full(jH, jJc, jJd, jit_, jb, *DELTAS)], 1e-15)
    ft = tfull.factorize_full(H, Jc, Jd, it, b, DELTAS)
    fj = jfull.factorize_full(jH, jJc, jJd, jit_, jb, DELTAS)
    assert ft.ok is True and fj.ok is True
    dt, dj = tfull.solve_full(ft, r), jfull.solve_full(fj, jr)
    _same(dt, dj, 1e-9)
    # the solve inverts the operator: A(d) reproduces the RHS
    _same(tfull.full_kkt_matvec(H, Jc, Jd, it, b, *DELTAS, dt), tfull.residual_to_rhs(r), 1e-9)
    # an all-zero Hessian with zero regularization makes the matrix singular
    Z = torch.zeros_like(H)
    assert tfull.factorize_full(Z, Jc, Jd, it, b, (0.0,) * 4).ok == jfull.factorize_full(
        jnp.zeros_like(jH), jJc, jJd, jit_, jb, (0.0,) * 4).ok


# ---------------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------------
def _assert_same_solve(rt, rj):
    assert rt.status.name == rj.status.name
    assert rt.iterations == rj.iterations
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))


def _newton_problems(ns):
    """The problems of tests/test_newton_solver.py:29-95 (f, c written with
    the array namespace ``ns``: jnp or torch), with their options."""
    B = 1e20

    def rosen(x):
        return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()

    return {
        "equality_qp": (dict(
            f=lambda x: 0.5 * (x ** 2).sum(), c=lambda x: x.sum()[None],
            xl=-B * np.ones(6), xu=B * np.ones(6), cl=np.array([1.0]), cu=np.array([1.0]),
            x0=np.zeros(6)), {}),
        "rosenbrock_bounded": (dict(
            f=rosen, c=None, xl=-2.0 * np.ones(8), xu=2.0 * np.ones(8),
            cl=np.zeros(0), cu=np.zeros(0), x0=-1.2 * np.ones(8)), dict(max_iter=300)),
        "inequality_nonconvex": (dict(
            f=lambda x: (ns.cos(x) + 0.1 * x ** 2).sum(), c=lambda x: x.sum()[None],
            xl=-5.0 * np.ones(5), xu=5.0 * np.ones(5), cl=np.array([-B]), cu=np.array([10.0]),
            x0=np.zeros(5)), dict(max_iter=200)),
        "stable_mode": (dict(
            f=lambda x: 0.5 * ((x - 2.0) ** 2).sum(), c=lambda x: x.sum()[None],
            xl=-B * np.ones(4), xu=B * np.ones(4), cl=np.array([-B]), cu=np.array([1.0]),
            x0=np.zeros(4)), dict(linsol_mode="stable")),
    }


def _newton(pkg, problem, solver_cls=None, **opts):
    o = pkg.NlpOptions()
    o.update(**{"Hessian": "analytical_exact", "verbosity_level": 0, **opts})
    cls = solver_cls or pkg.FilterIPMNewton
    return cls(pkg.NlpDenseConstraints(problem, o)).run()


def _jax_ex2(n):
    J = jnp.asarray(dense_ex2.ex2_jacobian(n))
    xl, xu, cl, cu = dense_ex2.ex2_bounds(n)
    return hiop_tpu.AutoDiffNlpProblem(
        f=lambda x: 0.25 * jnp.sum((x - 1.0) ** 4), c=lambda x: J @ x,
        xl=xl, xu=xu, cl=cl, cu=cu, x0=np.zeros(n))


@pytest.mark.parametrize("name", list(_newton_problems(jnp)))
def test_newton_solver_problem_matches_jax(name):
    spec_j, opts = _newton_problems(jnp)[name]
    spec_t, _ = _newton_problems(torch)[name]
    rj = _newton(hiop_tpu, hiop_tpu.AutoDiffNlpProblem(**spec_j), **opts)
    rt = _newton(hiop_tpu_torch, hiop_tpu_torch.AutoDiffNlpProblem(**spec_t),
                 compute_mode="cpu", **opts)
    assert rt.status.is_success
    _assert_same_solve(rt, rj)
    assert np.abs(rt.x - rj.x).max() <= 1e-7


def _forced_safe(fi):
    class _ForcedSafeNewton(fi.FilterIPMNewton):
        def _make_strategy(self):
            s = super()._make_strategy()
            s._safe_mode = 1
            return s

    return _ForcedSafeNewton


def test_forced_device_ldl_tier_matches_jax():
    """tests/test_ldl_blocked.py:85: the safe tier pinned to the no-pivot
    LDL^T from the first iteration."""
    n = 12

    def spec(ns):
        return dict(
            f=lambda x: 0.25 * ((x - 1.0) ** 4).sum() + 0.5 * (x ** 2).sum(),
            c=lambda x: ns.stack([x.sum(), x[0] * x[1]]),
            xl=-2.0 * np.ones(n), xu=2.0 * np.ones(n), cl=np.array([1.0, -1e20]),
            cu=np.array([1.0, 1.0]), x0=np.zeros(n))

    opts = dict(linear_solver_dense="ldl_nopiv")
    calls = []
    plain = tnd._ldl.ldl_nopiv
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnd._ldl, "ldl_nopiv", lambda A: calls.append(A.shape[0]) or plain(A))
        rt = _newton(hiop_tpu_torch, hiop_tpu_torch.AutoDiffNlpProblem(**spec(torch)),
                     solver_cls=_forced_safe(tfi), compute_mode="cpu", **opts)
    rj = _newton(hiop_tpu, hiop_tpu.AutoDiffNlpProblem(**spec(jnp)),
                 solver_cls=_forced_safe(jfi), **opts)
    assert rt.status.is_success
    _assert_same_solve(rt, rj)
    assert calls and set(calls) == {128}   # the 12 + 1 + 1 + 1 saddle, padded


def _labels(fi, f32):
    """Record each factorization's (kind, slot, dtype), each demotion, and
    each line-search test with its inputs."""
    log = {"fact": [], "demotions": [], "ls": []}
    S = fi._NewtonDenseStrategy
    factorize, demote = S._factorize, fi._mp_demote
    accept = fi.FilterIPMBase._accept_line_search_conditions

    def tagged(self):
        slot = self._safe_tiers[self._safe_mode - 1] if self._safe_mode else "quick"
        log["fact"].append(f"{self.kkt_kind}:{slot}:{'f32' if self.fact_dtype == f32 else 'f64'}")
        return factorize(self)

    def demoted(strategy, why):
        if strategy._mp_f32_ok:
            log["demotions"].append(why)
        return demote(strategy, why)

    def tested(self, theta_curr, theta_trial, phi_curr, phi_trial, alpha, grad_phi_dx):
        out = accept(self, theta_curr, theta_trial, phi_curr, phi_trial, alpha, grad_phi_dx)
        log["ls"].append((out, float(theta_curr), float(alpha), float(grad_phi_dx),
                          self.theta_min, self.s_phi, self.s_theta, self.delta))
        return out

    return log, tagged, demoted, tested


def _ex2_solve(pkg, n, forced=False, emulate=False, **opts):
    fi, f32 = (jfi, jnp.float32) if pkg is hiop_tpu else (tfi, torch.float32)
    log, tagged, demoted, tested = _labels(fi, f32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fi._NewtonDenseStrategy, "_factorize", tagged)
        mp.setattr(fi, "_mp_demote", demoted)
        mp.setattr(fi.FilterIPMBase, "_accept_line_search_conditions", tested)
        if emulate:
            mp.setattr(fi._NewtonDenseStrategy, "_cast", lambda self, a: a)
        if pkg is hiop_tpu:
            problem = _jax_ex2(n)
        else:
            problem = dense_ex2.autodiff_problem(n, "cpu")
            opts = dict(compute_mode="cpu", **opts)
        r = _newton(pkg, problem, solver_cls=_forced_safe(fi) if forced else None, **opts)
    return r, log


#: the primal infeasibility below which a linear-constraint iterate's theta
#: is rounding noise (inf_pr sits at 7e-15..4e-14 there in both packages)
THETA_NOISE = 1e-12


def _noise_decided(entry) -> bool:
    """Whether a line-search test was decided by rounding noise: near
    feasibility with a noise-level theta, where the switching condition
    alpha * (-grad_phi_dx)^s_phi > delta * theta^s_theta compares against
    delta * THETA_NOISE^s_theta or less (hiopAlgFilterIPM.cpp:2856-2945)."""
    _, theta, alpha, g, theta_min, s_phi, s_theta, delta = entry
    if theta >= min(theta_min, THETA_NOISE):
        return False
    lhs = alpha * (-g) ** s_phi if g < 0 else 0.0
    return lhs <= delta * THETA_NOISE ** s_theta


def _first_noise_decision(ls) -> int:
    return next((i for i, e in enumerate(ls) if _noise_decided(e)), len(ls))


EX2_RUNS = {
    "xdycyd": dict(),
    "xycyd_forced_ldl_nopiv": dict(KKTLinsys="xycyd", linear_solver_dense="ldl_nopiv", forced=True),
    "xycyd_forced_lu_eig": dict(KKTLinsys="xycyd", linear_solver_dense="lu_eig", forced=True),
    "xdycyd_forced_lu_eig": dict(linear_solver_dense="lu_eig", forced=True),
    "condensed": dict(KKTLinsys="condensed"),
    "normaleqn": dict(KKTLinsys="normaleqn"),
    "full": dict(KKTLinsys="full"),
    "f32_emulated": dict(kkt_fact_dtype="float32", emulate=True),
    "f32_emulated_forced_ldl_nopiv": dict(kkt_fact_dtype="float32", emulate=True,
                                          linear_solver_dense="ldl_nopiv", forced=True),
}


@pytest.mark.parametrize("name", list(EX2_RUNS))
def test_dense_ex2_newton_matches_jax(name):
    """DenseConsEx2's f and c at n=40 through AutoDiffNlpProblem, one run
    per KKT class, safe tier and mixed-precision schedule.

    The constraints are linear, so after the first full step the primal
    infeasibility theta is rounding noise (0..2e-10), summed in another
    order in each package. Near the optimum the filter's switching
    condition compares alpha*(-grad_phi_dx)^2.3 with theta^1.1 at that
    noise level (:func:`_noise_decided`), and the two packages may take
    different outcomes there (measured: in every run from about the 20th
    line-search test on; the ``xycyd`` runs then part at iteration 21 and
    end after 27 and 29 iterations, the ``condensed`` run parts at 22 and
    ends after 26 and 29; in ``condensed`` the relaxed equality, a
    1e-8-wide inequality, also amplifies the first direction's 1e-10
    rounding difference to 1e-6 by iteration 2). So: every line-search
    outcome is the same up to the first one decided at the noise level;
    where the solves still take the same number of iterations, they take
    the same factorizations in the same order (kind, slot, dtype) and the
    same demotions. Always: the same status, the objective to 1e-8."""
    run = dict(EX2_RUNS[name])
    rj, lj = _ex2_solve(hiop_tpu, 40, **run)
    rt, lt = _ex2_solve(hiop_tpu_torch, 40, **run)
    assert rt.status.is_success
    assert rt.status.name == rj.status.name
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))
    k = min(_first_noise_decision(lj["ls"]), _first_noise_decision(lt["ls"]))
    assert [e[0] for e in lt["ls"][:k]] == [e[0] for e in lj["ls"][:k]]
    if rt.iterations == rj.iterations:
        assert lt["fact"] == lj["fact"]
        assert lt["demotions"] == lj["demotions"]
    else:
        assert name in NOISE_PARTED
    if run.get("kkt_fact_dtype") == "float32":
        assert any(t.endswith(":f32") for t in lt["fact"])


#: the runs whose iteration counts part after a noise-decided line search
#: (measured; see test_dense_ex2_newton_matches_jax)
NOISE_PARTED = ("xycyd_forced_ldl_nopiv", "xycyd_forced_lu_eig", "condensed")


def test_dense_ex2_newton_selfcheck_500():
    """The exact-Newton example converges to SELFCHECK[500] on the CPU."""
    r = dense_ex2.solve_newton(500, verbosity_level=0, compute_mode="cpu")
    ref, tol = dense_ex2.SELFCHECK[500]
    assert r.status.is_success and dense_ex2.selfcheck_ok(r.obj, ref, tol)


def test_chip_smoke_solve_logs_record_a_solve():
    """The chip script's logging helpers on CPU solves: ``_dense_log``
    over the forced device-tier run (slots, inertia of each safe-tier
    test, one timestamp per KKT update) and ``_mp_log`` over an f32 ACOPF
    start, so that a fault in them shows here and not first on the card."""
    import chip_smoke
    from hiop_tpu_torch.examples import acopf_mds
    from hiop_tpu_torch.linalg import krylov

    with chip_smoke._dense_log(tfi, krylov) as log:
        r = dense_ex2.solve_newton(40, compute_mode="cpu", verbosity_level=0,
                                   linear_solver_dense="ldl_nopiv",
                                   solver_cls=chip_smoke._forced_safe_newton(tfi))
    assert r.status.is_success
    assert log["fact"][0] == "ldl_nopiv-f64" and len(log["t"]) == r.iterations
    assert all(int(n) == m == 4 and ok for n, m, ok in log["inertia"])
    with chip_smoke._mp_log(tfi, krylov) as log:
        acopf_mds.solve(8, compute_mode="cpu", verbosity_level=0, kkt_fact_dtype="float32", max_iter=3)
    assert log["fact"] and log["fact"][0] == "quick-f32" and log["strategy"] is not None
