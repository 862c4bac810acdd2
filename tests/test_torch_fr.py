"""Feasibility restoration in the port against the JAX package, on the CPU.

Modules: the FR problem classes of ``optimization/fr_problem.py``
(``MdsFeasibilityRestorationProblem`` over ACOPF B=16, the dense-assembled
``FeasibilityRestorationProblem`` over DenseConsEx2 at n=40 through
``AutoDiffNlpProblem``), at the same seeded point in both packages, to
1e-12 relative: sizes, bounds, starting point, f, grad f, c, the Jacobian
blocks, the Hessian blocks, and ``iterate_callback``'s decision against a
given filter. ``duals_update.lsq_duals_matfree`` in f64 (1e-9) and f32
(1e-5), and the f32 branch of ``initial_duals_lsq``. The port's
counterparts of ``tests/test_fr.py``: the MDS FR class equals the dense
one up to the variable permutation, and at ACOPF B=512 the MDS FR class
exposes only its blocks and never assembles the dense ones.

Whole solves on ACOPF B=16 (``tests/test_fr.py``'s forced case is B=32;
the parity runs here are at B=16 to keep the suite inside its time limit,
and B=32 with ``force_resto=yes`` is held to ``SELFCHECK[32]`` in the port
here and on the card, ``chip_smoke.py`` phase 14):

- ``force_resto=yes``: the same status, the same outer and nested
  iteration counts, the objective to 1e-8, through the MDS FR class, whose
  dense assemblies are never called;
- soft restoration, forced as in ``tests/test_kkt_variants.py``'s soft-FR
  test: every line-search trial of iteration 3 is rejected through
  ``_accept_line_search_conditions`` until the soft restoration has run,
  in both packages; both take the same soft/full sequence, status and
  iterations, and the objective to 1e-8 (``tests/test_torch_fr_dense.py``
  and ``tests/test_torch_aux.py`` hold the same on a quasi-Newton problem
  and on mds_ex1).

As in ``tests/test_torch_slice.py`` both packages have their native sparse
LDL^T library switched off, so the dense safe tiers are held to each other.
The dense bases' solves are in ``tests/test_torch_fr_dense.py``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch
from threadpoolctl import threadpool_limits

import examples.acopf_mds as jax_acopf
import hiop_tpu
import hiop_tpu.native.ldl as jax_native_ldl
import hiop_tpu.optimization.duals_update as jdu
import hiop_tpu.optimization.filter_ipm as jfi
import hiop_tpu.optimization.fr_problem as jfr
import hiop_tpu_torch
import hiop_tpu_torch.native.ldl as torch_native_ldl
import hiop_tpu_torch.optimization.duals_update as tdu
import hiop_tpu_torch.optimization.filter_ipm as tfi
import hiop_tpu_torch.optimization.fr_problem as tfr
from hiop_tpu.optimization.filter import Filter as JFilter
from hiop_tpu_torch.examples import acopf_mds, dense_ex2
from hiop_tpu_torch.optimization.filter import Filter as TFilter

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


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, tol=TOL):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape
    if a.size == 0:
        return
    scale = max(float(np.abs(b).max()), 1.0)
    assert float(np.abs(a - b).max()) <= tol * scale, float(np.abs(a - b).max())


def _mds_bases(B):
    """The ACOPF B-bus NlpMDS formulation in both packages (the examples'
    options)."""
    oj = hiop_tpu.NlpOptions()
    oj.update(Hessian="analytical_exact", fixed_var="relax", verbosity_level=0)
    jb = hiop_tpu.NlpMDS(jax_acopf.AcopfMds(B), oj)
    jb.finalize_initialization()
    tb = hiop_tpu_torch.NlpMDS(acopf_mds.AcopfMds(B), acopf_mds.acopf_options(
        compute_mode="cpu", verbosity_level=0))
    tb.finalize_initialization()
    return jb, tb


def _dense_bases(n):
    """DenseConsEx2's f and c through AutoDiffNlpProblem (exact Hessian) in
    both packages."""
    J = jnp.asarray(dense_ex2.ex2_jacobian(n))
    xl, xu, cl, cu = dense_ex2.ex2_bounds(n)
    jp = hiop_tpu.AutoDiffNlpProblem(
        f=lambda x: 0.25 * jnp.sum((x - 1.0) ** 4), c=lambda x: J @ x,
        xl=xl, xu=xu, cl=cl, cu=cu, x0=np.zeros(n))
    oj = hiop_tpu.NlpOptions()
    oj.update(Hessian="analytical_exact", verbosity_level=0)
    jb = hiop_tpu.NlpDenseConstraints(jp, oj)
    jb.finalize_initialization()
    ot = hiop_tpu_torch.NlpOptions()
    ot.update(Hessian="analytical_exact", verbosity_level=0, compute_mode="cpu")
    tb = hiop_tpu_torch.NlpDenseConstraints(dense_ex2.autodiff_problem(n, "cpu"), ot)
    tb.finalize_initialization()
    return jb, tb


def _fr_pair(kind):
    """(jax FR problem, port FR problem, z as numpy) at a seeded x_ref and a
    seeded point z."""
    rng = np.random.default_rng(5)
    if kind == "mds":
        jb, tb = _mds_bases(16)
        jcls, tcls = jfr.MdsFeasibilityRestorationProblem, tfr.MdsFeasibilityRestorationProblem
    else:
        jb, tb = _dense_bases(40)
        jcls, tcls = jfr.FeasibilityRestorationProblem, tfr.FeasibilityRestorationProblem
    x0 = np.asarray(jb.get_starting_point())
    x_ref = x0 + 0.05 * rng.standard_normal(x0.size)
    jf = jcls(jb, jnp.asarray(x_ref), 0.1, 2.5)
    tf = tcls(tb, torch.from_numpy(x_ref.copy()), 0.1, 2.5)
    z0 = np.asarray(jf.get_starting_point())
    z = z0 * (1.0 + 0.01 * rng.standard_normal(z0.size)) + 0.003
    return jf, tf, z


@pytest.fixture(scope="module", params=["mds", "dense"])
def fr_pair(request):
    return (request.param,) + _fr_pair(request.param)


def test_fr_problem_surface_matches_jax(fr_pair):
    kind, jf, tf, z = fr_pair
    assert tf.get_prob_sizes() == jf.get_prob_sizes()
    assert (tf.n, tf.m, tf.m_eq, tf.m_ineq) == (jf.n, jf.m, jf.m_eq, jf.m_ineq)
    assert tf.mu_fr == jf.mu_fr and tf.zeta == jf.zeta
    _close(tf.DR, jf.DR)
    for a, b in zip(tf.get_vars_info() + tf.get_cons_info(), jf.get_vars_info() + jf.get_cons_info()):
        np.testing.assert_array_equal(a, b)
    _close(tf.get_starting_point(), jf.get_starting_point())
    zt, zj = torch.from_numpy(z.copy()), jnp.asarray(z)
    _close(tf.eval_f(zt).reshape(1), np.asarray(jf.eval_f(zj)).reshape(1))
    _close(tf.eval_grad_f(zt), jf.eval_grad_f(zj))
    _close(tf.eval_cons(zt), jf.eval_cons(zj))
    lam = np.linspace(-0.5, 0.7, jf.m)
    if kind == "mds":
        assert tf.get_sparse_dense_blocks_info() == jf.get_sparse_dense_blocks_info()
        for a, b in zip(tf.jac_sparse_structure(), jf.jac_sparse_structure()):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tf.eval_jac_blocks(zt), jf.eval_jac_blocks(zj)):
            _close(a, b)
        for a, b in zip(tf.eval_hess_blocks(zt, 0.8, torch.from_numpy(lam)),
                        jf.eval_hess_blocks(zj, 0.8, jnp.asarray(lam))):
            _close(a, b)
    else:
        _close(tf.eval_jac_cons(zt), jf.eval_jac_cons(zj))
        _close(tf.eval_hess_lagr(zt, 0.8, torch.from_numpy(lam)),
               jf.eval_hess_lagr(zj, 0.8, jnp.asarray(lam)))


#: iterate_callback cases: (iteration, infeasibility reference, filter entries)
CALLBACK_CASES = {
    "accepted": (1, 1e10, [(1e10, float("-inf"))]),
    "no_filter": (3, 1e10, None),
    "first_iteration": (0, 1e10, None),
    "not_feasible_enough": (2, 1e-12, None),
    "in_the_filter": (1, 1e10, [(0.0, float("-inf"))]),
}


@pytest.mark.parametrize("case", list(CALLBACK_CASES))
def test_fr_iterate_callback_decision_matches_jax(fr_pair, case):
    _, jf, tf, z = fr_pair
    it, ref, entries = CALLBACK_CASES[case]
    s = np.random.default_rng(9).standard_normal(jf.m_ineq)
    decisions = []
    for f, filt, cast in ((jf, JFilter(), jnp.asarray), (tf, TFilter(), lambda a: torch.from_numpy(a.copy()))):
        f.accepted = None
        f.nrmInf_feas_ref = ref
        f.orig_filter = None
        if entries is not None:
            filt._entries = list(entries)
            f.orig_filter = filt
        info = types.SimpleNamespace(iter=it, x=cast(z), s=cast(s))
        decisions.append((f.iterate_callback(info), f.accepted))
    (go_t, acc_t), (go_j, acc_j) = decisions[1], decisions[0]
    assert go_t == go_j
    assert (acc_t is None) == (acc_j is None)
    assert go_t == (case in ("first_iteration", "not_feasible_enough", "in_the_filter"))
    if acc_t is not None:
        assert abs(acc_t["theta"] - acc_j["theta"]) <= TOL * max(1.0, acc_j["theta"])
        assert isinstance(acc_t["x"], torch.Tensor) and isinstance(acc_t["d"], torch.Tensor)
        _close(acc_t["x"], acc_j["x"])
        _close(acc_t["d"], acc_j["d"])


def test_mds_fr_matches_dense_fr_exactly():
    """The port's MDS FR class equals its generic dense-assembled FR class
    over the same MDS base at a live point, up to the [x_s, p, n, x_d]
    variable permutation (``tests/test_fr.py``'s test, on the port)."""
    base = hiop_tpu_torch.NlpMDS(acopf_mds.AcopfMds(8), acopf_mds.acopf_options(
        compute_mode="cpu", verbosity_level=0))
    base.finalize_initialization()
    x_ref = base.get_starting_point()
    fd = tfr.FeasibilityRestorationProblem(base, x_ref, 0.1, 2.5)
    fm = tfr.MdsFeasibilityRestorationProblem(base, x_ref, 0.1, 2.5)
    ns, nd, m, n_x = base.n_sparse, base.n_dense, base.m_eq + base.m_ineq, base.n
    pidx = np.concatenate([np.arange(ns), n_x + np.arange(2 * m), ns + np.arange(nd)])
    z_d = torch.from_numpy(fd.get_starting_point() * 1.01 + 0.003)
    z_m = z_d[torch.from_numpy(pidx)]
    np.testing.assert_allclose(fm.get_starting_point(), fd.get_starting_point()[pidx], rtol=1e-14)
    lo_m, hi_m = fm.get_vars_info()
    lo_d, hi_d = fd.get_vars_info()
    np.testing.assert_array_equal(lo_m, lo_d[pidx])
    np.testing.assert_array_equal(hi_m, hi_d[pidx])
    assert float(fm.eval_f(z_m)) == pytest.approx(float(fd.eval_f(z_d)), rel=1e-14)
    _close(fm.eval_grad_f(z_m), fd.eval_grad_f(z_d)[pidx], 1e-13)
    _close(fm.eval_cons(z_m), fd.eval_cons(z_d), 1e-13)
    _close(fm.eval_jac_cons(z_m), fd.eval_jac_cons(z_d)[:, pidx], 1e-13)
    lam = torch.from_numpy(np.linspace(-0.5, 0.7, fm.m))
    _close(fm.eval_hess_lagr(z_m, 0.8, lam), fd.eval_hess_lagr(z_d, 0.8, lam)[pidx][:, pidx], 1e-13)


def _forbid_dense_assembly(mp):
    """Make the MDS FR class's dense assemblies raise."""
    def forbidden(self, *a, **k):
        raise AssertionError("the MDS FR problem's dense assembly was called")

    for name in ("eval_jac_cons", "eval_hess_lagr"):
        mp.setattr(tfr.MdsFeasibilityRestorationProblem, name, forbidden)


def test_mds_fr_stays_block_structured_at_b512_scale(monkeypatch):
    """At the B=512 shape the MDS FR problem, and the nested NlpMDS over
    it, expose only the triplet values and the (m, n_d) dense block; the
    (m, n + 2m) [J | -I | I] and the (n + 2m)^2 Hessian are never
    assembled."""
    _forbid_dense_assembly(monkeypatch)
    base = hiop_tpu_torch.NlpMDS(acopf_mds.AcopfMds(512), acopf_mds.acopf_options(
        compute_mode="cpu", verbosity_level=0))
    base.finalize_initialization()
    fm = tfr.MdsFeasibilityRestorationProblem(base, base.get_starting_point(), 0.1, 1.0)
    n_sp, n_de = fm.get_sparse_dense_blocks_info()
    assert (fm.m, base.n_sparse, n_de) == (4608, 5120, 102)
    assert n_sp == base.n_sparse + 2 * fm.m and fm.n == 14438
    o = hiop_tpu_torch.NlpOptions()
    o.update(Hessian="analytical_exact", verbosity_level=0, scaling_type="none", compute_mode="cpu")
    nested = hiop_tpu_torch.NlpMDS(fm, o)
    nested.finalize_initialization()
    z = nested.get_starting_point()
    sp_vals, dense_blk = fm.eval_jac_blocks(z)
    jr, jc = fm.jac_sparse_structure()
    assert sp_vals.shape == jr.shape == jc.shape
    assert dense_blk.shape == (fm.m, n_de)
    assert sp_vals.numel() < 30 * fm.m  # O(base nnz + 2m): no densification
    (veq, vin), De, Di = nested.eval_jac_blocks_split(z)
    assert veq.numel() + vin.numel() == sp_vals.numel() and De.shape[1] == Di.shape[1] == n_de
    hss, hdd = nested.eval_hess_blocks(z, 1.0, torch.zeros(nested.m_eq, dtype=torch.float64),
                                       torch.zeros(nested.m_ineq, dtype=torch.float64))
    assert hss.shape == (n_sp,) and hdd.shape == (n_de, n_de)


# ---------------------------------------------------------------------------
# duals_update
# ---------------------------------------------------------------------------
def _lsq_operands(seed=4, n=60, mc=3, md=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in ((mc, n), (md, n), n, n, n, md, md)]


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9), ("float32", 1e-5)])
def test_lsq_duals_matfree_matches_jax(dtype, tol):
    ops = _lsq_operands()
    yt = tdu.lsq_duals_matfree(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in ops))
    yj = jdu.lsq_duals_matfree(*(jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in ops))
    for a, b in zip(yt, yj):
        assert a.dtype == getattr(torch, dtype)
        _close(a, b, tol)
    # and it solves the LSQ normal equations that lsq_duals factorizes
    y64 = tdu.lsq_duals(*(torch.from_numpy(a) for a in ops))
    for a, b in zip(yt, y64):
        _close(a.double(), b, 1e-8 if dtype == "float64" else 1e-4)


def test_initial_duals_lsq_takes_the_f32_matfree_branch(monkeypatch):
    """Above the entry threshold the initialization runs the f32 CG at
    tol=1e-6 and casts back, as ``hiop_tpu``'s does above 5e7 entries."""
    ops = _lsq_operands()
    monkeypatch.setattr(tdu, "LSQ_DENSE_MAX_ENTRIES", 100)
    yt = tdu.initial_duals_lsq(*(torch.from_numpy(a) for a in ops), lsq_max=1e3)
    yj = jdu.lsq_duals_matfree(*(jnp.asarray(a, dtype=jnp.float32) for a in ops), tol=1e-6)
    for a, b in zip(yt, yj):
        assert a.dtype == torch.float64
        _close(a, b, 1e-5)
    assert tdu.LSQ_DENSE_MAX_ENTRIES < 8 * 60
    monkeypatch.undo()
    assert tdu.LSQ_DENSE_MAX_ENTRIES == 50_000_000


# ---------------------------------------------------------------------------
# whole solves on an MDS base
# ---------------------------------------------------------------------------
def _solves(fi, mp):
    """Record, in order, every solver run as (nested?, status, iterations)
    and every soft restoration as ("soft", iteration, accepted)."""
    log = []
    run, soft = fi.FilterIPMBase.run, fi.FilterIPMBase._solve_soft_fr

    def recorded(self):
        r = run(self)
        log.append((bool(getattr(self, "within_fr", False)), r.status.name, r.iterations))
        return r

    def soft_recorded(self, *a, **k):
        out = soft(self, *a, **k)
        log.append(("soft", self.iter_num, out is not None))
        return out

    mp.setattr(fi.FilterIPMBase, "run", recorded)
    mp.setattr(fi.FilterIPMBase, "_solve_soft_fr", soft_recorded)
    return log


def iteration3_rejected(fi, mp):
    """Reject every trial of the outer solve's iteration 3 until the soft
    restoration has been tried."""
    accept, soft = fi.FilterIPMBase._accept_line_search_conditions, fi.FilterIPMBase._solve_soft_fr
    seen = {}

    def flaky(self, *a, **k):
        if self.iter_num == 3 and not getattr(self, "within_fr", False) and "soft" not in seen:
            return 0
        return accept(self, *a, **k)

    def spied(self, *a, **k):
        seen["soft"] = True
        return soft(self, *a, **k)

    mp.setattr(fi.FilterIPMBase, "_accept_line_search_conditions", flaky)
    mp.setattr(fi.FilterIPMBase, "_solve_soft_fr", spied)


ACOPF16_RUNS = {"forced": dict(force_resto="yes", tolerance=1e-6, mu0=0.1), "soft": {}}


@pytest.fixture(scope="module")
def jax_acopf16():
    out = {}
    for name, opts in ACOPF16_RUNS.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_native_ldl, "native_available", lambda: False)
            if name == "soft":
                iteration3_rejected(jfi, mp)
            log = _solves(jfi, mp)
            out[name] = (jax_acopf.solve(16, verbosity_level=0, **opts), log)
    return out


@pytest.mark.parametrize("name", list(ACOPF16_RUNS))
def test_acopf16_restoration_matches_jax(jax_acopf16, name, monkeypatch):
    rj, log_j = jax_acopf16[name]
    monkeypatch.setattr(torch_native_ldl, "native_available", lambda: False)
    _forbid_dense_assembly(monkeypatch)
    if name == "soft":
        iteration3_rejected(tfi, monkeypatch)
    log_t = _solves(tfi, monkeypatch)
    rt = acopf_mds.solve(16, compute_mode="cpu", verbosity_level=0, **ACOPF16_RUNS[name])
    assert rt.status.is_success and rt.status.name == rj.status.name
    assert log_t == log_j
    assert rt.iterations == rj.iterations
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))
    if name == "forced":
        assert log_t == [(True, "User_Stopped", 2), (False, "Solve_Success", 61)]
    else:
        assert log_t == [("soft", 3, True), (False, "Solve_Success", rt.iterations)]


def test_forced_resto_acopf32_routes_through_mds_fr(monkeypatch):
    """B=32, ``tests/test_fr.py``'s case, in the port: the MDS FR class,
    none of its dense assemblies, and ``SELFCHECK[32]``."""
    _forbid_dense_assembly(monkeypatch)
    made = []
    orig = tfr.MdsFeasibilityRestorationProblem.__init__

    def spy(self, *a, **k):
        made.append(True)
        orig(self, *a, **k)

    monkeypatch.setattr(tfr.MdsFeasibilityRestorationProblem, "__init__", spy)
    log = _solves(tfi, monkeypatch)
    r = acopf_mds.solve(32, compute_mode="cpu", verbosity_level=0, force_resto="yes",
                        tolerance=1e-6, mu0=0.1)
    assert made == [True]
    assert [entry[:2] for entry in log] == [(True, "User_Stopped"), (False, "Solve_Success")]
    ref, tol = acopf_mds.SELFCHECK[32]
    assert abs(r.obj - ref) <= tol * max(1.0, abs(ref))
