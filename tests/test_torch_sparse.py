"""The sparse formulation's modules in the port against the JAX package, on
the CPU, in f64.

On the same seeded numpy inputs: ``linalg/sparse.py`` (``TripletMatrix``
products and ``todense``, duplicates summed), ``formulation/sparse.py``
(``NlpSparse``: the scaling from triplet row maxima, ``eval_jac`` dense and
as triplets, ``eval_jac_vals_split``, ``eval_hess_vals`` and the dense
``eval_hess``) on HiOp's sparse Ex1 (scaled, so the scaling is not the
identity) and on ACOPF through the sparse interface (duplicate-free
triplets, a dense Hessian block in the upper triangle),
``linalg/solver_registry.py`` (``splu``: SuperLU's no-pivot mode with
pivot-sign inertia, the pivoted fallback without; ``native_ldl``),
``kkt/sparse_direct.py`` and ``kkt/full_space_sparse.py`` (factorize and
solve at fixed deltas), and the triplet branch of ``initial_duals_lsq``.
Values to 1e-12 relative; inertia triples exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import scipy.sparse.linalg  # noqa: F401
import scipy.sparse as sp
import torch
from threadpoolctl import threadpool_limits

import examples.acopf_mds as jax_acopf
import examples.sparse_ex1 as jax_ex1
import hiop_tpu
import hiop_tpu.kkt.full_space_sparse as jfs
import hiop_tpu.kkt.sparse_direct as jsd
import hiop_tpu.linalg.solver_registry as jreg
import hiop_tpu.linalg.sparse as jsparse
import hiop_tpu.optimization.duals_update as jdu
import hiop_tpu_torch
import hiop_tpu_torch.kkt.full_space_sparse as tfs
import hiop_tpu_torch.kkt.sparse_direct as tsd
import hiop_tpu_torch.linalg.solver_registry as treg
import hiop_tpu_torch.linalg.sparse as tsparse
import hiop_tpu_torch.optimization.duals_update as tdu
from hiop_tpu.optimization.iterate import Iterate as JIterate
from hiop_tpu.optimization.residual import Residual as JResidual
from hiop_tpu_torch.examples import acopf_mds, sparse_ex1
from hiop_tpu_torch.optimization.residual import Residual as TResidual
from hiop_tpu_torch.utils.carry import to_bounds, to_iterate

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

TOL = 1e-12


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a, dtype=np.float64)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ---------------------------------------------------------------------------
# linalg/sparse.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(7, 5), (0, 5), (4, 0)])
def test_triplet_matrix_matches_jax(shape):
    rng = np.random.default_rng(1)
    m, n = shape
    nnz = 0 if 0 in shape else 23
    rows = rng.integers(0, max(m, 1), nnz)
    cols = rng.integers(0, max(n, 1), nnz)
    if nnz:
        rows[:3], cols[:3] = rows[0], cols[0]      # a triple duplicate
    vals = rng.standard_normal(nnz)
    v, w = rng.standard_normal(n), rng.standard_normal(m)
    Aj = jsparse.TripletMatrix(rows, cols, jnp.asarray(vals), shape)
    At = tsparse.TripletMatrix(rows, cols, torch.as_tensor(vals), shape)
    assert At.shape == Aj.shape and At.T.shape == Aj.T.shape
    assert _rel(At @ torch.as_tensor(v), Aj @ jnp.asarray(v)) <= TOL
    assert _rel(At.T @ torch.as_tensor(w), Aj.T @ jnp.asarray(w)) <= TOL
    assert _rel(At.todense(), Aj.todense()) <= TOL
    At2 = At.with_values(2.0 * At.vals)
    assert _rel(At2 @ torch.as_tensor(v), 2.0 * (Aj @ jnp.asarray(v))) <= TOL


# ---------------------------------------------------------------------------
# formulation/sparse.py
# ---------------------------------------------------------------------------
def _problems(name):
    if name == "ex1":
        # scal = 50 puts every row maximum above scaling_max_grad
        return jax_ex1.SparseEx1(30, 50.0), sparse_ex1.SparseEx1(30, 50.0), {}
    return jax_acopf.AcopfSparse(8), acopf_mds.AcopfSparse(8), dict(fixed_var="relax")


def _formulations(name, **opts):
    pj, pt, base = _problems(name)
    oj = hiop_tpu.NlpOptions()
    oj.update(verbosity_level=0, **base, **opts)
    ot = hiop_tpu_torch.NlpOptions()
    ot.update(verbosity_level=0, compute_mode="cpu", **base, **opts)
    nj, nt = hiop_tpu.NlpSparse(pj, oj), hiop_tpu_torch.NlpSparse(pt, ot)
    nj.finalize_initialization()
    nt.finalize_initialization()
    x0 = np.asarray(pj.get_starting_point(), dtype=np.float64)
    nj.maybe_setup_scaling(jnp.asarray(x0))
    nt.maybe_setup_scaling(torch.as_tensor(x0))
    return nj, nt


def _point(nlp, seed=2):
    rng = np.random.default_rng(seed)
    return (1.0 + 0.1 * rng.standard_normal(nlp.n), rng.standard_normal(nlp.m_eq),
            rng.standard_normal(nlp.m_ineq))


@pytest.mark.parametrize("name", ["ex1", "acopf8"])
def test_nlp_sparse_matches_jax(name):
    nj, nt = _formulations(name)
    assert (nt.m_eq, nt.m_ineq) == (nj.m_eq, nj.m_ineq)
    for a in ("jac_eq_rows", "jac_eq_cols", "jac_in_rows", "jac_in_cols", "hess_rows", "hess_cols"):
        assert np.array_equal(getattr(nt, a), getattr(nj, a))
    assert nt.scale_obj == nj.scale_obj
    assert np.array_equal(nt._scale_cons, np.asarray(nj._scale_cons))
    if name == "ex1":
        assert np.asarray(nj._scale_cons).min() < 1.0    # the scaling is exercised
    assert not nt.matrix_free and not nj.matrix_free
    x, yc, yd = _point(nj)
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    for a, b in zip(nt.eval_jac_vals_split(xt), nj.eval_jac_vals_split(xj)):
        assert _rel(a, b) <= TOL
    for a, b in zip(nt.eval_jac(xt), nj.eval_jac(xj)):
        assert _rel(a, b) <= TOL
    args_j = (xj, 0.7, jnp.asarray(yc), jnp.asarray(yd))
    args_t = (xt, 0.7, torch.as_tensor(yc), torch.as_tensor(yd))
    assert _rel(nt.eval_hess_vals(*args_t), nj.eval_hess_vals(*args_j)) <= TOL
    assert _rel(nt.eval_hess(*args_t), nj.eval_hess(*args_j)) <= TOL


@pytest.mark.parametrize("name", ["ex1", "acopf8"])
def test_nlp_sparse_triplet_jacobian_matches_jax(name):
    """A registry solver keeps the Jacobian in triplet form (matrix_free)."""
    nj, nt = _formulations(name, linear_solver_sparse="splu")
    assert nt.matrix_free and nj.matrix_free
    x, yc, yd = _point(nj, 3)
    rng = np.random.default_rng(4)
    for Jt, Jj in zip(nt.eval_jac(torch.as_tensor(x)), nj.eval_jac(jnp.asarray(x))):
        assert isinstance(Jt, tsparse.TripletMatrix)
        assert np.array_equal(Jt.rows, np.asarray(Jj.rows)) and np.array_equal(Jt.cols, np.asarray(Jj.cols))
        assert _rel(Jt.vals, Jj.vals) <= TOL
        v, w = rng.standard_normal(Jt.shape[1]), rng.standard_normal(Jt.shape[0])
        assert _rel(Jt @ torch.as_tensor(v), Jj @ jnp.asarray(v)) <= TOL
        assert _rel(Jt.T @ torch.as_tensor(w), Jj.T @ jnp.asarray(w)) <= TOL


def test_initial_duals_lsq_on_triplets_matches_jax():
    """Triplet Jacobians take the matrix-free CG, in both packages."""
    nj, nt = _formulations("acopf8", linear_solver_sparse="splu")
    x, _, _ = _point(nj, 5)
    rng = np.random.default_rng(6)
    g = rng.standard_normal(nj.n)
    zl, zu = rng.random(nj.n), rng.random(nj.n)
    vl, vu = rng.random(nj.m_ineq), rng.random(nj.m_ineq)
    Jj = nj.eval_jac(jnp.asarray(x))
    Jt = nt.eval_jac(torch.as_tensor(x))
    calls = []
    matfree = tdu.lsq_duals_matfree
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdu, "lsq_duals_matfree", lambda *a, **k: calls.append(1) or matfree(*a, **k))
        yt = tdu.initial_duals_lsq(*Jt, *(torch.as_tensor(a) for a in (g, zl, zu, vl, vu)), 1e3)
    yj = jdu.initial_duals_lsq(*Jj, *(jnp.asarray(a) for a in (g, zl, zu, vl, vu)), 1e3)
    assert calls
    assert _np(yj[0]).size and np.abs(_np(yj[0])).max() > 0   # not capped to zero
    for a, b in zip(yt, yj):
        assert _rel(a, b) <= 1e-10


# ---------------------------------------------------------------------------
# linalg/solver_registry.py, kkt/sparse_direct.py, kkt/full_space_sparse.py
# ---------------------------------------------------------------------------
#: fixed regularization (delta_wx, delta_wd, delta_cc, delta_cd)
DELTAS = (1e-3, 2e-3, 1e-6, 1e-6)


def _kkt_operands(nj, seed=7):
    """Host operands of the sparse-direct KKT at a seeded point."""
    x, yc, yd = _point(nj, seed)
    rng = np.random.default_rng(seed + 1)
    h = np.asarray(nj.eval_hess_vals(jnp.asarray(x), 1.0, jnp.asarray(yc), jnp.asarray(yd)))
    je, ji = (np.asarray(v) for v in nj.eval_jac_vals_split(jnp.asarray(x)))
    Dx = rng.random(nj.n) + 0.1
    Dd = rng.random(nj.m_ineq) + 0.1
    rhs = [rng.standard_normal(k) for k in (nj.n, nj.m_ineq, nj.m_eq, nj.m_ineq)]
    return (h, Dx, Dd, je, ji), rhs


def _xdycyd_csc(nj):
    ops, _ = _kkt_operands(nj)
    k = jsd.SparseXDYcYdKKT(nj, "splu")
    vals = k._values(*ops, DELTAS)
    return sp.coo_matrix((vals, (k._rows, k._cols)), shape=(k.ntot, k.ntot)).tocsc()


@pytest.mark.parametrize("name", ["ex1", "acopf8"])
@pytest.mark.parametrize("solver", ["splu", "native_ldl"])
def test_registry_factorizations_match_jax(name, solver):
    nj, _ = _formulations(name)
    A = _xdycyd_csc(nj)
    ft = treg.get_solver_factory(solver)(A)
    fj = jreg.get_solver_factory(solver)(A)
    assert ft.inertia() is not None
    assert ft.inertia() == fj.inertia()
    if name == "ex1":
        # convex: the XDYcYd inertia, n + m_ineq positive and m_eq + m_ineq
        # negative (ACOPF's Lagrangian Hessian is indefinite at this point)
        assert ft.inertia() == (nj.n + nj.m_ineq, nj.m_eq + nj.m_ineq, 0)
    b = np.random.default_rng(9).standard_normal(A.shape[0])
    assert _rel(ft.solve(b), fj.solve(b)) <= TOL
    assert _rel(A @ ft.solve(b), b) <= 1e-9


def test_splu_pivoted_fallback_drops_inertia_like_jax():
    """A zero leading pivot defeats SuperLU's no-pivot mode: the pivoted
    factorization takes over and reports no inertia, in both packages."""
    A = sp.csc_matrix(np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 2.0], [0.0, 2.0, 1.0]]))
    ft, fj = treg._splu_factory(A, "none"), jreg._splu_factory(A, "none")
    assert ft.inertia() == fj.inertia() is None
    b = np.array([1.0, 2.0, 3.0])
    assert _rel(ft.solve(b), fj.solve(b)) <= TOL
    assert treg.is_symmetric_only("native_ldl") and treg.is_symmetric_only("device_ldl")
    assert not treg.is_symmetric_only("splu")
    assert sorted(treg._REGISTRY) == sorted(jreg._REGISTRY)


@pytest.mark.parametrize("name", ["ex1", "acopf8"])
@pytest.mark.parametrize("cls", ["SparseXDYcYdKKT", "SparseXYcYdKKT"])
@pytest.mark.parametrize("solver", ["splu", "native_ldl"])
def test_sparse_direct_kkt_matches_jax(name, cls, solver):
    nj, nt = _formulations(name)
    ops, rhs = _kkt_operands(nj)
    kt = getattr(tsd, cls)(nt, solver)
    kj = getattr(jsd, cls)(nj, solver)
    assert kt.factorize(*ops, DELTAS) and kj.factorize(*ops, DELTAS)
    assert kt.last_inertia is not None and kt.last_inertia == kj.last_inertia
    if name == "ex1":
        assert kt.last_inertia[1] == nj.m_eq + nj.m_ineq
    for a, b in zip(kt.solve(*rhs), kj.solve(*rhs)):
        assert _rel(a, b) <= TOL
    assert kt.last_inertia == kj.last_inertia


def _full_operands(nj, seed=11):
    rng = np.random.default_rng(seed)
    n, mi, me = nj.n, nj.m_ineq, nj.m_eq
    b = nj.bounds
    pos = {k: rng.random(s) + 0.1 for k, s in
           (("sxl", n), ("sxu", n), ("sdl", mi), ("sdu", mi),
            ("zl", n), ("zu", n), ("vl", mi), ("vu", mi))}
    for k, pat in (("sxl", b.ixl), ("zl", b.ixl), ("sxu", b.ixu), ("zu", b.ixu),
                   ("sdl", b.idl), ("vl", b.idl), ("sdu", b.idu), ("vu", b.idu)):
        pos[k] = np.where(np.asarray(pat) == 1.0, pos[k], 0.0 if k[0] in "zv" else 1.0)
    it = dict(x=rng.standard_normal(n), d=rng.standard_normal(mi),
              yc=rng.standard_normal(me), yd=rng.standard_normal(mi), **pos)
    res = [rng.standard_normal(s) for s in (n, mi, me, mi, n, n, mi, mi, n, n, mi, mi)]
    return it, res


@pytest.mark.parametrize("name", ["ex1", "acopf8"])
def test_sparse_full_kkt_matches_jax(name):
    nj, nt = _formulations(name)
    (h, _, _, je, ji), _ = _kkt_operands(nj)
    it, res = _full_operands(nj)
    it_j = JIterate(**{k: jnp.asarray(v) for k, v in it.items()})
    it_t = to_iterate(it_j, "cpu")
    b_t = to_bounds(nj.bounds, "cpu")
    kt, kj = tfs.SparseFullKKT(nt, "splu"), jfs.SparseFullKKT(nj, "splu")
    assert kt.factorize(h, je, ji, it_t, b_t, DELTAS)
    assert kj.factorize(h, je, ji, it_j, nj.bounds, DELTAS)
    dt = kt.solve(TResidual(*(torch.as_tensor(r) for r in res)))
    dj = kj.solve(JResidual(*(jnp.asarray(r) for r in res)))
    for a, b in zip(dt, dj):
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("inertia", [None, (80, 72, 0)], ids=["inertia_less", "inertia"])
def test_chronic_switch_to_native_ldl_matches_jax(inertia):
    """_SparseDirectStrategy's chronic-regularization switch: four
    regularized iterations on an inertia-less backend rebuild the KKT on
    native_ldl; with an inertia report it stays on splu."""
    import hiop_tpu.optimization.filter_ipm as jfi
    import hiop_tpu_torch.optimization.filter_ipm as tfi

    nj, nt = _formulations("acopf8")
    out = []
    for fi, nlp in ((jfi, nj), (tfi, nt)):
        st = fi._SparseDirectStrategy(nlp, nlp.log, nlp.runstats)
        names = []
        for k in range(6):
            st.perturb.delta_wx = 1e-4 if k != 1 else 0.0
            st.kkt.last_inertia = inertia
            st._maybe_switch_to_inertia_backend()
            names.append((st._solver_name, type(st.kkt).__name__, st._chronic_delta))
        out.append(names)
    assert out[1] == out[0]
    assert out[1][-1][0] == ("native_ldl" if inertia is None else "splu")
