"""The device sparse KKT modules of the port against the JAX package, on the
CPU, in f64.

On the same seeded numpy inputs: ``linalg/sparse_device.py``
(``DeviceSparseLDL``: the host symbolic analysis exactly, the level-scheduled
numeric factorization and solves to 1e-12 relative; the f32 factors with
f64 refinement; refactorization with new values; the refusals),
``kkt/sparse_direct.py`` ``DeviceSparseXDYcYdKKT`` under every ordering
policy, ``kkt/condensed_sparse_device.py`` ``CondensedSparseDeviceKKT`` and
``kkt/condensed_matfree.py`` (the Jacobi PCG) at one fixed KKT point:
values, inertia and directions to 1e-10, CG iterations and flags exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import scipy.sparse as sp
import torch
from threadpoolctl import threadpool_limits

import hiop_tpu
import hiop_tpu.kkt.condensed_matfree as jcmf
import hiop_tpu.kkt.sparse_direct as jsd
import hiop_tpu_torch
import hiop_tpu_torch.kkt.condensed_matfree as tcmf
import hiop_tpu_torch.kkt.sparse_direct as tsd
from hiop_tpu.interface.base import INF
from hiop_tpu.kkt.condensed_sparse_device import CondensedSparseDeviceKKT as JCondensed
from hiop_tpu.linalg.sparse_device import DeviceSparseLDL as JLDL
from hiop_tpu_torch.kkt.condensed_sparse_device import CondensedSparseDeviceKKT as TCondensed
from hiop_tpu_torch.linalg.sparse_device import DeviceSparseLDL as TLDL, equilibrate, read_factor_stats
from test_torch_sparse import DELTAS, _formulations, _kkt_operands, _rel

# The matrices here are small: torch's intra-op thread pool costs more than it
# gains, and its spinning threads slow the other test workers.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One OpenBLAS thread for numpy/scipy inside these tests (see
    tests/test_torch_sparse_solve.py); lifted after each."""
    with threadpool_limits(limits=1):
        yield


TOL = 1e-12
KKT_TOL = 1e-10


def _kkt_like(n, m, seed, delta=1e-2):
    """A random quasi-definite saddle [[H, J^T], [J, -delta I]] in COO,
    both triangles (the JAX package's test pattern)."""
    rng = np.random.default_rng(seed)
    H = sp.random(n, n, density=0.1, random_state=seed)
    H = H @ H.T + sp.diags(rng.uniform(0.5, 2.0, n))
    J = sp.random(m, n, density=0.25, random_state=seed + 1) + sp.eye(m, n)
    K = sp.bmat([[H, J.T], [J, -delta * sp.eye(m)]], format="coo")
    return ((K + K.T) * 0.5).tocoo()


def _both(K, **kw):
    N = K.shape[0]
    return JLDL(K.row, K.col, N, **kw), TLDL(K.row, K.col, N, device="cpu", **kw)


def _assert_same_symbolic(j, t):
    assert (t._perm is None) == (j._perm is None)
    if t._perm is not None:
        assert np.array_equal(t._perm, j._perm)
    assert t.lnz == j.lnz and t.n_levels == j.n_levels
    assert np.array_equal(t.Lp, j.Lp) and np.array_equal(t.Li, j.Li)
    assert np.array_equal(t.parent, j.parent)


def _assert_same_stats(ft, fj):
    assert read_factor_stats(ft) == (bool(fj.ok), int(fj.n_clamped), int(fj.n_neg))


# ---------------------------------------------------------------------------
# linalg/sparse_device.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,ordering", [(0, "amd"), (3, "amd"), (7, "amd"), (0, "rcm"), (0, "none")])
def test_device_ldl_matches_jax(seed, ordering):
    K = _kkt_like(40, 15, seed)
    N = K.shape[0]
    j, t = _both(K, ordering=ordering)
    _assert_same_symbolic(j, t)
    fj = j.get_numeric(np.float64)(np.asarray(K.data))
    ft = t.get_numeric(torch.float64)(K.data)
    _assert_same_stats(ft, fj)
    assert read_factor_stats(ft) == (True, 0, int((np.linalg.eigvalsh(K.toarray()) < 0).sum()))
    assert _rel(ft.Lx, fj.Lx) <= TOL and _rel(ft.d, fj.d) <= TOL
    # L D L^T reproduces P K P^T (the factors live in the permutation's
    # coordinates)
    L = np.eye(N)
    L[t.Li, np.repeat(np.arange(N), np.diff(t.Lp))] = ft.Lx.numpy()
    Kd = K.toarray()
    if t._perm is not None:
        Kd = Kd[np.ix_(t._perm, t._perm)]
    assert np.abs(L @ np.diag(ft.d.numpy()) @ L.T - Kd).max() <= TOL * max(1, abs(K.data).max())
    b = np.random.default_rng(seed).standard_normal(N)
    xt = t.get_solve()(ft, torch.as_tensor(b))
    assert _rel(xt, j.get_solve()(fj, b)) <= TOL
    assert np.linalg.norm(K @ xt.numpy() - b) <= 1e-12 * np.linalg.norm(b)


def test_device_ldl_f32_with_ir_matches_f64():
    """f32 factors, three f64 refinement steps through them: the solution
    of the f64 system to 1e-9, in both packages alike."""
    K = _kkt_like(50, 20, 11)
    N = K.shape[0]
    j, t = _both(K)
    fj = j.get_numeric(np.float32)(np.asarray(K.data))
    ft = t.get_numeric(torch.float32)(K.data)
    assert ft.Lx.dtype == torch.float32
    _assert_same_stats(ft, fj)
    assert read_factor_stats(ft)[2] == int((np.linalg.eigvalsh(K.toarray()) < 0).sum())
    b = np.random.default_rng(1).standard_normal(N)
    x_ref = np.linalg.solve(K.toarray(), b)
    for solve, f, conv in ((j.get_solve(), fj, np.asarray),
                           (t.get_solve(), ft, lambda v: v.numpy())):
        x = conv(solve(f, b)).astype(np.float64)
        for _ in range(3):
            x = x + conv(solve(f, b - K @ x)).astype(np.float64)
        assert _rel(x, x_ref) <= 1e-9


def test_device_ldl_refactorize_changes_values_only():
    """The regularization-retry contract: the same pattern, new values; the
    numeric runs again with no new symbolic work and tracks the inertia."""
    n, m = 30, 10
    K0 = _kkt_like(n, m, 2, delta=1e-8).tocoo()
    N = n + m
    j, t = _both(K0)
    num_j, num_t = j.get_numeric(np.float64), t.get_numeric(torch.float64)
    vals = np.asarray(K0.data)
    diag = np.flatnonzero(K0.row == K0.col)
    hdiag = diag[K0.row[diag] < n]
    for delta in (0.0, 1e-4, 1.0, 100.0):
        v = vals.copy()
        v[hdiag] += delta
        ft, fj = num_t(v), num_j(v)
        _assert_same_stats(ft, fj)
        w = np.linalg.eigvalsh(sp.coo_matrix((v, (K0.row, K0.col)), shape=(N, N)).toarray())
        assert read_factor_stats(ft)[2] == int((w < 0).sum()), delta
        assert _rel(ft.d, fj.d) <= TOL


def test_device_ldl_clamps_tiny_pivots_like_jax():
    """Two equal constraint rows and no dual regularization: the second
    dual pivot cancels to rounding noise, the static pivot clamping
    completes the factorization, and both packages clamp alike."""
    n, m = 20, 6
    rng = np.random.default_rng(5)
    H = sp.diags(rng.uniform(0.5, 2.0, n))
    J = sp.random(m, n, density=0.3, random_state=5).toarray() + np.eye(m, n)
    J[1] = J[0]
    K = sp.bmat([[H, sp.csr_matrix(J).T], [sp.csr_matrix(J), sp.csr_matrix((m, m))]]).tocoo()
    N = n + m
    rows = np.concatenate([K.row, np.arange(n, N)])     # the (structurally
    cols = np.concatenate([K.col, np.arange(n, N)])     # zero) dual diagonal
    vals = np.concatenate([K.data, np.zeros(m)])
    j = JLDL(rows, cols, N, ordering="none")
    t = TLDL(rows, cols, N, ordering="none", device="cpu")
    fj, ft = j.get_numeric(np.float64)(vals), t.get_numeric(torch.float64)(vals)
    _assert_same_stats(ft, fj)
    assert read_factor_stats(ft)[:2] == (True, 1)
    assert _rel(ft.d, fj.d) <= TOL


@pytest.mark.parametrize("case", ["missing_diagonal", "max_ops", "max_lnz"])
def test_device_ldl_refuses_like_jax(case):
    if case == "missing_diagonal":
        K, kw, match = sp.coo_matrix(np.array([[0.0, 1.0], [1.0, 0.0]])), {}, "diagonal"
    else:
        K, kw, match = _kkt_like(20, 5, 0), {case: 1}, case
    for cls, extra in ((JLDL, {}), (TLDL, dict(device="cpu"))):
        with pytest.raises(ValueError, match=match):
            cls(K.row, K.col, K.shape[0], **kw, **extra)


# ---------------------------------------------------------------------------
# kkt/sparse_direct.py: DeviceSparseXDYcYdKKT
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,ordering", [("ex1", o) for o in ("auto", "amd", "qd_amd", "rcm", "none")]
                         + [("acopf8", "auto"), ("acopf8", "rcm")])
def test_device_xdycyd_kkt_matches_jax(name, ordering):
    """Every ordering policy on sparse Ex1, the default and RCM on ACOPF
    (B=8). The directions agree to 1e-10, or, where the elimination order
    amplifies rounding (no pivoting: RCM on ACOPF puts large multipliers in
    L, and both packages' certified directions lie 1.3-1.6e-10 from the
    exact solution of a system with condition number 775), to twice the
    reference's own distance from the exact solution."""
    nj, nt = _formulations(name, linear_solver_sparse_ordering=ordering)
    ops, rhs = _kkt_operands(nj)
    kj, kt = jsd.DeviceSparseXDYcYdKKT(nj), tsd.DeviceSparseXDYcYdKKT(nt)
    assert np.array_equal(kt._ldl._perm, kj._ldl._perm) and kt._ldl.lnz == kj._ldl.lnz
    vj = kj._values(*ops, DELTAS)
    vt = kt.values_device(*ops, DELTAS)
    assert _rel(vt, vj) <= TOL
    assert _rel(equilibrate(vt, kt._rows_t, kt._cols_t, kt.ntot)[0],
                kj._equilibrate(jnp.asarray(vj))[0]) <= TOL
    assert kt.factorize(*ops, DELTAS) and kj.factorize(*ops, DELTAS)
    assert kt.last_inertia == kj.last_inertia
    if name == "ex1" and kt.last_inertia is not None:
        assert kt.last_inertia[1:] == (nj.m_eq + nj.m_ineq, 0)
    out_t, out_j = kt.solve(*rhs), kj.solve(*(jnp.asarray(r) for r in rhs))
    assert out_t is not None and out_j is not None
    A = sp.coo_matrix((vj, (kj._rows, kj._cols)), shape=(kj.ntot, kj.ntot))
    x_t, x_j = torch.cat(out_t).numpy(), np.concatenate([np.asarray(a) for a in out_j])
    exact = np.linalg.solve(A.toarray(), np.concatenate(rhs))
    tol = max(KKT_TOL, 2.0 * _rel(x_j, exact))
    assert _rel(x_t, exact) <= tol
    for a, b in zip(out_t, out_j):
        assert _rel(a, b) <= tol
    # the certified direction solves the augmented system, by the
    # certification's own measure ||b - A x|| <= 1e-9 (||b|| + max|A| ||x||)
    b = np.concatenate(rhs)
    assert (np.linalg.norm(b - A @ x_t)
            <= 1e-9 * (np.linalg.norm(b) + np.abs(vj).max() * np.linalg.norm(x_t)))


def test_device_xdycyd_kkt_f32_matches_jax():
    """kkt_fact_dtype=float32: f32 factors, every solve certified by f64
    refinement, in both packages to the refinement's tolerance."""
    nj, nt = _formulations("acopf8", kkt_fact_dtype="float32")
    ops, rhs = _kkt_operands(nj)
    kj, kt = jsd.DeviceSparseXDYcYdKKT(nj), tsd.DeviceSparseXDYcYdKKT(nt)
    assert kt.factorize(*ops, DELTAS) and kj.factorize(*ops, DELTAS)
    assert kt._factors.Lx.dtype == torch.float32
    assert kt.last_inertia == kj.last_inertia
    out_t, out_j = kt.solve(*rhs), kj.solve(*(jnp.asarray(r) for r in rhs))
    for a, b in zip(out_t, out_j):
        assert _rel(a, b) <= 1e-8


# ---------------------------------------------------------------------------
# kkt/condensed_sparse_device.py and kkt/condensed_matfree.py
# ---------------------------------------------------------------------------
class _Condensed:
    """A small inequality-only sparse problem (the JAX package's condensed
    test problem) for both packages, numpy data made from a seed."""

    def __init__(self, n=12, mi=7, seed=4):
        rng = np.random.default_rng(seed)
        Hd = sp.random(n, n, density=0.3, random_state=seed)
        self.Hd = (Hd @ Hd.T + sp.diags(rng.uniform(0.5, 2.0, n))).tocoo()
        self.Hu = sp.triu(self.Hd).tocoo()
        self.Ju = (sp.random(mi, n, density=0.4, random_state=seed + 1) + sp.eye(mi, n)).tocoo()
        self.n, self.mi = n, mi

    def problem(self, pkg, xp):
        c = self

        class P(pkg.SparseProblem):
            def get_prob_sizes(self):
                return c.n, c.mi

            def get_vars_info(self):
                return np.full(c.n, -INF), np.full(c.n, INF)

            def get_cons_info(self):
                return np.full(c.mi, -1.0), np.full(c.mi, 3.0)

            def get_starting_point(self):
                return np.zeros(c.n)

            def get_sparse_blocks_info(self):
                return c.n, c.Ju.nnz, c.Hu.nnz

            def jac_structure(self):
                return c.Ju.row, c.Ju.col

            def eval_jac_vals(self, x):
                return xp(c.Ju.data)

            def hess_structure(self):
                return c.Hu.row, c.Hu.col

            def eval_hess_vals(self, x, obj_factor, lam):
                return xp(c.Hu.data) * obj_factor

            def eval_f(self, x):
                return 0.5 * x @ (xp(c.Hd.toarray()) @ x)

            def eval_grad_f(self, x):
                return xp(c.Hd.toarray()) @ x

            def eval_cons(self, x):
                return x[:0], xp(c.Ju.toarray()) @ x

        return P()

    def formulations(self, **opts):
        out = []
        for pkg, xp, extra in ((hiop_tpu, jnp.asarray, {}),
                               (hiop_tpu_torch, lambda a: torch.as_tensor(a, dtype=torch.float64),
                                dict(compute_mode="cpu"))):
            o = pkg.NlpOptions()
            o.update(Hessian="analytical_exact", verbosity_level=0, **extra, **opts)
            nlp = pkg.NlpSparse(self.problem(pkg, xp), o)
            nlp.finalize_initialization()
            out.append(nlp)
        return out

    def operands(self, seed=6):
        rng = np.random.default_rng(seed)
        return (self.Hu.data.copy(), rng.uniform(0.1, 2.0, self.n), rng.uniform(0.1, 2.0, self.mi),
                self.Ju.data.copy()), [rng.standard_normal(k) for k in (self.n, self.mi, self.mi)]


def test_condensed_sparse_device_kkt_matches_jax():
    c = _Condensed()
    nj, nt = c.formulations()
    (h, Dx, Dd, jd), rhs = c.operands()
    kj, kt = JCondensed(nj), TCondensed(nt)
    deltas = (1e-3, 1e-4, 1e-5)
    assert np.array_equal(kt._ldl.Li, kj._ldl.Li) and kt._ldl.lnz == kj._ldl.lnz
    dd_tot = Dd + deltas[1]
    dd_tilde = dd_tot / (1.0 + deltas[2] * dd_tot)
    vt = kt.values_device(*(torch.as_tensor(a) for a in (h, Dx, jd, dd_tilde)), deltas[0])
    vj = kj._values_device(*(jnp.asarray(a) for a in (h, Dx, jd, dd_tilde)), deltas[0])
    assert _rel(vt, vj) <= TOL
    # the symmetrized matvec is K = H + diag(Dx + delta_wx) + J^T diag(dd_tilde) J
    Kd = c.Hd.toarray() + np.diag(Dx + deltas[0]) + c.Ju.T @ np.diag(dd_tilde) @ c.Ju
    x = np.random.default_rng(3).standard_normal(c.n)
    assert _rel(kt.k_mv(vt, torch.as_tensor(x)), Kd @ x) <= TOL
    assert kt.factorize(h, Dx, Dd, jd, deltas) and kj.factorize(*(jnp.asarray(a) for a in (h, Dx, Dd, jd)),
                                                                deltas)
    out_t, out_j = kt.solve(*rhs), kj.solve(*(jnp.asarray(r) for r in rhs))
    for a, b in zip(out_t, out_j):
        assert _rel(a, b) <= KKT_TOL
    # a regularization that makes K indefinite: both refuse (not SPD)
    bad = (-50.0, 1e-4, 1e-5)
    assert not kt.factorize(h, Dx, Dd, jd, bad)
    assert not kj.factorize(*(jnp.asarray(a) for a in (h, Dx, Dd, jd)), bad)


@pytest.mark.parametrize("delta_wx", [1e-3, -50.0])
def test_matrix_free_cg_matches_jax(delta_wx):
    """The Jacobi PCG on the condensed operator: the same iterations and
    flags, the same direction (delta_wx = -50 breaks down on negative
    curvature at once)."""
    c = _Condensed()
    nj, nt = c.formulations()
    (h, Dx, Dd, jd), (rx, rd, ryd) = c.operands()
    args = (nj.jac_in_rows, nj.jac_in_cols, nj.hess_rows, nj.hess_cols, nj.n, nj.m_ineq)
    sj = jcmf.make_cg_solver(jcmf.build_ops(*args), maxit=400)
    st = tcmf.make_cg_solver(tcmf.build_ops(*args, "cpu"), maxit=400)
    scal = (delta_wx, 1e-4, 1e-5, 1e-10)
    out_j = sj(*(jnp.asarray(a) for a in (h, jd, Dx, Dd, rx, rd, ryd)), *scal)
    out_t = st(*(torch.as_tensor(a) for a in (h, jd, Dx, Dd, rx, rd, ryd)), *scal)
    conv_j, neg_j, it_j, _ = out_j[3]
    conv_t, neg_t, it_t, _ = out_t[3]
    assert (bool(conv_t), bool(neg_t), int(it_t)) == (bool(conv_j), bool(neg_j), int(it_j))
    assert bool(neg_t) == (delta_wx < 0)
    if not bool(neg_t):
        assert int(it_t) > tcmf.CG_CHUNK  # the chunked loop ran past its first host read
    for a, b in zip(out_t[:3], out_j[:3]):
        assert _rel(a, b) <= KKT_TOL
