"""The port's dense factorization kernels against the JAX package.

On the CPU the port's wrappers take their plain PyTorch versions, which
repeat the CUDA kernels' blocked arithmetic; these are held against the
JAX lanes (XLA, and the Pallas kernels in interpret mode). The tests
marked ``gpu`` hold the CUDA kernels against the plain versions on a card
and skip where there is none. They need no JAX, so on a machine with a
card and without JAX they run alone:
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # a GPU host that runs this file's gpu tests may lack threadpoolctl
    threadpool_limits = None

from hiop_tpu_torch.linalg import cholesky as tchol
from hiop_tpu_torch.linalg import kernels
from hiop_tpu_torch.linalg import ldl_blocked as tldl

# The matrices here are small: torch's intra-op thread pool costs more than it
# gains, and its spinning threads slow the other test workers.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One OpenBLAS thread for numpy/scipy inside these tests: under six
    pytest-xdist workers on an 8-core CPU, OpenBLAS's spinning threads starve
    each other (tests/test_torch_sparse_solve.py). Lifted after each test."""
    if threadpool_limits is None:
        yield
        return
    with threadpool_limits(limits=1):
        yield

TOL_CHOL = {np.float64: 1e-10, np.float32: 1e-3}


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def _saddle(n, seed):
    """A quasi-definite saddle [[K, J^T], [J, -C]] (K, C SPD), symmetrically
    row-max scaled like the MDS safe tier's M: its no-pivot LDL^T exists
    with moderate growth, so two blockings agree to rounding."""
    rng = np.random.default_rng(seed)
    nd = n // 8
    G = rng.standard_normal((nd, nd))
    K = G @ G.T / nd + np.eye(nd)
    J = rng.standard_normal((n - nd, nd))
    H = rng.standard_normal((n - nd, 8))
    C = H @ H.T / 8 + np.diag(rng.uniform(0.1, 1.1, n - nd))
    M = np.block([[K, J.T], [J, -C]])
    s = 1.0 / np.sqrt(np.abs(M).max(axis=1))
    return s[:, None] * M * s[None, :]


@pytest.fixture(scope="module")
def jax_lanes():
    """(jax.numpy, hiop_tpu.linalg.cholesky, hiop_tpu.linalg.ldl_blocked)."""
    import jax.numpy as jnp
    from hiop_tpu.linalg import cholesky as jchol
    from hiop_tpu.linalg import ldl_blocked as jldl

    return jnp, jchol, jldl


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [128, 200, 256])
def test_plain_cholesky_matches_jax(jax_lanes, n, dtype):
    jnp, jchol, jldl = jax_lanes
    A = _spd(n, n).astype(dtype)
    L = tchol.cholesky(torch.from_numpy(A)).numpy()
    tol = TOL_CHOL[dtype]
    scale = np.abs(L).max()
    Lx = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    assert np.abs(L - Lx).max() / scale < tol
    if n % 128 == 0:
        Lp = np.asarray(jchol.pallas_cholesky(jnp.asarray(A), interpret=True))
        assert np.abs(L - Lp).max() / scale < tol
    assert np.all(np.triu(L, 1) == 0)


@pytest.mark.parametrize("n,bad", [(3, None), (200, 150)])
def test_plain_cholesky_non_pd_gives_nan_lower(jax_lanes, n, bad):
    jnp, jchol, jldl = jax_lanes
    """jnp.linalg.cholesky's failure semantics, which the quick tier's
    ok = all(isfinite(L)) relies on: an all-NaN lower triangle."""
    if bad is None:
        A = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    else:
        A = _spd(n, 3)
        A[bad, bad] = -1.0
    L = tchol.cholesky(torch.from_numpy(A)).numpy()
    Lx = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    lower = np.tril(np.ones((n, n), dtype=bool))
    assert np.all(np.isnan(L[lower])) and np.all(L[~lower] == 0)
    assert np.array_equal(np.isnan(L), np.isnan(Lx))


@pytest.mark.parametrize("n", [128, 200, 256])
def test_plain_ldl_matches_jax_lanes(jax_lanes, n):
    jnp, jchol, jldl = jax_lanes
    M = _saddle(n, n)
    f = tldl.ldl_factor(torch.from_numpy(M))
    for use_pallas in (False, True):
        fj = jldl._ldl_factor_impl(jnp.asarray(M), use_pallas=use_pallas, interpret=use_pallas)
        assert np.abs(f.L.numpy() - np.asarray(fj.L)).max() < 1e-9
        assert np.abs(f.d.numpy() - np.asarray(fj.d)).max() < 1e-9
        assert int(f.n_neg) == int(fj.n_neg)
        assert bool(f.ok) == bool(fj.ok)
    assert int(f.n_neg) == int(np.sum(np.linalg.eigvalsh(M) < 0))


@pytest.mark.parametrize("n", [300, 577])
def test_plain_versions_across_outer_blocks(jax_lanes, n):
    """Sizes past one outer block (OB = 256 columns), with a ragged last
    block: the delayed rank-OB updates and the inner updates of the plain
    versions against jnp.linalg.cholesky and the XLA LDL^T lane."""
    jnp, jchol, jldl = jax_lanes
    A = _spd(n, n)
    L = tchol.cholesky(torch.from_numpy(A)).numpy()
    Lx = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    assert np.abs(L - Lx).max() / np.abs(Lx).max() < 1e-10
    M = _saddle(n, n)
    f = tldl.ldl_factor(torch.from_numpy(M))
    fj = jldl._ldl_factor_impl(jnp.asarray(M), use_pallas=False, interpret=False)
    assert np.abs(f.L.numpy() - np.asarray(fj.L)).max() < 1e-9
    assert np.abs(f.d.numpy() - np.asarray(fj.d)).max() < 1e-9
    assert int(f.n_neg) == int(fj.n_neg) and bool(f.ok) == bool(fj.ok)


def test_plain_ldl_float32_matches_xla_lane(jax_lanes):
    jnp, jchol, jldl = jax_lanes
    M = _saddle(200, 5).astype(np.float32)
    f = tldl.ldl_factor(torch.from_numpy(M))
    fj = jldl._ldl_factor_impl(jnp.asarray(M), use_pallas=False, interpret=False)
    assert np.abs(f.d.numpy() - np.asarray(fj.d)).max() / np.abs(np.asarray(fj.d)).max() < 1e-3
    assert int(f.n_neg) == int(fj.n_neg) and bool(f.ok) == bool(fj.ok)


@pytest.mark.parametrize("k", [63, 100])
def test_plain_ldl_breakdown(jax_lanes, k):
    jnp, jchol, jldl = jax_lanes
    """An exact zero pivot (inside a diagonal block, and across the edge of
    one) gives d = 0, a zeroed column and ok = False, as in the JAX lane."""
    M = np.eye(200)
    M[k, k + 1] = M[k + 1, k] = M[k + 1, k + 1] = 1.0
    f = tldl.ldl_factor(torch.from_numpy(M))
    fj = jldl._ldl_factor_impl(jnp.asarray(M), use_pallas=False, interpret=False)
    assert not bool(f.ok) and not bool(fj.ok)
    assert float(f.d[k + 1]) == 0.0 and np.all(np.isfinite(f.L.numpy()))
    assert np.abs(f.d.numpy() - np.asarray(fj.d)).max() < 1e-12


@pytest.mark.parametrize("k_rhs", [None, 3])
def test_ldl_solve_matches_jax(jax_lanes, k_rhs):
    jnp, jchol, jldl = jax_lanes
    n = 150
    M = _saddle(n, 11)
    rng = np.random.default_rng(12)
    b = rng.standard_normal(n if k_rhs is None else (n, k_rhs))
    f = tldl.ldl_factor(torch.from_numpy(M))
    x = tldl.ldl_solve(f, torch.from_numpy(b)).numpy()
    fj = jldl._ldl_factor_impl(jnp.asarray(M), use_pallas=False, interpret=False)
    xj = np.asarray(jldl.ldl_solve(fj, jnp.asarray(b)))
    assert x.shape == b.shape
    assert np.abs(x - xj).max() / np.abs(xj).max() < 1e-9
    assert np.abs(M @ x - b).max() < 1e-8


def test_cpu_tensors_take_the_plain_version():
    kernels.stats.reset()
    A = torch.from_numpy(_spd(70, 1))
    assert torch.equal(tchol.cholesky(A), tchol.cholesky_plain(A))
    L, d = tldl.ldl_nopiv(A)
    Lp, dp = tldl.ldl_nopiv_plain(A)
    assert torch.equal(L, Lp) and torch.equal(d, dp)
    assert sum(kernels.stats.launches.values()) == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    A = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        tchol.cholesky_cuda(A)
    with pytest.raises(ValueError):
        tldl.ldl_nopiv_cuda(A)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("n", [1, 37, 64, 65, 128, 300, 1000])
def test_cuda_cholesky_matches_plain(cuda_device, n, dtype, tol):
    A = torch.from_numpy(_spd(n, n) / n).to(dtype).to(cuda_device)
    before = kernels.stats.launches["cholesky"]
    L = tchol.cholesky(A)
    torch.cuda.synchronize()
    assert kernels.stats.launches["cholesky"] == before + 1
    Lp = tchol.cholesky_plain(A)
    assert float((L - Lp).abs().max() / Lp.abs().max()) < tol
    A[n // 2, n // 2] = -1.0
    L = tchol.cholesky(A)
    lower = torch.tril(torch.ones(n, n, dtype=torch.bool, device=cuda_device))
    assert bool(torch.isnan(L[lower]).all()) and bool((L[~lower] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 1e-3)])
@pytest.mark.parametrize("n", [148, 294, 1000])
def test_cuda_ldl_matches_plain(cuda_device, n, dtype, tol):
    M = _saddle(n, n)
    Mt = torch.from_numpy(M).to(dtype).to(cuda_device)
    f = tldl.ldl_factor(Mt)
    Lp, dp = tldl.ldl_nopiv_plain(tldl._pad_sym(Mt, f.L.shape[0]))
    fp = tldl.ldl_factors(Mt, Lp, dp)
    assert bool(f.ok) == bool(fp.ok) and int(f.n_neg) == int(fp.n_neg)
    assert float((f.L - Lp).abs().max() / Lp.abs().max()) < tol
    assert float((f.d - dp).abs().max() / dp.abs().max()) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_factors_repeat_bitwise(cuda_device, dtype):
    """No atomics and no split-K: the same input gives the same bits."""
    A = torch.from_numpy(_spd(600, 2) / 600).to(dtype).to(cuda_device)
    assert torch.equal(tchol.cholesky(A), tchol.cholesky(A))
    M = torch.from_numpy(_saddle(600, 2)).to(dtype).to(cuda_device)
    (L1, d1), (L2, d2) = tldl.ldl_nopiv(M), tldl.ldl_nopiv(M)
    assert torch.equal(L1, L2) and torch.equal(d1, d2)


def _dense_kkt(n, mc, md, seed):
    """Seeded dense Newton KKT operands: an SPD Hessian block, barrier
    diagonals, dense Jacobians, and a right-hand side."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    H = G @ G.T / n + np.eye(n)
    ops = [H, np.abs(rng.standard_normal(n)), np.abs(rng.standard_normal(md)) + 0.1,
           rng.standard_normal((mc, n)), rng.standard_normal((md, n))]
    rhs = [rng.standard_normal(k) for k in (n, md, mc, md)]
    return [torch.from_numpy(a) for a in ops], [torch.from_numpy(r) for r in rhs]


@pytest.mark.gpu
def test_cuda_dense_newton_tiers_match_plain(cuda_device):
    """The dense Newton tiers at DenseConsEx2's constraint shape on the card
    against their CPU runs (the plain versions): the quick tier's Cholesky
    of K at 1000^2, the device safe tier's LDL^T of the 1007 saddle."""
    from hiop_tpu_torch.kkt import newton_dense as nd

    ops, rhs = _dense_kkt(1000, 1, 3, 5)
    deltas = (0.0, 0.0, 0.0, 0.0)
    dops, drhs = [a.to(cuda_device) for a in ops], [r.to(cuda_device) for r in rhs]
    before = dict(kernels.stats.sizes)
    fq, fq0 = nd.factorize_quick(*dops, *deltas), nd.factorize_quick(*ops, *deltas)
    assert bool(fq.ok) and bool(fq0.ok)
    for a, b in zip(nd.solve_quick(fq, *drhs), nd.solve_quick(fq0, *rhs)):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) < 1e-9
    fs, fs0 = nd.factorize_safe_device(*dops, *deltas), nd.factorize_safe_device(*ops, *deltas)
    assert bool(fs.ok) and int(fs.n_neg_eig) == int(fs0.n_neg_eig) == 4
    for a, b in zip(nd.solve_safe_device(fs, *drhs), nd.solve_safe_device(fs0, *rhs)):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) < 1e-9
    after = kernels.stats.sizes
    assert after[("cholesky", 1000, "float64")] > before.get(("cholesky", 1000, "float64"), 0)
    assert after[("ldl_nopiv", 1024, "float64")] > before.get(("ldl_nopiv", 1024, "float64"), 0)


@pytest.mark.gpu
def test_cuda_dense_examples_reach_their_saved_objectives(cuda_device):
    """The quasi-Newton dense_ex1 at n=5000 and the exact-Newton DenseConsEx2
    at n=500 on cuda:0, at their saved objectives, through the Cholesky
    kernel."""
    from hiop_tpu_torch.examples import dense_ex1, dense_ex2

    kernels.stats.reset()
    r = dense_ex1.solve(5000, verbosity_level=0)
    ref, tol = dense_ex1.SELFCHECK[5000]
    assert r.status.is_success and dense_ex1.selfcheck_ok(r.obj, ref, tol)
    assert kernels.stats.sizes[("cholesky", 1, "float64")] > 0
    r = dense_ex2.solve_newton(500, verbosity_level=0)
    ref, tol = dense_ex2.SELFCHECK[500]
    assert r.status.is_success and dense_ex2.selfcheck_ok(r.obj, ref, tol)
    assert kernels.stats.sizes[("cholesky", 500, "float64")] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,S", [(300, 3), (384, 8)])
def test_cuda_batched_factors_equal_single_launches(cuda_device, n, S, dtype):
    """The batched entry points (one launch sequence over S matrices,
    gridDim.z = S) give each matrix bit for bit the single-matrix kernel's
    factor, the Cholesky's NaN fill included, and the batched LDL^T
    wrapper's n_neg/ok per matrix those of the single one."""
    A = torch.stack([torch.from_numpy(_spd(n, s) / n) for s in range(S)]).to(dtype).to(cuda_device)
    A[1] = -A[1]   # not positive definite: the NaN lower triangle
    Lb = tchol.cholesky_batched(A)
    for s in range(S):
        assert torch.equal(Lb[s].nan_to_num(7.0), tchol.cholesky(A[s]).nan_to_num(7.0))
    lower = torch.tril(torch.ones(n, n, dtype=torch.bool, device=cuda_device))
    assert bool(torch.isnan(Lb[1][lower]).all()) and bool(torch.isfinite(Lb[0]).all())
    M = torch.stack([torch.from_numpy(_saddle(n, s)) for s in range(S)]).to(dtype).to(cuda_device)
    Wb, db = tldl.ldl_nopiv_batched(M)
    fb = tldl.ldl_factor_batched(M)
    for s in range(S):
        W1, d1 = tldl.ldl_nopiv(M[s])
        assert torch.equal(Wb[s], W1) and torch.equal(db[s], d1)
        f1 = tldl.ldl_factor(M[s])
        assert torch.equal(fb.L[s], f1.L)
        assert int(fb.n_neg[s]) == int(f1.n_neg) and bool(fb.ok[s]) == bool(f1.ok)
    assert kernels.stats.batches[("cholesky_batched", n, str(dtype).replace("torch.", ""), S)] > 0


@pytest.mark.gpu
def test_cuda_vmap_rule_launches_one_batched_kernel(cuda_device):
    """Under torch.func.vmap the wrappers' rules make one batched launch
    for all lanes, with the single launches' bits."""
    from torch.func import vmap

    A = torch.stack([torch.from_numpy(_spd(200, s) / 200) for s in range(4)]).to(cuda_device)
    before = kernels.stats.launches["cholesky_batched"]
    L = vmap(tchol.cholesky)(A)
    assert kernels.stats.launches["cholesky_batched"] == before + 1
    assert all(torch.equal(L[s], tchol.cholesky(A[s])) for s in range(4))
