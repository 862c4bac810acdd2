"""The rest of the port's surface against the JAX package, on the CPU in
f64: ``exec_policies`` reaching the factorization dispatch, ``profile_dir``,
``KronReduction``, the scipy cross-check adapter and the HPC drivers.

- ``exec_policies``: on mds_ex1 40/10, ``xla`` (and ``seq``, ``raja``)
  count only the Cholesky's ``library`` lane (LAPACK here), ``auto`` and
  ``pallas`` only its ``plain`` lane (the kernel's CPU version); under
  ``xla`` the port gives ``hiop_tpu``'s iterations and objective to 1e-8
  (both packages then factor with LAPACK). The library lane fails as
  ``jnp.linalg.cholesky`` does (a NaN lower triangle), alone, batched and
  under ``torch.func.vmap``; a forced restoration's nested solve keeps the
  outer solve's lane, and each solve restores the lane it found.
- ``profile_dir``: a solve writes a Chrome trace there and keeps its
  iterations and objective.
- ``KronReduction``: ``tests/test_transforms.py``'s dense n=10 and sparse
  n=30 cases against ``hiop_tpu``'s to 1e-12.
- The scipy adapter: SLSQP on sparse Ex1 n=30 and dense Ex4 (x0 = [9, 5])
  against ``hiop_tpu``'s adapter on its own problems to 1e-8;
  ``cross_validate`` on sparse Ex1 n=30; the densified Jacobian and
  Hessian of each problem kind against ``hiop_tpu``'s adapter.
- The HPC drivers: two mds_ex1 40/10 solves print ``hiop_tpu``'s driver's
  status, iterations and objective; the allreduce ladder in a world of one
  over gloo.
"""

import json
import os
import re

import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import scipy.sparse as sp
import torch
from threadpoolctl import threadpool_limits

import examples.dense_ex4 as j_ex4
import examples.hpc_multisolves as j_multisolves
import examples.mds_ex1 as j_ex1
import examples.sparse_ex1 as j_sx1
import hiop_tpu.utils.scipy_adapter as j_adapter
from hiop_tpu.utils.kron_reduction import KronReduction as JKron
from hiop_tpu_torch.examples import dense_ex4, hpc_benchmark, hpc_multisolves, mds_ex1, sparse_ex1
from hiop_tpu_torch.linalg import cholesky as tchol
from hiop_tpu_torch.linalg import kernels
from hiop_tpu_torch.utils import scipy_adapter as t_adapter
from hiop_tpu_torch.utils.kron_reduction import KronReduction as TKron

# The problems here are small: torch's intra-op thread pool costs more than
# it gains, and its spinning threads slow the other test workers.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One OpenBLAS thread for numpy/scipy inside these tests: under six
    pytest-xdist workers on an 8-core CPU, OpenBLAS's spinning threads starve
    each other (tests/test_torch_sparse_solve.py). Lifted after each test."""
    with threadpool_limits(limits=1):
        yield


def _same_solve(rt, rj):
    assert rt.status.name == rj.status.name
    assert rt.iterations == rj.iterations
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))


def _cholesky_lanes():
    return {k: v for k, v in kernels.stats.lanes.items() if k[0].startswith("cholesky")}


# --------------------------------------------------------------- exec_policies
@pytest.fixture(scope="module")
def jax_ex1_40():
    """``hiop_tpu``'s mds_ex1 40/10 (its default exec_policies is auto,
    which it maps to xla: jnp.linalg.cholesky)."""
    with threadpool_limits(limits=1):
        return j_ex1.solve(40, 10, verbosity_level=0)


@pytest.mark.parametrize("policy,lane", [("xla", "library"), ("seq", "library"), ("raja", "library"),
                                         ("auto", "plain"), ("pallas", "plain")])
def test_exec_policies_reach_the_dispatch(jax_ex1_40, policy, lane):
    kernels.stats.reset()
    rt = mds_ex1.solve(40, 10, verbosity_level=0, compute_mode="cpu", exec_policies=policy)
    assert rt.status.is_success
    lanes = _cholesky_lanes()
    assert set(lanes) == {("cholesky", lane)}
    # the quick tier: one Cholesky of K_d and one of S per factorization
    assert lanes[("cholesky", lane)] == 2 * rt.iterations
    if lane == "library":
        assert {k[1:] for k in kernels.stats.library} == {(10, "float64"), (43, "float64")}
        _same_solve(rt, jax_ex1_40)
    else:
        assert not kernels.stats.library
    assert sum(kernels.stats.launches.values()) == 0
    assert tchol.backend() == "kernel"  # the solve restored the lane it found


def test_default_lane_matches_jax(jax_ex1_40):
    """The plain lane (the default) also gives ``hiop_tpu``'s decisions."""
    rt = mds_ex1.solve(40, 10, verbosity_level=0, compute_mode="cpu")
    _same_solve(rt, jax_ex1_40)


def _non_spd(n=6, bad=3):
    rng = np.random.default_rng(5)
    G = rng.standard_normal((n, n))
    A = G @ G.T / n + np.eye(n)
    A[bad, bad] = -1.0
    return A


def test_library_lane_fails_as_jnp_cholesky():
    import jax.numpy as jnp

    A = _non_spd()
    Lj = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    kernels.stats.reset()
    with tchol.backend_scope("library"):
        Lt = tchol.cholesky(torch.as_tensor(A))
    lower = np.tril(np.ones(A.shape, bool))
    assert np.isnan(Lt.numpy()[lower]).all() and (Lt.numpy()[~lower] == 0).all()
    # ok = all(isfinite(L)), as kkt/mds.py reads it: False in both
    assert not bool(torch.isfinite(Lt).all()) and not np.isfinite(Lj).all()
    # an SPD matrix: LAPACK's factor, the same as jnp.linalg.cholesky's
    S = _non_spd(bad=0)
    S[0, 0] = 10.0
    with tchol.backend_scope("library"):
        Ls = tchol.cholesky(torch.as_tensor(S))
    assert np.allclose(Ls.numpy(), np.asarray(jnp.linalg.cholesky(jnp.asarray(S))), rtol=1e-13, atol=1e-13)
    assert dict(kernels.stats.lanes) == {("cholesky", "library"): 2}
    assert tchol.backend() == "kernel"


def test_library_lane_batched_and_vmapped():
    """A stack with one non-SPD matrix: the NaN triangle for that matrix
    alone, through ``cholesky_batched`` and through the vmap rule."""
    good = _non_spd(bad=0)
    good[0, 0] = 10.0
    A = torch.as_tensor(np.stack([good, _non_spd(), good + np.eye(6)]))
    kernels.stats.reset()
    with tchol.backend_scope("library"):
        Lb = tchol.cholesky_batched(A)
        Lv = torch.func.vmap(tchol.cholesky)(A)
    ref = torch.linalg.cholesky(A[[0, 2]])
    lower = torch.tril(torch.ones(6, 6, dtype=torch.bool))
    for L in (Lb, Lv):
        assert torch.equal(L[[0, 2]], ref)
        assert bool(torch.isnan(L[1][lower]).all()) and bool((L[1][~lower] == 0).all())
    assert dict(kernels.stats.lanes) == {("cholesky_batched", "library"): 2}


def test_backend_names_are_checked():
    with pytest.raises(ValueError, match="backend"):
        tchol.set_backend("xla")


def test_forced_restoration_keeps_the_outer_lane():
    """The nested FR solve inherits exec_policies, so under xla every
    Cholesky of the solve, nested ones included, is the library's
    (hiop_tpu's nested solve resets its global backend instead)."""
    kernels.stats.reset()
    r = mds_ex1.solve(40, 10, verbosity_level=0, compute_mode="cpu", exec_policies="xla",
                      force_resto="yes")
    assert r.status.is_success
    lanes = _cholesky_lanes()
    assert set(lanes) == {("cholesky", "library")}
    assert lanes[("cholesky", "library")] > 2 * r.iterations  # the nested solve's too


# ----------------------------------------------------------------- profile_dir
def test_profile_dir_writes_a_trace(tmp_path):
    plain = mds_ex1.solve(8, 4, verbosity_level=0, compute_mode="cpu")
    traced = mds_ex1.solve(8, 4, verbosity_level=0, compute_mode="cpu", profile_dir=str(tmp_path))
    assert traced.status == plain.status and traced.iterations == plain.iterations
    assert traced.obj == plain.obj and np.array_equal(traced.x, plain.x)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and re.fullmatch(r"hiop_solve_rank0_pid\d+_\d+\.pt\.trace\.json", files[0])
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::matmul" in names


# --------------------------------------------------------------- KronReduction
def _kron_dense_case():
    rng = np.random.default_rng(0)
    n = 10
    Y = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    Y = Y + n * np.eye(n)
    v = rng.standard_normal(n - 3) + 1j * rng.standard_normal(n - 3)
    return Y, [2, 5, 7], v


def _kron_sparse_case():
    rng = np.random.default_rng(1)
    n = 30
    Y = np.zeros((n, n), np.complex128)
    for i in range(n):
        Y[i, i] = 4.0 + 1j * 0.5
        if i + 1 < n:
            Y[i, i + 1] = Y[i + 1, i] = -1.0 + 0.2j
    Y[0, n - 1] = Y[n - 1, 0] = -0.5 + 0.1j
    aux = [3, 8, 15, 22]
    v = rng.standard_normal(n - len(aux)) + 1j * rng.standard_normal(n - len(aux))
    return Y, aux, v


@pytest.mark.parametrize("case,sparse", [("dense", False), ("tridiagonal", False), ("tridiagonal", True)])
def test_kron_reduction_matches_jax(case, sparse):
    Y, aux, v = _kron_dense_case() if case == "dense" else _kron_sparse_case()
    Yin = sp.csr_matrix(Y) if sparse else Y
    kt, kj = TKron(Yin, aux, device="cpu"), JKron(Yin, aux)
    Rt = kt.reduce()
    assert Rt.dtype == torch.complex128 and Rt.device.type == "cpu"
    assert np.allclose(Rt.numpy(), np.asarray(kj.reduce()), rtol=0, atol=1e-12)
    vt = kt.apply_nonaux_to_aux(v)
    assert np.allclose(vt.numpy(), np.asarray(kj.apply_nonaux_to_aux(v)), rtol=0, atol=1e-12)
    # with v on the non-aux buses, the aux buses carry no current
    keep = [i for i in range(Y.shape[0]) if i not in aux]
    i_aux = Y[np.ix_(aux, keep)] @ v + Y[np.ix_(aux, aux)] @ vt.numpy()
    assert np.allclose(i_aux, 0.0, atol=1e-10)


def test_kron_reduction_sparse_matches_dense():
    Y, aux, v = _kron_sparse_case()
    kd, ks = TKron(Y, aux, device="cpu"), TKron(sp.csr_matrix(Y), aux, device="cpu")
    assert np.allclose(kd.reduce().numpy(), ks.reduce().numpy(), rtol=0, atol=1e-12)
    assert np.allclose(kd.apply_nonaux_to_aux(torch.as_tensor(v)).numpy(),
                       ks.apply_nonaux_to_aux(v).numpy(), rtol=0, atol=1e-12)
    assert torch.equal(TKron(Y, [], device="cpu").reduce(), torch.as_tensor(Y))


# ------------------------------------------------------------ the scipy adapter
@pytest.fixture(scope="module")
def jax_scipy():
    with threadpool_limits(limits=1):
        return {"sparse": j_adapter.solve_with_scipy(j_sx1.SparseEx1(30)),
                "dense": j_adapter.solve_with_scipy(j_ex4.DenseConsEx4(), x0=np.array([9.0, 5.0]))}


def test_scipy_sparse_ex1_matches_jax_adapter(jax_scipy):
    ours = sparse_ex1.solve(30, verbosity_level=0, compute_mode="cpu")
    theirs = t_adapter.solve_with_scipy(sparse_ex1.SparseEx1(30))
    ref = jax_scipy["sparse"]
    assert ours.status.is_success and theirs.success == ref.success
    assert abs(theirs.fun - ref.fun) <= 1e-8 * max(1.0, abs(ref.fun))
    assert abs(ours.obj - theirs.fun) < 1e-6 * (1 + abs(theirs.fun))


def test_scipy_dense_ex4_matches_jax_adapter(jax_scipy):
    ours = dense_ex4.solve(verbosity_level=0, compute_mode="cpu")
    theirs = t_adapter.solve_with_scipy(dense_ex4.DenseConsEx4(), x0=np.array([9.0, 5.0]))
    ref = jax_scipy["dense"]
    assert ours.status.is_success and theirs.success == ref.success
    assert abs(theirs.fun - ref.fun) <= 1e-8 * max(1.0, abs(ref.fun))
    assert abs(ours.obj - theirs.fun) < 1e-5 * (1 + abs(theirs.fun))


def test_cross_validate_sparse_ex1():
    ours = sparse_ex1.solve(30, verbosity_level=0, compute_mode="cpu")
    rep = t_adapter.cross_validate(sparse_ex1.SparseEx1(30), ours.obj, ours_x=ours.x)
    assert rep.agrees, rep
    assert rep.obj_rel_gap <= 1e-5 and np.isfinite(rep.primal_inf_gap)
    assert rep.their_kkt_stationarity < 1e-4 * (1 + abs(rep.theirs_obj)), rep


@pytest.mark.parametrize("kind", ["sparse", "mds", "dense"])
def test_adapter_derivatives_match_jax(kind):
    """The densified Jacobian and Lagrangian Hessian of each problem kind
    (triplets, MDS blocks, a dense Jacobian without a Hessian surface)."""
    tp, jp = {"sparse": (sparse_ex1.SparseEx1(30), j_sx1.SparseEx1(30)),
              "mds": (mds_ex1.MdsEx1(8, 4), j_ex1.MdsEx1(8, 4)),
              "dense": (dense_ex4.DenseConsEx4(), j_ex4.DenseConsEx4())}[kind]
    n, m = tp.get_prob_sizes()
    rng = np.random.default_rng(3)
    x = np.asarray(jp.get_starting_point(), float) + 0.1 * rng.standard_normal(n)
    lam = rng.standard_normal(m)
    Jt = t_adapter._dense_jac_fn(tp, n, m)(x)
    Jj = j_adapter._dense_jac_fn(jp, n, m)(x)
    assert Jt.shape == (m, n) and np.allclose(Jt, Jj, rtol=1e-14, atol=1e-14)
    ht, hj = t_adapter._dense_hess_fn(tp, n, m), j_adapter._dense_hess_fn(jp, n, m)
    assert (ht is None) == (hj is None) == (kind == "dense")
    if ht is not None:
        Ht = ht(x, 0.7, lam)
        assert np.allclose(Ht, Ht.T) and np.allclose(Ht, hj(x, 0.7, lam), rtol=1e-14, atol=1e-14)


# ------------------------------------------------------------- the HPC drivers
def _solve_lines(out: str):
    """The per-solve lines without their times."""
    return [re.sub(r" in [0-9.]+ s$", "", line) for line in out.splitlines()
            if line.startswith("[driver] solve ")]


def test_hpc_multisolves_matches_jax_driver(capsys):
    assert hpc_multisolves.main(["2", "40", "10", "-cpu"]) == 0
    ours = _solve_lines(capsys.readouterr().out)
    with threadpool_limits(limits=1):
        assert j_multisolves.main(["2", "40", "10"]) == 0
    theirs = _solve_lines(capsys.readouterr().out)
    assert len(ours) == 2 and ours == theirs


def test_hpc_benchmark_world_of_one_over_gloo(capfd):
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        assert hpc_benchmark.main(["32768", "3", "2", "-cpu"]) == 0
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    rows = [line.split() for line in capfd.readouterr().out.splitlines() if re.match(r"^\s+\d+\s", line)]
    assert [int(r[0]) for r in rows] == [32768, 65536, 131072]
    assert all(float(r[2]) > 0 for r in rows)
