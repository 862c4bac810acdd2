"""The port's framework-free copies and vector-level modules against the
JAX package, on seeded inputs passed as numpy arrays (CPU, f64)."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch
from threadpoolctl import threadpool_limits

from hiop_tpu.kkt import mds as jmds
from hiop_tpu.linalg import ldl_blocked as jldl
from hiop_tpu.linalg import vector_ops as jvo
from hiop_tpu.optimization import duals_update as jdu
from hiop_tpu.optimization import iterate as jit_
from hiop_tpu.optimization import residual as jres
from hiop_tpu.utils.options import NlpOptions as JaxOptions
from hiop_tpu_torch.backends import execspace
from hiop_tpu_torch.kkt import mds as tmds
from hiop_tpu_torch.linalg import ldl_blocked as tldl
from hiop_tpu_torch.linalg import vector_ops as tvo
from hiop_tpu_torch.optimization import duals_update as tdu
from hiop_tpu_torch.optimization import iterate as tit
from hiop_tpu_torch.optimization import residual as tres
from hiop_tpu_torch.utils import carry
from hiop_tpu_torch.utils.options import NlpOptions as TorchOptions

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

N, MI, MC = 30, 10, 8


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


def _close(a, b, rtol=1e-13):
    """Equal up to rounding, leaf by leaf (tuples, NamedTuples, scalars)."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, rtol)
        return
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape
    assert np.allclose(a, b, rtol=rtol, atol=rtol * max(1.0, np.abs(b).max(initial=0.0)))


def _bounds_iterate(seed):
    """Seeded Bounds, an interior Iterate and a direction, as numpy tuples."""
    rng = np.random.default_rng(seed)
    xl = rng.uniform(-2, -1, N)
    xu = rng.uniform(1, 2, N)
    ixl = (rng.uniform(size=N) < 0.7).astype(float)
    ixu = (rng.uniform(size=N) < 0.5).astype(float)
    dl = rng.uniform(-2, -1, MI)
    du = rng.uniform(1, 2, MI)
    idl = (rng.uniform(size=MI) < 0.6).astype(float)
    idu = (rng.uniform(size=MI) < 0.6).astype(float)
    b = (np.where(ixl > 0, xl, -1e20), np.where(ixu > 0, xu, 1e20), ixl, ixu,
         np.where(idl > 0, dl, -1e20), np.where(idu > 0, du, 1e20), idl, idu)
    x = rng.uniform(-0.9, 0.9, N)
    d = rng.uniform(-0.9, 0.9, MI)
    pos = lambda k: rng.uniform(0.1, 2.0, k)  # noqa: E731
    it = (x, d, pos(N) * ixl, pos(N) * ixu, pos(MI) * idl, pos(MI) * idu,
          rng.standard_normal(MC), rng.standard_normal(MI),
          pos(N) * ixl, pos(N) * ixu, pos(MI) * idl, pos(MI) * idu)
    dr = tuple(rng.standard_normal(a.shape) for a in it)
    return b, it, dr


@pytest.fixture(scope="module")
def pair():
    b, it, dr = _bounds_iterate(0)
    jx = dict(b=jit_.Bounds(*map(jnp.asarray, b)), it=jit_.Iterate(*map(jnp.asarray, it)),
              dr=jit_.Iterate(*map(jnp.asarray, dr)))
    tx = dict(b=carry.to_bounds(b, "cpu"), it=carry.to_iterate(it, "cpu"),
              dr=carry.to_iterate(dr, "cpu"))
    jx["it"] = jit_.determine_slacks(jx["it"], jx["b"])
    tx["it"] = tit.determine_slacks(tx["it"], tx["b"])
    return jx, tx


def test_option_defaults_match_jax():
    jo, to = JaxOptions(), TorchOptions()
    assert list(jo._opts) == list(to._opts)
    for name, opt in jo._opts.items():
        assert to._opts[name].value == opt.value, name


def test_options_round_trip():
    o = TorchOptions()
    o.update(tolerance=1e-7, linear_solver_dense="ldl_nopiv", max_iter=17)
    assert (o.num("tolerance"), o.str_("linear_solver_dense"), o.integer("max_iter")) == (
        1e-7, "ldl_nopiv", 17)


ITERATE_CASES = {
    "determine_slacks": lambda m, p: m.determine_slacks(p["it"], p["b"]),
    "compute_safe_slacks": lambda m, p: m.compute_safe_slacks(p["it"], p["it"], p["b"], 0.1)[0],
    "eval_logbar": lambda m, p: m.eval_logbar(p["it"], p["b"]),
    "linear_damping_term": lambda m, p: m.linear_damping_term(p["it"], p["b"], 0.1, 1e-5),
    "add_logbar_grad_x": lambda m, p: m.add_logbar_grad_x(p["it"].x, p["it"], p["b"], 0.1),
    "add_logbar_grad_d": lambda m, p: m.add_logbar_grad_d(p["it"].d, p["it"], p["b"], 0.1),
    "add_damping_grad_x": lambda m, p: m.add_damping_grad_x(p["it"].x, p["b"], 0.1, 1e-5),
    "add_damping_grad_d": lambda m, p: m.add_damping_grad_d(p["it"].d, p["b"], 0.1, 1e-5),
    "fraction_to_the_boundary": lambda m, p: m.fraction_to_the_boundary(p["it"], p["dr"], 0.99, p["b"]),
    "take_step_primals": lambda m, p: m.take_step_primals(p["it"], p["dr"], 0.3),
    "take_step_duals": lambda m, p: m.take_step_duals(p["it"], p["dr"], 0.3, 0.2),
    "adjust_duals": lambda m, p: m.adjust_duals(p["it"], p["b"], 0.1, 1e10),
    "norm_one_of_duals": lambda m, p: m.norm_one_of_duals(p["it"]),
    "starting_point_primal": lambda m, p: m.starting_point_primal(
        p["it"].x * 3.0, p["it"].d * 3.0, p["b"], 1e-2, 1e-2),
}


@pytest.mark.parametrize("name", sorted(ITERATE_CASES))
def test_iterate_functions_match_jax(pair, name):
    jx, tx = pair
    _close(ITERATE_CASES[name](tit, tx), ITERATE_CASES[name](jit_, jx))


def _residual(mod, p, arrays):
    c, d, g, jyc, jyd, crhs = arrays
    return mod.update_residual(p["it"], c, d, g, jyc, jyd, crhs, p["b"], 0.1, 1e-5)


def test_residual_functions_match_jax(pair):
    jx, tx = pair
    rng = np.random.default_rng(3)
    arrays = (rng.standard_normal(MC), rng.standard_normal(MI), rng.standard_normal(N),
              rng.standard_normal(N), rng.standard_normal(N), rng.standard_normal(MC))
    rj, nj = _residual(jres, jx, [jnp.asarray(a) for a in arrays])
    rt, nt = _residual(tres, tx, [torch.from_numpy(a) for a in arrays])
    _close(tuple(rt), tuple(rj))
    _close(tuple(nt), tuple(nj))
    _close(tres.compress_rhs_xdycyd(rt, tx["it"], tx["b"]),
           jres.compress_rhs_xdycyd(rj, jx["it"], jx["b"]))
    _close(tres.barrier_diagonals(tx["it"], tx["b"]), jres.barrier_diagonals(jx["it"], jx["b"]))
    dirs = (rng.standard_normal(N), rng.standard_normal(MI), rng.standard_normal(MC),
            rng.standard_normal(MI))
    _close(tuple(tres.recover_direction(rt, tx["it"], tx["b"], *map(torch.from_numpy, dirs))),
           tuple(jres.recover_direction(rj, jx["it"], jx["b"], *map(jnp.asarray, dirs))))


VECTOR_CASES = {
    "logbar_sum": lambda m, a: m.logbar_sum(a["s"], a["p"]),
    "add_logbar_grad": lambda m, a: m.add_logbar_grad(a["g"], 0.5, a["s"], a["p"]),
    "linear_damping_term": lambda m, a: m.linear_damping_term(a["s"], a["p"], a["q"], 0.1, 1e-5),
    "add_linear_damping_grad": lambda m, a: m.add_linear_damping_grad(a["g"], a["p"], a["q"], 0.3),
    "fraction_to_the_boundary": lambda m, a: m.fraction_to_the_boundary(a["s"], a["g"], 0.99, a["p"]),
    "adjust_duals_plh": lambda m, a: m.adjust_duals_plh(a["s"] * 3, a["s"], a["p"], 0.1, 10.0),
    "project_into_bounds": lambda m, a: m.project_into_bounds(
        a["g"], -a["s"], a["p"], a["s"], a["q"], 1e-2, 1e-2),
    "slack_lower": lambda m, a: m.slack_lower(a["g"], -a["s"], a["p"]),
    "slack_upper": lambda m, a: m.slack_upper(a["g"], a["s"], a["q"]),
    "adjust_small_slacks": lambda m, a: m.adjust_small_slacks(a["s"] * 1e-9, a["g"], a["s"], a["p"], 0.1),
    "infnorm": lambda m, a: m.infnorm(a["g"]),
    "onenorm": lambda m, a: m.onenorm(a["g"]),
}


@pytest.mark.parametrize("name", sorted(VECTOR_CASES))
def test_vector_ops_match_jax(name):
    rng = np.random.default_rng(7)
    arrays = dict(s=rng.uniform(0.1, 2.0, 40), g=rng.standard_normal(40),
                  p=(rng.uniform(size=40) < 0.6).astype(float),
                  q=(rng.uniform(size=40) < 0.4).astype(float))
    jv = VECTOR_CASES[name](jvo, {k: jnp.asarray(v) for k, v in arrays.items()})
    tv = VECTOR_CASES[name](tvo, {k: torch.from_numpy(v) for k, v in arrays.items()})
    _close(tv, jv)


def test_lsq_duals_matches_jax():
    rng = np.random.default_rng(9)
    Jc, Jd = rng.standard_normal((MC, N)), rng.standard_normal((MI, N))
    vecs = (rng.standard_normal(N), rng.uniform(0, 1, N), rng.uniform(0, 1, N),
            rng.uniform(0, 1, MI), rng.uniform(0, 1, MI))
    yj = jdu.lsq_duals(jnp.asarray(Jc), jnp.asarray(Jd), *map(jnp.asarray, vecs))
    yt = tdu.lsq_duals(torch.from_numpy(Jc), torch.from_numpy(Jd), *map(torch.from_numpy, vecs))
    _close(yt, yj, rtol=1e-10)


def test_lsq_cholesky_failure_gives_nan_lower_like_jax():
    """lsq_duals' Cholesky keeps jnp.linalg.cholesky's failure semantics:
    a NaN lower triangle, no exception."""
    M = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    L = tdu._cholesky_nan_on_failure(torch.from_numpy(M)).numpy()
    Lj = np.asarray(jnp.linalg.cholesky(jnp.asarray(M)))
    assert np.array_equal(np.isnan(L), np.isnan(Lj)) and np.all(np.isnan(L[np.tril_indices(3)]))
    assert np.all(np.triu(L, 1) == 0)


def test_execspace_resolves_devices(monkeypatch):
    assert execspace.resolve_device("cpu") == torch.device("cpu")
    assert not execspace.on_accelerator(torch.device("cpu"))
    assert execspace.on_accelerator(torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("auto", "gpu"):
        with pytest.raises(RuntimeError, match="CUDA"):
            execspace.resolve_device(mode)


def test_tf32_is_off_after_import():
    import hiop_tpu_torch  # noqa: F401

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_carry_converts_jax_factors():
    """JAX-side factors, carried over as numpy arrays, solve in the port
    exactly as in the JAX package."""
    rng = np.random.default_rng(21)
    n = 60
    G = rng.standard_normal((n, n))
    M = np.block([[G @ G.T + n * np.eye(n), np.ones((n, 4))], [np.ones((4, n)), -np.eye(4)]])
    b = rng.standard_normal(n + 4)
    fj = jldl.ldl_factor(jnp.asarray(M))
    ft = carry.to_ldl_factors(tuple(np.asarray(a) for a in fj), "cpu")
    assert ft.n == n + 4 and int(ft.n_neg) == 4 and bool(ft.ok)
    _close(tldl.ldl_solve(ft, torch.from_numpy(b)), jldl.ldl_solve(fj, jnp.asarray(b)), rtol=1e-12)

    hss, Dxs = rng.uniform(1, 2, 20), rng.uniform(1, 2, 20)
    Hdd = np.eye(5) * 3.0
    Jc = rng.standard_normal((6, 25))
    Jd = rng.standard_normal((3, 25))
    args = (hss, Hdd, Dxs, rng.uniform(1, 2, 5), rng.uniform(1, 2, 3),
            Jc[:, :20], Jc[:, 20:], Jd[:, :20], Jd[:, 20:])
    fm = jmds.factorize(*map(jnp.asarray, args), 0.0, 0.0, 1e-8, 0.0)
    tf = carry.to_mds_factors(fm, "cpu")
    rhs = (rng.standard_normal(20), rng.standard_normal(5), rng.standard_normal(3),
           rng.standard_normal(6), rng.standard_normal(3))
    _close(tmds.solve(tf, *map(torch.from_numpy, rhs)), jmds.solve(fm, *map(jnp.asarray, rhs)),
           rtol=1e-12)


def test_carry_problem_data():
    data = {"Qd": np.eye(3), "idx": np.arange(4, dtype=np.int32), "name": "grid", "s": 2.0}
    t = carry.to_tensors(data, "cpu")
    assert t["Qd"].dtype == torch.float64 and t["idx"].dtype == torch.int64
    assert t["name"] == "grid" and t["s"] == 2.0
    cache = carry.DeviceCache(Qd=np.eye(2))
    assert cache.on("cpu") is cache.on(torch.device("cpu"))


def test_scatter_add_sums_duplicates_like_numpy():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 7, 50)
    vals = rng.standard_normal(50)
    ref = np.zeros(7)
    np.add.at(ref, idx, vals)
    out = tvo.scatter_add_(torch.zeros(7, dtype=torch.float64), torch.from_numpy(idx),
                           torch.from_numpy(vals))
    _close(out, ref)
