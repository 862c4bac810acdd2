"""The port's MDS KKT (``hiop_tpu_torch.kkt.mds``) against the JAX package
on ``AcopfMds(16)`` data at a seeded interior point, on the CPU.

Both formulations are evaluated at the same point; the evaluations must
agree, and the same numpy arrays then go into both packages' KKT
functions, whose factors, inertia counts and directions must agree to
1e-10 relative (both are f64; only the blocking and the order of sums
differ).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch
from threadpoolctl import threadpool_limits

from examples.acopf_mds import AcopfMds as JaxAcopf
from hiop_tpu import NlpMDS as JaxMDS, NlpOptions as JaxOptions
from hiop_tpu.kkt import mds as jmds
from hiop_tpu_torch import NlpMDS as TorchMDS, NlpOptions as TorchOptions
from hiop_tpu_torch.examples.acopf_mds import AcopfMds as TorchAcopf
from hiop_tpu_torch.kkt import mds as tmds
from hiop_tpu_torch.utils.carry import to_tensor

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

RTOL = 1e-10
DELTAS = dict(delta_wx=1e-3, delta_wd=0.0, delta_cc=1e-8, delta_cd=0.0)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    if a.size == 0:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def kkt_data():
    """The KKT operands of both packages at one seeded point (numpy)."""
    opts = dict(Hessian="analytical_exact", fixed_var="relax", verbosity_level=0)
    jo, to = JaxOptions(), TorchOptions()
    jo.update(**opts)
    to.update(compute_mode="cpu", **opts)
    jn, tn = JaxMDS(JaxAcopf(16), jo), TorchMDS(TorchAcopf(16), to)
    jn.finalize_initialization()
    tn.finalize_initialization()
    assert (jn.n, jn.m_eq, jn.m_ineq, jn.n_sparse) == (tn.n, tn.m_eq, tn.m_ineq, tn.n_sparse)

    rng = np.random.default_rng(16)
    x = np.asarray(jn.get_starting_point()) + 0.01 * rng.standard_normal(jn.n)
    yc = rng.standard_normal(jn.m_eq)
    yd = rng.standard_normal(jn.m_ineq)
    Jc, Jd = (np.asarray(a) for a in jn.eval_jac(jnp.asarray(x)))
    hss, Hdd = (np.asarray(a) for a in jn.eval_hess_blocks(
        jnp.asarray(x), 1.0, jnp.asarray(yc), jnp.asarray(yd)))
    tx = to_tensor(x, "cpu")
    tJc, tJd = tn.eval_jac(tx)
    thss, tHdd = tn.eval_hess_blocks(tx, 1.0, to_tensor(yc, "cpu"), to_tensor(yd, "cpu"))
    for a, b in ((tJc, Jc), (tJd, Jd), (thss, hss), (tHdd, Hdd)):
        assert _rel(b, a.numpy()) < 1e-12

    ns = jn.n_sparse
    Dxs = np.abs(hss) + rng.uniform(0.5, 1.5, ns)   # K_s > 0 for the quick tier
    Dxd = rng.uniform(0.5, 1.5, jn.n - ns)
    Dd = rng.uniform(0.5, 1.5, jn.m_ineq)
    args = (hss, Hdd, Dxs, Dxd, Dd, Jc[:, :ns], Jc[:, ns:], Jd[:, :ns], Jd[:, ns:])
    rows = np.concatenate([np.asarray(jn.jac_sp_eq_rows), jn.m_eq + np.asarray(jn.jac_sp_in_rows)])
    cols = np.concatenate([np.asarray(jn.jac_sp_eq_cols), np.asarray(jn.jac_sp_in_cols)])
    js_vals = np.concatenate([Jc[jn.jac_sp_eq_rows, jn.jac_sp_eq_cols],
                              Jd[jn.jac_sp_in_rows, jn.jac_sp_in_cols]])
    rhs = (rng.standard_normal(ns), rng.standard_normal(jn.n - ns), rng.standard_normal(jn.m_ineq),
           rng.standard_normal(jn.m_eq), rng.standard_normal(jn.m_ineq))
    return dict(args=args, rows=rows, cols=cols, ns=ns, js_vals=js_vals, rhs=rhs)


def _jax(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _torch(arrays):
    return tuple(to_tensor(a, "cpu") for a in arrays)


def test_schur_js_triplets_matches_jax(kkt_data):
    d = kkt_data
    m = d["args"][5].shape[0] + d["args"][7].shape[0]
    ks_inv = 1.0 / (d["args"][0] + d["args"][2])
    jp = jmds.build_schur_pairs(d["rows"], d["cols"], d["ns"])
    tp = tmds.build_schur_pairs(d["rows"], d["cols"], d["ns"])
    for a, b in zip(jp, tp):
        assert np.array_equal(np.asarray(a), b.numpy())
    Sj = np.asarray(jmds.schur_js_triplets(jnp.asarray(d["js_vals"]), jnp.asarray(ks_inv), jp, m))
    St = tmds.schur_js_triplets(to_tensor(d["js_vals"], "cpu"), to_tensor(ks_inv, "cpu"), tp, m)
    assert _rel(St.numpy(), Sj) < RTOL
    Js = np.concatenate([d["args"][5], d["args"][7]])
    assert _rel(St.numpy(), (Js * ks_inv) @ Js.T) < RTOL


@pytest.mark.parametrize("triplets", [False, True])
def test_factorize_and_solve_match_jax(kkt_data, triplets):
    d = kkt_data
    jkw, tkw = {}, {}
    if triplets:
        jkw = dict(js_vals=jnp.asarray(d["js_vals"]),
                   js_pairs=jmds.build_schur_pairs(d["rows"], d["cols"], d["ns"]))
        tkw = dict(js_vals=to_tensor(d["js_vals"], "cpu"),
                   js_pairs=tmds.build_schur_pairs(d["rows"], d["cols"], d["ns"]))
    fj = jmds.factorize(*_jax(d["args"]), *DELTAS.values(), **jkw)
    ft = tmds.factorize(*_torch(d["args"]), *DELTAS.values(), **tkw)
    assert bool(ft.ok) and bool(fj.ok)
    assert (bool(ft.ok_k), bool(ft.ok_s)) == (bool(fj.ok_k), bool(fj.ok_s))
    for name in ("ks_inv", "Ld", "Ls"):
        assert _rel(getattr(ft, name).numpy(), getattr(fj, name)) < RTOL, name
    outj = jmds.solve(fj, *_jax(d["rhs"]))
    outt = tmds.solve(ft, *_torch(d["rhs"]))
    for a, b in zip(outt, outj):
        assert _rel(a.numpy(), b) < RTOL


def test_factorize_flags_non_pd_dense_block(kkt_data):
    """A K_d that is not PD: the Cholesky's NaN factor makes ok_k False in
    both packages (the wrong-inertia signal of the regularization ladder)."""
    d = kkt_data
    args = list(d["args"])
    args[3] = args[3] - 1e3
    fj = jmds.factorize(*_jax(args), *DELTAS.values())
    ft = tmds.factorize(*_torch(args), *DELTAS.values())
    assert not bool(ft.ok_k) and not bool(fj.ok_k) and not bool(ft.ok)
    assert torch.equal(ft.Ld, torch.eye(ft.Ld.shape[0], dtype=ft.Ld.dtype))


@pytest.mark.parametrize("host", [False, True])
def test_factorize_safe_and_solve_safe_match_jax(kkt_data, host):
    """Both safe tiers: the device no-pivot LDL^T (plain version here) and
    the host LU + eigen inertia (lu_eig)."""
    d = kkt_data
    args = list(d["args"])
    args[0] = args[0] - 2.0 * args[2]   # an indefinite sparse block counts by Haynsworth
    fj = jmds.factorize_safe(*_jax(args), *DELTAS.values(), host=host)
    ft = tmds.factorize_safe(*_torch(args), *DELTAS.values(), host=host)
    assert ft.host == host and fj.host == host
    assert bool(ft.ok) == bool(fj.ok) and bool(ft.ok)
    assert int(ft.n_neg_eig) == int(fj.n_neg_eig)
    outj = jmds.solve_safe(fj, *_jax(d["rhs"]))
    outt = tmds.solve_safe(ft, *_torch(d["rhs"]))
    for a, b in zip(outt, outj):
        assert _rel(a.numpy(), b) < RTOL
