"""The port's Krylov solvers (``hiop_tpu_torch.linalg.krylov``) against the
JAX package's, on the CPU.

The systems are seeded numpy matrices acting on 4-tuples of vectors, the
shape in which ``_MdsStrategy._inner_refine_mds`` hands the compressed MDS
system (dx, dd, dyc, dyd) to FGMRES. The same operator, right-hand side
and preconditioner go through both packages, which must report the same
``converged`` and ``iters`` and agree on x to 1e-10 relative (both are
f64; only the order of the sums differs). A zero preconditioner makes
every method stagnate, and both packages must report it not converged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiop_tpu.linalg import krylov as jk
from hiop_tpu_torch.linalg import krylov as tk

torch.set_num_threads(1)

SIZES = (7, 3, 5, 4)          # the blocks of the tuple vector
N = sum(SIZES)
SCHEMES = ("mgs", "cgs2", "mgs_two_synch", "mgs_pm")
RTOL = 1e-10


def _split(v):
    out, k = [], 0
    for s in SIZES:
        out.append(v[k:k + s])
        k += s
    return tuple(out)


def _rel(a, b):
    a = np.concatenate([np.asarray(x, dtype=np.float64).ravel() for x in a])
    b = np.concatenate([np.asarray(x, dtype=np.float64).ravel() for x in b])
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _system(spd: bool, seed: int):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((N, N))
    if spd:
        A = G @ G.T / N + np.eye(N)
    else:
        A = np.eye(N) * 3.0 + G / np.sqrt(N)
    P = np.linalg.inv(A + 0.1 * np.diag(rng.uniform(0.5, 1.5, N)))   # a rough inverse
    if spd:
        P = 0.5 * (P + P.T)
    return A, P, rng.standard_normal(N)


def _ops(A, P, zero_precond=False):
    """(matvec, precond) over 4-tuples, for each package."""
    if zero_precond:
        P = np.zeros_like(P)
    Aj, Pj = jnp.asarray(A), jnp.asarray(P)
    At, Pt = torch.as_tensor(A), torch.as_tensor(P)
    jmv = lambda v: _split(Aj @ jnp.concatenate(v))    # noqa: E731
    jpc = lambda v: _split(Pj @ jnp.concatenate(v))    # noqa: E731
    tmv = lambda v: _split(At @ torch.cat(v))          # noqa: E731
    tpc = lambda v: _split(Pt @ torch.cat(v))          # noqa: E731
    return (jmv, jpc), (tmv, tpc)


def _rhs(b):
    return _split(jnp.asarray(b)), _split(torch.as_tensor(b))


def _same(outj, outt):
    (xj, ij), (xt, it) = outj, outt
    assert (it.converged, it.iters) == (ij.converged, ij.iters)
    assert _rel([a.numpy() for a in xt], xj) < RTOL
    assert abs(it.resid_norm - ij.resid_norm) <= 1e-8 * max(ij.resid_norm, 1e-300) + 1e-14


@pytest.mark.parametrize("precond", [False, True], ids=["plain", "precond"])
def test_pcg_matches_jax(precond):
    A, P, b = _system(True, 1)
    (jmv, jpc), (tmv, tpc) = _ops(A, P)
    bj, bt = _rhs(b)
    kw = dict(tol=1e-11, maxit=60)
    outj = jk.pcg(jmv, bj, M_inv=jpc if precond else None, **kw)
    outt = tk.pcg(tmv, bt, M_inv=tpc if precond else None, **kw)
    assert outt[1].converged
    _same(outj, outt)


@pytest.mark.parametrize("precond", [False, True], ids=["plain", "precond"])
def test_bicgstab_matches_jax(precond):
    A, P, b = _system(False, 2)
    (jmv, jpc), (tmv, tpc) = _ops(A, P)
    bj, bt = _rhs(b)
    x0 = np.random.default_rng(5).standard_normal(N) * 0.1
    kw = dict(tol=1e-11, maxit=60)
    outj = jk.bicgstab(jmv, bj, M_inv=jpc if precond else None, x0=_split(jnp.asarray(x0)), **kw)
    outt = tk.bicgstab(tmv, bt, M_inv=tpc if precond else None, x0=_split(torch.as_tensor(x0)), **kw)
    assert outt[1].converged
    _same(outj, outt)


@pytest.mark.parametrize("precond", [False, True], ids=["plain", "precond"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_fgmres_matches_jax(scheme, precond):
    """Restart 5 on an 19-unknown system: several restart cycles without a
    preconditioner; with it, FGMRES from the preconditioned first guess
    (the refinement pattern of ``_inner_refine_mds``)."""
    A, P, b = _system(False, 3)
    (jmv, jpc), (tmv, tpc) = _ops(A, P)
    bj, bt = _rhs(b)
    kw = dict(tol=1e-11, restart=5, maxit=80, gs_scheme=scheme)
    if precond:
        x0 = P @ b
        outj = jk.fgmres(jmv, bj, M_inv=jpc, x0=_split(jnp.asarray(x0)), **kw)
        outt = tk.fgmres(tmv, bt, M_inv=tpc, x0=_split(torch.as_tensor(x0)), **kw)
    else:
        outj = jk.fgmres(jmv, bj, **kw)
        outt = tk.fgmres(tmv, bt, **kw)
    assert outt[1].converged and outt[1].iters > (0 if precond else 5)
    _same(outj, outt)


@pytest.mark.parametrize("method", ["pcg", "bicgstab"] + [f"fgmres-{s}" for s in SCHEMES])
def test_zero_preconditioner_stagnates_in_both(method):
    A, P, b = _system(method == "pcg", 4)
    (jmv, jpc), (tmv, tpc) = _ops(A, P, zero_precond=True)
    bj, bt = _rhs(b)
    if method.startswith("fgmres"):
        kw = dict(tol=1e-10, restart=5, maxit=40, gs_scheme=method.split("-", 1)[1])
        outj = jk.fgmres(jmv, bj, M_inv=jpc, **kw)
        outt = tk.fgmres(tmv, bt, M_inv=tpc, **kw)
    else:
        fn = method
        outj = getattr(jk, fn)(jmv, bj, M_inv=jpc, tol=1e-10, maxit=40)
        outt = getattr(tk, fn)(tmv, bt, M_inv=tpc, tol=1e-10, maxit=40)
    assert not outt[1].converged and not outj[1].converged
    _same(outj, outt)


def test_tree_algebra_matches_jax():
    rng = np.random.default_rng(6)
    a, b = rng.standard_normal(N), rng.standard_normal(N)
    (aj, at), (bj, bt) = _rhs(a), _rhs(b)
    assert abs(tk.tree_dot(at, bt) - jk.tree_dot(aj, bj)) <= 1e-12 * abs(jk.tree_dot(aj, bj))
    assert abs(tk.tree_norm(at) - jk.tree_norm(aj)) <= 1e-13 * jk.tree_norm(aj)
    assert float(tk._tree_dot_device(at, bt)) == pytest.approx(float(jk._tree_dot_device(aj, bj)), rel=1e-13)
    for t, j in ((tk.tree_axpy(-0.3, at, bt), jk.tree_axpy(-0.3, aj, bj)),
                 (tk.tree_scale(2.5, at), jk.tree_scale(2.5, aj)),
                 (tk.tree_sub(at, bt), jk.tree_sub(aj, bj)),
                 (tk.tree_zeros_like(at), jk.tree_zeros_like(aj))):
        assert isinstance(t, tuple) and [x.shape[0] for x in t] == list(SIZES)
        assert _rel([x.numpy() for x in t], j) <= 1e-15
    # a bare tensor is a one-leaf tree
    assert tk.tree_dot(torch.as_tensor(a), torch.as_tensor(b)) == pytest.approx(float(a @ b), rel=1e-13)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_gs_orthogonalize_matches_jax(scheme):
    """One Gram-Schmidt step against a 4-vector orthonormal basis, and the
    mass dot/axpy products it is built from."""
    rng = np.random.default_rng(7)
    Q, _ = np.linalg.qr(rng.standard_normal((N, 4)))
    w = rng.standard_normal(N)
    Vj = [_split(jnp.asarray(Q[:, i])) for i in range(4)]
    Vt = [_split(torch.as_tensor(Q[:, i])) for i in range(4)]
    Lj, Lt = np.zeros((6, 6)), np.zeros((6, 6))
    # earlier rows of the correction matrix as the two-synch schemes left them
    for j in range(3):
        Lj[j, : j + 1] = Lt[j, : j + 1] = Q[:, : j + 1].T @ Q[:, j]
    hj, nj, vj = jk._gs_orthogonalize(Vj, _split(jnp.asarray(w)), scheme, Lj)
    ht, nt, vt = tk._gs_orthogonalize(Vt, _split(torch.as_tensor(w)), scheme, Lt)
    assert np.allclose(ht, hj, rtol=1e-12, atol=1e-14)
    assert nt == pytest.approx(nj, rel=1e-12)
    assert _rel([x.numpy() for x in vt], vj) < 1e-11
    assert np.allclose(Lt, Lj, rtol=1e-12, atol=1e-15)
    dots = tk._mass_dots_dev(Vt, _split(torch.as_tensor(w))).numpy()
    assert np.allclose(dots, np.asarray(jk._mass_dots_dev(tuple(Vj), _split(jnp.asarray(w)))), rtol=1e-13)
    ax = tk._mass_axpy_dev(Vt, dots, _split(torch.as_tensor(w)))
    assert _rel([x.numpy() for x in ax],
                jk._mass_axpy_dev(tuple(Vj), jnp.asarray(dots), _split(jnp.asarray(w)))) < 1e-13
    with pytest.raises(ValueError):
        tk._gs_orthogonalize(Vt, _split(torch.as_tensor(w)), "householder", Lt)
