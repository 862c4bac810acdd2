"""The port's native host library and the ``schur_sparse_ldl`` safe tier
against the JAX package, on the CPU.

``hiop_tpu_torch.native`` builds its own copies of ``ldl.cpp`` and
``csr_utils.cpp`` with ``g++`` into ``build/native/``. Held against
``hiop_tpu.native`` (which builds the same sources beside its package):

- the sparse LDL^T gives bit-identical pivots and inertia, and solves that
  agree to 1e-12; the AMD and RCM orderings are identical;
- the bordered sparse safe tier (``factorize_safe_schur`` /
  ``solve_safe_schur``) gives the same inertia and directions to 1e-10
  relative on an ``AcopfMds(16)`` saddle;
- with both libraries on, ACOPF B=16 walks the same safe ladder in both
  packages, with default options (the CPU ladder) and with the card's
  ladder (both ``on_accelerator`` probes patched True): the same status,
  iteration count and tier sequence, and the objective to 1e-8 relative;
- with the port's library off, the ladder has no ``schur_sparse_ldl``
  tier, as in the JAX package without its library.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import examples.acopf_mds as jax_acopf
import hiop_tpu.backends.execspace as jax_execspace
import hiop_tpu.kkt.mds as jmds
import hiop_tpu.native as jax_native
import hiop_tpu.native.ldl as jax_native_ldl
import hiop_tpu.optimization.filter_ipm as jax_filter_ipm
import hiop_tpu_torch.kkt.mds as tmds
import hiop_tpu_torch.native as torch_native
import hiop_tpu_torch.native.ldl as torch_native_ldl
import hiop_tpu_torch.optimization.filter_ipm as torch_filter_ipm
from examples.acopf_mds import AcopfMds as JaxAcopf
from hiop_tpu import NlpMDS as JaxMDS, NlpOptions as JaxOptions
from hiop_tpu_torch import NlpMDS as TorchMDS, NlpOptions as TorchOptions
from hiop_tpu_torch.examples import acopf_mds
from hiop_tpu_torch.examples.acopf_mds import AcopfMds as TorchAcopf
from hiop_tpu_torch.utils.carry import to_tensor

# The matrices here are small: torch's intra-op thread pool costs more than it
# gains, and its spinning threads slow the other test workers.
torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300) if a.size else 0.0


def _quasi_definite(n1: int, n2: int, seed: int):
    """[[A, B^T], [B, -C]] with A and C sparse SPD: n1 positive and n2
    negative eigenvalues, factorable without pivoting in any order."""
    rng = np.random.default_rng(seed)

    def spd(n):
        G = sp.random(n, n, density=0.05, random_state=rng)
        return (G @ G.T + sp.diags(rng.uniform(1.0, 2.0, n))).tocsc()

    B = sp.random(n2, n1, density=0.1, random_state=rng)
    return sp.bmat([[spd(n1), B.T], [B, -spd(n2)]], format="csc")


def test_library_builds_outside_the_package():
    assert torch_native.native_available() and torch_native_ldl.native_available()
    assert jax_native_ldl.native_available()
    built = sorted(p.name for p in torch_native.BUILD_DIR.glob("lib*.so"))
    assert any(n.startswith("libldl_") for n in built), built
    assert any(n.startswith("libcsr_utils_") for n in built), built


@pytest.mark.parametrize("seed", [0, 1])
def test_orderings_match_jax(seed):
    A = _quasi_definite(60, 40, seed)
    S = sp.csr_matrix(A + A.T)
    ptr, idx = np.asarray(S.indptr, np.int64), np.asarray(S.indices, np.int64)
    for name in ("amd_ordering", "rcm_ordering"):
        a = getattr(torch_native, name)(S.shape[0], ptr, idx)
        b = getattr(jax_native, name)(S.shape[0], ptr, idx)
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("ordering", ["amd", "rcm", "none"])
def test_native_ldl_matches_jax(ordering):
    A = _quasi_definite(70, 50, 7)
    ft = torch_native_ldl.NativeLdlFactorization(A, ordering=ordering)
    fj = jax_native_ldl.NativeLdlFactorization(A, ordering=ordering)
    assert ft.inertia() == fj.inertia() == (70, 50, 0)
    assert np.array_equal(ft._D, fj._D)
    rhs = np.random.default_rng(3).standard_normal((120, 3))
    for r in (rhs, rhs[:, 0]):
        xt = ft.solve(r)
        assert _rel(xt, fj.solve(r)) < 1e-12
        assert _rel(A @ xt, r) < 1e-10
    with pytest.raises(torch_native_ldl.SingularError):
        torch_native_ldl.NativeLdlFactorization(sp.csc_matrix((3, 3)), ordering=ordering)


def test_factorize_safe_schur_matches_jax():
    """One seeded ACOPF B=16 saddle with an indefinite sparse block (its
    negative entries count by Haynsworth additivity)."""
    opts = dict(Hessian="analytical_exact", fixed_var="relax", verbosity_level=0)
    jo, to = JaxOptions(), TorchOptions()
    jo.update(**opts)
    to.update(compute_mode="cpu", **opts)
    jn, tn = JaxMDS(JaxAcopf(16), jo), TorchMDS(TorchAcopf(16), to)
    jn.finalize_initialization()
    tn.finalize_initialization()
    rng = np.random.default_rng(16)
    x = np.asarray(jn.get_starting_point()) + 0.01 * rng.standard_normal(jn.n)
    yc, yd = rng.standard_normal(jn.m_eq), rng.standard_normal(jn.m_ineq)
    Jc, Jd = (np.asarray(a) for a in jn.eval_jac(jnp.asarray(x)))
    hss, Hdd = (np.asarray(a) for a in jn.eval_hess_blocks(
        jnp.asarray(x), 1.0, jnp.asarray(yc), jnp.asarray(yd)))
    ns, mc, md = jn.n_sparse, jn.m_eq, jn.m_ineq
    Dxs = np.abs(hss) + rng.uniform(0.5, 1.5, ns)
    Dxs[: ns // 10] -= 2.0 * Dxs[: ns // 10] + np.abs(hss[: ns // 10])
    Dxd, Dd = rng.uniform(0.5, 1.5, jn.n - ns), rng.uniform(0.5, 1.5, md)
    rows = np.concatenate([np.asarray(jn.jac_sp_eq_rows), mc + np.asarray(jn.jac_sp_in_rows)])
    cols = np.concatenate([np.asarray(jn.jac_sp_eq_cols), np.asarray(jn.jac_sp_in_cols)])
    js_vals = np.concatenate([Jc[jn.jac_sp_eq_rows, jn.jac_sp_eq_cols],
                              Jd[jn.jac_sp_in_rows, jn.jac_sp_in_cols]])
    Jdn = np.concatenate([Jc[:, ns:], Jd[:, ns:]])
    deltas = (1e-3, 0.0, 1e-8, 0.0)
    fj = jmds.factorize_safe_schur(
        hss, Hdd, Dxs, Dxd, Dd, Jdn, rows, cols, js_vals,
        jmds.build_schur_pairs(rows, cols, ns), *deltas, mc, md)
    t = lambda a: to_tensor(a, "cpu")  # noqa: E731
    ft = tmds.factorize_safe_schur(
        t(hss), t(Hdd), t(Dxs), t(Dxd), t(Dd), t(Jdn), rows, cols, t(js_vals),
        tmds.build_schur_pairs(rows, cols, ns), *deltas, mc, md)
    assert ft.host and ft.ok and fj.ok
    assert ft.n_neg_eig == fj.n_neg_eig >= mc + md - ns // 10
    rhs = (rng.standard_normal(ns), rng.standard_normal(jn.n - ns), rng.standard_normal(md),
           rng.standard_normal(mc), rng.standard_normal(md))
    outj = jmds.solve_safe_schur(fj, *(jnp.asarray(a) for a in rhs))
    outt = tmds.solve_safe_schur(ft, *(t(a) for a in rhs))
    for a, b in zip(outt, outj):
        assert _rel(a.numpy(), b) < 1e-10


def _record_tiers(monkeypatch, mod, log):
    """Record the safe tier of each factorization that ``mod`` serves."""
    dense, schur = mod.factorize_safe, mod.factorize_safe_schur

    def safe(*a, host=False, **k):
        log.append("lu_eig" if host else "ldl_nopiv")
        return dense(*a, host=host, **k)

    def bordered(*a, **k):
        log.append("schur_sparse_ldl")
        return schur(*a, **k)

    monkeypatch.setattr(mod, "factorize_safe", safe)
    monkeypatch.setattr(mod, "factorize_safe_schur", bordered)


@pytest.mark.parametrize("card_ladder", [False, True], ids=["cpu_ladder", "card_ladder"])
def test_acopf16_native_tier_matches_jax(monkeypatch, card_ladder):
    if card_ladder:
        monkeypatch.setattr(jax_execspace, "on_accelerator", lambda *a: True)
        monkeypatch.setattr(torch_filter_ipm, "on_accelerator", lambda *a: True)
    tiers = {"jax": [], "torch": []}
    _record_tiers(monkeypatch, jmds, tiers["jax"])
    _record_tiers(monkeypatch, tmds, tiers["torch"])
    rj = jax_acopf.solve(16, verbosity_level=0)
    rt = acopf_mds.solve(16, verbosity_level=0, compute_mode="cpu")
    assert rt.status.is_success and rt.status.name == rj.status.name
    assert rt.iterations == rj.iterations == 44
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))
    assert tiers["torch"] == tiers["jax"]
    assert tiers["torch"][0] == "schur_sparse_ldl"
    assert ("ldl_nopiv" in tiers["torch"]) == card_ladder


@pytest.mark.parametrize("card_ladder", [False, True], ids=["cpu_ladder", "card_ladder"])
def test_ladder_without_the_library_matches_jax(monkeypatch, card_ladder):
    monkeypatch.setattr(jax_execspace, "on_accelerator", lambda *a: card_ladder)
    monkeypatch.setattr(torch_filter_ipm, "on_accelerator", lambda *a: card_ladder)
    ladders = {}
    for lib_on in (True, False):
        monkeypatch.setattr(jax_native_ldl, "native_available", lambda v=lib_on: v)
        monkeypatch.setattr(torch_native_ldl, "native_available", lambda v=lib_on: v)
        jo, to = JaxOptions(), TorchOptions()
        jo.update(**jax_acopf_options())
        to.update(compute_mode="cpu", **jax_acopf_options())
        sj = jax_filter_ipm.FilterIPMNewton(JaxMDS(JaxAcopf(8), jo))._make_strategy()
        st = torch_filter_ipm.FilterIPMNewton(TorchMDS(TorchAcopf(8), to))._make_strategy()
        assert tuple(st._safe_tiers) == tuple(sj._safe_tiers)
        ladders[lib_on] = tuple(st._safe_tiers)
    dense = ("ldl_nopiv", "lu_eig") if card_ladder else ("lu_eig",)
    assert ladders == {True: ("schur_sparse_ldl",) + dense, False: dense}


def jax_acopf_options():
    return dict(Hessian="analytical_exact", fixed_var="relax", verbosity_level=0)


@pytest.mark.slow
def test_acopf512_card_ladder_native_tiers_match_jax(monkeypatch):
    """Full width on the CPU with the card's ladder and both libraries on,
    capped at 25 iterations: the safe tier of every factorization, by
    iteration, is the same in both packages, and so is the iterate. Prints
    the sequence (``-s``); ``chip_smoke.py`` phase 6 sets its cap from it
    (tens of minutes)."""
    monkeypatch.setattr(jax_execspace, "on_accelerator", lambda *a: True)
    monkeypatch.setattr(torch_filter_ipm, "on_accelerator", lambda *a: True)
    tiers = {"jax": [], "torch": []}
    for name, mod, ipm in (("jax", jmds, jax_filter_ipm), ("torch", tmds, torch_filter_ipm)):
        it = [-1]

        def prepare(self, *a, _f=ipm._MdsStrategy.prepare, _it=it, **k):
            _it[0] += 1
            return _f(self, *a, **k)

        monkeypatch.setattr(ipm._MdsStrategy, "prepare", prepare)
        log = []
        _record_tiers(monkeypatch, mod, log)
        tiers[name] = (it, log)
    # tag each factorization with the iteration it served
    for name, mod in (("jax", jmds), ("torch", tmds)):
        it, log = tiers[name]
        for attr in ("factorize_safe", "factorize_safe_schur"):
            def tagged(*a, _f=getattr(mod, attr), _it=it, _log=log, **k):
                n = len(_log)
                out = _f(*a, **k)
                _log[n] = (_it[0], _log[n])
                return out

            monkeypatch.setattr(mod, attr, tagged)
    opts = dict(verbosity_level=0, max_iter=25)
    rj = jax_acopf.solve(512, **opts)
    rt = acopf_mds.solve(512, compute_mode="cpu", **opts)
    seq = tiers["torch"][1]
    print("\nACOPF B=512, card ladder, native library on: (iteration, safe tier) per factorization")
    print(seq)
    print("status", rt.status.name, "iterations", rt.iterations, "obj", repr(rt.obj), repr(rj.obj))
    assert rt.status.name == rj.status.name and rt.iterations == rj.iterations
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))
    assert seq == tiers["jax"][1]
