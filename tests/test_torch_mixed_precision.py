"""Mixed precision in the port (``kkt_fact_dtype=float32``) against the JAX
package, on the CPU.

Three kinds of parity:

- **The device saddle family** of ``kkt/mds.py`` on ACOPF B=16 operands:
  the same ``ok`` and inertia count, L and d to 1e-9 in f64 and 1e-4 in
  f32, the operator-form matvec to 1e-12 of the dense saddle's, the same
  certification and refinement counts, directions to 1e-8 relative.
- **The schedule's logic, exactly.** With the casts to f32 switched off in
  both packages (``_MdsStrategy._cast`` patched to the identity), every
  decision of the mixed-precision schedule still runs (f32 slots, FGMRES
  certification, the f32 safe tier's curvature acceptance, demotions,
  re-entry) on f64 arithmetic, and both packages must take the same
  factorizations in the same order, the same demotions, the same
  iterations, and the objective to 1e-8.
- **Real f32.** Here the two packages round differently: JAX's f32
  factors come from LAPACK and XLA's unrolled LDL^T, the port's from the
  plain versions of its kernels, and the first iterate already differs in
  the 6th digit (the inner refinement may accept a raw f32 solve: its
  tolerance is max(ir_inner_tol, ir_inner_tol_factor * mu), relative).
  The trajectories then part: at B=16 on the CPU ladder ``hiop_tpu``
  takes 45 iterations and the port 41. The converged objective agrees to
  1e-8 relative, the f32 factorization count within 2 and the iteration
  count within 10% (the logic itself is held exactly above). On the card's
  ladder both packages run the same f32 stretch and the same first
  demotion, compared over the first 12 iterations. Later on, at B=16, the
  port's trajectory collapses its line search at iteration 39 where
  ``hiop_tpu``'s does not: the soft restoration fails, the nested FR solve
  restores feasibility in 3 iterations, and the port converges after 48
  iterations (``hiop_tpu``: 44) to the same objective (5e-14 relative;
  ``SELFCHECK`` has no B=16 entry, so the objective is held to
  ``hiop_tpu``'s).

Every ``hiop_tpu`` reference solve runs once, in a module-scoped fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch
from threadpoolctl import threadpool_limits

import examples.acopf_mds as jax_acopf
import hiop_tpu.backends.execspace as jax_execspace
import hiop_tpu.kkt.mds as jmds
import hiop_tpu.optimization.filter_ipm as jfi
import hiop_tpu_torch.kkt.mds as tmds
import hiop_tpu_torch.optimization.filter_ipm as tfi
from examples.acopf_mds import AcopfMds as JaxAcopf
from hiop_tpu import NlpMDS as JaxMDS, NlpOptions as JaxOptions
from hiop_tpu.utils.logger import Logger as JaxLogger
from hiop_tpu_torch import NlpMDS as TorchMDS, NlpOptions as TorchOptions
from hiop_tpu_torch.examples import acopf_mds
from hiop_tpu_torch.examples.acopf_mds import AcopfMds as TorchAcopf
from hiop_tpu_torch.utils.logger import Logger as TorchLogger
from chip_smoke import _runs as _runs_text, fact_label

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

PKG = {
    "jax": dict(fi=jfi, f32=jnp.float32),
    "torch": dict(fi=tfi, f32=torch.float32),
}


def _mp_solve(pkg: str, B: int, card_ladder: bool, emulate: bool = False, **opts):
    """One ACOPF solve with kkt_fact_dtype=float32 and the native library
    on, recording each factorization's slot/dtype and each demotion."""
    fi, f32 = PKG[pkg]["fi"], PKG[pkg]["f32"]
    facts, demotions = [], []
    with pytest.MonkeyPatch.context() as mp:
        if card_ladder:
            mp.setattr(jax_execspace if pkg == "jax" else tfi, "on_accelerator", lambda *a: True)
        if emulate:
            mp.setattr(fi._MdsStrategy, "_cast", lambda self, a: a)
        factorize, demote = fi._MdsStrategy._factorize, fi._mp_demote

        def tagged(self):
            facts.append(fact_label(self, f32))
            return factorize(self)

        def demoted(strategy, why):
            if strategy._mp_f32_ok:
                demotions.append(why)
            return demote(strategy, why)

        mp.setattr(fi._MdsStrategy, "_factorize", tagged)
        mp.setattr(fi, "_mp_demote", demoted)
        kw = dict(verbosity_level=0, kkt_fact_dtype="float32", **opts)
        if pkg == "jax":
            r = jax_acopf.solve(B, **kw)
        else:
            r = acopf_mds.solve(B, compute_mode="cpu", **kw)
    return dict(r=r, facts=facts, demotions=demotions, n_f32=sum("f32" in f for f in facts))


def _runs(seq):
    """The distinct consecutive entries of seq."""
    return [t for i, t in enumerate(seq) if i == 0 or seq[i - 1] != t]


def _same_objective(rt, rj):
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))


# ---------------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_cpu_f32():
    return _mp_solve("jax", 16, False)


@pytest.fixture(scope="module")
def jax_emulated():
    return {False: _mp_solve("jax", 16, False, emulate=True),
            True: _mp_solve("jax", 16, True, emulate=True, max_iter=40)}


def _report(t, j):
    """Both solves' numbers (``-s``)."""
    rt, rj = t["r"], j["r"]
    print(f"\nhiop_tpu {rj.status.name} {rj.iterations} iterations, {j['n_f32']} of "
          f"{len(j['facts'])} in f32, demotions {j['demotions']}: {_runs_text(j['facts'])}")
    print(f"hiop_tpu_torch {rt.status.name} {rt.iterations} iterations, {t['n_f32']} of "
          f"{len(t['facts'])} in f32, demotions {t['demotions']}: {_runs_text(t['facts'])}")
    print(f"objectives {rj.obj!r} {rt.obj!r}, rel diff {abs(rt.obj - rj.obj) / abs(rj.obj):.2e}")


def test_cpu_ladder_f32_matches_jax(jax_cpu_f32):
    j = jax_cpu_f32
    t = _mp_solve("torch", 16, False)
    _report(t, j)
    rt, rj = t["r"], j["r"]
    assert rt.status.is_success and rt.status.name == rj.status.name
    _same_objective(rt, rj)
    assert abs(rt.iterations - rj.iterations) <= 0.1 * rj.iterations, (rt.iterations, rj.iterations)
    assert abs(t["n_f32"] - j["n_f32"]) <= 2, (t["n_f32"], j["n_f32"])
    assert t["demotions"] == j["demotions"] == []
    assert _runs(t["facts"]) == _runs(j["facts"])
    assert t["facts"][0] == "quick-f32" and "lu_eig-f64" in t["facts"]


@pytest.mark.parametrize("card_ladder", [False, True], ids=["cpu_ladder", "card_ladder"])
def test_mp_schedule_logic_matches_jax_exactly(jax_emulated, card_ladder):
    """f64 arithmetic in the f32 slots of both packages: the same
    decisions, factorization by factorization (the card's ladder capped
    at 40 iterations: past them an ill-conditioned stretch of host
    lu_eig factorizations amplifies the last bits of f64 sums)."""
    j = jax_emulated[card_ladder]
    t = _mp_solve("torch", 16, card_ladder, emulate=True, **({"max_iter": 40} if card_ladder else {}))
    _report(t, j)
    rt, rj = t["r"], j["r"]
    assert rt.status.name == rj.status.name
    assert rt.iterations == rj.iterations
    _same_objective(rt, rj)
    assert t["facts"] == j["facts"]
    assert t["demotions"] == j["demotions"]
    if card_ladder:
        assert t["demotions"] == ["f32 safe-tier curvature test failed"]
        assert "device-f32[schur_sparse_ldl]" in t["facts"]
    else:
        assert rt.status.is_success and t["n_f32"] == 13


def test_card_ladder_f32_first_stretch_matches_jax():
    """Real f32 on the card's ladder, first 12 iterations: the quick f32
    tier, then the f32 device LDL^T in the schur_sparse_ldl slot until the
    same first demotion, then the f64 ladder."""
    j = _mp_solve("jax", 16, True, max_iter=12)
    t = _mp_solve("torch", 16, True, max_iter=12)
    _report(t, j)
    assert t["r"].status.name == j["r"].status.name == "Max_Iter_Exceeded"
    assert t["demotions"][:1] == j["demotions"][:1] == ["f32 safe-tier factorization rejected"]
    k = t["facts"].index("schur_sparse_ldl-f64")
    assert t["facts"][:k + 1] == j["facts"][:k + 1]
    assert _runs(t["facts"]) == _runs(j["facts"]) == [
        "quick-f32", "device-f32[schur_sparse_ldl]", "schur_sparse_ldl-f64"]
    assert abs(t["n_f32"] - j["n_f32"]) <= 2


def test_card_ladder_f32_b16_recovers_through_restoration(jax_cpu_f32):
    """Real f32 on the card's ladder at B=16, to the end: the collapsed
    line search at iteration 35 goes to the soft restoration, which fails,
    then to the nested FR solve, which restores feasibility; the solve then
    converges to ``hiop_tpu``'s optimum (here the CPU ladder's, the same
    problem's). The real-f32 trajectory is decided by rounding: under this
    module's one BLAS thread it reaches the collapse at iteration 35 and
    ends at 44; with OpenBLAS's default thread count, at 39 and 48."""
    restorations = []
    soft, apply = tfi.FilterIPMBase._solve_soft_fr, tfi.fr_mod.apply_feasibility_restoration

    def soft_recorded(self, *a, **k):
        out = soft(self, *a, **k)
        restorations.append(("soft", self.iter_num, out is not None))
        return out

    def full_recorded(solver, *a, **k):
        out = apply(solver, *a, **k)
        restorations.append(("full", solver.iter_num, solver.last_fr["status"].name,
                             solver.last_fr["iterations"], out is not None))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfi.FilterIPMBase, "_solve_soft_fr", soft_recorded)
        mp.setattr(tfi.fr_mod, "apply_feasibility_restoration", full_recorded)
        t = _mp_solve("torch", 16, True)
    rt = t["r"]
    assert rt.status.name == "Solve_Success" and rt.iterations == 44
    assert restorations == [("soft", 35, False), ("full", 35, "User_Stopped", 3, True)]
    _same_objective(rt, jax_cpu_f32["r"])
    assert t["demotions"][:1] == ["f32 safe-tier factorization rejected"]


@pytest.mark.slow
def test_acopf32_card_ladder_f32_matches_jax():
    """B=32, real f32, the card's ladder, to convergence (about a minute):
    the same status, the objective to 1e-8, the iteration count within 2
    and the same first demotion. Prints both factorization sequences
    (``-s``)."""
    j = _mp_solve("jax", 32, True)
    t = _mp_solve("torch", 32, True)
    _report(t, j)
    rt, rj = t["r"], j["r"]
    assert rt.status.is_success and rt.status.name == rj.status.name
    _same_objective(rt, rj)
    assert abs(rt.iterations - rj.iterations) <= 2
    assert t["demotions"][:1] == j["demotions"][:1]


def test_mds_ex1_f32_matches_jax(capsys):
    """The mds_ex1 examples' ``-pallas`` flag (mixed precision through the
    kernels) at ns=40, nd=20: the quick tier alone, f32 throughout."""
    import examples.mds_ex1 as jax_ex1
    from hiop_tpu_torch.examples import mds_ex1

    rj = jax_ex1.solve(40, 20, verbosity_level=0, exec_policies="pallas", kkt_fact_dtype="float32")
    rt = mds_ex1.solve(40, 20, verbosity_level=0, compute_mode="cpu", kkt_fact_dtype="float32")
    assert rt.status.is_success and rt.status.name == rj.status.name
    assert rt.iterations == rj.iterations
    _same_objective(rt, rj)
    assert mds_ex1.main(["40", "20", "-cpu", "-pallas"]) == 0
    assert "status Solve_Success" in capsys.readouterr().out


def test_corrupted_f32_solve_demotes_and_converges(monkeypatch):
    """A useless f32 solve (zero directions): the inner FGMRES refinement
    cannot progress, so f32 is demoted, the direction is recomputed in f64
    and the solve still converges (counterpart of
    ``tests/test_mixed_precision.py::test_mds_residual_demotes_on_bad_f32_solve``
    at B=16)."""
    orig = tfi._MdsStrategy._solve
    state = {"corrupted": 0}

    def bad_solve(self, f, rx_t, rd_t, ryc, ryd):
        out = orig(self, f, rx_t, rd_t, ryc, ryd)
        if self.fact_dtype == torch.float32:
            state["corrupted"] += 1
            return tuple(torch.zeros_like(a) for a in out)
        return out

    monkeypatch.setattr(tfi._MdsStrategy, "_solve", bad_solve)
    t = _mp_solve("torch", 16, False)
    assert state["corrupted"] > 0
    assert t["demotions"] == ["MDS inner FGMRES-IR did not converge"]
    assert t["r"].status.is_success
    ref, tol = 5.257269809774589, 1e-6
    assert abs(t["r"].obj - ref) <= tol * ref


def test_mu_threshold_schedule_runs():
    """mp_schedule=mu_threshold: f32 only while mu >= mp_mu_threshold."""
    seen = []
    orig = tfi._mp_count_fact

    def spy(strategy):
        seen.append((strategy._mu, strategy.fact_dtype))
        orig(strategy)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfi, "_mp_count_fact", spy)
        t = _mp_solve("torch", 16, False, mp_schedule="mu_threshold", mp_mu_threshold=1e-3)
    assert t["r"].status.is_success
    assert any(dt == torch.float32 for _, dt in seen)
    assert all(dt == torch.float64 for mu, dt in seen if mu < 1e-3)


# ---------------------------------------------------------------------------
# the schedule's pieces, unit by unit
# ---------------------------------------------------------------------------
def _fake_strategy(pkg, **over):
    class P:
        delta_wx = 0.0

    class S:
        perturb = P()
        log = (JaxLogger if pkg == "jax" else TorchLogger)(verbosity=0)
        _safe_mode = 1
        _safe_tiers = ("lu_eig",)
        _chronic_delta = 0
        _mp_schedule = "adaptive"
        _mp_mu_threshold = 1e-4
        _mp_f32_ok = False
        _deesc_n = 3
        _deesc_clean = 0
        _deesc_budget = 2
        _mu = 1e-2
        _fact_dtype_opt = PKG[pkg]["f32"]

    s = S()
    for k, v in over.items():
        setattr(s, k, v)
    return s


def test_deescalation_reenters_f32_as_jax():
    """N clean safe-mode iterations step the ladder back and re-enable f32
    (counterpart of ``tests/test_mixed_precision.py::test_deescalation_reenters_f32``)."""
    for pkg in ("jax", "torch"):
        fi = PKG[pkg]["fi"]
        s = _fake_strategy(pkg)
        for _ in range(3):
            assert s._safe_mode == 1
            fi._maybe_deescalate_safe(s)
        assert s._safe_mode == 0 and s._mp_f32_ok is True and s._deesc_budget == 1
        s2 = _fake_strategy(pkg)
        fi._maybe_deescalate_safe(s2)
        fi._maybe_deescalate_safe(s2)
        s2.perturb = type("P2", (), {"delta_wx": 1e-8})()
        fi._maybe_deescalate_safe(s2)
        assert s2._deesc_clean == 0 and s2._safe_mode == 1


CASES = [
    dict(),                                           # safe, f32 demoted
    dict(_mp_f32_ok=True),                            # safe, device probe decides
    dict(_mp_f32_ok=True, _safe_mode=0),              # quick, adaptive
    dict(_safe_mode=0),                               # quick, demoted
    dict(_safe_mode=0, _mp_schedule="mu_threshold"),  # mu above the cutover
    dict(_safe_mode=0, _mp_schedule="mu_threshold", _mu=1e-6),
    dict(_mp_f32_ok=True, _mp_schedule="mu_threshold"),
]


@pytest.mark.parametrize("probe", [False, True], ids=["cpu", "card"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_mp_fact_dtype_matches_jax(case, probe):
    out = {}
    for pkg in ("jax", "torch"):
        s = _fake_strategy(pkg, **CASES[case])
        s._mp_safe_f32_device = lambda p=probe: p
        out[pkg] = PKG[pkg]["fi"]._mp_fact_dtype(s) == PKG[pkg]["f32"]
    assert out["torch"] == out["jax"]
    s = _fake_strategy("torch", _fact_dtype_opt=torch.float64, **CASES[case])
    assert tfi._mp_fact_dtype(s) == torch.float64


def test_mds_matvec_matches_jax():
    rng = np.random.default_rng(11)
    ns, nd, mc, md = 9, 4, 5, 3
    blocks = [rng.standard_normal(s) for s in ((ns,), (ns,), (nd,), (md,), (nd, nd),
                                             (mc, ns), (mc, nd), (md, ns), (md, nd))]
    deltas = (1e-3, 2e-3, 1e-6, 3e-6)
    v = [rng.standard_normal(k) for k in (ns + nd, md, mc, md)]
    outj = jfi._mds_matvec_jit(*(jnp.asarray(b) for b in blocks), *deltas, ns,
                               *(jnp.asarray(x) for x in v))
    outt = tfi._mds_matvec(*(torch.as_tensor(b) for b in blocks), *deltas, ns,
                           *(torch.as_tensor(x) for x in v))
    for a, b in zip(outt, outj):
        assert np.allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=1e-13)


# ---------------------------------------------------------------------------
# the device saddle family on ACOPF B=16 operands
# ---------------------------------------------------------------------------
def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300) if a.size else 0.0


@pytest.fixture(scope="module")
def ops():
    """Operands of both packages at the ACOPF B=16 starting point (the
    counterpart of ``tests/test_mixed_precision.py::_acopf_operands``), as
    numpy arrays, with each package's triplet structure."""
    opts = dict(Hessian="analytical_exact", fixed_var="relax", verbosity_level=0)
    jo, to = JaxOptions(), TorchOptions()
    jo.update(**opts)
    to.update(compute_mode="cpu", **opts)
    jn, tn = JaxMDS(JaxAcopf(16), jo), TorchMDS(TorchAcopf(16), to)
    jn.finalize_initialization()
    tn.finalize_initialization()
    ns = jn.n_sparse
    x0 = jn.get_starting_point()
    Jc, Jd = (np.asarray(a) for a in jn.eval_jac(x0))
    hss, Hdd = (np.asarray(a) for a in jn.eval_hess_blocks(
        x0, 1.0, jnp.zeros((jn.m_eq,)), jnp.zeros((jn.m_ineq,))))
    js_vals = np.concatenate([Jc[jn.jac_sp_eq_rows, jn.jac_sp_eq_cols],
                              Jd[jn.jac_sp_in_rows, jn.jac_sp_in_cols]])
    rng = np.random.default_rng(0)
    rhs = (rng.standard_normal(ns), rng.standard_normal(jn.n_dense), rng.standard_normal(jn.m_ineq),
           rng.standard_normal(jn.m_eq), rng.standard_normal(jn.m_ineq))
    return dict(
        ns=ns, hss=hss, Hdd=Hdd, Dxs=np.ones(ns), Dxd=np.ones(jn.n_dense), Dd=np.ones(jn.m_ineq),
        Jc_s=Jc[:, :ns], Jc_d=Jc[:, ns:], Jd_s=Jd[:, :ns], Jd_d=Jd[:, ns:], js_vals=js_vals,
        sj=jmds.mds_js_struct(jn), st=tmds.mds_js_struct(tn), tn=tn, rhs=rhs,
        v=rng.standard_normal(jn.n_dense + jn.m_eq + jn.m_ineq),
    )


def _args(p, names, lib):
    conv = jnp.asarray if lib == "jax" else torch.as_tensor
    return tuple(conv(p[k]) for k in names)


FULL = ("hss", "Hdd", "Dxs", "Dxd", "Dd", "Jc_s", "Jc_d", "Jd_s", "Jd_d")
OPF = ("hss", "Hdd", "Dxs", "Dxd", "Dd", "Jc_d", "Jd_d", "js_vals")
ZERO = (0.0, 0.0, 0.0, 0.0)


def test_mds_js_struct_matches_jax_and_is_cached(ops):
    sj, st = ops["sj"], ops["st"]
    for a, b in zip(sj[:2], st[:2]):
        assert np.array_equal(np.asarray(a), b.numpy())
    for a, b in zip(sj[2], st[2]):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert tmds.mds_js_struct(ops["tn"]) is st


def test_saddle_device_matches_jax(ops):
    fj = jmds.factorize_saddle_device(*_args(ops, FULL, "jax"), *ZERO)
    ft = tmds.factorize_saddle_device(*_args(ops, FULL, "torch"), *ZERO)
    assert bool(ft.ok) == bool(fj.ok) is True
    for name in ("L", "d", "s", "ks_inv"):
        assert _rel(getattr(ft, name).numpy(), getattr(fj, name)) < 1e-9, name
    outj = jmds.solve_saddle_device(fj, *_args(dict(enumerate(ops["rhs"])), range(5), "jax"))
    outt = tmds.solve_saddle_device(ft, *_args(dict(enumerate(ops["rhs"])), range(5), "torch"))
    for a, b in zip(outt, outj):
        assert _rel(a.numpy(), b) < 1e-8


def _rhs(ops, lib):
    return _args(dict(enumerate(ops["rhs"])), range(5), lib)


def test_saddle_device_mp_matches_jax(ops):
    fj = jmds.factorize_saddle_device_mp(*_args(ops, FULL, "jax"), *ZERO)
    ft = tmds.factorize_saddle_device_mp(*_args(ops, FULL, "torch"), *ZERO)
    assert ft.L.dtype == torch.float32 and ft.M.dtype == torch.float64
    assert bool(ft.ok) == bool(fj.ok) is True and int(ft.n_neg) == int(fj.n_neg)
    assert _rel(ft.L.numpy(), fj.L) < 1e-4 and _rel(ft.d.numpy(), fj.d) < 1e-4
    assert _rel(ft.M.numpy(), fj.M) < 1e-12
    outj = jmds.solve_saddle_device_mp(fj, *_rhs(ops, "jax"))
    outt = tmds.solve_saddle_device_mp(ft, *_rhs(ops, "torch"))
    assert outt[5] == bool(outj[5]) is True
    for a, b in zip(outt[:5], outj[:5]):
        assert _rel(a.numpy(), b) < 1e-8
    # information-free factors: refinement stagnates, nothing certifies
    # (counterpart of test_saddle_mp_uncertified_when_factors_are_useless)
    bad_t = ft._replace(L=torch.zeros_like(ft.L), d=torch.ones_like(ft.d))
    bad_j = fj._replace(L=jnp.zeros_like(fj.L), d=jnp.ones_like(fj.d))
    assert tmds.solve_saddle_device_mp(bad_t, *_rhs(ops, "torch"))[5] is False
    assert not bool(jmds.solve_saddle_device_mp(bad_j, *_rhs(ops, "jax"))[5])


def test_saddle_device_mp_op_matches_jax(ops):
    sj, st = ops["sj"], ops["st"]
    fj = jmds.factorize_saddle_device_mp_op(*_args(ops, OPF, "jax"), sj[2], *ZERO)
    ft = tmds.factorize_saddle_device_mp_op(*_args(ops, OPF, "torch"), st[2], *ZERO)
    f_mp = tmds.factorize_saddle_device_mp(*_args(ops, FULL, "torch"), *ZERO)
    assert bool(ft.ok) == bool(fj.ok) == bool(f_mp.ok) is True
    assert int(ft.n_neg) == int(fj.n_neg) == int(f_mp.n_neg)
    assert _rel(ft.L.numpy(), fj.L) < 1e-4 and _rel(ft.d.numpy(), fj.d) < 1e-4
    for name in ("s", "m_norm", "Kd", "Jdn", "diagC", "ks_inv", "dd_tot"):
        assert _rel(getattr(ft, name).numpy(), getattr(fj, name)) < 1e-6, name
    # the operator-form matvec against the dense f64 saddle and against JAX's
    v = torch.as_tensor(ops["v"])
    mv = tmds._op_matvec(ft, st[0], st[1], v)
    assert _rel(mv.numpy(), (f_mp.M @ v).numpy()) < 1e-12
    assert _rel(mv.numpy(), jmds._op_matvec(fj, sj[0], sj[1], jnp.asarray(ops["v"]))) < 1e-12
    outj = jmds.solve_saddle_device_mp_op(fj, sj[0], sj[1], *_rhs(ops, "jax"))
    outt = tmds.solve_saddle_device_mp_op(ft, st[0], st[1], *_rhs(ops, "torch"))
    assert outt[5] == bool(outj[5]) is True and outt[6] == int(outj[6])
    ref = tmds.solve_saddle_device_mp(f_mp, *_rhs(ops, "torch"))
    for a, b, c in zip(outt[:5], outj[:5], ref[:5]):
        assert _rel(a.numpy(), b) < 1e-8
        assert _rel(a.numpy(), c.numpy()) < 1e-6


def test_op_form_fgmres_escalation_certifies_as_jax(ops):
    """Factors of a perturbed system (delta_w = 0.35) under the true
    operator: plain refinement fails within its budget, the FGMRES stage
    certifies, in both packages with the same counts (counterpart of
    ``tests/test_mixed_precision.py::test_op_form_fgmres_escalation_certifies``)."""
    out = {}
    for lib, mds, conv, struct in (("jax", jmds, jnp.asarray, ops["sj"]),
                                   ("torch", tmds, torch.as_tensor, ops["st"])):
        a = _args(ops, OPF, lib)
        f_bad = mds.factorize_saddle_device_mp_op(*a, struct[2], 0.35, 0.35, 0.0, 0.0)
        f_true = mds.factorize_saddle_device_mp_op(*a, struct[2], *ZERO)
        f_mix = f_bad._replace(Kd=f_true.Kd, diagC=f_true.diagC, ks_inv=f_true.ks_inv,
                               m_norm=f_true.m_norm)
        rhs = conv(np.random.default_rng(1).standard_normal(ops["v"].shape[0]))
        x0, c0, n0 = mds._mp_solve_refined_op(f_mix, struct[0], struct[1], rhs, max_ir=4, fgmres_k=0)
        x1, c1, n1 = mds._mp_solve_refined_op(f_mix, struct[0], struct[1], rhs, max_ir=4, fgmres_k=16)
        res = mds._op_matvec(f_mix, struct[0], struct[1], x1) - rhs
        out[lib] = (bool(c0), int(n0), bool(c1), int(n1), np.asarray(x1),
                    float(np.linalg.norm(np.asarray(res)) / np.linalg.norm(np.asarray(rhs))))
    t, j = out["torch"], out["jax"]
    assert t[:4] == j[:4] and t[:3] == (False, 4, True) and t[3] > t[1]
    assert t[5] < 1e-8 and j[5] < 1e-8
    assert _rel(t[4], j[4]) < 1e-8


def test_fgmres_device_and_least_squares_match_jax():
    rng = np.random.default_rng(12)
    n, K = 30, 8
    A = np.eye(n) * 2.0 + rng.standard_normal((n, n)) / np.sqrt(n)
    P = np.linalg.inv(A + 0.2 * np.eye(n))
    b = rng.standard_normal(n)
    H = np.triu(rng.standard_normal((K + 1, K)), -1)
    H[:, K - 2:] = 0.0          # columns not built yet get y = 0
    out = {}
    for lib, mds, conv in (("jax", jmds, jnp.asarray), ("torch", tmds, torch.as_tensor)):
        Am, Pm = conv(A), conv(P)
        x, n_it = mds._fgmres_device(lambda v, Am=Am: Am @ v, lambda v, Pm=Pm: Pm @ v,
                                     conv(b), conv(np.zeros(n)), K, 1e-10 * np.linalg.norm(b))
        out[lib] = (np.asarray(x), int(n_it), np.asarray(mds._fgmres_y(conv(H), 1.5, K)))
    (xt, nt, yt), (xj, nj, yj) = out["torch"], out["jax"]
    assert nt == nj and 0 < nt <= K
    assert _rel(xt, xj) < 1e-10 and np.linalg.norm(A @ xt - b) <= 1e-9 * np.linalg.norm(b)
    assert _rel(yt, yj) < 1e-9 and np.all(yt[K - 2:] == 0.0)
