"""Feasibility restoration on dense-constrained bases, the port against the
JAX package, on the CPU.

Forced restoration (``force_resto=yes``): the nested FR solve is an
``NlpDenseConstraints`` over the dense-assembled FR problem, under
``FilterIPMQuasiNewton`` (L-BFGS) or, with ``Hessian=analytical_exact``,
``FilterIPMNewton`` over the (n + 2m)^2 FR Hessian. The standard: the same
status, the same outer and nested iteration counts and nested statuses,
the objective to 1e-8 relative, on a problem with nonlinear constraints
(both solvers) and on DenseConsEx1 (quasi-Newton).

DenseConsEx2's constraints are linear: after the first full step its
primal infeasibility theta is rounding noise summed in another order by
each package (ROADMAP.md section 3), and the filter's tests near the
optimum decide on it. So DenseConsEx2 under exact Newton at n=40 is held
as ``tests/test_torch_dense_newton.py`` holds it: every line-search
outcome the same up to the first one decided at the noise level, the same
nested solve, the same status and the objective to 1e-8 (measured: both
packages take one nested iteration, then the outer solves part at
iteration 21, where theta is 2e-14, and end after 39 and 35 iterations).

Infeasible problems: the soft restoration fails, the nested FR solve
converges to a point that is still infeasible, and both packages end in
Infeasible_Problem (Newton) or Steplength_Too_Small (quasi-Newton, whose
second nested solve stalls) after the same iterations.

Soft restoration, forced as in ``tests/test_torch_fr.py`` (every trial of
iteration 3 rejected), on the nonlinear problem under quasi-Newton: the
same soft/full sequence, status, iterations and objective.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch
from threadpoolctl import threadpool_limits

import examples.dense_ex1 as jax_ex1
import hiop_tpu
import hiop_tpu.optimization.filter_ipm as jfi
import hiop_tpu_torch
import hiop_tpu_torch.optimization.filter_ipm as tfi
from hiop_tpu_torch.examples import dense_ex1, dense_ex2
from test_torch_dense_newton import _ex2_solve, _first_noise_decision
from test_torch_fr import iteration3_rejected

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

PKGS = {"jax": (hiop_tpu, jfi, jnp, {}), "torch": (hiop_tpu_torch, tfi, torch, {"compute_mode": "cpu"})}


def _record(pkg, fn):
    """Run ``fn()`` with every solver run and every soft restoration
    recorded, in order: ("outer"/"nested", status, iterations) and
    ("soft", iteration, accepted)."""
    _, fi, _, _ = PKGS[pkg]
    log = []
    run, soft = fi.FilterIPMBase.run, fi.FilterIPMBase._solve_soft_fr

    def recorded(self):
        r = run(self)
        log.append(("nested" if getattr(self, "within_fr", False) else "outer",
                    r.status.name, r.iterations))
        return r

    def soft_recorded(self, *a, **k):
        out = soft(self, *a, **k)
        log.append(("soft", self.iter_num, out is not None))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fi.FilterIPMBase, "run", recorded)
        mp.setattr(fi.FilterIPMBase, "_solve_soft_fr", soft_recorded)
        r = fn()
    return r, log


def _nonlinear(ns, pkg, n=12):
    """A small problem with nonlinear equality and inequality constraints
    and bounds of every kind."""
    return pkg.AutoDiffNlpProblem(
        f=lambda x: 0.25 * ((x - 1.0) ** 4).sum() + x[0] * x[1],
        c=lambda x: ns.stack([(x ** 2).sum(), x[0] * x[1] + x[2], (x[3:] ** 3).sum()]),
        xl=np.r_[-1e20, 0.0, 0.5 * np.ones(n - 2)], xu=np.r_[1e20, 10.0, 5 * np.ones(n - 2)],
        cl=np.array([1.5 * n, -1e20, 2.0]), cu=np.array([1.5 * n, 4.0, 1e20]),
        x0=0.7 * np.ones(n))


def _infeasible(ns, pkg):
    """min |x|^2 s.t. |x|^2 <= 1 and x_1 + x_2 >= 3: no feasible point."""
    return pkg.AutoDiffNlpProblem(
        f=lambda x: (x ** 2).sum(),
        c=lambda x: ns.stack([(x ** 2).sum(), x[0] + x[1]]),
        xl=-1e20 * np.ones(2), xu=1e20 * np.ones(2),
        cl=np.array([-1e20, 3.0]), cu=np.array([1.0, 1e20]), x0=np.array([0.5, 0.2]))


@functools.lru_cache(maxsize=None)
def _problem(pkg_name, make):
    """One problem object per package and maker: ``hiop_tpu`` compiles
    its derivatives once per ``AutoDiffNlpProblem``, so the solves of a
    module share them."""
    pkg, _, ns, _ = PKGS[pkg_name]
    return make(ns, pkg)


def _solve(pkg_name, make, newton, **opts):
    pkg, _, _, extra = PKGS[pkg_name]
    o = pkg.NlpOptions()
    o.update(verbosity_level=0, **({"Hessian": "analytical_exact"} if newton else {}), **extra, **opts)
    cls = pkg.FilterIPMNewton if newton else pkg.FilterIPMQuasiNewton
    return _record(pkg_name, lambda: cls(pkg.NlpDenseConstraints(_problem(pkg_name, make), o)).run())


def _assert_same(t, j):
    (rt, lt), (rj, lj) = t, j
    assert rt.status.name == rj.status.name
    assert rt.iterations == rj.iterations
    assert lt == lj
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))


@pytest.mark.parametrize("newton", [False, True], ids=["quasi_newton", "newton"])
def test_forced_resto_nonlinear_matches_jax(newton):
    j = _solve("jax", _nonlinear, newton, force_resto="yes")
    t = _solve("torch", _nonlinear, newton, force_resto="yes")
    _assert_same(t, j)
    assert t[1] == [("nested", "User_Stopped", 1),
                    ("outer", "Solve_Success" if newton else "Solve_Acceptable_Level", 28 if newton else 31)]


def test_soft_fr_nonlinear_quasi_newton_matches_jax():
    runs = {}
    for pkg, fi in (("jax", jfi), ("torch", tfi)):
        with pytest.MonkeyPatch.context() as mp:
            iteration3_rejected(fi, mp)
            runs[pkg] = _solve(pkg, _nonlinear, False)
    _assert_same(runs["torch"], runs["jax"])
    rt, log = runs["torch"]
    assert rt.status.is_success
    assert log == [("soft", 3, True), ("outer", "Solve_Success", rt.iterations)]


def test_forced_resto_dense_ex1_quasi_newton_matches_jax():
    j = _record("jax", lambda: jax_ex1.solve(200, verbosity_level=0, force_resto="yes"))
    t = _record("torch", lambda: dense_ex1.solve(200, verbosity_level=0, force_resto="yes",
                                                 compute_mode="cpu"))
    _assert_same(t, j)
    assert t[0].status.is_success and [e[0] for e in t[1]] == ["nested", "outer"]


def test_forced_resto_dense_ex2_newton_matches_jax():
    (rj, lj), (rt, lt) = (_record(name, lambda pkg=pkg: _ex2_solve(pkg, 40, force_resto="yes"))
                          for name, pkg in (("jax", hiop_tpu), ("torch", hiop_tpu_torch)))
    (rj, ls_j), (rt, ls_t) = rj, rt
    assert rt.status.is_success and rt.status.name == rj.status.name
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))
    assert lt[0] == lj[0] == ("nested", "User_Stopped", 1)
    k = min(_first_noise_decision(ls_j["ls"]), _first_noise_decision(ls_t["ls"]))
    assert k >= 15   # measured: the first 18 tests are decided above the noise
    assert [e[0] for e in ls_t["ls"][:k]] == [e[0] for e in ls_j["ls"][:k]]


@pytest.mark.parametrize("newton", [True, False], ids=["newton", "quasi_newton"])
def test_infeasible_problem_matches_jax(newton):
    j = _solve("jax", _infeasible, newton)
    t = _solve("torch", _infeasible, newton)
    _assert_same(t, j)
    if newton:
        assert t[0].status.name == "Infeasible_Problem"
        assert t[1] == [("soft", 4, False), ("nested", "Solve_Success", 9),
                        ("outer", "Infeasible_Problem", 4)]
    else:
        assert t[0].status.name == "Steplength_Too_Small"
        assert t[1] == [("soft", 5, False), ("nested", "User_Stopped", 5),
                        ("soft", 8, False), ("nested", "Steplength_Too_Small", 21),
                        ("outer", "Steplength_Too_Small", 8)]


def test_nested_fr_solve_stays_on_the_base_device(monkeypatch):
    """The nested options carry the base's compute_mode (fresh options
    would resolve "auto" to cuda:0) and nothing else of the base's."""
    seen = []
    init = tfi.FilterIPMBase.__init__

    def spy(self, nlp):
        init(self, nlp)
        seen.append((nlp.device, nlp.options.str_("compute_mode"), nlp.options.str_("kkt_fact_dtype")))

    monkeypatch.setattr(tfi.FilterIPMBase, "__init__", spy)
    r = dense_ex2.solve_newton(40, verbosity_level=0, compute_mode="cpu", force_resto="yes",
                               kkt_fact_dtype="float32")
    assert r.status.is_success
    assert [s[:2] for s in seen] == [(torch.device("cpu"), "cpu")] * 2
    assert [s[2] for s in seen] == ["float32", "float64"]


def test_chip_smoke_fr_log_records_a_restoration():
    """The chip script's restoration log on a CPU solve: the nested solve
    (its iterations, status, acceptance), the nested factorizations and the
    LSQ solves, so that a fault in it shows here and not first on the card."""
    import chip_smoke
    from hiop_tpu_torch.linalg import kernels as K

    with chip_smoke._fr_log(torch, tfi, K) as log:
        r = dense_ex2.solve_newton(40, verbosity_level=0, compute_mode="cpu", force_resto="yes")
    assert r.status.is_success
    (full,) = log["full"]
    assert (full["iteration"], full["nested_iterations"], full["status"], full["accepted"]) == \
        (1, 1, "User_Stopped", True)
    assert full["launches"] == {} and log["soft"] == [] and log["matfree"] == []
    assert log["nested_fact"] == ["quick-f64"]
    assert tfi.fr_mod.apply_feasibility_restoration.__name__ == "apply_feasibility_restoration"
