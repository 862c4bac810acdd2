"""The port's robustness surface against the JAX package, on the CPU:
checkpoints, ``write_kkt``, ``deepchecks``, ``elastic_mode`` and
``fixed_var=remove``.

- **Checkpoints** (``utils/checkpoint.py``, ``hiop_tpu``'s npz format): a
  file round trip; a solve that saves every 2 iterations and stops at 5,
  then a solve that resumes from the file, reaches the uninterrupted
  solve's final iterate (the same bits on mds_ex1 under Newton; under
  quasi-Newton the checkpoint holds the L-BFGS memory but not the previous
  point, so the first resumed iteration skips one secant update in both
  packages, and the objective agrees to 1e-8). Across packages, on mds_ex1
  (Newton) and DenseConsEx1 (quasi-Newton, with the BFGS fields): the
  files have the same keys and shapes, a checkpoint written by
  ``hiop_tpu`` resumes in the port and one written by the port resumes in
  ``hiop_tpu``, and both continuations of each file give the same status,
  iteration count and objective to 1e-8.
- **write_kkt**: the same files and keys as ``hiop_tpu``'s, arrays to 1e-10
  relative, over 3 iterations of mds_ex1 and of a problem with nonlinear
  constraints under exact Newton (whose dump holds the Hessian; with
  linear constraints the residual ryc would be cancellation noise).
- **deepchecks**: the same result as without it, and its warning on a
  direction made non-finite by a monkeypatch, in both packages.
- **soft restoration** on mds_ex1, forced as in ``tests/test_torch_fr.py``
  (every trial of iteration 3 rejected): the same soft/full sequence,
  status, iterations and objective as ``hiop_tpu``.
- **elastic_mode**: each value (and both bound strategies) on mds_ex1:
  the same status, iterations and objective as ``hiop_tpu``.
- **fixed_var=remove** on DenseConsEx3 (n=100, 26 fixed variables): the
  reduced problem's data against ``hiop_tpu``'s; the solve against
  ``hiop_tpu``'s and against ``fixed_var=relax``. DenseConsEx3's
  constraints are linear and its theta falls to rounding noise (0 in one
  package, 6e-14 in the other at iteration 10); the second-order
  correction's test ``theta_curr <= theta_trial`` then decides on that
  noise and the two packages part at iteration 12 (measured: the port ends
  in Solve_Acceptable_Level after 17 iterations, ``hiop_tpu`` in
  Solve_Success after 18, objectives 1.3e-13 apart). So the line-search
  outcomes must be the same up to the first that differs, and that one
  must be a test between noise-level thetas; and the objective to 1e-8.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch
from threadpoolctl import threadpool_limits

import examples.dense_ex1 as jax_ex1
import examples.dense_ex3 as jax_ex3
import examples.mds_ex1 as jax_mds_ex1
import hiop_tpu.optimization.filter_ipm as jfi
import hiop_tpu_torch.optimization.filter_ipm as tfi
from hiop_tpu.formulation.transforms import FixedVarsRemover as JaxRemover
from hiop_tpu_torch import NlpDenseConstraints, NlpOptions
from hiop_tpu_torch.examples import dense_ex1, dense_ex3, mds_ex1
from hiop_tpu_torch.formulation.transforms import FixedVarsRemover
from hiop_tpu_torch.utils import checkpoint as ckpt
from test_torch_fr import iteration3_rejected
from test_torch_fr_dense import _nonlinear, _record, _solve

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

def _quiet(o):
    return {"verbosity_level": 0, **o}


SOLVES = {
    "mds": {"jax": lambda **o: jax_mds_ex1.solve(40, 20, **_quiet(o)),
            "torch": lambda **o: mds_ex1.solve(40, 20, compute_mode="cpu", **_quiet(o))},
    "qn": {"jax": lambda **o: jax_ex1.solve(200, **_quiet(o)),
           "torch": lambda **o: dense_ex1.solve(200, compute_mode="cpu", **_quiet(o))},
}


def _same_solve(rt, rj):
    assert rt.status.name == rj.status.name
    assert rt.iterations == rj.iterations
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_file(tmp_path):
    state = {
        "n": 5, "m_eq": 1, "m_ineq": 2, "mu": 0.1, "iter_num": 7,
        "theta_max": 10.0, "theta_min": 1e-4,
        "filter_entries": [(1.0, 2.0), (0.5, float("-inf"))],
        "it_x": np.arange(5.0),
    }
    path = str(tmp_path / "chk.npz")
    ckpt.save_state(path, state)
    loaded = ckpt.load_state(path)
    assert loaded["iter_num"] == 7 and loaded["mu"] == 0.1
    assert np.array_equal(loaded["it_x"], np.arange(5.0))
    assert loaded["filter_entries"] == [(1.0, 2.0), (0.5, float("-inf"))]
    ckpt.validate(loaded, 5, 1, 2)
    with pytest.raises(ValueError):
        ckpt.validate(loaded, 6, 1, 2)
    # checkpoint_format=orbax: a torch.distributed.checkpoint directory
    # with the same keys, read back the same (an empty array included)
    state["it_yd"] = np.zeros(0)
    ckpt.save_state(str(tmp_path / "orbax"), state, fmt="orbax")
    assert os.path.isdir(tmp_path / "orbax")
    from_dir = ckpt.load_state(str(tmp_path / "orbax"))
    assert set(from_dir) == set(state)
    assert from_dir["iter_num"] == 7 and from_dir["mu"] == 0.1
    assert np.array_equal(from_dir["it_x"], np.arange(5.0))
    assert from_dir["it_yd"].shape == (0,) and from_dir["it_yd"].dtype == np.float64
    assert from_dir["filter_entries"] == [(1.0, 2.0), (0.5, float("-inf"))]


def _write_checkpoint(pkg, case, path):
    return SOLVES[case][pkg](max_iter=5, checkpoint_save="yes", checkpoint_save_every_N_iter=2,
                             checkpoint_file=path)


def _resume(pkg, case, path):
    return SOLVES[case][pkg](checkpoint_load_on_start="yes", checkpoint_file=path)


@pytest.mark.parametrize("case", ["mds", "qn"])
def test_checkpoint_save_every_2_then_resume(case, tmp_path):
    path = str(tmp_path / "state.npz")
    full = SOLVES[case]["torch"]()
    part = _write_checkpoint("torch", case, path)
    assert part.iterations == 5 and os.path.exists(path)
    assert ckpt.load_state(path)["iter_num"] == 4
    resumed = _resume("torch", case, path)
    assert resumed.status.name == full.status.name and resumed.status.is_success
    # the counter restarts at the checkpoint (hiop_tpu's loop resets it)
    assert resumed.iterations + 4 == full.iterations
    if case == "mds":
        assert resumed.obj == full.obj and np.array_equal(resumed.x, full.x)
    else:
        assert abs(resumed.obj - full.obj) <= 1e-8 * max(1.0, abs(full.obj))
        assert np.abs(resumed.x - full.x).max() <= 1e-6


@pytest.fixture(scope="module")
def cross_checkpoints(tmp_path_factory):
    """Per case: the checkpoint each package writes, and hiop_tpu's
    continuation of each."""
    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    for case in SOLVES:
        files = {pkg: str(d / f"{pkg}_{case}.npz") for pkg in ("jax", "torch")}
        for pkg, path in files.items():
            _write_checkpoint(pkg, case, path)
        out[case] = dict(files=files, jax_resumes={pkg: _resume("jax", case, files[pkg])
                                                   for pkg in files})
    return out


@pytest.mark.parametrize("case", ["mds", "qn"])
def test_checkpoints_resume_across_packages(cross_checkpoints, case):
    c = cross_checkpoints[case]
    with np.load(c["files"]["jax"]) as zj, np.load(c["files"]["torch"]) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].shape == zt[k].shape and zj[k].dtype == zt[k].dtype, k
            if zj[k].dtype.kind == "f" and zj[k].size:
                a, b = zt[k], zj[k]
                finite = np.isfinite(b)
                assert np.array_equal(np.isfinite(a), finite), k
                assert np.abs(a[finite] - b[finite]).max(initial=0.0) <= 1e-10 * max(
                    1.0, np.abs(b[finite]).max(initial=0.0)), k
        if case == "qn":
            assert {"array__bfgs_S", "array__bfgs_Y", "array__bfgs_active",
                    "scalar__bfgs_sigma"} <= set(zt.files)
    for writer in ("jax", "torch"):
        rt = _resume("torch", case, c["files"][writer])
        rj = c["jax_resumes"][writer]
        assert rt.status.is_success
        _same_solve(rt, rj)


# ---------------------------------------------------------------------------
# write_kkt and deepchecks
# ---------------------------------------------------------------------------
def _dumps(pkg, case, directory, monkeypatch):
    monkeypatch.chdir(directory)
    if case == "mds":
        SOLVES["mds"][pkg](write_kkt="yes", max_iter=3)
    else:
        _solve(pkg, _nonlinear, True, write_kkt="yes", max_iter=3)
    return {os.path.basename(f): dict(np.load(f)) for f in sorted(glob.glob("*.npz"))}


@pytest.mark.parametrize("case", ["mds", "dense_newton"])
def test_write_kkt_matches_jax(case, tmp_path, monkeypatch):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    dj = _dumps("jax", case, tmp_path / "jax", monkeypatch)
    dt = _dumps("torch", case, tmp_path / "torch", monkeypatch)
    assert sorted(dt) == sorted(dj) == [f"hiop_tpu_kkt_iter{i}.npz" for i in range(3)]
    for name in dj:
        assert sorted(dt[name]) == sorted(dj[name])
        assert ("H" in dt[name]) == (case == "dense_newton")
        for k, b in dj[name].items():
            a = dt[name][k]
            assert a.shape == b.shape, (name, k)
            assert np.abs(a - b).max(initial=0.0) <= 1e-10 * max(1.0, np.abs(b).max(initial=0.0)), (name, k)


def _corrupted_deepchecks(fi, mp):
    """Hand ``_deepchecks`` a copy of each direction with a NaN in x (the
    solve itself goes on with the true direction)."""
    check = fi.FilterIPMBase._deepchecks

    def corrupted(self, it_curr, dir_, b):
        x = dir_.x * 1.0
        x[0] = float("nan")
        return check(self, it_curr, dir_._replace(x=x), b)

    def corrupted_jax(self, it_curr, dir_, b):
        return check(self, it_curr, dir_._replace(x=dir_.x.at[0].set(jnp.nan)), b)

    mp.setattr(fi.FilterIPMBase, "_deepchecks", corrupted if fi is tfi else corrupted_jax)


def test_deepchecks_matches_jax(capsys, monkeypatch):
    plain = SOLVES["mds"]["torch"]()
    checked = SOLVES["mds"]["torch"](deepchecks="yes")
    assert checked.obj == plain.obj and np.array_equal(checked.x, plain.x)
    _same_solve(checked, SOLVES["mds"]["jax"](deepchecks="yes"))
    capsys.readouterr()
    warnings = {}
    for pkg, fi in (("jax", jfi), ("torch", tfi)):
        with monkeypatch.context() as mp:
            _corrupted_deepchecks(fi, mp)
            r = SOLVES["mds"][pkg](deepchecks="yes", verbosity_level=1)
        warnings[pkg] = [line for line in capsys.readouterr().out.splitlines() if "deepchecks" in line]
        assert r.status.is_success
    assert warnings["torch"] == warnings["jax"]
    assert warnings["torch"] == ["deepchecks: non-finite entries in direction x"] * plain.iterations


def test_soft_fr_mds_ex1_matches_jax():
    runs = {}
    for pkg, fi in (("jax", jfi), ("torch", tfi)):
        with pytest.MonkeyPatch.context() as mp:
            iteration3_rejected(fi, mp)
            runs[pkg] = _record(pkg, SOLVES["mds"][pkg])
    (rt, lt), (rj, lj) = runs["torch"], runs["jax"]
    _same_solve(rt, rj)
    assert lt == lj == [("soft", 3, True), ("outer", "Solve_Success", rt.iterations)]


# ---------------------------------------------------------------------------
# elastic mode
# ---------------------------------------------------------------------------
ELASTIC = [("tighten_bound", "mu_projected"), ("tighten_bound", "mu_scaled"),
           ("correct_it", "mu_projected"), ("correct_it", "mu_scaled"),
           ("correct_it_adjust_bound", "mu_projected")]


@pytest.mark.parametrize("mode,strategy", ELASTIC)
def test_elastic_mode_matches_jax(mode, strategy):
    opts = dict(elastic_mode=mode, elastic_bound_strategy=strategy)
    rt = SOLVES["mds"]["torch"](**opts)
    rj = SOLVES["mds"]["jax"](**opts)
    assert rt.status.is_success
    _same_solve(rt, rj)
    assert rt.obj != SOLVES["mds"]["torch"]().obj   # the bounds did move


# ---------------------------------------------------------------------------
# fixed_var=remove
# ---------------------------------------------------------------------------
def test_fixed_vars_remover_maps_match_jax():
    n = 40
    pj, pt = jax_ex3.DenseConsEx3(n), dense_ex3.DenseConsEx3(n)
    xl, xu = (np.asarray(a) for a in pt.get_vars_info())
    fixed = (xu - xl) <= 1e-15 * np.maximum(1.0, np.abs(xu))
    vals = 0.5 * (xl + xu)
    wj, wt = JaxRemover(pj, fixed, vals), FixedVarsRemover(pt, fixed, vals)
    assert wt.get_prob_sizes() == wj.get_prob_sizes() == (n - int(fixed.sum()), 2)
    for a, b in zip(wt.get_vars_info() + wt.get_cons_info(), wj.get_vars_info() + wj.get_cons_info()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(wt.get_starting_point(), wj.get_starting_point())
    z = np.random.default_rng(3).uniform(0.5, 2.0, wt.n_red)
    zt, zj = torch.from_numpy(z), jnp.asarray(z)
    xf = wt.expand(zt)
    np.testing.assert_array_equal(xf.numpy(), np.asarray(wj.expand(zj)))
    np.testing.assert_array_equal(xf.numpy()[fixed], vals[fixed])
    np.testing.assert_array_equal(wt.restrict(xf).numpy(), z)
    np.testing.assert_array_equal(wt.restrict(xf.numpy()).numpy(), z)
    for name in ("eval_f", "eval_grad_f", "eval_cons", "eval_jac_cons"):
        a, b = getattr(wt, name)(zt), getattr(wj, name)(zj)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-14, atol=1e-14)


def _recorded_ex3(pkg, fixed_var, n=100):
    fi = jfi if pkg == "jax" else tfi
    log, full_x = [], []
    accept = fi.FilterIPMBase._accept_line_search_conditions

    def tested(self, theta_curr, theta_trial, *a):
        out = accept(self, theta_curr, theta_trial, *a)
        log.append((out, float(theta_curr), float(theta_trial)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fi.FilterIPMBase, "_accept_line_search_conditions", tested)
        if pkg == "jax":
            r = jax_ex3.solve(n, fixed_var=fixed_var, verbosity_level=0)
        else:
            p = dense_ex3.DenseConsEx3(n)
            p.solution_callback = lambda status, x, *a: full_x.append(x)
            o = NlpOptions()
            o.update(fixed_var=fixed_var, verbosity_level=0, compute_mode="cpu")
            r = tfi.FilterIPMQuasiNewton(NlpDenseConstraints(p, o)).run()
    return r, log, full_x


#: theta at or below this is rounding noise of DenseConsEx3's linear constraints
THETA_NOISE = 1e-12


def test_fixed_var_remove_matches_jax_and_relax():
    rj, lj, _ = _recorded_ex3("jax", "remove")
    rt, lt, full_x = _recorded_ex3("torch", "remove")
    relax, _, _ = _recorded_ex3("torch", "relax")
    assert rt.status.is_success and rj.status.is_success
    # the reduced primal vector, as hiop_tpu reports it; the solution
    # callback sees the full-space point with the fixed values in place
    assert rt.x.shape == rj.x.shape == (74,)
    (x_full,) = full_x
    xl, xu = dense_ex3.DenseConsEx3(100).get_vars_info()
    fixed = xl == xu
    assert x_full.shape == (100,) and int(fixed.sum()) == 26
    np.testing.assert_array_equal(x_full.numpy()[~fixed], rt.x)
    np.testing.assert_array_equal(x_full.numpy()[fixed], xl[fixed])
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))
    assert abs(rt.obj - relax.obj) <= 1e-6 * max(1.0, abs(relax.obj))
    # the packages may part only at a test between noise-level thetas
    k = next((i for i, (e_t, e_j) in enumerate(zip(lt, lj)) if e_t[0] != e_j[0]),
             min(len(lt), len(lj)))
    if k < min(len(lt), len(lj)):
        assert max(lt[k][1:] + lj[k][1:]) <= THETA_NOISE
        assert k >= 10
    else:
        assert (rt.iterations, rt.status.name) == (rj.iterations, rj.status.name)
