"""The port's main path end to end against the JAX package, on the CPU,
and the port's package contract.

Parity: the same problem through ``hiop_tpu`` and ``hiop_tpu_torch`` (both
f64) gives the same status, the same iteration count, and the objective to
1e-8 relative. The regularization ladder's decisions are discrete, so a
different iteration count is a fault, not noise. The ACOPF runs here hold
the dense safe tiers to each other, so both packages have their native
sparse LDL^T library switched off (no ``schur_sparse_ldl`` tier); with the
libraries on, ``tests/test_torch_native.py`` holds the native tier.
"""

import os
import subprocess
import sys

import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch
from threadpoolctl import threadpool_limits

import examples.acopf_mds as jax_acopf
import examples.mds_ex1 as jax_ex1
import hiop_tpu.native.ldl as jax_native_ldl
import hiop_tpu_torch.native.ldl as torch_native_ldl
from hiop_tpu_torch import FilterIPMNewton, FilterIPMQuasiNewton, NlpDenseConstraints, NlpMDS, NlpOptions
from hiop_tpu_torch.examples import acopf_mds, mds_ex1
from hiop_tpu_torch.formulation.base import NlpFormulation
from hiop_tpu_torch.linalg import ldl_blocked

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_solve(rt, rj):
    assert rt.status == rj.status or rt.status.name == rj.status.name
    assert rt.iterations == rj.iterations
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))


def test_mds_ex1_matches_jax():
    rj = jax_ex1.solve(40, 20, verbosity_level=0)
    rt = mds_ex1.solve(40, 20, verbosity_level=0, compute_mode="cpu")
    assert rt.status.is_success
    _assert_same_solve(rt, rj)


def test_acopf16_ldl_nopiv_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_native_ldl, "native_available", lambda: False)
    monkeypatch.setattr(torch_native_ldl, "native_available", lambda: False)
    opts = dict(verbosity_level=0, linear_solver_dense="ldl_nopiv")
    rj = jax_acopf.solve(16, **opts)

    calls = []
    plain = ldl_blocked.ldl_nopiv

    def counted(A):
        calls.append(A.shape[0])
        return plain(A)

    monkeypatch.setattr(ldl_blocked, "ldl_nopiv", counted)
    rt = acopf_mds.solve(16, compute_mode="cpu", **opts)
    assert rt.status.is_success
    _assert_same_solve(rt, rj)
    assert calls and set(calls) == {256}   # the 148 x 148 saddle, padded


def test_imports_load_neither_jax_nor_hiop_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hiop_tpu_torch, chip_smoke, chip_measure\n"
        "import hiop_tpu_torch.native, hiop_tpu_torch.native.ldl\n"
        "for m in pkgutil.walk_packages(hiop_tpu_torch.__path__, 'hiop_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'hiop_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules if m.startswith('hiop_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FilterIPMNewton(NlpMDS(mds_ex1.MdsEx1(8, 4), NlpOptions())).run()


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """With no card visible the script exits nonzero and prints no result;
    alone in a directory, without the package, it does the same."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for script, cwd in ((os.path.join(ROOT, "chip_smoke.py"), ROOT), (str(alone), str(tmp_path))):
        out = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                             text=True, timeout=120, env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


#: (options, formulation attributes, what the message names): the fused
#: state of a parametric problem (batch_solve's: its family runs through
#: solve_batched, as in hiop_tpu). Every option is ported: a mesh-sharded
#: fused state and checkpoint_format=orbax in tests/test_torch_mesh.py and
#: tests/test_torch_multiprocess.py, profile_dir in tests/test_torch_surface.py
UNPORTED = [
    (dict(jit_mode="solve"), dict(parametric=True), "batch_solve.solve_batched"),
]


@pytest.mark.parametrize("opts,attrs,item", UNPORTED, ids=["parametric_fused_state"])
def test_unported_options_raise(opts, attrs, item):
    o = NlpOptions()
    o.update(compute_mode="cpu", verbosity_level=0, **opts)
    if "_mesh" in attrs:
        from hiop_tpu_torch.examples import dense_ex1

        nlp = NlpDenseConstraints(dense_ex1.DenseConsEx1(20), o)
        solver_cls = FilterIPMQuasiNewton
    else:
        nlp = NlpMDS(mds_ex1.MdsEx1(8, 4), o)
        solver_cls = FilterIPMNewton
    solver = solver_cls(nlp)
    for k, v in attrs.items():
        setattr(nlp, k, v)
    with pytest.raises(NotImplementedError, match=item):
        solver.run()


def test_unported_solvers_and_formulations_raise():
    o = NlpOptions()
    o.update(compute_mode="cpu", verbosity_level=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FilterIPMNewton(NlpFormulation(mds_ex1.MdsEx1(8, 4), o)).run()


def test_restoration_over_an_unported_formulation_raises():
    """Feasibility restoration keeps the base's structure class; a base
    that is neither MDS, dense-constrained nor sparse (here the bare
    formulation base class) raises naming the three classes there are."""
    from types import SimpleNamespace

    from hiop_tpu_torch.optimization.fr_problem import apply_feasibility_restoration

    o = NlpOptions()
    o.update(compute_mode="cpu", verbosity_level=0)
    base = NlpFormulation(mds_ex1.MdsEx1(8, 4), o)
    solver = SimpleNamespace(nlp=base, filter=None, log=base.log)
    with pytest.raises(NotImplementedError, match="NlpDenseConstraints, NlpMDS and NlpSparse"):
        apply_feasibility_restoration(solver, None, 0.1, SimpleNamespace(nlp_feasib=1.0))


@pytest.mark.slow
def test_acopf512_card_ladder_first_iterations_match_jax(monkeypatch):
    """Full width on the CPU, with the ladder the card builds (device LDL^T,
    then host LU + eigen inertia): in 10 iterations both packages escalate
    through the same tiers, in the same order, and reach the same iterate
    (a few minutes)."""
    import hiop_tpu.backends.execspace as jax_execspace
    import hiop_tpu.kkt.mds as jax_kkt_mds
    import hiop_tpu_torch.kkt.mds as torch_kkt_mds
    import hiop_tpu_torch.optimization.filter_ipm as torch_filter_ipm

    monkeypatch.setattr(jax_native_ldl, "native_available", lambda: False)
    monkeypatch.setattr(torch_native_ldl, "native_available", lambda: False)
    monkeypatch.setattr(jax_execspace, "on_accelerator", lambda *a: True)
    monkeypatch.setattr(torch_filter_ipm, "on_accelerator", lambda *a: True)
    tiers = {"jax": [], "torch": []}
    for name, mod in (("jax", jax_kkt_mds), ("torch", torch_kkt_mds)):
        def recorded(*a, _f=mod.factorize_safe, _log=tiers[name], host=False, **k):
            if not _log or _log[-1] != host:
                _log.append(host)
            return _f(*a, host=host, **k)

        monkeypatch.setattr(mod, "factorize_safe", recorded)
    opts = dict(verbosity_level=0, linear_solver_dense="auto", max_iter=10)
    rj = jax_acopf.solve(512, **opts)
    rt = acopf_mds.solve(512, compute_mode="cpu", **opts)
    _assert_same_solve(rt, rj)
    assert tiers["torch"] == tiers["jax"] == [False, True]
