"""The port's variable-axis mesh (``hiop_tpu_torch.parallel.mesh``) against
the JAX package, on the CPU.

Counterpart of tests/test_sharding.py. ``hiop_tpu`` shards over 8 virtual
devices of one process; a torch rank is one device, so here two gloo ranks
are launched once for the module (``parallel.multiprocess.launch``,
tests/torch_mp_worker.py ``mesh``) and run every case on one 2-rank mesh
while the JAX and single-process references run in this process. The
ranks take away DTensor's rules for ``linalg_cholesky_ex``,
``cholesky_solve`` and ``index_put(_)`` (torch 2.11 lacks the first and
the third), so every case also shows that the solver runs those on each
rank's replica at its named sites and nowhere else.

- DenseConsEx1 n=512 (QN): iterations equal to the port's and
  ``hiop_tpu``'s single runs, objective to 1e-9 relative; the iterate
  handed to the solution callback is still an n-sharded DTensor.
- DenseConsEx2 n=512: objective to 1e-7 (its first iterate reaches 1e10,
  and the constraint sums then round with the order of the partial sums,
  as in ``hiop_tpu``'s test, which checks the objective alone).
- ``jit_mode=iteration`` sharded QN: 8.6157e-02 within 1e-5, and the
  iterations and objective (to 1e-9) of the port's and ``hiop_tpu``'s
  single ``jit_mode=iteration`` runs.
- pad-and-mask, n=509 (QN) and n=13 (dense Newton, identity pad block),
  each padded to a multiple of 2: iterations, objective to 1e-9, the
  result trimmed to the user's n and x to 1e-8.
- ACOPF B=16 under MDS Newton: iterations equal, objective to 1e-10.
- ``schur_js_triplets_sharded`` over the 2 ranks against ``hiop_tpu``'s on
  its 8-device mesh and against the port's ``schur_js_triplets``, to 1e-12.
- the allreduce ladder at base 1024, 2 sizes, 2 repetitions.
- each of the four operations on a DTensor outside the solver's sites
  raises (no operation is replicated quietly).
- PriDec's batched scenario axis split over two CPU devices
  (``_eval_recourse_sharded``) against the unsplit sums, and a whole
  PriDec Ex1 solve split so against the unsplit one.
"""

import concurrent.futures
import json
import os
import tempfile

import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch
from threadpoolctl import threadpool_limits

import examples.dense_ex1 as jax_ex1
import examples.dense_ex2 as jax_ex2
from hiop_tpu_torch.parallel.multiprocess import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mp_worker.py")
LAUNCH_TIMEOUT_S = 240

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(limits=1):
        yield


def launch_suite(suite: str, num_processes: int):
    """Start the suite's ranks in a thread; returns a future of
    {case: [per-rank result dict]}."""

    def run():
        with tempfile.TemporaryDirectory() as tmp:
            results = launch([WORKER, suite], num_processes=num_processes, platform="cpu",
                             timeout=LAUNCH_TIMEOUT_S, extra_env={"HIOP_TPU_MP_TMP": tmp}, cwd=ROOT)
        cases = {}
        for r in results:
            for line in r.stdout.splitlines():
                if line.startswith("{"):
                    d = json.loads(line)
                    cases.setdefault(d["case"], []).append(d)
        return cases

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(run)
    pool.shutdown(wait=False)
    return fut


def case_result(ranks, name, n_ranks):
    """The case's result, the same on every rank that ran it (waits for
    the ranks: call it after the references are computed)."""
    got = ranks.result()[name]
    for d in got:
        assert "error" not in d, d["error"]
    assert len(got) == n_ranks
    first = {k: v for k, v in got[0].items() if k not in ("rank", "seconds", "rungs")}
    for d in got[1:]:
        assert {k: v for k, v in d.items() if k not in ("rank", "seconds", "rungs")} == first
    return got[0]


@pytest.fixture(scope="module", autouse=True)
def ranks():
    """The future of the ranks' results, launched before any test so that
    the ranks run while the references are computed."""
    return launch_suite("mesh", 2)


def _jax_qn(prob, **opts):
    from hiop_tpu import FilterIPMQuasiNewton, NlpDenseConstraints, NlpOptions

    o = NlpOptions()
    o.update(verbosity_level=0, **opts)
    return FilterIPMQuasiNewton(NlpDenseConstraints(prob, o)).run()


def _port_qn(prob, **opts):
    from hiop_tpu_torch import FilterIPMQuasiNewton, NlpDenseConstraints, NlpOptions

    o = NlpOptions()
    o.update(verbosity_level=0, compute_mode="cpu", **opts)
    return FilterIPMQuasiNewton(NlpDenseConstraints(prob, o)).run()


def _close(a, b, rel):
    return abs(a - b) <= rel * (1 + abs(b))


def test_dense_ex1_sharded_matches_single(ranks):
    from hiop_tpu_torch.examples import dense_ex1

    rj, rt = _jax_qn(jax_ex1.DenseConsEx1(512)), _port_qn(dense_ex1.DenseConsEx1(512))
    r = case_result(ranks, "dense_ex1", 2)
    assert r["status"] == "Solve_Success"
    assert r["iterations"] == rt.iterations == rj.iterations
    assert _close(r["obj"], rt.obj, 1e-9) and _close(r["obj"], rj.obj, 1e-9)


def test_dense_ex2_sharded_matches_single(ranks):
    from hiop_tpu_torch.examples import dense_ex2
    from hiop_tpu_torch.status import SolveStatus

    rj, rt = _jax_qn(jax_ex2.DenseConsEx2(512)), _port_qn(dense_ex2.DenseConsEx2(512))
    r = case_result(ranks, "dense_ex2", 2)
    assert SolveStatus[r["status"]].is_success
    assert _close(r["obj"], rt.obj, 1e-7) and _close(r["obj"], rj.obj, 1e-7)


def test_sharded_iterate_stays_sharded(ranks):
    """The x-sized leaves stay n-sharded through the solve (no gather):
    the final iterate is a DTensor holding half of n on each rank."""
    r = case_result(ranks, "dense_ex1", 2)
    assert r["x_type"] == "DTensor"
    assert r["placements"] == ["S(0)"] and r["local_shape"] == [256]


def test_fused_qn_sharded_mesh(ranks):
    from hiop_tpu_torch.examples import dense_ex1

    rj = _jax_qn(jax_ex1.DenseConsEx1(512), jit_mode="iteration")
    rt = _port_qn(dense_ex1.DenseConsEx1(512), jit_mode="iteration")
    r = case_result(ranks, "jit_iteration", 2)
    assert r["status"] == "Solve_Success"
    assert abs(r["obj"] - 8.6157e-02) < 1e-5
    assert r["iterations"] == rt.iterations == rj.iterations
    assert _close(r["obj"], rt.obj, 1e-9) and _close(r["obj"], rj.obj, 1e-9)


def test_sharded_pad_and_mask_uneven_n(ranks):
    from hiop_tpu_torch.examples import dense_ex1

    rj, rt = _jax_qn(jax_ex1.DenseConsEx1(509)), _port_qn(dense_ex1.DenseConsEx1(509))
    r = case_result(ranks, "pad_509", 2)
    assert r["status"] == "Solve_Success"
    assert r["iterations"] == rt.iterations == rj.iterations
    assert _close(r["obj"], rt.obj, 1e-9) and _close(r["obj"], rj.obj, 1e-9)
    x = np.asarray(r["x"])
    assert x.shape == (509,)  # trimmed back to the user's n
    np.testing.assert_allclose(x, rt.x, atol=1e-8)
    np.testing.assert_allclose(x, rj.x, atol=1e-8)


def test_sharded_newton_pad_uneven_n(ranks):
    """Exact Newton on an auto-padded n=13 over 2 ranks: the padded
    problem's identity pad block keeps the pad variables inert."""
    import jax.numpy as jnp
    from hiop_tpu import AutoDiffNlpProblem as JaxAutoDiff, FilterIPMNewton as JaxNewton
    from hiop_tpu import NlpDenseConstraints as JaxDense, NlpOptions as JaxOptions
    from hiop_tpu_torch import AutoDiffNlpProblem, FilterIPMNewton, NlpDenseConstraints, NlpOptions

    n = 13
    box = dict(xl=np.full(n, -3.0), xu=np.full(n, 3.0), cl=np.array([1.0]), cu=np.array([4.0]),
               x0=np.full(n, 0.2))
    oj = JaxOptions()
    oj.update(verbosity_level=0, Hessian="analytical_exact")
    rj = JaxNewton(JaxDense(JaxAutoDiff(
        f=lambda x: jnp.sum((x - 0.7) ** 2) + 0.05 * jnp.sum(x**4),
        c=lambda x: jnp.stack([jnp.sum(x)]), **box), oj)).run()
    ot = NlpOptions()
    ot.update(verbosity_level=0, Hessian="analytical_exact", compute_mode="cpu")
    rt = FilterIPMNewton(NlpDenseConstraints(AutoDiffNlpProblem(
        f=lambda x: torch.sum((x - 0.7) ** 2) + 0.05 * torch.sum(x**4),
        c=lambda x: torch.stack([torch.sum(x)]), **box), ot)).run()
    r = case_result(ranks, "newton_pad", 2)
    assert r["status"] == "Solve_Success"
    assert r["iterations"] == rt.iterations == rj.iterations
    assert _close(r["obj"], rt.obj, 1e-9) and _close(r["obj"], rj.obj, 1e-9)
    x = np.asarray(r["x"])
    assert x.shape == (n,)
    np.testing.assert_allclose(x, rt.x, atol=1e-8)
    np.testing.assert_allclose(x, rj.x, atol=1e-8)


def test_sharded_mds_newton_acopf_matches_single(ranks):
    import examples.acopf_mds as jax_acopf
    from hiop_tpu import FilterIPMNewton as JaxNewton, NlpMDS as JaxMDS, NlpOptions as JaxOptions
    from hiop_tpu_torch import FilterIPMNewton, NlpMDS, NlpOptions
    from hiop_tpu_torch.examples import acopf_mds

    opts = dict(Hessian="analytical_exact", fixed_var="relax", tolerance=1e-6, mu0=0.1,
                verbosity_level=0)
    oj = JaxOptions()
    oj.update(**opts)
    rj = JaxNewton(JaxMDS(jax_acopf.AcopfMds(16), oj)).run()
    ot = NlpOptions()
    ot.update(compute_mode="cpu", **opts)
    rt = FilterIPMNewton(NlpMDS(acopf_mds.AcopfMds(16), ot)).run()
    r = case_result(ranks, "acopf16", 2)
    assert r["status"] == "Solve_Success"
    assert r["iterations"] == rt.iterations == rj.iterations
    assert abs(r["obj"] - rt.obj) < 1e-10 and abs(r["obj"] - rj.obj) < 1e-10


def test_sharded_schur_assembly_matches(ranks):
    """The pair list partitioned over 2 ranks, the partial scatters summed
    by one all-reduce: the same matrix as hiop_tpu's 8-device assembly and
    the port's single-device one, replicated on every rank."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from hiop_tpu.kkt import mds as jax_kkt_mds
    from hiop_tpu_torch.kkt import mds as kkt_mds
    from torch_mp_worker import schur_case

    m, ns, rows, cols, vals, ksinv = schur_case()
    jpairs = jax_kkt_mds.build_schur_pairs(rows, cols, ns)
    S_jax = np.asarray(jax_kkt_mds.schur_js_triplets_sharded(
        jnp.asarray(vals), jnp.asarray(ksinv), jpairs, m, Mesh(np.array(jax.devices()), ("x",))))
    S_port = kkt_mds.schur_js_triplets(torch.as_tensor(vals), torch.as_tensor(ksinv),
                                       kkt_mds.build_schur_pairs(rows, cols, ns), m).numpy()
    r = case_result(ranks, "schur_sharded", 2)
    assert r["placements"] == ["R"]
    S = np.asarray(r["S"])
    scale = np.abs(S_port).max()
    assert np.abs(S - S_jax).max() <= 1e-12 * scale
    assert np.abs(S - S_port).max() <= 1e-12 * scale


def test_allreduce_ladder_runs(ranks):
    got = ranks.result()["ladder"]
    assert len(got) == 2 and all("error" not in d for d in got)
    for d in got:
        assert [c for c, _ in d["rungs"]] == [1024, 2048]
        assert all(dt > 0 for _, dt in d["rungs"])


def test_op_without_a_sharding_rule_raises(ranks):
    """No generic fallback: an operation DTensor has no rule for raises
    outside the solver's named replica sites."""
    from torch_mp_worker import NO_RULE_OPS

    r = case_result(ranks, "no_rule_raises", 2)
    assert r["raised"] == {name: True for name in NO_RULE_OPS}


def _pridec_ex1(nx, S, devices=None, **opts):
    import hiop_tpu_torch
    from hiop_tpu_torch.examples import pridec_ex1

    o = hiop_tpu_torch.PriDecOptions()
    o.update(verbosity_level=0, **opts)
    return hiop_tpu_torch.PriDecSolver(pridec_ex1.PriDecEx1(nx, S, "cpu"), o,
                                       scenario_devices=devices)


@pytest.mark.parametrize("S", [12, 13])
def test_recourse_split_over_two_devices_matches_unsplit(S):
    """The scenario axis split over two (CPU) devices, a count that needs
    a zero-weight pad and one that does not: the same sums."""
    cpu = torch.device("cpu")
    solver = _pridec_ex1(6, S, devices=[cpu, cpu])
    x0 = np.linspace(0.0, 1.0, 6)
    rv, gr = solver.prob.eval_rterms_batched(np.arange(S), x0)
    r_split, g_split = solver._eval_recourse_sharded(x0, [cpu, cpu])
    assert abs(r_split - float(rv.sum()) / S) <= 1e-12 * abs(r_split)
    np.testing.assert_allclose(g_split, gr.numpy().sum(axis=0) / S, rtol=1e-12, atol=1e-12)


def test_pridec_solve_split_over_two_devices_matches_unsplit():
    cpu = torch.device("cpu")
    one = _pridec_ex1(6, 12).run()
    two = _pridec_ex1(6, 12, devices=[cpu, cpu], shard_scenarios="yes").run()
    assert two.status == one.status and two.iterations == one.iterations
    assert abs(two.obj - one.obj) <= 1e-10 * max(1.0, abs(one.obj))
