"""The port's PriDec solver and its scenario scheduling against the JAX
package, on the CPU in f64.

``HessianApprox`` step for step (alpha, ratio, both convergence measures to
1e-12); the recourse model; ``partition_scenarios`` and
``dynamic_schedule`` against serial evaluation, with error propagation;
``PriDecSolver`` on PriDec Ex1 (batched, serial host loop, two workers,
``accum_local``) against ``hiop_tpu``'s: the same status and PriDec
iterations, the objective to 1e-8 relative; ``options_file`` forwarding;
the batched recourse of PriDec Ex2 against its host solves; SC-ACOPF's
batched recourse (``AcopfPriDec.eval_rterms_batched``, B=8, 2 outages) at a
fixed dispatch against ``hiop_tpu``'s, and its whole PriDec solve (marked
``slow``: about 50 s with the JAX reference).
"""

import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch
from threadpoolctl import threadpool_limits

import examples.acopf_pridec as j_apd
import examples.pridec_ex1 as j_px1
import hiop_tpu
import hiop_tpu.optimization.pridec as jpd
import hiop_tpu.parallel.scenario_sched as jss
import hiop_tpu_torch
import hiop_tpu_torch.optimization.pridec as tpd
import hiop_tpu_torch.parallel.scenario_sched as tss
from hiop_tpu.interface.pridec import RecourseApproxEvaluator as JEvaluator
from hiop_tpu_torch.examples import acopf_pridec, pridec_ex1, pridec_ex2
from hiop_tpu_torch.interface.pridec import RecourseApproxEvaluator
from hiop_tpu_torch.utils.logger import Logger

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


def _close(a, b, tol=1e-12):
    return abs(a - b) <= tol * max(1.0, abs(b))


def test_hessian_approx_step_for_step():
    """The alpha heuristic, the trust-region ratio, the Barzilai-Borwein
    alpha and both convergence measures along one seeded sequence."""
    rng = np.random.default_rng(0)
    n = 7
    ja = jpd.HessianApprox(n, 1.0, hiop_tpu.PriDecOptions(), jpd.Logger(0))
    ta = tpd.HessianApprox(n, 1.0, hiop_tpu_torch.PriDecOptions(), Logger(0))
    x, g, f = rng.standard_normal(n), rng.standard_normal(n), 3.0
    for h in (ja, ta):
        h.initialize(f, x, g)
    assert _close(ta.get_alpha_f(g), ja.get_alpha_f(g))
    base, base_m1 = 2.0, 2.0
    for _ in range(6):
        x = x + 0.3 * rng.standard_normal(n)
        g = 0.5 * g + 0.1 * rng.standard_normal(n)
        f = f * 0.7 + 0.05 * rng.random()
        obj = 5.0 + rng.random()
        for h in (ja, ta):
            h.update_hess_coeff(x, g, f)
        base_m1, base = base, ja.compute_base(obj)
        assert _close(ta.compute_base(obj), base)
        for h in (ja, ta):
            h.update_ratio(base, base_m1)
        assert _close(ta.ratio_, ja.ratio_)
        assert _close(ta.get_alpha_f(g), ja.get_alpha_f(g))
        assert _close(ta.check_convergence_grad(g), ja.check_convergence_grad(g))
        assert _close(ta.check_convergence_fcn(base, base_m1), ja.check_convergence_fcn(base, base_m1))
    assert _close(ta.get_alpha_BB(), ja.get_alpha_BB())


def test_recourse_model_matches_jax():
    rng = np.random.default_rng(1)
    n = 5
    args = dict(rval=1.5, x0=rng.standard_normal(n), grad=rng.standard_normal(n),
                hess_diag=rng.random(n))
    je, te = JEvaluator(n, **args), RecourseApproxEvaluator(n, **args)
    x = rng.standard_normal(n)
    xt = torch.from_numpy(x)
    assert _close(float(te.eval_f(xt)), float(je.eval_f(x)))
    assert np.allclose(te.eval_grad(xt).numpy(), np.asarray(je.eval_grad(x)), rtol=1e-12, atol=1e-14)
    assert te.eval_grad(xt).device == xt.device


@pytest.mark.parametrize("S", [1, 7, 8, 100])
@pytest.mark.parametrize("P", [1, 3, 8])
def test_partition_scenarios_matches_jax(S, P):
    parts = [tss.partition_scenarios(S, P, r) for r in range(P)]
    for r in range(P):
        assert np.array_equal(parts[r], jss.partition_scenarios(S, P, r))
    assert sorted(np.concatenate(parts).tolist()) == list(range(S))


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_dynamic_schedule_matches_serial(workers):
    def eval_one(i):
        return float(i) ** 2, np.full(3, float(i))

    r, g, count = tss.dynamic_schedule(eval_one, range(10), workers)
    rj, gj, countj = jss.dynamic_schedule(eval_one, range(10), workers)
    assert (r, count) == (rj, countj) == (285.0, 10)
    assert np.array_equal(g, gj) and np.array_equal(g, np.full(3, 45.0))


def test_dynamic_schedule_propagates_errors():
    def eval_one(i):
        if i == 3:
            raise ValueError("scenario 3 failed")
        return 1.0, np.zeros(2)

    for workers in (1, 3):
        with pytest.raises(ValueError, match="scenario 3"):
            tss.dynamic_schedule(eval_one, range(6), workers)
    with pytest.raises(ValueError, match="no scenario"):
        tss.dynamic_schedule(eval_one, [], 2)


def test_one_process_rank_and_reduce(monkeypatch):
    """One process: rank 0 of 1 and a no-op reduce; with more processes one
    all_reduce of (rval, grad) (here a stand-in that doubles, as a second
    rank with the same values would; the real two-process run is in
    tests/test_torch_multiprocess.py)."""
    assert tss.process_rank_and_count() == (0, 1)
    g = np.arange(3.0)
    assert tss.allreduce_across_processes(2.0, g) == (2.0, g)
    monkeypatch.setattr(tss, "process_rank_and_count", lambda: (0, 2))
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: "gloo")
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda t: t.mul_(2.0))
    r, gsum = tss.allreduce_across_processes(2.0, g)
    assert r == 4.0 and np.array_equal(gsum, 2.0 * g)


# ---------------------------------------------------------------------------
# PriDec Ex1
# ---------------------------------------------------------------------------
NX, S1 = 6, 12


@pytest.fixture(scope="module")
def jax_ex1():
    return j_px1.solve(NX, S1, verbosity_level=0).run()


def _port_ex1(batched=True, **opts):
    prob = pridec_ex1.PriDecEx1(NX, S1, "cpu")
    prob.batched = batched
    o = hiop_tpu_torch.PriDecOptions()
    o.update(verbosity_level=0, **opts)
    return hiop_tpu_torch.PriDecSolver(prob, o).run()


def _same_result(r, ref):
    assert r.status.name == ref.status.name and r.iterations == ref.iterations
    assert abs(r.obj - ref.obj) <= 1e-8 * max(1.0, abs(ref.obj))


def test_pridec_ex1_matches_jax(jax_ex1):
    r = _port_ex1()
    _same_result(r, jax_ex1)
    assert abs(r.obj - (0.5 * S1 * NX + 0.5 * NX)) < 1e-5


@pytest.mark.parametrize("mode", ["serial", "two_workers", "accum_local"])
def test_pridec_ex1_host_loop_matches_batched(jax_ex1, mode):
    """The scenario loop on the host: dealt to one or two worker threads,
    or statically partitioned and reduced (accum_local)."""
    opts = {"serial": {}, "two_workers": dict(num_local_workers=2),
            "accum_local": dict(accum_local="true")}[mode]
    _same_result(_port_ex1(batched=False, **opts), jax_ex1)


def test_batched_recourse_matches_serial_terms():
    p = pridec_ex1.PriDecEx1(6, 12, "cpu")
    x0 = np.linspace(0.0, 1.0, 6)
    rv, gr = p.eval_rterms_batched(np.arange(12), x0)
    assert np.allclose(rv.numpy(), [p.eval_f_rterm(i, x0) for i in range(12)], atol=1e-12)
    assert np.allclose(gr.numpy(), np.stack([p.eval_grad_rterm(i, x0) for i in range(12)]),
                       atol=1e-12)


def test_options_file_is_forwarded():
    """options_file_master_prob reaches a solve_master that takes it, as
    the reference passes it (hiopAlgPrimalDecomp.cpp:880)."""
    seen = []

    class Recording(pridec_ex1.PriDecEx1):
        def solve_master(self, x, include_r, evaluator=None, options_file=""):
            seen.append(options_file)
            return super().solve_master(x, include_r, evaluator)

    o = hiop_tpu_torch.PriDecOptions()
    o.update(verbosity_level=0, options_file_master_prob="master.options", max_iter=2)
    hiop_tpu_torch.PriDecSolver(Recording(4, 3, "cpu"), o).run()
    assert seen and set(seen) == {"master.options"}


def test_shard_scenarios_on_several_devices(monkeypatch):
    """With more than one CUDA device, shard_scenarios=yes and auto split
    the batched scenario axis over them (here run on two CPU devices in
    their place) and give the one-device result; no keeps one device."""
    seen = []
    real = hiop_tpu_torch.PriDecSolver._eval_recourse_sharded

    def on_cpu(self, x0, devices):
        seen.append([str(d) for d in devices])
        return real(self, x0, [torch.device("cpu")] * len(devices))

    one = _port_ex1(max_iter=2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(hiop_tpu_torch.PriDecSolver, "_eval_recourse_sharded", on_cpu)
    for opt in ("yes", "auto"):
        seen.clear()
        r = _port_ex1(shard_scenarios=opt, max_iter=2)
        assert seen and all(d == ["cuda:0", "cuda:1"] for d in seen)
        assert r.iterations == one.iterations == 2
        assert abs(r.obj - one.obj) <= 1e-10 * max(1.0, abs(one.obj))
    seen.clear()
    _port_ex1(shard_scenarios="no", max_iter=2)
    assert not seen


def _undeclared_problem(name):
    """The two batched examples whose recourse is a batched solve on the
    problem's own device (``splits_over_devices`` False), at small sizes."""
    if name == "pridec_ex2":
        return pridec_ex2.PriDecEx2Batched(10, 4, 3, compute_mode="cpu"), np.linspace(0.6, 1.4, 10)
    p = acopf_pridec.AcopfPriDec(8, 2, compute_mode="cpu", verbosity=0)
    return p, np.asarray(p.rec.core.start_dense()) * 0.9


@pytest.mark.parametrize("name", ["pridec_ex2", "acopf_pridec"])
def test_shard_scenarios_keeps_undeclared_problems_on_one_device(monkeypatch, name):
    """Two devices in the process: a batched problem that does not declare
    ``splits_over_devices`` stays on the unsplit batched path under auto
    (every scenario in one call, x as given, the same sums), and yes
    refuses it (hiop_tpu: its batched evaluation is not traceable)."""
    prob, x = _undeclared_problem(name)
    calls = []
    real = type(prob).eval_rterms_batched

    def spy(self, idxs, x_):
        calls.append((np.asarray(idxs).tolist(), type(x_)))
        out = real(self, idxs, x_)
        calls[-1] += (out,)
        return out

    monkeypatch.setattr(type(prob), "eval_rterms_batched", spy)
    cpu = torch.device("cpu")
    o = hiop_tpu_torch.PriDecOptions()
    o.update(verbosity_level=0, shard_scenarios="auto")
    solver = hiop_tpu_torch.PriDecSolver(prob, o, scenario_devices=[cpu, cpu])
    r, g = solver._eval_recourse(x)
    S = prob.get_num_rterms()
    assert [c[:2] for c in calls] == [(list(range(S)), np.ndarray)]
    rv, gr = calls[0][2]
    assert r == float(np.asarray(rv).sum()) / S
    np.testing.assert_array_equal(g, np.asarray(gr).sum(axis=0) / S)
    o.update(shard_scenarios="yes")
    with pytest.raises(ValueError, match="splits_over_devices"):
        hiop_tpu_torch.PriDecSolver(prob, o, scenario_devices=[cpu, cpu])._eval_recourse(x)
    assert len(calls) == 1


def test_pridec_ex2_batched_matches_host_recourse():
    """Per-scenario samples: the batched recourse values and gradients
    against the per-scenario host solves with the same xi."""
    rng = np.random.default_rng(3)
    nx, nS, S = 10, 4, 3
    xis = 1.0 + 0.2 * rng.standard_normal((S, nS))
    pb = pridec_ex2.PriDecEx2Batched(nx, nS, S, xis=xis, compute_mode="cpu")
    x = rng.uniform(0.6, 1.4, nx)
    rvals, grads = pb.eval_rterms_batched(np.arange(S), x)
    for i in range(S):
        ph = pridec_ex2.PriDecEx2(nx, nS, S, compute_mode="cpu")
        ph.xi = xis[i]
        assert abs(float(rvals[i]) - ph.eval_f_rterm(i, x)) < 1e-6
        assert np.allclose(grads[i].numpy(), ph.eval_grad_rterm(i, x), atol=1e-5)


# ---------------------------------------------------------------------------
# SC-ACOPF
# ---------------------------------------------------------------------------
def test_acopf_pridec_recourse_matches_jax():
    """The batched contingency re-dispatch solves (B=8, outages of ring
    lines 0 and 4) at the basecase start dispatch, against hiop_tpu's."""
    jp = j_apd.AcopfPriDec(8, 2)
    tp = acopf_pridec.AcopfPriDec(8, 2, compute_mode="cpu", verbosity=0)
    x = np.asarray(tp.rec.core.start_dense()) * 0.9
    rj, gj = jp.eval_rterms_batched(np.arange(2), x)
    rt, gt = tp.eval_rterms_batched(np.arange(2), x)
    assert np.allclose(rt, np.asarray(rj), rtol=1e-8, atol=0)
    assert np.allclose(gt, np.asarray(gj), atol=1e-6)
    assert tp.host_fallbacks == []


@pytest.mark.slow
def test_acopf_pridec_matches_jax():
    """The whole PriDec SC-ACOPF solve at B=8 with 2 outages: hiop_tpu
    reaches Solve_Success in 4 PriDec iterations at 3.4271015801543077."""
    jr = j_apd.solve(8, 2, verbosity_level=0)
    tr = acopf_pridec.solve(8, 2, compute_mode="cpu", verbosity_level=0)
    _same_result(tr, jr)
