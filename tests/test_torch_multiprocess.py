"""The port's multi-process execution (``hiop_tpu_torch.parallel``) against
single-process runs, on the CPU.

Counterpart of tests/test_multiprocess.py: two gloo ranks are launched
once for the module (``parallel.multiprocess.launch``,
tests/torch_mp_worker.py ``mp``) and run every case while the references
run in this process.

- ACOPF B=32 under MDS Newton, sharded over the two processes: both ranks
  agree exactly, and the run matches the single-process port run
  (iterations equal, objective to 1e-8) and ``SELFCHECK[32]``.
  (``hiop_tpu``'s own two-process run of this case fails its test; the
  port is held to the single run.)
- PriDec Ex1 nx=8 S=24 with the per-rank scenario partition and the
  cross-process all-reduce: iterations equal, objective to 1e-8 against
  the port's and ``hiop_tpu``'s single runs.
- ``checkpoint_format=orbax`` (a ``torch.distributed.checkpoint``
  directory) written every 2 iterations by a sharded QN solve stopped at
  5, then resumed: the uninterrupted solve's status and iterations, the
  objective to 1e-8 and x to 1e-6 (test_torch_aux's schedule for the npz
  file).
- ``allgather_json`` gathers every rank's object on every rank.
- the launcher (these run first, while the ranks work): a failing worker
  raises with its rc, the ranks run on the card unless the caller asks
  for the CPU, a rank that hangs in a collective is killed at the launch
  timeout, and ranks that hash strings differently are refused. The
  ranks take away four DTensor rules, as tests/test_torch_mesh.py says.
"""

import os
import time

import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch
from threadpoolctl import threadpool_limits

from hiop_tpu_torch.parallel.multiprocess import initialize, launch
from test_torch_mesh import case_result, launch_suite

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module", autouse=True)
def ranks():
    """The future of the ranks' results, launched before any test so that
    the ranks run while the references are computed."""
    return launch_suite("mp", 2)


def test_one_process_initialize_is_a_noop(monkeypatch):
    for k in ("HIOP_TPU_COORDINATOR", "HIOP_TPU_NUM_PROCS", "HIOP_TPU_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    assert initialize() == (0, 1)
    assert not torch.distributed.is_initialized()


def test_launcher_surfaces_worker_failure(tmp_path):
    bad = tmp_path / "bad_worker.py"
    bad.write_text("import sys; sys.exit(3)\n")
    with pytest.raises(RuntimeError, match="rank .*rc=3"):
        launch([str(bad)], num_processes=2, platform="cpu", timeout=60)


def test_launcher_runs_on_the_card_unless_asked(tmp_path, capsys):
    """launch() and its CLI hand the ranks platform cuda (NCCL, one card
    per rank) unless the caller asks for the CPU."""
    from hiop_tpu_torch.parallel.multiprocess import main

    show = tmp_path / "show_platform.py"
    show.write_text("import os; print(os.environ['HIOP_TPU_PLATFORM'])\n")
    assert launch([str(show)], num_processes=1)[0].stdout.split() == ["cuda"]
    assert launch([str(show)], num_processes=1, platform="cpu")[0].stdout.split() == ["cpu"]
    assert main(["-n", "1", str(show)]) == 0
    assert capsys.readouterr().out.split()[-1] == "cuda"


def test_launcher_kills_a_hung_rank(tmp_path):
    """Rank 1 never reaches the barrier rank 0 waits in: both are killed
    at the launch timeout, well before the collective's own timeout."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hung = tmp_path / "hung_worker.py"
    hung.write_text(
        f"import sys, time\nsys.path.insert(0, {root!r})\n"
        "import torch.distributed as dist\n"
        "from hiop_tpu_torch.parallel.multiprocess import initialize\n"
        "rank, _ = initialize()\n"
        "time.sleep(600) if rank == 1 else dist.barrier()\n"
    )
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timeout after 10 s"):
        launch([str(hung)], num_processes=2, platform="cpu", timeout=10)
    assert time.monotonic() - t0 < 40


def test_ranks_with_different_hash_seeds_are_refused(tmp_path):
    """DTensor's sharding decisions depend on the string hash: ranks that
    hash differently must not start a solve (each rank here re-executes
    itself with a seed of its own before joining)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "seeded_worker.py"
    worker.write_text(
        f"import os, sys\nsys.path.insert(0, {root!r})\n"
        "rank = os.environ['HIOP_TPU_PROC_ID']\n"
        "if os.environ.get('PYTHONHASHSEED') != str(int(rank) + 1):\n"
        "    os.execve(sys.executable, [sys.executable] + sys.argv,\n"
        "              dict(os.environ, PYTHONHASHSEED=str(int(rank) + 1)))\n"
        "from hiop_tpu_torch.parallel.multiprocess import initialize\n"
        "initialize()\n"
    )
    with pytest.raises(RuntimeError, match="PYTHONHASHSEED"):
        launch([str(worker)], num_processes=2, platform="cpu", timeout=60)


def test_two_process_newton_mds_acopf_matches_single(ranks):
    from hiop_tpu_torch import FilterIPMNewton, NlpMDS, NlpOptions
    from hiop_tpu_torch.examples.acopf_mds import SELFCHECK, AcopfMds

    o = NlpOptions()
    o.update(Hessian="analytical_exact", fixed_var="relax", tolerance=1e-6, mu0=0.1,
             verbosity_level=0, compute_mode="cpu")
    r1 = FilterIPMNewton(NlpMDS(AcopfMds(32), o)).run()
    r = case_result(ranks, "acopf32", 2)
    assert r["status"] == "Solve_Success"
    assert r["iterations"] == r1.iterations
    assert r["obj"] == pytest.approx(r1.obj, rel=1e-8, abs=1e-8)
    ref, tol = SELFCHECK[32]
    assert abs(r["obj"] - ref) <= tol * max(1.0, abs(ref))


def test_two_process_pridec_matches_single(ranks):
    import examples.pridec_ex1 as jax_pex1
    from hiop_tpu_torch.examples import pridec_ex1

    rj = jax_pex1.solve(nx=8, S=24, verbosity_level=0, max_iter=60).run()
    rt = pridec_ex1.solve(nx=8, S=24, compute_mode="cpu", verbosity_level=0, max_iter=60).run()
    r = case_result(ranks, "pridec", 2)
    assert r["status"] == rt.status.name == rj.status.name
    assert r["iterations"] == rt.iterations == rj.iterations
    assert r["obj"] == pytest.approx(rt.obj, rel=1e-8, abs=1e-8)
    assert r["obj"] == pytest.approx(rj.obj, rel=1e-8, abs=1e-8)


def test_dcp_checkpoint_resume_matches_uninterrupted(ranks):
    r = case_result(ranks, "checkpoint_dcp", 2)
    full, part, resumed = r["full"], r["part"], r["resumed"]
    assert r["is_dir"]
    assert part["iterations"] == 5
    assert resumed["status"] == full["status"] == "Solve_Success"
    # the counter restarts at the checkpoint of iteration 4
    assert resumed["iterations"] + 4 == full["iterations"]
    assert abs(resumed["obj"] - full["obj"]) <= 1e-8 * max(1.0, abs(full["obj"]))
    assert np.abs(np.asarray(resumed["x"]) - np.asarray(full["x"])).max() <= 1e-6


def test_allgather_json_over_two_ranks(ranks):
    got = ranks.result()["allgather"]
    assert len(got) == 2 and all("error" not in d for d in got)
    want = [{"rank": 0, "payload": "xxx"}, {"rank": 1, "payload": "x" * 8}]
    assert all(d["gathered"] == want for d in got)
