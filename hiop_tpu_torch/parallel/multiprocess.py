"""Multi-process execution harness over ``torch.distributed``.

Counterpart of ``hiop_tpu/parallel/multiprocess.py``. The reference
distributes the quasi-Newton solver across MPI ranks and its CI runs real
2-rank MPI jobs (reference CMakeLists.txt:508,512; SURVEY.md §2.9). Here
every process calls :func:`initialize` once at startup, which joins one
``torch.distributed`` process group; a mesh built over the world's ranks
(:func:`hiop_tpu_torch.parallel.mesh.make_mesh`) then spans all processes,
and the solver's n-axis reductions become that group's collectives.

One rank drives one device: a mesh of four devices is four processes.
``hiop_tpu``'s ``HIOP_TPU_LOCAL_DEVICES`` (several virtual devices per
process) therefore has no counterpart. On the card, rank ``r`` takes
``cuda:{r % torch.cuda.device_count()}``, so two ranks on a one-card
machine share ``cuda:0`` (NCCL refuses that; gloo carries it).

Two entry points:

* :func:`initialize` — call from each worker process before any
  distributed use;
* :func:`launch` — host-side launcher that spawns N copies of a worker
  script with the right environment (the ``mpirun -n N`` analogue), used by
  the tests and the CLI::

      python -m hiop_tpu_torch.parallel.multiprocess -n 2 worker.py args...
      python -m hiop_tpu_torch.parallel.multiprocess -n 2 -m package.module args...

Environment contract (read by :func:`initialize` when arguments are None):

==============================  ============================================
``HIOP_TPU_COORDINATOR``        ``host:port`` of the rank-0 rendezvous, or
                                ``file://PATH`` of a file rendezvous on one
                                machine (what :func:`launch` uses)
``HIOP_TPU_NUM_PROCS``          world size
``HIOP_TPU_PROC_ID``            this process's rank
``HIOP_TPU_PLATFORM``           ``cpu`` (gloo) or ``cuda`` (NCCL)
``HIOP_TPU_DIST_BACKEND``       overrides the backend (``gloo`` on the card
                                carries several ranks on one device)
==============================  ============================================
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
from typing import Optional, Sequence

#: how long a collective may wait for its peers before it raises
COLLECTIVE_TIMEOUT_S = 120.0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    platform: Optional[str] = None,
    backend: Optional[str] = None,
) -> tuple[int, int]:
    """Join the process group and pin this rank's device.

    Returns ``(process_id, num_processes)``. With every argument None and
    no ``HIOP_TPU_*`` environment this is a single-process run: nothing is
    initialized and ``(0, 1)`` is returned. The backend is gloo for
    ``platform="cpu"`` and NCCL for ``"cuda"`` unless ``backend`` (or
    ``HIOP_TPU_DIST_BACKEND``) names another; every collective times out
    after ``COLLECTIVE_TIMEOUT_S`` seconds."""
    import torch
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("HIOP_TPU_COORDINATOR")
    num_processes = num_processes if num_processes is not None else _env_int("HIOP_TPU_NUM_PROCS")
    process_id = process_id if process_id is not None else _env_int("HIOP_TPU_PROC_ID")
    platform = platform or os.environ.get("HIOP_TPU_PLATFORM") or "cuda"
    backend = backend or os.environ.get("HIOP_TPU_DIST_BACKEND") or (
        "gloo" if platform == "cpu" else "nccl"
    )
    if coordinator_address is None and num_processes is None:
        return 0, 1
    import faulthandler

    # a rank that dies of a signal leaves its Python stack on stderr, where
    # launch() reports it
    faulthandler.enable()
    rank, world = int(process_id or 0), int(num_processes or 1)
    if platform != "cpu":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(
        backend=backend,
        init_method=(coordinator_address if coordinator_address.startswith("file://")
                     else f"tcp://{coordinator_address}"),
        world_size=world,
        rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
        **kw,
    )
    _check_same_string_hash(world)
    return rank, world


def _check_same_string_hash(world: int) -> None:
    """Every rank must hash strings alike: DTensor's sharding decisions
    iterate over hashed containers, and ranks with different
    PYTHONHASHSEEDs were seen to plan different collectives for the same
    operation (wrong values, then a hang). :func:`launch` starts every
    rank with one seed."""
    import torch.distributed as dist

    hashes = [None] * world
    dist.all_gather_object(hashes, hash("hiop_tpu_torch"))
    if len(set(hashes)) != 1:
        raise RuntimeError(
            "the ranks hash strings differently; start every rank with the same "
            "PYTHONHASHSEED (hiop_tpu_torch.parallel.multiprocess.launch does)"
        )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(
    worker_argv: Sequence[str],
    num_processes: int = 2,
    platform: str = "cuda",
    timeout: float = 600.0,
    extra_env: Optional[dict] = None,
    cwd: Optional[str] = None,
    backend: Optional[str] = None,
) -> list[subprocess.CompletedProcess]:
    """Spawn ``num_processes`` copies of ``python worker_argv...`` wired to
    one rendezvous (the ``mpirun`` analogue). The ranks run on the card
    (``platform="cuda"``: NCCL, rank r on ``cuda:{r % device_count}``)
    unless the caller asks for ``platform="cpu"`` (gloo). When any rank is still
    running after ``timeout`` seconds, every rank is killed. Raises on a
    timeout or any nonzero exit, with each failing rank's stderr and stdout
    tails.
    Returns the per-rank CompletedProcess list (stdout/stderr captured)."""
    import shutil
    import tempfile
    import time

    # the rendezvous is a file of a fresh directory: a port picked here
    # could be taken by a concurrent launch before rank 0 listens on it,
    # and ranks of two jobs would then join one group
    rdv_dir = tempfile.mkdtemp(prefix="hiop_rdv_")
    rendezvous = "file://" + os.path.join(rdv_dir, "store")
    procs, files = [], []
    for pid in range(num_processes):
        env = dict(os.environ)
        env.update(
            HIOP_TPU_COORDINATOR=rendezvous,
            HIOP_TPU_NUM_PROCS=str(num_processes),
            HIOP_TPU_PROC_ID=str(pid),
            HIOP_TPU_PLATFORM=platform,
            PYTHONHASHSEED=os.environ.get("PYTHONHASHSEED", "0"),
        )
        if backend:
            env["HIOP_TPU_DIST_BACKEND"] = backend
        if extra_env:
            env.update({k: str(v) for k, v in extra_env.items()})
        # output goes to files, not pipes: a rank blocked on a full pipe
        # that nobody drains would stall its peers' collectives
        out_f, err_f = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        files.append((out_f, err_f))
        procs.append(
            subprocess.Popen(
                [sys.executable, *worker_argv],
                env=env, cwd=cwd, stdout=out_f, stderr=err_f, text=True,
            )
        )
    deadline = time.monotonic() + timeout
    failed = []
    for pid, p in enumerate(procs):
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            for q in procs:
                if q.poll() is None:
                    q.kill()
            p.wait()
            failed.append((pid, f"timeout after {timeout:g} s"))
    for q in procs:
        q.wait()
    shutil.rmtree(rdv_dir, ignore_errors=True)
    results = []
    for p, (out_f, err_f) in zip(procs, files):
        out_f.seek(0)
        err_f.seek(0)
        results.append(subprocess.CompletedProcess(p.args, p.returncode, stdout=out_f.read(),
                                                   stderr=err_f.read()))
        out_f.close()
        err_f.close()
    for pid, r in enumerate(results):
        if r.returncode != 0 and not any(f[0] == pid for f in failed):
            failed.append((pid, f"rc={r.returncode}"))
    if failed:
        msgs = "\n".join(
            f"-- rank {pid} {why}:\n{(results[pid].stderr or '')[-2000:]}"
            f"\n-- rank {pid} stdout tail:\n{(results[pid].stdout or '')[-1000:]}"
            for pid, why in failed
        )
        raise RuntimeError(f"multiprocess launch failed:\n{msgs}")
    return results


def _rank_and_world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank0_print(*args, **kwargs) -> None:
    """Print only on rank 0 (the reference's rank-0 logger convention).
    Arguments are evaluated on every rank before the call, so a value that
    needs a collective to read is read by all ranks alike."""
    if _rank_and_world()[0] == 0:
        print(*args, **kwargs)


def allgather_json(obj) -> list:
    """Gather a small JSON-serializable object from every rank to all
    ranks (diagnostics helper for cross-rank result checks)."""
    import torch.distributed as dist

    _rank, world = _rank_and_world()
    if world == 1:
        return [json.loads(json.dumps(obj))]
    out = [None] * world
    dist.all_gather_object(out, json.dumps(obj))
    return [json.loads(s) for s in out]


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m hiop_tpu_torch.parallel.multiprocess",
        description="Launch N coordinated worker processes (mpirun analogue).",
    )
    ap.add_argument("-n", "--num-processes", type=int, default=2)
    ap.add_argument("--platform", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--backend", default=None, choices=(None, "gloo", "nccl"))
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("-m", "--module", default=None, help="run a module as the worker (python -m MODULE)")
    ap.add_argument("worker", nargs=argparse.REMAINDER, help="worker script + args")
    args = ap.parse_args(argv)
    worker = ["-m", args.module, *args.worker] if args.module else args.worker
    if not worker:
        ap.error("missing worker script")
    results = launch(
        worker,
        num_processes=args.num_processes,
        platform=args.platform,
        timeout=args.timeout,
        backend=args.backend,
    )
    for pid, r in enumerate(results):
        sys.stdout.write(f"===== rank {pid} =====\n{r.stdout}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
