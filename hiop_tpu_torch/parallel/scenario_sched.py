"""Scenario scheduling for the PriDec solver.

Counterpart of ``hiop_tpu/parallel/scenario_sched.py``, after the
reference's two distribution modes for recourse-term evaluation
(hiopAlgPrimalDecomp.cpp):

* dynamic master-worker dispatch (``run()``, cpp:790-1090): rank 0 deals
  scenario indices to workers one at a time and reassigns work as results
  arrive (the work-stealing loop cpp:950-995). Here the same dealing
  discipline runs over a local thread pool: a shared index queue from
  which workers pull as they finish.

* static partition + local accumulation (``run_local()``, cpp:1269,
  option ``accum_local``): each rank evaluates a contiguous block of
  scenarios, accumulates value and subgradient locally, and one reduce
  combines them (cpp:1651-1652). Here the partition is by the
  ``torch.distributed`` rank when a process group is initialized; in one
  process the combine is a no-op, across processes one ``all_reduce`` of
  (rval, grad).

The batched path (``eval_rterms_batched``) remains the preferred
realization for homogeneous scenarios; these schedulers cover
heterogeneous per-scenario NLP solves where batching cannot apply.
:func:`partition_scenarios` and :func:`dynamic_schedule` are copies of
``hiop_tpu``'s framework-free functions.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Sequence, Tuple

import numpy as np


def partition_scenarios(S: int, num_ranks: int, rank: int) -> np.ndarray:
    """Contiguous balanced partition of scenario indices (run_local's
    per-rank block; remainder spread over the first ranks)."""
    if num_ranks <= 0:
        raise ValueError("num_ranks must be positive")
    if not 0 <= rank < num_ranks:
        raise ValueError("rank out of range")
    base, rem = divmod(S, num_ranks)
    start = rank * base + min(rank, rem)
    count = base + (1 if rank < rem else 0)
    return np.arange(start, start + count, dtype=np.int64)


def dynamic_schedule(
    eval_one: Callable[[int], Tuple[float, np.ndarray]],
    indices: Sequence[int],
    num_workers: int,
) -> Tuple[float, np.ndarray, int]:
    """Deal `indices` to `num_workers` threads from a shared queue; each
    worker pulls the next scenario as soon as it finishes its current one
    (the reference's dynamic reassignment loop, cpp:950-995).  Returns
    (sum of rvals, sum of grads, n_evaluated); worker exceptions re-raise
    on the caller thread."""
    indices = list(indices)
    if not indices:
        raise ValueError("no scenario indices to schedule")
    num_workers = max(1, min(int(num_workers), len(indices)))
    if num_workers == 1:
        rsum, gsum = 0.0, None
        for i in indices:
            r, g = eval_one(int(i))
            rsum += float(r)
            g = np.asarray(g, dtype=np.float64)
            gsum = g.copy() if gsum is None else gsum + g
        return rsum, gsum, len(indices)

    work: queue.SimpleQueue = queue.SimpleQueue()
    for i in indices:
        work.put(int(i))
    lock = threading.Lock()
    acc = {"rval": 0.0, "grad": None, "count": 0, "err": None}

    def worker():
        local_r, local_g, local_n = 0.0, None, 0
        try:
            while True:
                try:
                    i = work.get_nowait()
                except queue.Empty:
                    break
                r, g = eval_one(i)
                local_r += float(r)
                g = np.asarray(g, dtype=np.float64)
                local_g = g.copy() if local_g is None else local_g + g
                local_n += 1
        except BaseException as e:  # propagate to caller
            with lock:
                acc["err"] = e
            return
        with lock:
            acc["rval"] += local_r
            acc["count"] += local_n
            if local_g is not None:
                acc["grad"] = (
                    local_g if acc["grad"] is None else acc["grad"] + local_g
                )

    threads = [threading.Thread(target=worker) for _ in range(num_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if acc["err"] is not None:
        raise acc["err"]
    return acc["rval"], acc["grad"], acc["count"]


def process_rank_and_count() -> Tuple[int, int]:
    """(rank, world size) of the ``torch.distributed`` process group when
    one is initialized, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def allreduce_across_processes(rval: float, grad: np.ndarray):
    """Sum the local (rval, grad) accumulations over all processes, the
    reference's MPI_Reduce (cpp:1651-1652). A no-op in a single process."""
    _rank, nprocs = process_rank_and_count()
    if nprocs == 1:
        return rval, grad
    import torch
    import torch.distributed as dist

    # NCCL reduces device tensors only; gloo takes host tensors
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    payload = torch.as_tensor(
        np.concatenate([[rval], np.asarray(grad, dtype=np.float64)]), device=dev
    )
    dist.all_reduce(payload)
    total = payload.cpu().numpy()
    return float(total[0]), total[1:]
