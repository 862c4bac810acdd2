"""Allreduce microbenchmark over a mesh's process group.

Counterpart of ``hiop_tpu/parallel/collectives_bench.py`` and of the
reference's ``hpc_benchmark.cpp`` (src/Drivers/MDS/hpc_benchmark.cpp:34-93):
allreduce latency against buffer size, from 32768 doubles per rank in a
ladder of doublings, 8 dependent reduces per trial, averaged over the
repetitions. The MPI allreduce becomes ``torch.distributed.all_reduce``
over the mesh's group (NCCL on the card, gloo on the CPU or for several
ranks on one card); on the card the repetitions are timed between two
``torch.cuda.synchronize()``.

Run in one process (a world of one) with
``python -m hiop_tpu_torch.parallel.collectives_bench [-cpu]``, or on N
ranks with ``python -m hiop_tpu_torch.parallel.multiprocess -n N -m
hiop_tpu_torch.parallel.collectives_bench`` (on the card; on the CPU:
``--platform cpu`` to the launcher and ``-cpu`` to the benchmark). The
benchmark's device follows its own ``-cpu`` flag only.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import torch


def run(
    mesh,
    base_count: int = 32768,
    num_sizes: int = 6,
    reduces_per_trial: int = 8,
    reps: int = 20,
    dtype=torch.float64,
) -> List[Tuple[int, float]]:
    """Returns [(doubles_per_rank, seconds_per_allreduce)] per ladder rung."""
    import torch.distributed as dist

    from hiop_tpu_torch.parallel.mesh import mesh_device

    group = mesh.get_group()
    dev = mesh_device(mesh)
    on_card = dev.type == "cuda"

    def trial(x):
        for _ in range(reduces_per_trial):
            s = x.clone()
            dist.all_reduce(s, group=group)
            x = x + 1e-30 * s  # keep the dependency so nothing is elided
        return x

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    results = []
    count = base_count
    for _ in range(num_sizes):
        x = trial(torch.ones((count,), dtype=dtype, device=dev))  # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            x = trial(x)
        sync()
        results.append((count, (time.perf_counter() - t0) / (reps * reduces_per_trial)))
        count *= 2
    return results


def main(compute_mode: str = "auto") -> List[Tuple[int, float]]:
    from hiop_tpu_torch.parallel.mesh import make_mesh
    from hiop_tpu_torch.parallel.multiprocess import rank0_print

    mesh = make_mesh(compute_mode=compute_mode)
    res = run(mesh)
    rank0_print(f"allreduce microbenchmark over {mesh.size()} ranks")
    for count, dt in res:
        mb = count * 8 / 1e6
        rank0_print(f"  {count:>9} doubles/rank ({mb:.3f} MB): {dt * 1e6:10.2f} us/allreduce")
    return res


if __name__ == "__main__":
    import sys

    from hiop_tpu_torch.parallel.multiprocess import initialize

    initialize()
    main("cpu" if "-cpu" in sys.argv[1:] else "auto")
