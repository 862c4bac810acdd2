"""Allreduce microbenchmark driver (reference hpc_benchmark.cpp:34-93).

Counterpart of ``examples/hpc_benchmark.py``: allreduce latency against
buffer size, from ``base_count`` doubles per rank (32768) in a ladder of
doublings, 8 dependent reduces per trial, averaged over ``reps`` trials,
through :func:`hiop_tpu_torch.parallel.collectives_bench.run` over the
mesh of :func:`hiop_tpu_torch.parallel.mesh.make_mesh`. The reference's
MPI allreduce becomes ``torch.distributed.all_reduce``: NCCL on the card,
gloo with ``-cpu``.

Run: ``python -m hiop_tpu_torch.examples.hpc_benchmark [base_count]
[num_sizes] [reps] [-cpu]`` in one process (a world of one, on cuda:0),
or on N ranks with ``python -m hiop_tpu_torch.parallel.multiprocess -n N
-m hiop_tpu_torch.examples.hpc_benchmark``.
"""

from __future__ import annotations

import sys

from hiop_tpu_torch.parallel import collectives_bench
from hiop_tpu_torch.parallel.mesh import make_mesh
from hiop_tpu_torch.parallel.multiprocess import initialize, rank0_print


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")]
    base = int(pos[0]) if len(pos) > 0 else 32768
    num_sizes = int(pos[1]) if len(pos) > 1 else 6
    reps = int(pos[2]) if len(pos) > 2 else 20

    initialize()  # joins the launcher's ranks; a world of one otherwise
    mesh = make_mesh(compute_mode="cpu" if "-cpu" in argv else "auto")
    rows = collectives_bench.run(mesh, base_count=base, num_sizes=num_sizes, reps=reps)
    rank0_print(f"[driver] allreduce ladder over {mesh.size()} rank(s), base {base} f64/rank")
    rank0_print(f"{'doubles/rank':>16} {'bytes/rank':>14} {'us/allreduce':>14} {'GB/s/rank':>12}")
    for count, secs in rows:
        nbytes = count * 8
        bw = nbytes / secs / 1e9 if secs > 0 else float("inf")
        rank0_print(f"{count:>16d} {nbytes:>14d} {secs * 1e6:>14.2f} {bw:>12.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
