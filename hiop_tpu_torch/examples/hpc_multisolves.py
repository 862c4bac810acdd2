"""Repeated-solves driver (reference hpc_multisolves.cpp:18-77: MDS Ex1
solves, each timed, to probe multi-instance throughput).

Counterpart of ``examples/hpc_multisolves.py``: ``num_solves`` fresh
:class:`~hiop_tpu_torch.examples.mds_ex1.MdsEx1` problems, formulations
and solvers in a row, with that driver's options. On the card the first
solve pays for loading the kernel library (built by ``nvcc`` if it is not
built yet) and for capturing each kernel's CUDA graph at each size; the
warm solves after it are the sustained rate, and the driver reports them
apart. It returns 1 if a solve fails or if the objectives differ by more
than 1e-9 relative: every instance solves the same problem.

Run: ``python -m hiop_tpu_torch.examples.hpc_multisolves [num_solves]
[n_sp] [n_de] [-cpu]`` (on cuda:0 unless ``-cpu``).
"""

from __future__ import annotations

import sys
import time

from hiop_tpu_torch import FilterIPMNewton, NlpMDS, NlpOptions
from hiop_tpu_torch.examples.mds_ex1 import MdsEx1


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")]
    num_solves = int(pos[0]) if len(pos) > 0 else 5
    n_sp = int(pos[1]) if len(pos) > 1 else 400
    n_de = int(pos[2]) if len(pos) > 2 else 100

    extra = dict(compute_mode="cpu") if "-cpu" in argv else {}
    objs, times = [], []
    for i in range(num_solves):
        t0 = time.perf_counter()
        o = NlpOptions()
        o.update(verbosity_level=0, Hessian="analytical_exact", duals_update_type="linear",
                 duals_init="zero", tolerance=1e-5, mu0=0.1, **extra)
        # a fresh problem, formulation and solver every time, like the
        # reference's `new MdsEx1(...)` per loop iteration
        r = FilterIPMNewton(NlpMDS(MdsEx1(n_sp, n_de), o)).run()
        times.append(time.perf_counter() - t0)
        objs.append(float(r.obj))
        print(f"[driver] solve {i + 1}/{num_solves}: obj={r.obj:12.5e} "
              f"status={r.status.name} iters={r.iterations} in {times[-1]:.3f} s")
        if not r.status.is_success:
            print("[driver] solve failed")
            return 1
    print(f"[driver] first solve {times[0]:.3f} s (kernel library load and CUDA-graph captures "
          f"on a card)")
    if num_solves > 1:
        warm = times[1:]
        print(f"[driver] {len(warm)} warm solves in {sum(warm):.3f} s "
              f"({sum(warm) / len(warm):.3f} s/solve average)")
    if max(objs) - min(objs) > 1e-9 * (1 + abs(objs[0])):
        print("[driver] solves disagree:", objs)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
