"""The benchmark of ``hiop_tpu_torch`` (the PyTorch and CUDA port) on one
NVIDIA H100.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data. Everything that belongs to one configuration,
traffic mix, metric or kernel sits in a file of its own that the harness
finds by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration as it is run (sizes,
  options, the guarantee, the reference module that judges it);
- ``traffic/<traffic>.json``: a traffic mix, the parameters that the
  grid-snapshot generator in :mod:`portbench.traffic` reads (or the entry,
  where it makes its own requests), and the entry it drives;
- ``entries/<entry>.py``: how a request reaches the program's entry point,
  and for an instance that is not a grid snapshot, its request stream;
- ``reference/<reference>.py``: the plain NumPy reference of a problem;
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct`` in a cell;
- ``e2e/<metric>.py`` and ``metrics/<metric>.py``: the reader of an
  end-to-end or a per-layer metric, or of every metric of one stem
  (``metrics/iters.py`` reads ``iters.screen``);
- ``work/<kernel>.py``: a kernel's operations and bytes, from the
  logical size of what its caller factors.

``calibrate.py`` takes the readings that a cell's limits are set from,
with the lower-precision control and the faults of ``faults.py``; the
benchmark's own runs run neither.

Nothing here imports JAX or the JAX package ``hiop_tpu``; nothing under
``reference/`` imports the program.
"""
