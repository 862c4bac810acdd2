"""Wall-clock timer (parity: hiopTimer, HiOp src/Utils/hiopTimer.hpp:65).

A host clock: on a CUDA device it measures the host's dispatch, not the
device's work (the solver's spans, :mod:`hiop_tpu_torch.utils.trace`, place
device operations on the same host timeline through the profiler).
"""

from __future__ import annotations

import time
from typing import Optional


class Timer:
    def __init__(self) -> None:
        self._acc = 0.0
        self._t0: Optional[float] = None

    def reset(self) -> "Timer":
        self._acc = 0.0
        self._t0 = None
        return self

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> "Timer":
        if self._t0 is not None:
            self._acc += time.perf_counter() - self._t0
            self._t0 = None
        return self

    def restart(self) -> "Timer":
        return self.reset().start()

    @property
    def elapsed(self) -> float:
        extra = time.perf_counter() - self._t0 if self._t0 is not None else 0.0
        return self._acc + extra

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
