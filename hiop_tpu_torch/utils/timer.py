"""Wall-clock timer (parity: hiopTimer, HiOp src/Utils/hiopTimer.hpp:65).

On accelerators a timer must account for async dispatch; ``stop()`` optionally
synchronizes the device of a CUDA tensor to include device time (the
reference's CUDA stream syncs play the same role).
"""

from __future__ import annotations

import time
from typing import Any, Optional


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

    def stop(self, sync: Any = None) -> "Timer":
        if getattr(sync, "is_cuda", False):
            import torch

            torch.cuda.synchronize(sync.device)
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
