"""Leveled logger.

Parity with ``hiopLogger`` (HiOp src/Utils/hiopLogger.hpp:87): a
14-level verbosity enum, master-process-only printing, and typed writers for
solver objects. "Rank 0" means rank 0 of an initialized
``torch.distributed`` process group; single-process runs always print.
"""

from __future__ import annotations

import enum
import sys
from typing import Any, IO, Optional

import numpy as np


class Verbosity(enum.IntEnum):
    """Mirrors hiopVerbosityLevel (hiopLogger.hpp:69-84)."""

    ERROR = 0
    WARNING = 1
    NO_OUTPUT = 2
    SUMMARY = 3
    SCALARS = 4
    FCN_EVAL = 5
    LINESEARCH = 6
    LINESEARCH_VERB = 7
    LINALG = 8
    ITERATE = 9
    MATRICES = 10
    LINESEARCH_ITS = 11
    MAX_VERBOSE = 12


# hiop-style aliases
hovError = Verbosity.ERROR
hovWarning = Verbosity.WARNING
hovSummary = Verbosity.SUMMARY
hovScalars = Verbosity.SCALARS
hovFcnEval = Verbosity.FCN_EVAL
hovLinesearch = Verbosity.LINESEARCH
hovLinesearchVerb = Verbosity.LINESEARCH_VERB
hovLinAlgScalars = Verbosity.LINALG
hovIteration = Verbosity.ITERATE
hovMatrices = Verbosity.MATRICES
hovMaxVerbose = Verbosity.MAX_VERBOSE


def _is_master() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class Logger:
    def __init__(
        self,
        verbosity: int = Verbosity.SUMMARY,
        stream: Optional[IO] = None,
        master_only: bool = True,
    ):
        self.verbosity = Verbosity(int(verbosity))
        self.stream = stream if stream is not None else sys.stdout
        self.master_only = master_only

    def _emit(self, msg: str) -> None:
        if self.master_only and not _is_master():
            return
        print(msg, file=self.stream, flush=True)

    def printf(self, level: int, fmt: str, *args: Any) -> None:
        if int(level) <= int(self.verbosity):
            self._emit(fmt % args if args else fmt)

    def write(self, msg: str, obj: Any = None, level: int = Verbosity.SUMMARY) -> None:
        """Typed writer: prints `msg` and optionally a vector/matrix/pytree."""
        if int(level) > int(self.verbosity):
            return
        if obj is None:
            self._emit(msg)
            return
        with np.printoptions(precision=6, suppress=False, threshold=200):
            if hasattr(obj, "_asdict"):  # NamedTuple pytrees (Iterate/Residual)
                parts = [f"{k}={np.asarray(v)}" for k, v in obj._asdict().items()]
                self._emit(f"{msg}\n  " + "\n  ".join(parts))
            else:
                self._emit(f"{msg} {np.asarray(obj)}")

    def error(self, msg: str, *args: Any) -> None:
        self.printf(Verbosity.ERROR, msg, *args)

    def warning(self, msg: str, *args: Any) -> None:
        self.printf(Verbosity.WARNING, msg, *args)

    def summary(self, msg: str, *args: Any) -> None:
        self.printf(Verbosity.SUMMARY, msg, *args)
