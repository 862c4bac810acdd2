"""The run's device, its set-up clock, and the check that nothing of JAX
was loaded."""

from __future__ import annotations

import os
import subprocess
import sys

#: top-level module names that no run may load, compared whole
#: (``hiop_tpu_torch``, the port, begins with ``hiop_tpu`` and is allowed)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hiop_tpu"})


class NoDevice(RuntimeError):
    pass


def require_cuda(chips: int) -> None:
    """Raise unless ``chips`` CUDA devices are there. A measurement never
    falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} are there")


def describe(chips: int) -> dict:
    """The device part of the result line."""
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it ("unknown" where
    it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def process_age() -> float:
    """Seconds since this process started (the kernel's start time, so the
    interpreter's own start-up counts)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_loaded() -> list:
    """The modules of JAX or of the JAX package that this process holds."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)
