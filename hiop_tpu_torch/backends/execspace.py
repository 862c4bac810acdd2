"""Execution-space resolution (L0).

Counterpart of ``hiop_tpu/backends/execspace.py``. The reference maps its
string options (mem_space, mem_backend, exec_policies, compute_mode) to a
(memory backend, exec policy) pair; here ``compute_mode`` resolves to one
``torch.device``:

- ``compute_mode="cpu"`` pins the CPU (the tests pass this);
- ``"auto"``, ``"gpu"``, ``"tpu"`` and ``"hybrid"`` mean ``cuda:0``, and
  raise when no CUDA device is visible: a solve never carries on on the
  CPU unless the caller asked for it.

The hot dense factorizations dispatch on the device of their input (the
hand-written CUDA kernels for a CUDA tensor, their plain PyTorch versions
for a CPU tensor), so there is no separate kernel-backend axis.
"""

from __future__ import annotations

import torch


def resolve_device(compute_mode: str) -> torch.device:
    if compute_mode == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"compute_mode={compute_mode!r} needs a CUDA device and none is "
            "visible; pass compute_mode='cpu' to solve on the CPU"
        )
    return torch.device("cuda", 0)


def on_accelerator(device: torch.device) -> bool:
    """True when the solve's resolved device is a CUDA device — the probe
    for 'does the device tier of a solver ladder apply here'
    (``hiop_tpu``'s version looks for a TPU among the visible devices)."""
    return device.type == "cuda"
