"""Execution-space resolution (L0).

Counterpart of ``hiop_tpu/backends/execspace.py``. The reference maps its
string options (mem_space, mem_backend, exec_policies, compute_mode) to a
(memory backend, exec policy) pair; here ``compute_mode`` resolves to one
``torch.device``:

- ``compute_mode="cpu"`` pins the CPU (the tests pass this);
- ``"auto"``, ``"gpu"``, ``"tpu"`` and ``"hybrid"`` mean the current CUDA
  device (``cuda:0``, or a rank's own card), and raise when no CUDA device
  is visible: a solve never carries on on the CPU unless the caller asked
  for it.

``exec_policies`` selects the lane of the dense factorizations
(:func:`kernel_backend`; the solver applies it for the duration of each
solve, :func:`hiop_tpu_torch.linalg.cholesky.backend_scope`):

============================  ==========================================  =====================
``exec_policies``             Cholesky (single, batched, vmapped,         no-pivot LDL^T
                              DTensor replica)
============================  ==========================================  =====================
``pallas``                    the hand-written kernel, f32 and f64        the hand-written kernel
``auto`` (default)            the hand-written kernel                     the hand-written kernel
``xla``, ``seq``, ``raja``    ``torch.linalg.cholesky_ex`` (cuSOLVER on   the hand-written kernel
                              a card, LAPACK on the CPU)
============================  ==========================================  =====================

A kernel lane on a CPU tensor is the kernel's plain PyTorch version. In
``hiop_tpu``, ``auto`` means ``xla`` and ``pallas`` takes the Pallas
kernels for f32 only (Mosaic has no f64); here ``auto`` keeps the
hand-written kernels, and ``pallas`` takes them in f64 too (the card has
f64 tensor cores). No library has a no-pivot LDL^T, so every value keeps
that kernel.
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
    # cuda:0 in one process; a rank of a multi-process run takes the card
    # ``parallel.multiprocess.initialize`` set current
    return torch.device("cuda", torch.cuda.current_device())


def on_accelerator(device: torch.device) -> bool:
    """True when the solve's resolved device is a CUDA device — the probe
    for 'does the device tier of a solver ladder apply here'
    (``hiop_tpu``'s version looks for a TPU among the visible devices)."""
    return device.type == "cuda"


def kernel_backend(exec_policies: str) -> str:
    """The Cholesky lane of an ``exec_policies`` value (table above):
    ``"library"`` for ``xla``, ``seq`` and ``raja``, else ``"kernel"``."""
    return "library" if exec_policies in ("xla", "seq", "raja") else "kernel"
