"""hiop_tpu_torch — the PyTorch/CUDA port of hiop_tpu for one NVIDIA H100.

It mirrors ``hiop_tpu``'s module layout file for file. ``hiop_tpu`` (JAX)
is the reference each ported module is tested against; this package never
imports it or JAX. The port covers the Newton filter line-search IPM on
mixed dense-sparse (MDS) problems through the general loop, in f64 and in
mixed precision (``kkt_fact_dtype=float32`` with f64 FGMRES refinement),
with hand-written CUDA kernels for the blocked Cholesky (quick tier) and
the blocked no-pivot LDL^T (inertia-revealing safe tier).

Entry points run on ``cuda:0`` unless the options set
``compute_mode="cpu"``; without a CUDA device they raise.

Precision note: TF32 is switched off for float32 matmuls and convolutions
when the package is imported. It keeps about three decimal digits, and a
reduced-precision pass inside a KKT factorization is fatal: on the TPU one
bf16 pass gave a 1e5x LDL^T factor error and a wrong inertia count
(``hiop_tpu/linalg/ldl_blocked.py:166-169``).
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
if _torch.backends.cuda.matmul.allow_tf32 or _torch.backends.cudnn.allow_tf32:
    raise RuntimeError("hiop_tpu_torch needs TF32 off for its factorizations")

from hiop_tpu_torch.status import SolveStatus  # noqa: E402
from hiop_tpu_torch.utils.options import NlpOptions  # noqa: E402
from hiop_tpu_torch.utils.logger import Logger, Verbosity  # noqa: E402
from hiop_tpu_torch.interface.base import MdsProblem, NlpProblem  # noqa: E402
from hiop_tpu_torch.formulation.base import NlpFormulation  # noqa: E402
from hiop_tpu_torch.formulation.mds import NlpMDS  # noqa: E402
from hiop_tpu_torch.optimization.filter_ipm import (  # noqa: E402
    FilterIPMNewton,
    FilterIPMQuasiNewton,
)

__version__ = "0.1.0"

__all__ = [
    "SolveStatus",
    "NlpOptions",
    "Logger",
    "Verbosity",
    "NlpProblem",
    "MdsProblem",
    "NlpFormulation",
    "NlpMDS",
    "FilterIPMNewton",
    "FilterIPMQuasiNewton",
]
