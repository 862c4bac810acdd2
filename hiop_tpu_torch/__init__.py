"""hiop_tpu_torch — the PyTorch/CUDA port of hiop_tpu for one NVIDIA H100.

It mirrors ``hiop_tpu``'s module layout file for file. ``hiop_tpu`` (JAX)
is the reference each ported module is tested against; this package never
imports it or JAX. The port covers the filter line-search IPM through the
general loop: the Newton solver on mixed dense-sparse (MDS),
dense-constrained and sparse problems (every dense KKT class: XDYcYd,
XYcYd, condensed, normal equations, full; for sparse problems also the
host sparse-direct XDYcYd/XYcYd and full-space KKT over SuperLU or the
native LDL^T), and the quasi-Newton (L-BFGS) solver on dense-constrained
and sparse problems, in f64 and in mixed precision
(``kkt_fact_dtype=float32`` with f64 FGMRES refinement), with the
reference's robustness surface (soft and full feasibility restoration,
elastic mode, ``fixed_var=remove``, checkpoints, ``write_kkt``,
``deepchecks``). Hand-written CUDA
kernels carry the blocked Cholesky (quick tiers, the low-rank KKT's Schur
system) and the blocked no-pivot LDL^T (inertia-revealing safe tiers).

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
from hiop_tpu_torch.interface.base import (  # noqa: E402
    AutoDiffNlpProblem,
    DenseConstraintsProblem,
    MdsProblem,
    NlpProblem,
    SparseProblem,
)
from hiop_tpu_torch.formulation.base import NlpFormulation  # noqa: E402
from hiop_tpu_torch.formulation.dense import NlpDenseConstraints  # noqa: E402
from hiop_tpu_torch.formulation.mds import NlpMDS  # noqa: E402
from hiop_tpu_torch.formulation.sparse import NlpSparse  # noqa: E402
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
    "DenseConstraintsProblem",
    "MdsProblem",
    "SparseProblem",
    "AutoDiffNlpProblem",
    "NlpFormulation",
    "NlpDenseConstraints",
    "NlpMDS",
    "NlpSparse",
    "FilterIPMNewton",
    "FilterIPMQuasiNewton",
]
