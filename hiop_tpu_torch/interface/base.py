"""User-facing NLP problem interfaces (L4).

Counterpart of ``hiop_tpu/interface/base.py`` (reference
hiopInterface.hpp:134,586): :class:`NlpProblem` (sizes, bounds,
f/grad/cons evaluations, starting point, callbacks) and
:class:`MdsProblem` (mixed dense-sparse block structure).

Evaluations receive ``x`` as a float64 tensor on the solver's device and
may return tensors, numpy arrays or Python scalars; the formulation moves
every result to the solver's device. A problem that computes with torch
on ``x.device`` keeps the whole evaluation on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np

INF = 1e20  # bound magnitude treated as infinity, same convention as the reference


@dataclasses.dataclass
class IterateCallbackInfo:
    """Per-iteration scalars streamed to the user (hiopInterface.hpp:446-467)."""

    iter: int
    obj_value: float
    logbar_obj_value: float
    x: Any
    z_L: Any
    z_U: Any
    s: Any
    g: Any
    yc: Any
    yd: Any
    inf_pr: float
    inf_du: float
    onenorm_pr: float
    mu: float
    alpha_du: float
    alpha_pr: float
    ls_trials: int


class NlpProblem:
    """Abstract NLP: min f(x) s.t. cl <= c(x) <= cu, xl <= x <= xu."""

    #: True when ALL constraints are linear (the reference's hiopLinear
    #: NonlinearityType): the Jacobian is evaluated once and cached.
    jac_constant: bool = False

    # -- sizes & data -------------------------------------------------------
    def get_prob_sizes(self) -> Tuple[int, int]:
        raise NotImplementedError

    def get_vars_info(self) -> Tuple[np.ndarray, np.ndarray]:
        """Return (xlow, xupp); entries <=-1e20 / >=1e20 mean unbounded."""
        raise NotImplementedError

    def get_cons_info(self) -> Tuple[np.ndarray, np.ndarray]:
        """Return (clow, cupp); clow==cupp marks an equality."""
        raise NotImplementedError

    def get_starting_point(self) -> np.ndarray:
        n, _ = self.get_prob_sizes()
        return np.zeros(n)

    def get_warmstart_point(self):
        """Optionally return (x0, z_L0, z_U0, yc0, yd0, d0, vl0, vu0)."""
        return None

    # -- evaluations --------------------------------------------------------
    def eval_f(self, x) -> float:
        raise NotImplementedError

    def eval_grad_f(self, x):
        raise NotImplementedError

    def eval_cons(self, x):
        raise NotImplementedError

    def eval_cons_subset(self, x, idx_cons):
        """Two-call constraint evaluation (optional; hiopInterface.hpp:303-366).

        Return the values of constraints ``idx_cons`` (in that order) at
        ``x``. The default returns :data:`NotImplemented`, which makes the
        formulation use the one-call :meth:`eval_cons`."""
        return NotImplemented

    # -- callbacks ----------------------------------------------------------
    def iterate_callback(self, info: IterateCallbackInfo) -> bool:
        """Return False to stop the solver (User_Stopped)."""
        return True

    def solution_callback(self, status, x, z_L, z_U, g, lam, obj_value) -> None:
        pass

    def force_update_x(self, x):
        """Hook to overwrite the primal point (hiopInterface.hpp force_update_x)."""
        return x


class MdsProblem(NlpProblem):
    """Mixed dense-sparse NLP (hiopInterfaceMDS, hiopInterface.hpp:586).

    Variables are ordered [x_sparse, x_dense]. Jacobians have a sparse triplet
    block over the sparse variables and a dense block over the dense
    variables; the Hessian is block-diagonal: a *diagonal* sparse block (the
    MDS KKT's Schur elimination requires it, hiopKKTLinSysMDS.cpp:172-276)
    and a dense block.
    """

    def get_sparse_dense_blocks_info(self) -> Tuple[int, int]:
        """Return (n_sparse, n_dense)."""
        raise NotImplementedError

    def jac_sparse_structure(self) -> Tuple[np.ndarray, np.ndarray]:
        """Static (rows, cols) of the sparse-block Jacobian triplets (all m rows)."""
        raise NotImplementedError

    def eval_jac_blocks(self, x):
        """Return (sparse_vals, dense_block) with dense_block shape (m, n_dense)."""
        raise NotImplementedError

    def eval_hess_blocks(self, x, obj_factor, lam):
        """Return (hss_diag (n_sparse,), hdd (n_dense, n_dense))."""
        raise NotImplementedError
