"""User-facing NLP problem interfaces (L4).

Counterpart of ``hiop_tpu/interface/base.py`` (reference
hiopInterface.hpp:134,518,586,779): :class:`NlpProblem` (sizes, bounds,
f/grad/cons evaluations, starting point, callbacks),
:class:`DenseConstraintsProblem` (a dense constraint Jacobian),
:class:`SparseProblem` (triplet Jacobian and upper-triangle Hessian),
:class:`MdsProblem` (mixed dense-sparse block structure) and
:class:`AutoDiffNlpProblem` (derivatives from ``torch.func``).

Evaluations receive ``x`` as a float64 tensor on the solver's device and
may return tensors, numpy arrays or Python scalars; the formulation moves
every result to the solver's device. A problem that computes with torch
on ``x.device`` keeps the whole evaluation on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

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
    #: True when every evaluation is torch on the device of ``x`` with no
    #: host round trip: ``jit_mode=iteration/solve`` then run the fused
    #: modes (hiop_tpu's flag of the same name: evaluations it can trace)
    jittable: bool = False
    #: False when the evaluations take plain tensors only: a mesh-sharded
    #: formulation then hands them its rank's replica of ``x``
    takes_dtensor: bool = True

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


class DenseConstraintsProblem(NlpProblem):
    """Dense-Jacobian NLP (hiopInterfaceDenseConstraints, hiopInterface.hpp:518)."""

    def eval_jac_cons(self, x):
        """Return the dense (m, n) Jacobian of all constraints."""
        raise NotImplementedError


class SparseProblem(NlpProblem):
    """Fully sparse NLP (hiopInterfaceSparse, hiopInterface.hpp:779).

    Structure is static (declared once, host integer arrays); only values
    are re-evaluated. The Hessian is the upper triangle of the Lagrangian
    Hessian obj_factor * H_f + sum lam_i * H_{c_i}.
    """

    def get_sparse_blocks_info(self) -> Tuple[int, int, int]:
        """Return (n, nnz_jac, nnz_hess_upper_triangle)."""
        raise NotImplementedError

    def jac_structure(self) -> Tuple[np.ndarray, np.ndarray]:
        """Static (rows, cols) of the Jacobian triplets."""
        raise NotImplementedError

    def eval_jac_vals(self, x):
        """Values aligned with jac_structure()."""
        raise NotImplementedError

    def hess_structure(self) -> Tuple[np.ndarray, np.ndarray]:
        """Static (rows, cols) of the upper-triangle Hessian triplets."""
        raise NotImplementedError

    def eval_hess_vals(self, x, obj_factor, lam):
        """Values aligned with hess_structure()."""
        raise NotImplementedError


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


class AutoDiffNlpProblem(NlpProblem):
    """Define an NLP from torch-traceable ``f`` and ``c`` alone.

    The derivatives come from ``torch.func``: the gradient of
    ``f(x).sum()``, the forward-mode Jacobian of ``c``, and the Hessian of
    the Lagrangian ``obj_factor * f + lam . c`` (``hessian`` is
    ``jacfwd(jacrev(.))``). Every evaluation runs in torch on the device
    of ``x``, the solver's device; ``f`` and ``c`` must keep any constant
    tensors they close over on that device. The ``torch.func`` transforms
    take no DTensor (``takes_dtensor = False``): on a mesh the formulation
    hands every evaluation this rank's replica of ``x``.

    >>> p = AutoDiffNlpProblem(f=lambda x: (x**2).sum(), c=lambda x: x[:1],
    ...                        xl=..., xu=..., cl=..., cu=..., x0=...)
    """

    jittable = True
    takes_dtensor = False

    def __init__(
        self,
        f: Callable,
        c: Optional[Callable],
        xl,
        xu,
        cl,
        cu,
        x0,
        name: str = "autodiff_nlp",
    ):
        from torch.func import grad, hessian, jacfwd

        self.name = name
        self._f = f
        self._c = c
        self._grad_f = grad(lambda x: f(x).sum())
        self._jac_c = jacfwd(c) if c is not None else None
        self._xl = np.asarray(xl, dtype=np.float64)
        self._xu = np.asarray(xu, dtype=np.float64)
        self._cl = np.atleast_1d(np.asarray(cl, dtype=np.float64))
        self._cu = np.atleast_1d(np.asarray(cu, dtype=np.float64))
        self._x0 = np.asarray(x0, dtype=np.float64)

        def lagr(x, obj_factor, lam):
            val = obj_factor * f(x).sum()
            return val + lam @ c(x) if c is not None else val

        self._hess_lagr = hessian(lagr, argnums=0)

    def get_prob_sizes(self):
        return self._x0.shape[0], self._cl.shape[0]

    def get_vars_info(self):
        return self._xl, self._xu

    def get_cons_info(self):
        return self._cl, self._cu

    def get_starting_point(self):
        return self._x0

    def eval_f(self, x):
        return self._f(x)

    def eval_grad_f(self, x):
        return self._grad_f(x)

    def eval_cons(self, x):
        if self._c is None:
            return x.new_zeros((0,))
        return self._c(x)

    def eval_jac_cons(self, x):
        if self._jac_c is None:
            return x.new_zeros((0, x.shape[0]))
        return self._jac_c(x)

    def eval_hess_lagr(self, x, obj_factor, lam):
        return self._hess_lagr(x, torch.full((), float(obj_factor), dtype=x.dtype, device=x.device), lam)
