"""Primal-decomposition (PriDec) problem interface.

Counterpart of ``hiop_tpu/interface/pridec.py`` (reference
hiopInterfacePriDecProblem, hiopInterfacePrimalDecomp.hpp:55-120): a
two-stage stochastic program

  min_x  basecase(x) + sum_i r_i(x) / S

where each recourse term r_i is evaluated per scenario (possibly itself an
NLP solve). The master solve receives a quadratic recourse model built by
:class:`RecourseApproxEvaluator`:

  q(x) = rval + g^T (x - x0) + 1/2 (x - x0)^T diag(h) (x - x0)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class RecourseApproxEvaluator:
    """Quadratic recourse model (hiopInterfacePrimalDecomp.hpp:120). The
    model's arrays are kept as numpy and moved to a device once, at the
    first evaluation there; ``eval_f``/``eval_grad`` compute on the device
    of ``x``."""

    def __init__(self, n: int, rval: float = 0.0, x0=None, grad=None, hess_diag=None):
        self.n = n
        self.rval = float(rval)
        self.x0 = np.zeros(n) if x0 is None else np.asarray(x0, dtype=np.float64)
        self.grad = np.zeros(n) if grad is None else np.asarray(grad, dtype=np.float64)
        self.hess_diag = (
            np.zeros(n) if hess_diag is None else np.asarray(hess_diag, dtype=np.float64)
        )
        self._on: dict = {}

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(x0, grad, hess_diag) as f64 tensors on ``device``."""
        key = str(torch.device(device))
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = tuple(
                torch.as_tensor(a, dtype=torch.float64, device=device)
                for a in (self.x0, self.grad, self.hess_diag)
            )
        return t

    def eval_f(self, x):
        x = torch.as_tensor(x, dtype=torch.float64)
        x0, g, h = self.on(x.device)
        dx = x - x0
        return self.rval + g @ dx + 0.5 * (dx * h) @ dx

    def eval_grad(self, x):
        x = torch.as_tensor(x, dtype=torch.float64)
        x0, g, h = self.on(x.device)
        return g + h * (x - x0)


class PriDecProblem:
    """User problem for the PriDec solver."""

    def get_num_rterms(self) -> int:
        """Number of recourse terms (scenarios) S."""
        raise NotImplementedError

    def get_num_vars(self) -> int:
        """Dimension of the coupling variable x (n_coupling)."""
        raise NotImplementedError

    def solve_master(
        self,
        x: np.ndarray,
        include_r: bool,
        evaluator: Optional[RecourseApproxEvaluator] = None,
        options_file: str = "",
    ) -> Tuple[np.ndarray, float]:
        """Solve the basecase (+ optional quadratic recourse model); returns
        (x_opt, obj). ``options_file`` forwards the PriDec option
        ``options_file_master_prob`` (the reference passes it as the last
        argument of ``solve_master``, hiopAlgPrimalDecomp.cpp:880) so the
        user's master NLP can load its own option file; implementations may
        omit the parameter and it will not be passed."""
        raise NotImplementedError

    def eval_f_rterm(self, idx: int, x: np.ndarray) -> float:
        """Recourse value r_idx(x) (may itself run an NLP solve)."""
        raise NotImplementedError

    def eval_grad_rterm(self, idx: int, x: np.ndarray) -> np.ndarray:
        """Gradient of r_idx at x."""
        raise NotImplementedError

    # Optional batched evaluation of a whole array of scenario indices at
    # once (torch.func.vmap over the scenarios, or one batched solve).
    # Returns (rvals (k,), grads (k, n)).
    batched = False
    #: True when ``eval_rterms_batched`` also takes ``idxs`` and ``x`` as
    #: tensors and evaluates on the device of ``x``: the solver may then
    #: split the scenario axis over several devices (``shard_scenarios``).
    #: hiop_tpu splits a problem whose batched evaluation it can trace.
    splits_over_devices = False

    def eval_rterms_batched(self, idxs: np.ndarray, x: np.ndarray):
        raise NotImplementedError

    def set_recourse_approx_evaluator(self, evaluator: RecourseApproxEvaluator):
        """Notification hook; the evaluator is also passed to solve_master."""
