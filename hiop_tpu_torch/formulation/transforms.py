"""Problem transformations.

Counterpart of ``hiop_tpu/formulation/transforms.py`` (reference
hiopNlpTransforms.hpp:80-555): the fixed-variable *remover*
(hiopFixedVarsRemover, :150) squeezes variables with xl == xu out of the
problem, keeping full <-> reduced index maps and compressing dense Jacobian
columns. The index maps are built once with numpy; the maps themselves run
in torch on the device of the point they are given. The relaxer (:318) and
bounds relaxer (:506) live in formulation/base.py; gradient-based scaling
(:351) in ``_setup_scaling``.
"""

from __future__ import annotations

import numpy as np
import torch

from hiop_tpu_torch.interface.base import DenseConstraintsProblem


class FixedVarsRemover(DenseConstraintsProblem):
    """Wrap a dense-Jacobian problem, removing variables fixed at their
    bounds. The wrapped problem sees the reduced space; ``expand``/
    ``restrict`` convert between the two, and the solution callback
    receives the full-space point."""

    def __init__(self, problem, fixed_mask: np.ndarray, fixed_vals: np.ndarray):
        self.inner = problem
        self.fixed_mask = np.asarray(fixed_mask, bool)
        self.free_idx = np.nonzero(~self.fixed_mask)[0]
        self.fixed_idx = np.nonzero(self.fixed_mask)[0]
        self._fixed_vals = np.asarray(fixed_vals, dtype=np.float64)[self.fixed_idx]
        self.n_full = self.fixed_mask.size
        self.n_red = int(self.free_idx.size)
        self.jittable = getattr(problem, "jittable", False)
        self._on = {}

    def _maps(self, device):
        """(free indices, fixed indices, fixed values) on ``device``, made
        once per device."""
        key = str(device)
        if key not in self._on:
            self._on[key] = (
                torch.as_tensor(self.free_idx, device=device),
                torch.as_tensor(self.fixed_idx, device=device),
                torch.as_tensor(self._fixed_vals, device=device),
            )
        return self._on[key]

    @staticmethod
    def _t(a, like=None):
        if isinstance(a, torch.Tensor):
            return a
        device = like.device if like is not None else None
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)

    # -- maps ---------------------------------------------------------------
    def expand(self, x_red):
        x_red = self._t(x_red)
        free, fixed, vals = self._maps(x_red.device)
        x = x_red.new_zeros((self.n_full,))
        x[free] = x_red
        x[fixed] = vals.to(x.dtype)
        return x

    def restrict(self, x_full):
        x_full = self._t(x_full)
        return x_full[self._maps(x_full.device)[0]]

    # -- interface ----------------------------------------------------------
    def get_prob_sizes(self):
        _, m = self.inner.get_prob_sizes()
        return self.n_red, m

    def get_vars_info(self):
        xl, xu = self.inner.get_vars_info()
        return np.asarray(xl)[self.free_idx], np.asarray(xu)[self.free_idx]

    def get_cons_info(self):
        return self.inner.get_cons_info()

    def get_starting_point(self):
        return np.asarray(self.inner.get_starting_point())[self.free_idx]

    def eval_f(self, x_red):
        return self.inner.eval_f(self.expand(x_red))

    def eval_grad_f(self, x_red):
        g = self._t(self.inner.eval_grad_f(self.expand(x_red)), like=x_red)
        return g[self._maps(g.device)[0]]

    def eval_cons(self, x_red):
        return self.inner.eval_cons(self.expand(x_red))

    def eval_jac_cons(self, x_red):
        J = self._t(self.inner.eval_jac_cons(self.expand(x_red)), like=x_red)
        return J[:, self._maps(J.device)[0]]

    def eval_hess_lagr(self, x_red, obj_factor, lam):
        H = self._t(self.inner.eval_hess_lagr(self.expand(x_red), obj_factor, lam), like=x_red)
        free = self._maps(H.device)[0]
        return H[free][:, free]

    def iterate_callback(self, info):
        return self.inner.iterate_callback(info)

    def solution_callback(self, status, x, zl, zu, g, lam, obj):
        self.inner.solution_callback(status, self.expand(x), zl, zu, g, lam, obj)
