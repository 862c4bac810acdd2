"""Dense-constrained NLP formulation (hiopNlpDenseConstraints,
hiopNlpFormulation.hpp:428).

Counterpart of ``hiop_tpu/formulation/dense.py``: few global constraints
whose Jacobian is dense (m x n), kept as one (m, n) tensor on the solver's
device. The scaling reductions run on the device and reach the host in one
transfer; the eq/ineq row split is an ``index_select`` on the device; a
problem whose constraints are all linear (``jac_constant``) has its scaled
Jacobian evaluated once and cached. On a mesh
(:func:`hiop_tpu_torch.parallel.mesh.shard_formulation`) the Jacobian is
column-sharded, the reference's MPI-distributed hiopMatrixDenseRowMajor:
J @ x and J M^{-1} J^T contract over n and end in an all-reduce
(hiopMatrixDenseRowMajor.cpp:487,699).
"""

from __future__ import annotations

from typing import Tuple

import torch

from hiop_tpu_torch.formulation.base import NlpFormulation
from hiop_tpu_torch.parallel.mesh import shard_n


class NlpDenseConstraints(NlpFormulation):
    def maybe_setup_scaling(self, x0) -> None:
        if self._scaling_done:
            return
        x0 = self._for_problem(x0)
        grad0 = self._dev(self.problem.eval_grad_f(x0)).reshape(self.n)
        jac0 = self._dev(self.problem.eval_jac_cons(x0)).reshape(self.m, self.n)
        norms = [grad0.abs().max().reshape(1)]
        if self.m:
            norms.append(jac0.abs().amax(dim=1))
        host = torch.cat(norms).cpu().numpy()
        self._setup_scaling(host[:1], host[1:])

    def eval_jac(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (Jc (m_eq, n), Jd (m_ineq, n)), scaled."""
        if getattr(self.problem, "jac_constant", False):
            cached = getattr(self, "_jac_cache", None)
            if cached is not None:
                return cached
        self.runstats.n_eval_jac += 1
        with self.runstats.tm_eval_jac:
            J = self._dev(self.problem.eval_jac_cons(self._for_problem(x))).reshape(self.m, self.n)
        J = J * self._scale_cons_t[:, None]
        mesh = getattr(self, "_mesh", None)
        if mesh is not None:
            # m replicated rows x n sharded columns, rather than leaving the
            # layout to propagation from x
            J = shard_n(mesh, J, self._mesh_axis)
        out = (J.index_select(0, self._eq_idx_t), J.index_select(0, self._ineq_idx_t))
        if getattr(self.problem, "jac_constant", False):
            self._jac_cache = out
        return out

    def eval_hess(self, x, obj_factor, yc, yd):
        """Dense scaled Lagrangian Hessian: requires the problem to provide
        eval_hess_lagr(x, obj_factor, lam) (:class:`AutoDiffNlpProblem`
        derives it with ``torch.func.hessian``)."""
        self.runstats.n_eval_hess += 1
        lam = self._lam_user_order(yc, yd)
        with self.runstats.tm_eval_hess:
            H = self.problem.eval_hess_lagr(self._for_problem(x), obj_factor * self.scale_obj,
                                            self._for_problem(lam))
        # row-major for the factorization kernels (torch.func.hessian may
        # return the transposed layout)
        return self._dev(H).reshape(self.n, self.n).contiguous()
