"""Kron reduction of complex admittance matrices.

Counterpart of ``hiop_tpu/utils/kron_reduction.py`` (reference
``hiopKronReduction``, hiopKronReduction.hpp:69, and the complex linear
algebra it drives: hiopMatrixComplexDense/SparseTriplet,
hiopLinSolverUMFPACKZ): the power-grid network reduction

  Y_red = Y_aa - Y_ab * Y_bb^{-1} * Y_ba

over a complex bus-admittance matrix partitioned into auxiliary (b) and
non-auxiliary (a) buses; the LU of Y_bb is kept to map non-aux quantities
onto the aux buses (:meth:`KronReduction.apply_nonaux_to_aux`).

Both of the reference's representations are taken:

- **dense complex**: any array-like input; Y_bb is factored on the host
  by scipy ``lu_factor`` (LAPACK);
- **sparse complex**: any ``scipy.sparse`` input; Y_bb is factored by
  scipy ``splu`` (SuperLU, the role UMFPACK plays in the reference), and
  the off-diagonal blocks stay sparse until the Schur product.

The factorization, once per network, is host work, as in the reference
and in ``hiop_tpu``. The results are complex128 tensors on ``device``
(the card unless the caller passes ``"cpu"``); the dense case forms
Y_aa - Y_ab X there.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from hiop_tpu_torch.backends.execspace import resolve_device


def _is_sparse(A) -> bool:
    import scipy.sparse as sp

    return sp.issparse(A)


class KronReduction:
    def __init__(self, Ybus, aux_idx: Sequence[int], device="auto"):
        """Ybus: (n, n) complex admittance matrix, dense array-like or any
        scipy.sparse matrix; aux_idx: the auxiliary buses to eliminate;
        device: a ``torch.device``, or a ``compute_mode`` string (``"auto"``
        is the card, ``"cpu"`` the CPU)."""
        self.device = resolve_device(device) if isinstance(device, str) else torch.device(device)
        self._sparse = _is_sparse(Ybus)
        n = Ybus.shape[0]
        aux = np.asarray(sorted(aux_idx), dtype=np.int64)
        keep = np.setdiff1d(np.arange(n, dtype=np.int64), aux)
        self.aux_idx = aux
        self.nonaux_idx = keep
        if self._sparse:
            import scipy.sparse as sp
            import scipy.sparse.linalg as spla

            Y = sp.csc_matrix(Ybus, dtype=np.complex128)
            self._Yab_sp = Y[keep][:, aux].tocsc()
            self._Yba_sp = Y[aux][:, keep].tocsc()
            self._Yaa = self._dev(Y[keep][:, keep].toarray())
            # complex sparse LU of Y_bb (UMFPACKZ's role; SuperLU here)
            self._lu_sp = spla.splu(Y[aux][:, aux].tocsc()) if aux.size else None
        else:
            import scipy.linalg as sla

            Y = np.asarray(Ybus, dtype=np.complex128)
            self._Yba_h = Y[np.ix_(aux, keep)]
            self._Yab = self._dev(Y[np.ix_(keep, aux)])
            self._Yaa = self._dev(Y[np.ix_(keep, keep)])
            self._lu = sla.lu_factor(Y[np.ix_(aux, aux)]) if aux.size else None

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.complex128), device=self.device)

    def _solve_bb(self, B: np.ndarray) -> np.ndarray:
        """Y_bb^{-1} B on the host, with the kept factorization."""
        if self._sparse:
            return self._lu_sp.solve(np.asarray(B, np.complex128))
        import scipy.linalg as sla

        return sla.lu_solve(self._lu, np.asarray(B, np.complex128))

    def reduce(self) -> torch.Tensor:
        """Y_red = Y_aa - Y_ab Y_bb^{-1} Y_ba (buildKronRed)."""
        if self.aux_idx.size == 0:
            return self._Yaa
        if self._sparse:
            X = self._solve_bb(self._Yba_sp.toarray())
            return self._Yaa - self._dev(self._Yab_sp @ X)
        return self._Yaa - self._Yab @ self._dev(self._solve_bb(self._Yba_h))

    def apply_nonaux_to_aux(self, v_nonaux) -> torch.Tensor:
        """Aux-bus voltages from non-aux voltages:
        v_aux = -Y_bb^{-1} Y_ba v_nonaux (apply_nonaux_to_aux)."""
        if isinstance(v_nonaux, torch.Tensor):
            v_nonaux = v_nonaux.detach().cpu().numpy()
        v = np.asarray(v_nonaux, np.complex128)
        Yba_v = (self._Yba_sp if self._sparse else self._Yba_h) @ v
        return -self._dev(self._solve_bb(Yba_v))
