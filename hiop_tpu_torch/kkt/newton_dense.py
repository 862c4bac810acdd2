"""Dense Newton KKT helpers.

Counterpart of ``hiop_tpu/kkt/newton_dense.py``. Only the host LU + eigen
inertia of the last safe tier (``lu_eig``) is ported so far, because the
MDS safe tier shares it; the dense XDYcYd KKT itself waits for ROADMAP.md
section 1, item 9.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

from hiop_tpu_torch.formulation.base import to_numpy


def _lu_with_inertia(M, delta_cc):
    """Host-side LU + eigen inertia (numpy LAPACK), the stable fallback of
    the safe ladder (the reference's MA57/dsytrf on the CPU while the quick
    path lives on the accelerator). Returns (lu, piv, n_neg_eig) with
    n_neg_eig = -1 for a numerically singular matrix."""
    Mh = to_numpy(M)
    lu, piv = sla.lu_factor(Mh)
    delta_cc = float(delta_cc)
    w = np.linalg.eigvalsh(0.5 * (Mh + Mh.T))
    tol = 1e1 * np.finfo(Mh.dtype).eps * max(float(np.max(np.abs(w))), 1.0)
    if delta_cc > 0.0:
        # the dual-regularized eigenvalues sit at -delta_cc, usually BELOW
        # the eig noise floor tol ~ eps*||M||; attribute noise-band
        # eigenvalues to the negative count: if they are the -delta_cc ones
        # the inertia comes out right, if they are a near-singular Hessian
        # block the count exceeds mc+md and the caller bumps delta_w
        n_neg_eig = int(np.sum(w < tol))
    else:
        n_neg = int(np.sum(w < -tol))
        n_zero = int(np.sum(np.abs(w) <= tol))
        n_neg_eig = -1 if n_zero > 0 else n_neg
    return lu, piv, np.asarray(n_neg_eig)
