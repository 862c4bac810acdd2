"""Pluggable sparse direct-solver registry.

Counterpart of ``hiop_tpu/linalg/solver_registry.py`` (host numpy and
scipy, no framework). The ``linear_solver_sparse`` option names a backend
(MA57 / PARDISO / STRUMPACK / Ginkgo / cuSOLVER in HiOp,
src/Optimization/hiopKKTLinSysSparse.cpp:277-376) chosen through a factory
(LinAlgFactory.cpp). A backend is a callable ``factory(csc_matrix) ->
solver`` where ``solver.solve(rhs)`` returns the solution (and may raise on
singular input). The built-in ``splu`` entry wraps scipy's SuperLU and
plays the MA57 role; ``native_ldl`` is the package's own sparse LDL^T
(:mod:`hiop_tpu_torch.native.ldl`); users register further backends with
:func:`register_solver` and select them by name through the option.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}
_SYMMETRIC_ONLY: set = set()


def register_solver(name: str, factory: Callable, symmetric_only: bool = False) -> None:
    """Register ``factory(csc_matrix) -> solver-with-.solve(rhs)`` under
    ``name`` (selectable via the ``linear_solver_sparse`` option).

    ``symmetric_only`` marks backends that read only one triangle (e.g. an
    LDL^T): they must not be handed nonsymmetric systems such as the
    unreduced full-space KKT (HiOp restricts that class to nonsymmetric
    PARDISO/STRUMPACK, hiopKKTLinSysSparse.cpp:845-849)."""
    _REGISTRY[name] = factory
    if symmetric_only:
        _SYMMETRIC_ONLY.add(name)
    else:
        _SYMMETRIC_ONLY.discard(name)


def is_symmetric_only(name: str) -> bool:
    """True if the backend factorizes only symmetric matrices (reads one
    triangle) and is therefore invalid for nonsymmetric systems."""
    return name in _SYMMETRIC_ONLY


def get_solver_factory(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no sparse direct solver registered under {name!r}; "
            f"available: {sorted(_REGISTRY)}"
        ) from None


def has_solver(name: str) -> bool:
    return name in _REGISTRY


class _SpluKKT:
    """SuperLU wrapper tuned for augmented KKT systems.

    Partial pivoting on a saddle-point matrix with zero (2,2)-block
    diagonals destroys the symmetric-pattern fill bound (measured in
    ``hiop_tpu``: 240k -> 200M L+U nonzeros on the n=20000 sparse Ex1
    system once the delta regularizers are zero). So factorize WITHOUT
    pivoting first (SuperLU's ``SymmetricMode``, ``diag_pivot_thresh=0``)
    and verify each solve with one step of iterative refinement; if the
    no-pivot factors are unusable or inaccurate, refactorize with partial
    pivoting.

    Inertia: when the no-pivot factorization is in effect (perm_r ==
    perm_c certifies that no row pivoting deviated from the symmetric fill
    ordering), K = L U with U = D L^T, so the SIGNS of diag(U) are the
    pivot signs of an unpivoted LDL^T, the same inertia source as HSL
    MA57's pivots (hiopLinSolverSymSparseMA57.hpp:109). :meth:`inertia`
    returns None when only the pivoted fallback holds (callers then use the
    inertia-free curvature acceptor)."""

    def __init__(self, A_csc, spec: str):
        import numpy as np
        from scipy.sparse.linalg import splu

        self._A = A_csc
        self._lu = None
        self._inertia = None
        try:
            lu = splu(
                A_csc, permc_spec=spec, diag_pivot_thresh=0.0,
                options={"SymmetricMode": True},
            )
            if np.all(np.isfinite(lu.L.data)) and np.all(np.isfinite(lu.U.data)):
                self._lu = lu
                if np.array_equal(lu.perm_r, lu.perm_c):
                    d = lu.U.diagonal()
                    # sign count only: a pivot of magnitude delta_cc (1e-8)
                    # is a legitimate regularized negative pivot, so no
                    # relative tolerance here; outright singularity shows
                    # up as a SuperLU RuntimeError or non-finite factors,
                    # both routed to the singularity handler
                    n_zero = int(np.sum(d == 0.0))
                    n_neg = int(np.sum(d < 0.0))
                    n_pos = int(np.sum(d > 0.0))
                    self._inertia = (n_pos, n_neg, n_zero)
        except RuntimeError:
            self._lu = None
        if self._lu is None:
            self._lu = splu(A_csc, permc_spec=spec)  # pivoted fallback

    def inertia(self):
        """(n_pos, n_neg, n_zero) from the no-pivot factor diagonal, or
        None when only the pivoted (inertia-less) factorization holds."""
        return self._inertia

    def solve(self, rhs):
        import numpy as np

        x = self._lu.solve(rhs)
        r = rhs - self._A @ x
        x = x + self._lu.solve(r)  # one IR step
        nr = np.linalg.norm(rhs - self._A @ x)
        if not np.isfinite(nr) or nr > 1e-8 * (1.0 + np.linalg.norm(rhs)):
            from scipy.sparse.linalg import splu

            # no-pivot factors too inaccurate for this matrix: redo pivoted
            # and drop the inertia derived from them (callers re-reading
            # inertia() fall back to the curvature acceptor)
            self._inertia = None
            self._lu = splu(self._A, permc_spec="MMD_AT_PLUS_A")
            x = self._lu.solve(rhs)
            x = x + self._lu.solve(rhs - self._A @ x)
        return x


def _splu_factory(A_csc, ordering: str = "auto"):
    # KKT systems have symmetric structure: a symmetric-pattern minimum-
    # degree ordering gives far less fill than the unsymmetric COLAMD
    # default (hiop_tpu measured 115k vs 25M L+U nonzeros on the n=5000
    # sparse Ex1 augmented system). 'amd'/'auto' -> MMD on A^T+A,
    # 'rcm'/'none' fall through to SuperLU's corresponding modes.
    spec = {
        "auto": "MMD_AT_PLUS_A",
        "amd": "MMD_AT_PLUS_A",
        "rcm": "MMD_ATA",
        "none": "NATURAL",
    }.get(ordering, "MMD_AT_PLUS_A")
    return _SpluKKT(A_csc, spec)


register_solver("splu", _splu_factory)


def _native_ldl_factory(A_csc, ordering: str = "auto"):
    """The package's host up-looking sparse LDL^T (native/ldl.cpp), the MA57
    role (hiopLinSolverSymSparseMA57.hpp:109): pivot signs give the inertia
    for the inertia-correction acceptor. 'auto' keeps the natural KKT block
    order (x, d, yc, yd): the IPM's deltas make the matrix quasi-definite,
    for which the unpivoted positive-block-first elimination is stable;
    reorderings may place constraint rows before the primal block and hit
    structural zero pivots."""
    from hiop_tpu_torch.native.ldl import NativeLdlFactorization

    ord_map = {"auto": "none", "none": "none", "rcm": "rcm", "amd": "amd"}
    return NativeLdlFactorization(A_csc, ordering=ord_map.get(ordering, "none"))


register_solver("native_ldl", _native_ldl_factory, symmetric_only=True)

# 'device_ldl' names the device-resident level-scheduled sparse LDL^T
# (kkt/sparse_direct.DeviceSparseXDYcYdKKT over linalg/sparse_device). The
# name is registered as in hiop_tpu, because NlpSparse.matrix_free and
# FilterIPMNewton's strategy choice branch on has_solver(); the strategies
# build the device class themselves, and a generic caller that hands a csc
# matrix to its factory gets the host native LDL^T, as in hiop_tpu.
register_solver("device_ldl", _native_ldl_factory, symmetric_only=True)
