"""Native sparse LDL^T host solver with inertia (ldl.cpp wrapper).

Counterpart of ``hiop_tpu/native/ldl.py``; ``ldl.cpp`` is a copy of the JAX
package's source, built with ``g++`` at first use into ``build/native/``
(:func:`hiop_tpu_torch.native.build_library`).

Registry bridge playing the reference's HSL MA57 role
(HiOp's src/LinAlg/hiopLinSolverSymSparseMA57.hpp:109): a host
symmetric-indefinite factorization whose pivot signs provide the inertia
for the inertia-correction acceptance test (hiopFactAcceptor.hpp:97). No
numerical pivoting (like the reference's MAGMA-nopiv/cuSOLVER paths): a
tiny pivot fails the factorization and the IPM's regularization ladder
retries.

The symbolic analysis is cached per sparsity pattern (per process), so the
per-iteration cost is the numeric factorization only — the reference's
symbolic-once/numeric-per-iteration discipline. The MDS strategy's
``schur_sparse_ldl`` safe tier (:func:`hiop_tpu_torch.kkt.mds.factorize_safe_schur`)
factors its sparse Schur block with it.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from hiop_tpu_torch.native import amd_ordering, build_library, rcm_ordering

_SRC = Path(__file__).resolve().parent / "ldl.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_I64PP = ctypes.POINTER(ctypes.c_int64)


def _try_load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = build_library(_SRC)
        if path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
            lib.ldl_symbolic.restype = ctypes.c_int64
            lib.ldl_symbolic.argtypes = [
                ctypes.c_int64, _I64P, _I64P, _I64P, _I64P, _I64P, _I64P,
            ]
            lib.ldl_numeric.restype = ctypes.c_int64
            lib.ldl_numeric.argtypes = [
                ctypes.c_int64, _I64P, _I64P, _F64P, _I64P, _I64P,
                _I64P, _F64P, _F64P, ctypes.c_double,
                _I64PP, _I64PP, _I64PP,
                _I64P, _I64P, _I64P, _F64P,
            ]
            lib.ldl_solve.restype = None
            lib.ldl_solve.argtypes = [ctypes.c_int64, _I64P, _I64P, _F64P, _F64P, _F64P]
            lib.ldl_solve_multi.restype = None
            lib.ldl_solve_multi.argtypes = [
                ctypes.c_int64, ctypes.c_int64, _I64P, _I64P, _F64P, _F64P, _F64P,
            ]
            _lib = lib
        except Exception:
            _build_failed = True
        return _lib


def native_available() -> bool:
    return _try_load() is not None


class _Symbolic:
    __slots__ = ("parent", "Lp", "lnz")

    def __init__(self, parent, Lp, lnz):
        self.parent = parent
        self.Lp = Lp
        self.lnz = lnz


#: pattern-hash -> (perm or None, _Symbolic); the KKT assembler rebuilds the
#: matrix object every iteration but the pattern is static
_SYMBOLIC_CACHE: Dict[bytes, Tuple[Optional[np.ndarray], _Symbolic]] = {}


class SingularError(RuntimeError):
    """Zero/tiny pivot at column k (matches SuperLU's RuntimeError contract
    so a caller's regularization retry handles both backends)."""


class NativeLdlFactorization:
    """Factorize P A P^T = L D L^T for a symmetric scipy sparse matrix.

    ``solve(rhs)`` accepts (n,) or (n, k); ``inertia()`` returns
    (n_pos, n_neg, n_zero) from the signs of D.
    """

    def __init__(self, A, ordering: str = "auto", zero_tol: float = 0.0):
        import scipy.sparse as sp

        lib = _try_load()
        if lib is None:
            raise RuntimeError("native LDL library unavailable (no C++ toolchain?)")
        A = sp.csc_matrix(A)
        n = A.shape[0]
        if A.shape[0] != A.shape[1]:
            raise ValueError("matrix must be square")
        self.n = n

        key_src = A.indptr.tobytes() + A.indices.tobytes() + ordering.encode()
        key = hashlib.sha1(key_src).digest()
        cached = _SYMBOLIC_CACHE.get(key)
        if cached is not None:
            perm, sym = cached
            if perm is not None:
                A = A[perm][:, perm].tocsc()
            U = sp.triu(A, format="csc")
            Ap = np.ascontiguousarray(U.indptr, np.int64)
            Ai = np.ascontiguousarray(U.indices, np.int64)
        else:
            perm = self._compute_perm(A, ordering)
            if perm is not None:
                A = A[perm][:, perm].tocsc()
            U = sp.triu(A, format="csc")
            Ap = np.ascontiguousarray(U.indptr, np.int64)
            Ai = np.ascontiguousarray(U.indices, np.int64)
            parent = np.empty(n, np.int64)
            Lnz = np.empty(n, np.int64)
            Lp = np.empty(n + 1, np.int64)
            flag = np.empty(n, np.int64)
            lnz = lib.ldl_symbolic(n, Ap, Ai, parent, Lnz, Lp, flag)
            if lnz < 0:
                raise ValueError("invalid upper-triangle pattern")
            sym = _Symbolic(parent, Lp, int(lnz))
            _SYMBOLIC_CACHE[key] = (perm, sym)

        Ax = np.ascontiguousarray(U.data, np.float64)
        self._perm = perm
        self._Lp = sym.Lp
        self._Li = np.empty(sym.lnz, np.int64)
        self._Lx = np.empty(sym.lnz, np.float64)
        self._D = np.empty(n, np.float64)
        npos = ctypes.c_int64()
        nneg = ctypes.c_int64()
        nzero = ctypes.c_int64()
        flag = np.empty(n, np.int64)
        pattern = np.empty(n, np.int64)
        lnz_cnt = np.empty(n, np.int64)
        Y = np.empty(n, np.float64)
        bad = lib.ldl_numeric(
            n, Ap, Ai, Ax, sym.Lp, sym.parent,
            self._Li, self._Lx, self._D, float(zero_tol),
            ctypes.byref(npos), ctypes.byref(nneg), ctypes.byref(nzero),
            flag, pattern, lnz_cnt, Y,
        )
        self._inertia = (int(npos.value), int(nneg.value), int(nzero.value))
        if bad >= 0:
            raise SingularError(f"zero pivot at column {bad} (of {n})")

    @staticmethod
    def _compute_perm(A, ordering: str) -> Optional[np.ndarray]:
        if ordering in ("none",):
            return None
        # amd -> native approximate minimum degree, rcm/auto -> native RCM
        import scipy.sparse as sp

        S = sp.csr_matrix(A)
        fn = amd_ordering if ordering == "amd" else rcm_ordering
        order = fn(
            A.shape[0],
            np.asarray(S.indptr, np.int64),
            np.asarray(S.indices, np.int64),
        )
        return np.asarray(order, np.int64)

    def inertia(self) -> Tuple[int, int, int]:
        return self._inertia

    def solve(self, rhs):
        lib = _try_load()
        rhs = np.asarray(rhs, np.float64)
        one_d = rhs.ndim == 1
        B = rhs.reshape(self.n, -1) if not one_d else rhs[:, None]
        if self._perm is not None:
            B = B[self._perm]
        # explicit copy: ldl_solve_multi works in place and the reshape
        # chain above can alias the caller's array
        B = np.array(B.T, dtype=np.float64, order="C").reshape(-1)
        lib.ldl_solve_multi(
            self.n, rhs.size // self.n, self._Lp, self._Li, self._Lx, self._D, B
        )
        X = B.reshape(-1, self.n).T
        if self._perm is not None:
            Xout = np.empty_like(X)
            Xout[self._perm] = X
            X = Xout
        return X[:, 0] if one_d else X.reshape(rhs.shape)
