"""Native (C++) host-runtime utilities with lazy build and numpy fallback.

Counterpart of ``hiop_tpu/native/__init__.py``. The sparse symbolic phase
(triplet -> CSR with duplicate merging, CSR transpose index maps, RCM and
AMD fill-reducing orderings) runs on the host. It is implemented in C++
(``csr_utils.cpp``, a copy of the JAX package's source) compiled on first
use with ``g++``; if no compiler is available the numpy fallback is used
(same results, slower for very large patterns) and ``amd_ordering`` falls
back to RCM, as in ``hiop_tpu``.

:func:`build_library` is shared with :mod:`hiop_tpu_torch.native.ldl`: each
source is built once into ``build/native/`` at the repository root, under a
name that carries a hash of the source, so an edited source is rebuilt and
an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_SRC = _HERE / "csr_utils.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def build_library(src: Path) -> Optional[Path]:
    """Compile ``src`` with ``g++`` into ``build/native/`` unless that
    build exists already; returns the library's path, or None when there is
    no compiler or the build fails. The output is written to a temporary
    file and renamed, so processes that build at once never load half a
    file."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    lib = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except Exception:
        return None
    return lib


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
            lib.coo_to_csr_index.restype = ctypes.c_int64
            lib.coo_to_csr_index.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                _I64P, _I64P, _I64P, _I64P, _I64P, _I64P, _I64P,
            ]
            lib.csr_transpose_index.restype = None
            lib.csr_transpose_index.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                _I64P, _I64P, _I64P, _I64P, _I64P,
            ]
            lib.rcm_ordering.restype = None
            lib.rcm_ordering.argtypes = [ctypes.c_int64, _I64P, _I64P, _I64P]
            lib.amd_ordering.restype = ctypes.c_int64
            lib.amd_ordering.argtypes = [ctypes.c_int64, _I64P, _I64P, _I64P]
            _lib = lib
        except Exception:
            _build_failed = True
        return _lib


def native_available() -> bool:
    return _try_load() is not None


def coo_to_csr_index(
    m: int, n: int, rows: np.ndarray, cols: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sort/merge COO triplets into CSR order.

    Returns (perm, merge_to, out_rows, out_cols, row_ptr):
    values_csr = zeros(nnz_out); np.add.at(values_csr, merge_to, vals[perm]).
    """
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    nnz = rows.size
    lib = _try_load()
    if lib is not None:
        perm = np.empty(nnz, np.int64)
        merge_to = np.empty(nnz, np.int64)
        out_rows = np.empty(nnz, np.int64)
        out_cols = np.empty(nnz, np.int64)
        row_ptr = np.empty(m + 1, np.int64)
        nnz_out = lib.coo_to_csr_index(
            m, n, nnz, rows, cols, perm, merge_to, out_rows, out_cols, row_ptr
        )
        if nnz_out < 0:
            raise ValueError("invalid triplet structure (row out of range)")
        return perm, merge_to, out_rows[:nnz_out], out_cols[:nnz_out], row_ptr
    # numpy fallback
    perm = np.lexsort((cols, rows)).astype(np.int64)
    sr, sc = rows[perm], cols[perm]
    if nnz:
        new_grp = np.concatenate([[True], (sr[1:] != sr[:-1]) | (sc[1:] != sc[:-1])])
    else:
        new_grp = np.zeros(0, bool)
    merge_to = np.cumsum(new_grp).astype(np.int64) - 1
    out_rows = sr[new_grp]
    out_cols = sc[new_grp]
    row_ptr = np.zeros(m + 1, np.int64)
    np.add.at(row_ptr, out_rows + 1, 1)
    row_ptr = np.cumsum(row_ptr)
    return perm, merge_to, out_rows, out_cols, row_ptr


def csr_transpose_index(
    m: int, n: int, row_ptr: np.ndarray, cols: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (t_row_ptr, t_cols, perm) with values_T = values[perm]."""
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    nnz = cols.size
    lib = _try_load()
    if lib is not None:
        t_row_ptr = np.empty(n + 1, np.int64)
        t_cols = np.empty(nnz, np.int64)
        perm = np.empty(nnz, np.int64)
        lib.csr_transpose_index(m, n, nnz, row_ptr, cols, t_row_ptr, t_cols, perm)
        return t_row_ptr, t_cols, perm
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(row_ptr))
    perm = np.lexsort((rows, cols)).astype(np.int64)
    t_cols = rows[perm]
    t_row_ptr = np.zeros(n + 1, np.int64)
    np.add.at(t_row_ptr, cols[perm] + 1, 1)
    return np.cumsum(t_row_ptr), t_cols, perm


def rcm_ordering(n: int, row_ptr: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (new -> old) of a symmetric pattern."""
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    lib = _try_load()
    if lib is not None:
        order = np.empty(n, np.int64)
        lib.rcm_ordering(n, row_ptr, cols, order)
        return order
    # numpy/python fallback (BFS by increasing degree)
    import collections

    degree = np.diff(row_ptr)
    visited = np.zeros(n, bool)
    order = []
    while len(order) < n:
        cand = np.nonzero(~visited)[0]
        seed = cand[np.argmin(degree[cand])]
        q = collections.deque([seed])
        visited[seed] = True
        while q:
            u = q.popleft()
            order.append(u)
            nbrs = [v for v in cols[row_ptr[u]:row_ptr[u + 1]] if not visited[v]]
            for v in sorted(nbrs, key=lambda v: degree[v]):
                visited[v] = True
                q.append(v)
    return np.asarray(order[::-1], np.int64)


def amd_ordering(n: int, row_ptr: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Approximate-minimum-degree ordering (new -> old) of a symmetric
    pattern (CSR of A + A^T; diagonal ignored) — the fill-reducing ordering
    MA57/cuSOLVER provide in the reference (`linear_solver_sparse_ordering`
    option, hiopOptions.cpp). Falls back to RCM without a C++ toolchain."""
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    lib = _try_load()
    if lib is None:
        return rcm_ordering(n, row_ptr, cols)
    order = np.empty(n, np.int64)
    if lib.amd_ordering(n, row_ptr, cols, order) != 0:
        raise ValueError("invalid symmetric pattern (column index out of range)")
    return order
