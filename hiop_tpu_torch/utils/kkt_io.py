"""Per-iteration KKT dumping.

Counterpart of ``hiop_tpu/utils/kkt_io.py`` (``hiopCSR_IO``, the
``write_kkt`` option): the KKT operands, right-hand side and solution of
each iteration go to ``<prefix>_kkt_iter<N>.npz`` in the working directory,
under the JAX package's file names and keys, so offline tools read the
dumps of either package. Tensors reach the host here, at the dump, and
nowhere else. :func:`write_iajaaa`/:func:`read_iajaaa` handle the
reference's ``.iajaaa`` sparse text format (src/LinAlg/csr_iajaaa.md).
"""

from __future__ import annotations

import numpy as np

from hiop_tpu_torch.formulation.base import to_numpy

#: file-name prefix of the dumps (``hiop_tpu``'s, for shared tooling)
DUMP_PREFIX = "hiop_tpu"


def dump_kkt(prefix: str, iter_num: int, **arrays) -> str:
    path = f"{prefix}_kkt_iter{iter_num}.npz"
    np.savez(path, **{k: to_numpy(v) for k, v in arrays.items() if v is not None})
    return path


def write_iajaaa(path: str, A, rhs=None, sol=None) -> str:
    """Write a matrix (+ optional rhs/solution vectors) in the reference's
    ``.iajaaa`` sparse text format: n, nnz, the n+1 row pointers
    (1-based), the nnz column indices (1-based), the nnz values, then any
    number of n-vectors. Dense input is converted; explicit zeros dropped."""
    A = to_numpy(A)
    n = A.shape[0]
    rows, cols = np.nonzero(A)
    vals = A[rows, cols]
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(row_ptr, rows + 1, 1)
    row_ptr = np.cumsum(row_ptr)
    with open(path, "w") as f:
        f.write(f"{n}\n{vals.size}\n")
        f.write("\n".join(str(int(p) + 1) for p in row_ptr) + "\n")
        f.write("\n".join(str(int(c) + 1) for c in cols) + "\n")
        f.write("\n".join(repr(float(v)) for v in vals) + "\n")
        for vec in (rhs, sol):
            if vec is not None:
                f.write("\n".join(repr(float(v)) for v in to_numpy(vec)) + "\n")
    return path


def read_iajaaa(path: str):
    """Read an .iajaaa file back; returns (A_dense, vectors list)."""
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    n = int(next(it))
    nnz = int(next(it))
    row_ptr = np.array([int(next(it)) - 1 for _ in range(n + 1)])
    cols = np.array([int(next(it)) - 1 for _ in range(nnz)])
    vals = np.array([float(next(it)) for _ in range(nnz)])
    A = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(row_ptr))
    A[rows, cols] = vals
    rest = [float(t) for t in it]
    vecs = [np.asarray(rest[i:i + n]) for i in range(0, len(rest), n)]
    return A, vecs
