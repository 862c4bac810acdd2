"""Blocked lower Cholesky for the MDS quick tier.

Counterpart of ``hiop_tpu/linalg/cholesky.py``, whose Pallas kernel
(``_chol_kernel``) served f32/bf16 matrices that fit VMEM, while the f64
main path used ``jnp.linalg.cholesky``. Here one function serves both:

- a CUDA tensor goes to the hand-written kernel (``csrc/cholesky.cu``,
  f32/f64, any n): per 64-wide block column, one CTA factors the diagonal
  block in registers (a Crout that builds the inverse of its factor
  in the same loop), a panel kernel forms P = W L_kk^{-T}, and a tiled
  kernel applies A22 -= P P^T to the lower triangle;
- a CPU tensor goes to :func:`cholesky_plain`, which repeats that blocked
  arithmetic with torch operations.

There is no fallback between the two: a CUDA tensor launches the kernel or
raises.

Failure semantics are those of ``jnp.linalg.cholesky``, which the f64
main path of ``hiop_tpu`` relies on (``kkt/mds.py``: ok = all(isfinite(L))):
when a pivot is not finite and positive, the whole lower triangle is NaN
and the upper triangle is 0.
"""

from __future__ import annotations

import torch

from hiop_tpu_torch.linalg import kernels as _k

NB = _k.NB


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the symmetric matrix A (lower triangle read)."""
    if A.is_cuda:
        return cholesky_cuda(A)
    if A.device.type != "cpu":
        raise ValueError(f"cholesky: unsupported device {A.device}")
    return cholesky_plain(A)


def cholesky_cuda(A: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (counted in
    ``kernels.stats`` as ``cholesky``)."""
    _k.check_input(A, "cholesky")
    n = A.shape[0]
    L = torch.empty_like(A)
    if n == 0:
        return L
    X = torch.empty((NB, NB), dtype=A.dtype, device=A.device)
    info = torch.zeros((1,), dtype=torch.int32, device=A.device)
    fn = getattr(_k.load(), "hiop_cholesky_" + _k.dtype_suffix(A.dtype))
    start = _k.stats.begin()
    rc = fn(A.data_ptr(), L.data_ptr(), n, X.data_ptr(), info.data_ptr(),
            torch.cuda.current_stream(A.device).cuda_stream)
    _k.raise_on_error(rc, "cholesky")
    _k.stats.count("cholesky", n, A.dtype, start)
    return L


def _diag_factor(S: torch.Tensor):
    """Crout of one diagonal block with the inverse of its factor built in
    the same loop (the kernel's ``diag_factor``). Returns (L_kk, X = L_kk^{-1},
    bad) where ``bad`` flags a pivot that is not finite and positive."""
    kb = S.shape[0]
    S = torch.tril(S).clone()
    L = torch.zeros_like(S)
    X = torch.eye(kb, dtype=S.dtype, device=S.device)
    bad = torch.zeros((), dtype=torch.bool, device=S.device)
    for j in range(kb):
        sjj = S[j, j]
        bad = bad | ~(torch.isfinite(sjj) & (sjj > 0))
        piv = torch.sqrt(sjj)
        inv = 1.0 / piv
        col = S[j + 1:, j] * inv
        xrow = X[j, : j + 1] * inv
        L[j, j] = piv
        L[j + 1:, j] = col
        S[j + 1:, j + 1:] -= torch.outer(col, col)
        X[j + 1:, : j + 1] -= torch.outer(col, xrow)
        X[j, : j + 1] = xrow
    return L, X, bad


def cholesky_plain(A: torch.Tensor) -> torch.Tensor:
    """The kernel's blocked right-looking arithmetic in torch operations
    (the CPU lane, and the yardstick the kernel is held against)."""
    n = A.shape[0]
    W = torch.tril(A).clone()
    bad = torch.zeros((), dtype=torch.bool, device=A.device)
    for k0 in range(0, n, NB):
        k1 = min(k0 + NB, n)
        Lkk, X, bad_k = _diag_factor(W[k0:k1, k0:k1])
        bad = bad | bad_k
        W[k0:k1, k0:k1] = Lkk
        if k1 == n:
            break
        P = W[k1:, k0:k1] @ X.T
        W[k1:, k0:k1] = P
        W[k1:, k1:] -= torch.tril(P @ P.T)
    return torch.where(bad, torch.tril(torch.full_like(W, float("nan"))), W)
