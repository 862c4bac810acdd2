"""Blocked lower Cholesky for the MDS quick tier.

Counterpart of ``hiop_tpu/linalg/cholesky.py``, whose Pallas kernel
(``_chol_kernel``) served f32/bf16 matrices that fit VMEM, while the f64
main path used ``jnp.linalg.cholesky``. Here one function serves both:

- a CUDA tensor goes to the hand-written kernel (``csrc/cholesky.cu``,
  f32/f64, any n): per 64-wide block column, one CTA factors the diagonal
  block as two 32-wide leaves (one warp each, in registers, building the
  inverse of the factor in the same loop), a panel kernel forms
  P = W L_kk^{-T}, and the columns right of it inside the 256-wide outer
  block take A22 -= P P^T; after each outer block one rank-256 update
  covers the rest of the lower triangle (f64 tile products on the DMMA
  tensor cores, the whole launch sequence replayed as one CUDA graph);
- a CPU tensor goes to :func:`cholesky_plain`, which repeats that blocked
  arithmetic with torch operations.

There is no fallback between the two: a CUDA tensor launches the kernel or
raises.

Batches: :func:`cholesky_batched` factors an (S, n, n) stack of matrices
of one n, on a card in one batched launch of the same kernel (every launch
of the sequence with ``gridDim.z = S``; each factor is bit for bit the
single launch's), on the CPU by :func:`cholesky_plain_batched`.
:func:`cholesky` is batchable by ``torch.func.vmap``: under vmap its rule
calls :func:`cholesky_batched` once for all lanes, as ``pallas_call``'s
batching rule adds a grid axis under ``jax.vmap`` in ``hiop_tpu``.

Backends: ``hiop_tpu`` picks between its Pallas kernel and
``jnp.linalg.cholesky`` by a module global that the solver sets from the
``exec_policies`` option (``set_backend``). Here :func:`set_backend` /
:func:`backend` hold ``"kernel"`` (the hand-written kernel on a card, its
plain version on the CPU; the default) or ``"library"``
(``torch.linalg.cholesky_ex``: cuSOLVER on a card, LAPACK on the CPU), in a
context variable that each solve sets for its own run and restores
(:func:`backend_scope`); the mapping from the option is
:func:`hiop_tpu_torch.backends.execspace.kernel_backend`. The lane of every
call is counted in ``kernels.stats.lanes``.

Failure semantics are those of ``jnp.linalg.cholesky``, which the f64
main path of ``hiop_tpu`` relies on (``kkt/mds.py``: ok = all(isfinite(L))):
when a pivot is not finite and positive, the whole lower triangle is NaN
and the upper triangle is 0. Every lane keeps them.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from hiop_tpu_torch.linalg import kernels as _k
from hiop_tpu_torch.utils.dtensor import is_dtensor, local as mesh_local

NB = _k.NB
OB = _k.OB
LEAF = _k.LEAF

BACKENDS = ("kernel", "library")
_BACKEND = contextvars.ContextVar("hiop_tpu_torch_cholesky_backend", default="kernel")


def _checked(name: str) -> str:
    if name not in BACKENDS:
        raise ValueError(f"cholesky backend {name!r} is not one of {BACKENDS}")
    return name


def set_backend(name: str) -> None:
    """Select the Cholesky lane of this context: ``"kernel"`` or
    ``"library"``."""
    _BACKEND.set(_checked(name))


def backend() -> str:
    return _BACKEND.get()


@contextlib.contextmanager
def backend_scope(name: str):
    """:func:`set_backend` for the duration of a block (one solve), then
    the lane that was selected before."""
    token = _BACKEND.set(_checked(name))
    try:
        yield
    finally:
        _BACKEND.reset(token)


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the symmetric matrix A (lower triangle read).
    Under ``torch.func.vmap``, one batched launch over the lanes. A
    DTensor (a mesh-sharded solve's replicated system) is factored on each
    rank's own replica and comes back ``Replicate``."""
    if is_dtensor(A):
        A, wrap = mesh_local(A)
        return wrap(_Cholesky.apply(A))
    return _Cholesky.apply(A)


def _cholesky_one(A: torch.Tensor) -> torch.Tensor:
    if A.device.type not in ("cuda", "cpu"):
        raise ValueError(f"cholesky: unsupported device {A.device}")
    if _BACKEND.get() == "library":
        return cholesky_library(A, "cholesky")
    if A.is_cuda:
        _k.stats.lane("cholesky", "kernel")
        return cholesky_cuda(A)
    _k.stats.lane("cholesky", "plain")
    return cholesky_plain(A)


def cholesky_batched(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of an (S, n, n) stack of symmetric matrices;
    a matrix whose factorization fails gets the NaN lower triangle alone."""
    if A.device.type not in ("cuda", "cpu"):
        raise ValueError(f"cholesky_batched: unsupported device {A.device}")
    if _BACKEND.get() == "library":
        return cholesky_library(A, "cholesky_batched")
    if A.is_cuda:
        _k.stats.lane("cholesky_batched", "kernel")
        return cholesky_batched_cuda(A)
    _k.stats.lane("cholesky_batched", "plain")
    return cholesky_plain_batched(A)


def cholesky_library(A: torch.Tensor, op: str = "cholesky") -> torch.Tensor:
    """The library lane: ``torch.linalg.cholesky_ex`` of one matrix or an
    (S, n, n) stack (lower triangle read), with ``jnp.linalg.cholesky``'s
    failure semantics built on the device from ``info`` (no host read)."""
    start = _k.stats.begin() if A.is_cuda else None
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    # a failed matrix becomes all NaN, then tril_ zeroes its upper triangle
    # (a factor that succeeded is lower triangular already)
    L = torch.where((info == 0)[..., None, None], L, float("nan")).tril_()
    _k.stats.lane(op, "library", A, start)
    return L


class _Cholesky(torch.autograd.Function):
    """:func:`cholesky` with a ``torch.func.vmap`` rule (no derivative)."""

    @staticmethod
    def forward(A):
        return _cholesky_one(A)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, A):
        if in_dims[0] is None:
            return _cholesky_one(A), None
        return cholesky_batched(A.movedim(in_dims[0], 0).contiguous()), 0


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
            _k.args_buffer("cholesky", A).data_ptr(),
            torch.cuda.current_stream(A.device).cuda_stream)
    _k.raise_on_error(rc, "cholesky")
    _k.stats.count("cholesky", n, A.dtype, start)
    return L


def cholesky_batched_cuda(A: torch.Tensor) -> torch.Tensor:
    """Launch the batched CUDA kernel on the current stream (counted in
    ``kernels.stats`` as ``cholesky_batched``, once per batch)."""
    _k.check_input(A, "cholesky_batched", batched=True)
    S, n = A.shape[0], A.shape[-1]
    L = torch.empty_like(A)
    if n == 0:
        return L
    X = torch.empty((S, NB, NB), dtype=A.dtype, device=A.device)
    info = torch.zeros((S,), dtype=torch.int32, device=A.device)
    fn = getattr(_k.load(), "hiop_cholesky_batched_" + _k.dtype_suffix(A.dtype))
    start = _k.stats.begin()
    rc = fn(A.data_ptr(), L.data_ptr(), n, S, X.data_ptr(), info.data_ptr(),
            _k.args_buffer("cholesky_batched", A, S).data_ptr(),
            torch.cuda.current_stream(A.device).cuda_stream)
    _k.raise_on_error(rc, "cholesky_batched")
    _k.stats.count("cholesky_batched", n, A.dtype, start, batch=S)
    return L


def _leaf(S: torch.Tensor):
    """Crout of one 32-wide leaf with the inverse of its factor built in
    the same loop (the kernel's ``leaf32``). Returns (L, X = L^{-1}, pivots)."""
    kb = S.shape[0]
    S = torch.tril(S).clone()
    L = torch.zeros_like(S)
    X = torch.eye(kb, dtype=S.dtype, device=S.device)
    for j in range(kb):
        sjj = S[j, j]
        inv = torch.rsqrt(sjj)
        piv = sjj * inv
        col = S[j + 1:, j] * inv
        L[j, j] = piv
        L[j + 1:, j] = col
        S[j + 1:, j + 1:] -= torch.outer(col, col)
        xrow = X[j, : j + 1] * inv
        X[j + 1:, : j + 1] -= torch.outer(col, xrow)
        X[j, : j + 1] = xrow
    return L, X, torch.diagonal(S).clone()


def _diag_factor(S: torch.Tensor):
    """Factor of one diagonal block and the inverse of that factor, as the
    kernel's ``diag_factor`` does it: two 32-wide leaves joined by small
    products. Returns (L_kk, X = L_kk^{-1}, bad) where ``bad`` flags a pivot
    that is not finite and positive."""
    kb = S.shape[0]
    h = min(kb, LEAF)
    L11, X11, p1 = _leaf(S[:h, :h])
    if kb == h:
        return L11, X11, ~(torch.isfinite(p1) & (p1 > 0)).all()
    L21 = S[h:, :h] @ X11.T
    L22, X22, p2 = _leaf(S[h:, h:] - torch.tril(L21 @ L21.T))
    p = torch.cat([p1, p2])
    L = torch.zeros_like(S)
    X = torch.zeros_like(S)
    L[:h, :h], L[h:, :h], L[h:, h:] = L11, L21, L22
    X[:h, :h], X[h:, h:] = X11, X22
    X[h:, :h] = -(X22 @ (L21 @ X11))
    return L, X, ~(torch.isfinite(p) & (p > 0)).all()


def cholesky_plain(A: torch.Tensor) -> torch.Tensor:
    """The kernel's blocked arithmetic in torch operations (the CPU lane,
    and the yardstick the kernel is held against): NB-wide block columns,
    updates of the columns inside an OB-wide outer block at each block
    column, and one rank-OB update of the rest after each outer block."""
    n = A.shape[0]
    W = torch.tril(A).clone()
    bad = torch.zeros((), dtype=torch.bool, device=A.device)
    for K0 in range(0, n, OB):
        kend = min(K0 + OB, n)
        for k0 in range(K0, kend, NB):
            k1 = min(k0 + NB, n)
            Lkk, X, bad_k = _diag_factor(W[k0:k1, k0:k1])
            bad = bad | bad_k
            W[k0:k1, k0:k1] = Lkk
            if k1 == n:
                break
            P = W[k1:, k0:k1] @ X.T
            W[k1:, k0:k1] = P
            if k1 < kend:
                W[k1:, k1:kend] -= torch.tril(P @ P[: kend - k1].T)
        if kend < n:
            P = W[kend:, K0:kend]
            W[kend:, kend:] -= torch.tril(P @ P.T)
    return torch.where(bad, torch.tril(torch.full_like(W, float("nan"))), W)


def _leaf_batched(S: torch.Tensor):
    """:func:`_leaf` of an (S, kb, kb) stack, the same operations per matrix."""
    kb = S.shape[-1]
    S = torch.tril(S).clone()
    L = torch.zeros_like(S)
    X = torch.eye(kb, dtype=S.dtype, device=S.device).expand_as(S).clone()
    for j in range(kb):
        sjj = S[:, j, j]
        inv = torch.rsqrt(sjj)
        piv = sjj * inv
        col = S[:, j + 1:, j] * inv[:, None]
        L[:, j, j] = piv
        L[:, j + 1:, j] = col
        S[:, j + 1:, j + 1:] -= col[:, :, None] * col[:, None, :]
        xrow = X[:, j, : j + 1] * inv[:, None]
        X[:, j + 1:, : j + 1] -= col[:, :, None] * xrow[:, None, :]
        X[:, j, : j + 1] = xrow
    return L, X, torch.diagonal(S, dim1=-2, dim2=-1).clone()


def _diag_factor_batched(S: torch.Tensor):
    """:func:`_diag_factor` of an (S, kb, kb) stack; ``bad`` per matrix."""
    kb = S.shape[-1]
    h = min(kb, LEAF)
    L11, X11, p1 = _leaf_batched(S[:, :h, :h])
    if kb == h:
        return L11, X11, ~(torch.isfinite(p1) & (p1 > 0)).all(dim=-1)
    L21 = S[:, h:, :h] @ X11.mT
    L22, X22, p2 = _leaf_batched(S[:, h:, h:] - torch.tril(L21 @ L21.mT))
    p = torch.cat([p1, p2], dim=-1)
    L = torch.zeros_like(S)
    X = torch.zeros_like(S)
    L[:, :h, :h], L[:, h:, :h], L[:, h:, h:] = L11, L21, L22
    X[:, :h, :h], X[:, h:, h:] = X11, X22
    X[:, h:, :h] = -(X22 @ (L21 @ X11))
    return L, X, ~(torch.isfinite(p) & (p > 0)).all(dim=-1)


def cholesky_plain_batched(A: torch.Tensor) -> torch.Tensor:
    """:func:`cholesky_plain` of an (S, n, n) stack: the same blocked
    arithmetic per matrix (the batched kernel's CPU lane and yardstick)."""
    n = A.shape[-1]
    W = torch.tril(A).clone()
    bad = torch.zeros(A.shape[:1], dtype=torch.bool, device=A.device)
    for K0 in range(0, n, OB):
        kend = min(K0 + OB, n)
        for k0 in range(K0, kend, NB):
            k1 = min(k0 + NB, n)
            Lkk, X, bad_k = _diag_factor_batched(W[:, k0:k1, k0:k1])
            bad = bad | bad_k
            W[:, k0:k1, k0:k1] = Lkk
            if k1 == n:
                break
            P = W[:, k1:, k0:k1] @ X.mT
            W[:, k1:, k0:k1] = P
            if k1 < kend:
                W[:, k1:, k1:kend] -= torch.tril(P @ P[:, : kend - k1].mT)
        if kend < n:
            P = W[:, kend:, K0:kend]
            W[:, kend:, kend:] -= torch.tril(P @ P.mT)
    nan = torch.tril(torch.full_like(W, float("nan")))
    return torch.where(bad[:, None, None], nan, W)
