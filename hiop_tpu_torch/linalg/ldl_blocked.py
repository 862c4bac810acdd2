"""Blocked no-pivot LDL^T (the inertia-revealing MDS safe tier).

Counterpart of ``hiop_tpu/linalg/ldl_blocked.py`` (reference
hiopLinSolverSymDenseMagmaNopiv, hiopLinSolverSymDenseMagma.hpp:145): about
twice as fast as pivoted LDL^T but less stable, used inside the IPM's
regularization ladder where a breakdown triggers a retry with larger
perturbations. The inertia comes from the signs of the pivots, valid by
Sylvester's law whenever the factorization completes without breakdown.

The matrix is padded with an identity block to a multiple of 128, as in
``_ldl_factor_impl``; the padding pivots are +1 and are left out of the
inertia count. The factorization itself:

- a CUDA tensor goes to the hand-written kernel (``csrc/ldl_nopiv.cu``,
  f32/f64, any size): per 64-wide block column, one CTA factors the
  diagonal block as two 32-wide leaves (one warp each, in registers, with
  the unit-lower inverse built in the same loop), a panel kernel forms
  P = W L_kk^{-T} D_kk^{-1}, and the columns right of it inside the
  256-wide outer block take A22 -= P D_kk P^T; after each outer block one
  rank-256 update covers the rest of the lower triangle (as
  :mod:`hiop_tpu_torch.linalg.cholesky`);
- a CPU tensor goes to :func:`ldl_nopiv_plain`, which repeats that blocked
  arithmetic with torch operations.

The no-pivot factor is unique, so the block width (64 here, 128 in the
JAX lanes) changes the result by rounding only. A zero pivot gives d = 0
and a zeroed column, not NaN; ``ok`` then reports the breakdown.

Every ``exec_policies`` value takes this kernel (no library has a
no-pivot LDL^T; the plain version is the CPU lane and the tests'
yardstick); ``kernels.stats.lanes`` counts the lane of each call.

Solve = unit-lower triangular solve, diagonal scale, unit-upper solve
(``torch.linalg.solve_triangular``; in JAX these are XLA calls outside the
Pallas kernel too).

Batches: :func:`ldl_nopiv_batched` factors an (S, n, n) stack of matrices
of one n, on a card in one batched launch of the same kernel (each factor
bit for bit the single launch's), on the CPU by
:func:`ldl_nopiv_plain_batched`; :func:`ldl_factor_batched` pads each
matrix and reduces ``ok``/``n_neg`` per matrix. :func:`ldl_nopiv` (and so
:func:`ldl_factor`) is batchable by ``torch.func.vmap``: under vmap its
rule makes one batched launch over the lanes, as ``pallas_call``'s
batching rule adds a grid axis under ``jax.vmap`` in ``hiop_tpu``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hiop_tpu_torch.linalg import kernels as _k
from hiop_tpu_torch.utils.dtensor import is_dtensor, local as mesh_local

_BLOCK = 128  # padding granularity of hiop_tpu's _ldl_factor_impl
NB = _k.NB
OB = _k.OB
LEAF = _k.LEAF


class LdlFactors(NamedTuple):
    L: torch.Tensor       # (n_p, n_p) unit-lower factor (padded)
    d: torch.Tensor       # (n_p,) pivots (padding pivots are +1)
    n: int                # true (unpadded) dimension
    n_neg: torch.Tensor   # count of negative pivots among the first n
    ok: torch.Tensor      # bool: finite factor, no pivot breakdown


def _inv_or_zero(d):
    return torch.where(d.abs() > 0, 1.0 / torch.where(d == 0, 1.0, d), 0.0)


def _pad_sym(M, n_p):
    """Embed M (or each matrix of a stack) into blkdiag(M, I_{n_p-n}) —
    extra pivots come out as +1. Out of place, so that it runs under
    ``torch.func.vmap``."""
    n = M.shape[-1]
    if n_p == n:
        return M.contiguous()
    pad = n_p - n
    lead = M.shape[:-2]
    right = M.new_zeros((*lead, n, pad))
    eye = torch.eye(pad, dtype=M.dtype, device=M.device).expand(*lead, pad, pad)
    bottom = torch.cat([M.new_zeros((*lead, pad, n)), eye], dim=-1)
    return torch.cat([torch.cat([M, right], dim=-1), bottom], dim=-2).contiguous()


def ldl_nopiv(A: torch.Tensor):
    """(L, d) of the symmetric matrix A (lower triangle read), any size.
    Under ``torch.func.vmap``, one batched launch over the lanes. A
    DTensor (a mesh-sharded solve's replicated system) is factored on each
    rank's own replica and comes back ``Replicate``."""
    if is_dtensor(A):
        A, wrap = mesh_local(A)
        L, d = _LdlNopiv.apply(A)
        return wrap(L), wrap(d)
    return _LdlNopiv.apply(A)


def _ldl_nopiv_one(A: torch.Tensor):
    if A.is_cuda:
        _k.stats.lane("ldl_nopiv", "kernel")
        return ldl_nopiv_cuda(A)
    if A.device.type != "cpu":
        raise ValueError(f"ldl_nopiv: unsupported device {A.device}")
    _k.stats.lane("ldl_nopiv", "plain")
    return ldl_nopiv_plain(A)


def ldl_nopiv_batched(A: torch.Tensor):
    """(L, d) of each matrix of an (S, n, n) stack: (S, n, n) and (S, n)."""
    if A.is_cuda:
        _k.stats.lane("ldl_nopiv_batched", "kernel")
        return ldl_nopiv_batched_cuda(A)
    if A.device.type != "cpu":
        raise ValueError(f"ldl_nopiv_batched: unsupported device {A.device}")
    _k.stats.lane("ldl_nopiv_batched", "plain")
    return ldl_nopiv_plain_batched(A)


class _LdlNopiv(torch.autograd.Function):
    """:func:`ldl_nopiv` with a ``torch.func.vmap`` rule (no derivative)."""

    @staticmethod
    def forward(A):
        return _ldl_nopiv_one(A)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, A):
        if in_dims[0] is None:
            return _ldl_nopiv_one(A), (None, None)
        return ldl_nopiv_batched(A.movedim(in_dims[0], 0).contiguous()), (0, 0)


def ldl_nopiv_cuda(A: torch.Tensor):
    """Launch the CUDA kernel on the current stream (counted in
    ``kernels.stats`` as ``ldl_nopiv``)."""
    _k.check_input(A, "ldl_nopiv")
    n = A.shape[0]
    L = torch.empty_like(A)
    d = torch.empty((n,), dtype=A.dtype, device=A.device)
    if n == 0:
        return L, d
    X = torch.empty((NB, NB), dtype=A.dtype, device=A.device)
    invd = torch.empty((NB,), dtype=A.dtype, device=A.device)
    fn = getattr(_k.load(), "hiop_ldl_nopiv_" + _k.dtype_suffix(A.dtype))
    start = _k.stats.begin()
    rc = fn(A.data_ptr(), L.data_ptr(), d.data_ptr(), n, X.data_ptr(), invd.data_ptr(),
            _k.args_buffer("ldl_nopiv", A).data_ptr(),
            torch.cuda.current_stream(A.device).cuda_stream)
    _k.raise_on_error(rc, "ldl_nopiv")
    _k.stats.count("ldl_nopiv", n, A.dtype, start)
    return L, d


def ldl_nopiv_batched_cuda(A: torch.Tensor):
    """Launch the batched CUDA kernel on the current stream (counted in
    ``kernels.stats`` as ``ldl_nopiv_batched``, once per batch)."""
    _k.check_input(A, "ldl_nopiv_batched", batched=True)
    S, n = A.shape[0], A.shape[-1]
    L = torch.empty_like(A)
    d = torch.empty((S, n), dtype=A.dtype, device=A.device)
    if n == 0:
        return L, d
    X = torch.empty((S, NB, NB), dtype=A.dtype, device=A.device)
    invd = torch.empty((S, NB), dtype=A.dtype, device=A.device)
    fn = getattr(_k.load(), "hiop_ldl_nopiv_batched_" + _k.dtype_suffix(A.dtype))
    start = _k.stats.begin()
    rc = fn(A.data_ptr(), L.data_ptr(), d.data_ptr(), n, S, X.data_ptr(), invd.data_ptr(),
            _k.args_buffer("ldl_nopiv_batched", A, S).data_ptr(),
            torch.cuda.current_stream(A.device).cuda_stream)
    _k.raise_on_error(rc, "ldl_nopiv_batched")
    _k.stats.count("ldl_nopiv_batched", n, A.dtype, start, batch=S)
    return L, d


def _leaf(S: torch.Tensor):
    """Unblocked no-pivot LDL^T of one 32-wide leaf with the unit-lower
    inverse built in the same loop (the kernel's ``leaf32``; the fused form
    of hiop_tpu's ``_ldl_diag_block_inv``). Returns (L, d, X = L^{-1})."""
    kb = S.shape[0]
    S = torch.tril(S).clone()
    L = torch.eye(kb, dtype=S.dtype, device=S.device)
    d = torch.zeros((kb,), dtype=S.dtype, device=S.device)
    X = torch.eye(kb, dtype=S.dtype, device=S.device)
    for j in range(kb):
        dj = S[j, j]
        scol = S[j + 1:, j]
        lcol = scol * _inv_or_zero(dj)
        L[j + 1:, j] = lcol
        d[j] = dj
        S[j + 1:, j + 1:] -= torch.outer(scol, lcol)
        X[j + 1:, : j + 1] -= torch.outer(lcol, X[j, : j + 1])
    return L, d, X


def _diag_factor(S: torch.Tensor):
    """No-pivot LDL^T of one diagonal block and the inverse of its unit
    lower factor, as the kernel's ``diag_factor`` does it: two 32-wide
    leaves joined by small products. Returns (L_kk, d_kk, X)."""
    kb = S.shape[0]
    h = min(kb, LEAF)
    L11, d1, X11 = _leaf(S[:h, :h])
    if kb == h:
        return L11, d1, X11
    T21 = S[h:, :h] @ X11.T
    L21 = T21 * _inv_or_zero(d1)[None, :]
    L22, d2, X22 = _leaf(S[h:, h:] - torch.tril(L21 @ T21.T))
    L = torch.zeros_like(S)
    X = torch.zeros_like(S)
    L[:h, :h], L[h:, :h], L[h:, h:] = L11, L21, L22
    X[:h, :h], X[h:, h:] = X11, X22
    X[h:, :h] = -(X22 @ (L21 @ X11))
    return L, torch.cat([d1, d2]), X


def ldl_nopiv_plain(A: torch.Tensor):
    """The kernel's blocked arithmetic in torch operations (the CPU lane,
    and the yardstick the kernel is held against): NB-wide block columns,
    updates of the columns inside an OB-wide outer block at each block
    column, and one rank-OB update of the rest after each outer block."""
    n = A.shape[0]
    W = torch.tril(A).clone()
    d = torch.zeros((n,), dtype=A.dtype, device=A.device)
    for K0 in range(0, n, OB):
        kend = min(K0 + OB, n)
        for k0 in range(K0, kend, NB):
            k1 = min(k0 + NB, n)
            Lkk, dk, X = _diag_factor(W[k0:k1, k0:k1])
            W[k0:k1, k0:k1] = Lkk
            d[k0:k1] = dk
            if k1 == n:
                break
            P = (W[k1:, k0:k1] @ X.T) * _inv_or_zero(dk)[None, :]
            W[k1:, k0:k1] = P
            if k1 < kend:
                W[k1:, k1:kend] -= torch.tril((P * dk[None, :]) @ P[: kend - k1].T)
        if kend < n:
            P = W[kend:, K0:kend]
            W[kend:, kend:] -= torch.tril((P * d[None, K0:kend]) @ P.T)
    return W, d


def ldl_factor(M: torch.Tensor) -> LdlFactors:
    """Blocked no-pivot LDL^T of symmetric M with ``_ldl_factor_impl``'s
    padding, breakdown test and inertia count. Any square f32/f64 matrix."""
    L, d = ldl_nopiv(_pad_sym(M, _padded_size(M.shape[0])))
    return ldl_factors(M, L, d)


def _padded_size(n: int) -> int:
    return max(((n + _BLOCK - 1) // _BLOCK) * _BLOCK, _BLOCK)


def ldl_factor_batched(M: torch.Tensor) -> LdlFactors:
    """:func:`ldl_factor` of each matrix of an (S, n, n) stack in one
    batched factorization: L (S, n_p, n_p), d (S, n_p), and ``n_neg`` and
    ``ok`` per matrix (S,)."""
    n = M.shape[-1]
    L, d = ldl_nopiv_batched(_pad_sym(M, _padded_size(n)))
    n_p = L.shape[-1]
    true_mask = torch.arange(n_p, device=M.device) < n
    d_true = torch.where(true_mask, d, 1.0)
    if n:
        scale = M.abs().amax(dim=(-2, -1)).clamp(min=1.0)
    else:
        scale = M.new_ones(M.shape[:1])
    tiny = torch.finfo(M.dtype).eps * scale * 1e-2
    ok = (
        torch.isfinite(L).all(dim=-1).all(dim=-1)
        & torch.isfinite(d).all(dim=-1)
        & (d_true.abs() > tiny[:, None]).all(dim=-1)
    )
    n_neg = ((d < 0) & true_mask).sum(dim=-1)
    return LdlFactors(L, d, n, n_neg, ok)


def ldl_factors(M: torch.Tensor, L: torch.Tensor, d: torch.Tensor) -> LdlFactors:
    """The factors of M from (L, d) of its padded form: the breakdown test
    and the inertia count of ``_ldl_factor_impl``."""
    n, n_p = M.shape[0], L.shape[0]
    true_mask = torch.arange(n_p, device=M.device) < n
    d_true = torch.where(true_mask, d, 1.0)
    # breakdown: pivots tiny relative to the matrix scale, or non-finite
    # factor — either way the factorization carries no usable information
    scale = M.abs().max().clamp(min=1.0) if n else 1.0
    tiny = torch.finfo(M.dtype).eps * scale * 1e-2
    ok = (
        torch.isfinite(L).all()
        & torch.isfinite(d).all()
        & (d_true.abs() > tiny).all()
    )
    n_neg = ((d < 0) & true_mask).sum()
    return LdlFactors(L, d, n, n_neg, ok)


def ldl_solve(f: LdlFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Solve M x = rhs with the factors. rhs is (n,) or (n, k)."""
    n_p = f.L.shape[0]
    squeeze = rhs.dim() == 1
    r = rhs[:, None] if squeeze else rhs
    pad = n_p - r.shape[0]
    if pad:
        r = torch.cat([r, r.new_zeros((pad, r.shape[1]))], dim=0)
    y = torch.linalg.solve_triangular(f.L, r, upper=False, unitriangular=True)
    z = y * _inv_or_zero(f.d)[:, None]
    x = torch.linalg.solve_triangular(f.L.T, z, upper=True, unitriangular=True)
    x = x[: rhs.shape[0]]
    return x[:, 0] if squeeze else x


def _leaf_batched(S: torch.Tensor):
    """:func:`_leaf` of an (S, kb, kb) stack, the same operations per matrix."""
    kb = S.shape[-1]
    S = torch.tril(S).clone()
    eye = torch.eye(kb, dtype=S.dtype, device=S.device).expand_as(S)
    L = eye.clone()
    d = S.new_zeros(S.shape[:-1])
    X = eye.clone()
    for j in range(kb):
        dj = S[:, j, j]
        scol = S[:, j + 1:, j]
        lcol = scol * _inv_or_zero(dj)[:, None]
        L[:, j + 1:, j] = lcol
        d[:, j] = dj
        S[:, j + 1:, j + 1:] -= scol[:, :, None] * lcol[:, None, :]
        X[:, j + 1:, : j + 1] -= lcol[:, :, None] * X[:, j, None, : j + 1]
    return L, d, X


def _diag_factor_batched(S: torch.Tensor):
    """:func:`_diag_factor` of an (S, kb, kb) stack."""
    kb = S.shape[-1]
    h = min(kb, LEAF)
    L11, d1, X11 = _leaf_batched(S[:, :h, :h])
    if kb == h:
        return L11, d1, X11
    T21 = S[:, h:, :h] @ X11.mT
    L21 = T21 * _inv_or_zero(d1)[:, None, :]
    L22, d2, X22 = _leaf_batched(S[:, h:, h:] - torch.tril(L21 @ T21.mT))
    L = torch.zeros_like(S)
    X = torch.zeros_like(S)
    L[:, :h, :h], L[:, h:, :h], L[:, h:, h:] = L11, L21, L22
    X[:, :h, :h], X[:, h:, h:] = X11, X22
    X[:, h:, :h] = -(X22 @ (L21 @ X11))
    return L, torch.cat([d1, d2], dim=-1), X


def ldl_nopiv_plain_batched(A: torch.Tensor):
    """:func:`ldl_nopiv_plain` of an (S, n, n) stack: the same blocked
    arithmetic per matrix (the batched kernel's CPU lane and yardstick)."""
    n = A.shape[-1]
    W = torch.tril(A).clone()
    d = A.new_zeros(A.shape[:-1])
    for K0 in range(0, n, OB):
        kend = min(K0 + OB, n)
        for k0 in range(K0, kend, NB):
            k1 = min(k0 + NB, n)
            Lkk, dk, X = _diag_factor_batched(W[:, k0:k1, k0:k1])
            W[:, k0:k1, k0:k1] = Lkk
            d[:, k0:k1] = dk
            if k1 == n:
                break
            P = (W[:, k1:, k0:k1] @ X.mT) * _inv_or_zero(dk)[:, None, :]
            W[:, k1:, k0:k1] = P
            if k1 < kend:
                W[:, k1:, k1:kend] -= torch.tril((P * dk[:, None, :]) @ P[:, : kend - k1].mT)
        if kend < n:
            P = W[:, kend:, K0:kend]
            W[:, kend:, kend:] -= torch.tril((P * d[:, None, K0:kend]) @ P.mT)
    return W, d
