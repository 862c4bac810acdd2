"""Compact limited-memory BFGS (Byrd-Nocedal-Schnabel).

Counterpart of ``hiop_tpu/optimization/hessian_lowrank.py`` (reference
hiopHessianLowRank, hiopHessianLowRank.hpp:60-90)::

  B = sigma*I - U N^{-1} U^T,   U = [sigma*S, Y] (n x 2l),
  N = [[sigma*S^T S, L], [L^T, -D]],
  L_ij = s_i^T y_j (i > j),  D = diag(s_i^T y_i)

solved with H = B + Dx (Dx = log-barrier diagonal) through the inverse
representation (doc hpp:75-85)::

  H^{-1} = Dh^{-1} - Dh^{-1} U V^{-1} U^T Dh^{-1},
  Dh = sigma + Dx (diagonal),  V = -N + U^T Dh^{-1} U.

The memory S, Y is a fixed-size (l_max, n) pair of tensors with a 0/1
activity mask, as in ``hiop_tpu``: inactive rows are zeroed and their V
rows/columns padded with identity, so a partly filled memory behaves
exactly as there. The secant update (the skip test, the five sigma
strategies and the sigma clip) decides with ``torch.where`` on the device
and never synchronizes; the 2l x 2l solves go through
:func:`hiop_tpu_torch.linalg.small_solve.solve_small`. On a mesh S and Y
are n-sharded DTensors: the l x l Gram matrices contract over n and end in
an all-reduce, the reference's MPI_Allreduce of l x l buffers
(hiopHessianLowRank.cpp:459, 590-591), and the 2l x 2l V solve runs
replicated, as the reference's does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hiop_tpu_torch.linalg.small_solve import solve_small


class BfgsState(NamedTuple):
    S: torch.Tensor        # (l_max, n) rows s_i, chronological (oldest first)
    Y: torch.Tensor        # (l_max, n) rows y_i
    active: torch.Tensor   # (l_max,) 0/1 float mask
    sigma: torch.Tensor    # scalar multiple of identity in B0


def init_state(n: int, l_max: int, sigma0: float = 1.0, dtype=torch.float64,
               device=None, mesh=None, axis_name: str = "n") -> BfgsState:
    """Zero BFGS memory on ``device``. With ``mesh`` given, S and Y are
    n-sharded from the start (the reference keeps them MPI
    column-distributed, hiopHessianLowRank.hpp:60), and the mask and sigma
    are replicated."""
    ll = max(l_max, 1)
    S = torch.zeros((ll, n), dtype=dtype, device=device)
    Y = torch.zeros((ll, n), dtype=dtype, device=device)
    active = torch.zeros((ll,), dtype=dtype, device=device)
    sigma = torch.tensor(sigma0, dtype=dtype, device=device)
    if mesh is not None:
        from hiop_tpu_torch.parallel.mesh import replicate, shard_n

        S, Y = shard_n(mesh, S, axis_name), shard_n(mesh, Y, axis_name)
        active, sigma = replicate(mesh, active), replicate(mesh, sigma)
    return BfgsState(S=S, Y=Y, active=active, sigma=sigma)


_SIGMA_STRATEGIES = ("sigma0", "sty", "sty_inv", "snrm_ynrm", "sty_srnm_ynrm")
_SIGMA_SAFE_MIN, _SIGMA_SAFE_MAX = 1e-8, 1e8


def _roll_in(buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Drop the oldest row, append ``new`` (``jnp.roll(buf, -1).at[-1].set``)."""
    return torch.cat([buf[1:], new.reshape((1,) + buf.shape[1:])], dim=0)


def update(
    state: BfgsState,
    s_new: torch.Tensor,
    y_new: torch.Tensor,
    sigma0: float,
    strategy: str = "sty",
) -> BfgsState:
    """Secant update with the reference's skip conditions (skip when
    ||s||_inf < 100*eps or s^T y <= ||s|| ||y|| sqrt(eps)).

    s_new = x_curr - x_prev;  y_new = grad_Lagr(x_curr, lam_curr) -
    grad_Lagr(x_prev, lam_curr) (the caller assembles it; see
    hiopHessianLowRank::update)."""
    eps = torch.finfo(s_new.dtype).eps
    s_inf = s_new.abs().max()
    sty = s_new @ y_new
    s_nrm = torch.linalg.norm(s_new)
    y_nrm = torch.linalg.norm(y_new)

    take = (s_inf >= 100 * eps) & (sty > s_nrm * y_nrm * eps ** 0.5)

    S2 = torch.where(take, _roll_in(state.S, s_new), state.S)
    Y2 = torch.where(take, _roll_in(state.Y, y_new), state.Y)
    a2 = torch.where(take, _roll_in(state.active, state.active.new_ones(())), state.active)

    if strategy == "sty":
        sig = sty / (s_nrm * s_nrm)
    elif strategy == "sty_inv":
        sig = y_nrm * y_nrm / sty
    elif strategy == "snrm_ynrm":
        sig = torch.sqrt(s_nrm * s_nrm / (y_nrm * y_nrm))
    elif strategy == "sty_srnm_ynrm":
        sig = 0.5 * (sty / (s_nrm * s_nrm) + y_nrm * y_nrm / sty)
    else:  # "sigma0"
        sig = torch.tensor(sigma0, dtype=s_new.dtype, device=s_new.device)
    sig = torch.clamp(sig, _SIGMA_SAFE_MIN, _SIGMA_SAFE_MAX)
    sigma2 = torch.where(take, sig, state.sigma)
    return BfgsState(S2, Y2, a2, sigma2)


def _masked_V_and_U(state: BfgsState, dh_inv: torch.Tensor):
    """U (2l, n) row-major and the padded V (2l, 2l)."""
    S, Y, act, sigma = state.S, state.Y, state.active, state.sigma
    Sm = S * act[:, None]
    Ym = Y * act[:, None]
    SY = Sm @ Ym.T                                    # (l, l): s_i^T y_j
    L = torch.tril(SY, diagonal=-1)
    D = torch.diagonal(SY)

    SdS = (Sm * dh_inv) @ Sm.T                        # S Dh^{-1} S^T
    SdY = (Sm * dh_inv) @ Ym.T
    YdY = (Ym * dh_inv) @ Ym.T
    StS = Sm @ Sm.T

    V11 = sigma * sigma * SdS - sigma * StS
    V12 = sigma * SdY - L
    V22 = YdY + torch.diag(D)
    V = torch.cat([torch.cat([V11, V12], 1), torch.cat([V12.T, V22], 1)], 0)
    act2 = torch.cat([act, act])
    V = V * act2[:, None] * act2[None, :] + torch.diag(1.0 - act2)
    U = torch.cat([sigma * Sm, Ym], dim=0)            # (2l, n)
    return U, V, act2


def solve(state: BfgsState, Dx: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(B + diag(Dx))^{-1} rhs for rhs of shape (n,) or (n, k)
    (hiopHessianLowRank::solve / symMatTimesInverseTimesMatTrans)."""
    dh_inv = 1.0 / (state.sigma + Dx)                 # (n,)
    U, V, act2 = _masked_V_and_U(state, dh_inv)
    single = rhs.dim() == 1
    R = rhs[:, None] if single else rhs               # (n, k)
    DR = dh_inv[:, None] * R
    t = U @ DR                                        # (2l, k)
    w = solve_small(V, t) * act2[:, None]
    out = DR - dh_inv[:, None] * (U.T @ w)
    return out[:, 0] if single else out


def times_vec(state: BfgsState, x: torch.Tensor) -> torch.Tensor:
    """B @ x via the compact form (timesVec; used by curvature tests)."""
    S, Y, act, sigma = state.S, state.Y, state.active, state.sigma
    Sm = S * act[:, None]
    Ym = Y * act[:, None]
    SY = Sm @ Ym.T
    L = torch.tril(SY, diagonal=-1)
    D = torch.diagonal(SY)
    N11 = sigma * (Sm @ Sm.T)
    N = torch.cat([torch.cat([N11, L], 1), torch.cat([L.T, -torch.diag(D)], 1)], 0)
    act2 = torch.cat([act, act])
    N = N * act2[:, None] * act2[None, :] + torch.diag(1.0 - act2)
    U = torch.cat([sigma * Sm, Ym], dim=0)
    t = U @ x
    w = solve_small(N, t) * act2
    return sigma * x - U.T @ w
