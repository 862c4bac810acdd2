"""KKT residuals.

Counterpart of ``hiop_tpu/optimization/residual.py`` (reference
hiopResidual, hiopResidual.hpp:61). Residual blocks are stored in the
reference's right-hand-side convention: each block equals the value such
that the Newton system reads ``A * delta = r`` (rx is negated after
assembly, ryc = crhs - c(x), ryd = d_it - d(x); the bound rows rxl... are
stored unnegated and enter direction recovery as dsxl = dx + rxl).

Infinity/one norms of the optimality, feasibility, and complementarity
subsets are computed both for the NLP (mu=0, no damping) and the barrier
problem (with mu and damping), matching getNlpErrors/getBarrierErrors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hiop_tpu_torch.linalg import vector_ops as vo
from hiop_tpu_torch.optimization.iterate import Bounds, Iterate


class Residual(NamedTuple):
    rx: torch.Tensor
    rd: torch.Tensor
    ryc: torch.Tensor
    ryd: torch.Tensor
    rxl: torch.Tensor
    rxu: torch.Tensor
    rdl: torch.Tensor
    rdu: torch.Tensor
    rszl: torch.Tensor
    rszu: torch.Tensor
    rsvl: torch.Tensor
    rsvu: torch.Tensor


class ResidualNorms(NamedTuple):
    nlp_optim: torch.Tensor
    nlp_feasib: torch.Tensor
    nlp_complem: torch.Tensor
    bar_optim: torch.Tensor
    bar_feasib: torch.Tensor
    bar_complem: torch.Tensor
    nlp_feasib_onenorm: torch.Tensor   # theta for the filter
    bar_optim_onenorm: torch.Tensor
    cons_violation: torch.Tensor       # true bound/equality violation of c(x), d(x)


def _on(pattern):
    return pattern == 1.0


def update_residual(it: Iterate, c, d, grad_f, jacT_yc, jacT_yd, crhs, b: Bounds,
                    mu, kappa_d: float = 1e-5):
    """Assemble all 12 blocks + norms (hiopResidual::update).

    jacT_yc / jacT_yd are Jc^T yc and Jd^T yd, precomputed by the caller.
    Returns (Residual, ResidualNorms)."""
    # optimality rows
    rx_raw = grad_f + jacT_yc + jacT_yd - it.zl + it.zu
    nlp_optim = vo.infnorm(rx_raw)
    nlp_optim_1 = vo.onenorm(rx_raw)
    # damping enters the barrier residual only
    damp_x = (b.ixl - b.ixu) * (kappa_d * mu)
    rx = -(rx_raw + damp_x)
    bar_optim = vo.infnorm(rx)
    bar_optim_1 = vo.onenorm(rx)

    rd_raw = it.yd + it.vl - it.vu
    nlp_optim = torch.maximum(nlp_optim, vo.infnorm(rd_raw))
    nlp_optim_1 = nlp_optim_1 + vo.onenorm(rd_raw)
    damp_d = (b.idl - b.idu) * (kappa_d * mu)
    rd = rd_raw - damp_d
    bar_optim = torch.maximum(bar_optim, vo.infnorm(rd))
    bar_optim_1 = bar_optim_1 + vo.onenorm(rd)

    # feasibility rows
    ryc = crhs - c
    ryd = it.d - d
    nlp_feasib = torch.maximum(vo.infnorm(ryc), vo.infnorm(ryd))
    nlp_feasib_1 = vo.onenorm(ryc) + vo.onenorm(ryd)

    # true constraint violation (uses d(x), not the slack iterate d)
    inf = float("inf")
    viol_eq = vo.infnorm(ryc)
    viol_dl = torch.clamp(-vo.min_init(torch.where(_on(b.idl), d - b.dl, inf), inf), min=0.0)
    viol_du = torch.clamp(-vo.min_init(torch.where(_on(b.idu), b.du - d, inf), inf), min=0.0)
    cons_violation = torch.maximum(viol_eq, torch.maximum(viol_dl, viol_du))

    # bound rows (zero when slacks are consistent; kept for SOC/IR paths)
    rxl = torch.where(_on(b.ixl), it.x - it.sxl - b.xl, 0.0)
    rxu = torch.where(_on(b.ixu), b.xu - it.x - it.sxu, 0.0)
    rdl = torch.where(_on(b.idl), it.d - it.sdl - b.dl, 0.0)
    rdu = torch.where(_on(b.idu), b.du - it.d - it.sdu, 0.0)

    # complementarity rows: stored = mu e - s.*z on pattern
    sz_xl = torch.where(_on(b.ixl), it.sxl * it.zl, 0.0)
    sz_xu = torch.where(_on(b.ixu), it.sxu * it.zu, 0.0)
    sv_dl = torch.where(_on(b.idl), it.sdl * it.vl, 0.0)
    sv_du = torch.where(_on(b.idu), it.sdu * it.vu, 0.0)
    nlp_complem = torch.maximum(
        torch.maximum(vo.infnorm(sz_xl), vo.infnorm(sz_xu)),
        torch.maximum(vo.infnorm(sv_dl), vo.infnorm(sv_du)),
    )
    rszl = torch.where(_on(b.ixl), mu - sz_xl, 0.0)
    rszu = torch.where(_on(b.ixu), mu - sz_xu, 0.0)
    rsvl = torch.where(_on(b.idl), mu - sv_dl, 0.0)
    rsvu = torch.where(_on(b.idu), mu - sv_du, 0.0)
    bar_complem = torch.maximum(
        torch.maximum(vo.infnorm(rszl), vo.infnorm(rszu)),
        torch.maximum(vo.infnorm(rsvl), vo.infnorm(rsvu)),
    )

    res = Residual(rx, rd, ryc, ryd, rxl, rxu, rdl, rdu, rszl, rszu, rsvl, rsvu)
    norms = ResidualNorms(
        nlp_optim=nlp_optim,
        nlp_feasib=nlp_feasib,
        nlp_complem=nlp_complem,
        bar_optim=bar_optim,
        bar_feasib=nlp_feasib,
        bar_complem=bar_complem,
        nlp_feasib_onenorm=nlp_feasib_1,
        bar_optim_onenorm=bar_optim_1,
        cons_violation=cons_violation,
    )
    return res, norms


def _safe_slacks(it: Iterate, b: Bounds):
    return (
        torch.where(_on(b.ixl), it.sxl, 1.0),
        torch.where(_on(b.ixu), it.sxu, 1.0),
        torch.where(_on(b.idl), it.sdl, 1.0),
        torch.where(_on(b.idu), it.sdu, 1.0),
    )


def compress_rhs_xdycyd(res: Residual, it: Iterate, b: Bounds):
    """Fold bound/complementarity rows into the 4-block XDYcYd RHS
    (doc: hiopKKTLinSys.hpp:334-345). Returns (rx_t, rd_t, ryc, ryd)::

      rx_t = rx + Sxl^{-1}(rszl - Zl rxl) - Sxu^{-1}(rszu - Zu rxu)
      rd_t = rd + Sdl^{-1}(rsvl - Vl rdl) - Sdu^{-1}(rsvu - Vu rdu)
    """
    sxl, sxu, sdl, sdu = _safe_slacks(it, b)
    rx_t = (
        res.rx
        + torch.where(_on(b.ixl), (res.rszl - it.zl * res.rxl) / sxl, 0.0)
        - torch.where(_on(b.ixu), (res.rszu - it.zu * res.rxu) / sxu, 0.0)
    )
    rd_t = (
        res.rd
        + torch.where(_on(b.idl), (res.rsvl - it.vl * res.rdl) / sdl, 0.0)
        - torch.where(_on(b.idu), (res.rsvu - it.vu * res.rdu) / sdu, 0.0)
    )
    return rx_t, rd_t, res.ryc, res.ryd


def recover_direction(res: Residual, it: Iterate, b: Bounds, dx, dd, dyc, dyd) -> Iterate:
    """Back-substitute the eliminated rows to the full 12-block direction::

      dsxl = dx + rxl            dzl = Sxl^{-1}(rszl - Zl dsxl)
      dsxu = rxu - dx            dzu = Sxu^{-1}(rszu - Zu dsxu)
      dsdl = dd + rdl            dvl = Sdl^{-1}(rsvl - Vl dsdl)
      dsdu = rdu - dd            dvu = Sdu^{-1}(rsvu - Vu dsdu)
    """
    sxl, sxu, sdl, sdu = _safe_slacks(it, b)
    dsxl = torch.where(_on(b.ixl), dx + res.rxl, 0.0)
    dsxu = torch.where(_on(b.ixu), res.rxu - dx, 0.0)
    dsdl = torch.where(_on(b.idl), dd + res.rdl, 0.0)
    dsdu = torch.where(_on(b.idu), res.rdu - dd, 0.0)
    dzl = torch.where(_on(b.ixl), (res.rszl - it.zl * dsxl) / sxl, 0.0)
    dzu = torch.where(_on(b.ixu), (res.rszu - it.zu * dsxu) / sxu, 0.0)
    dvl = torch.where(_on(b.idl), (res.rsvl - it.vl * dsdl) / sdl, 0.0)
    dvu = torch.where(_on(b.idu), (res.rsvu - it.vu * dsdu) / sdu, 0.0)
    return Iterate(dx, dd, dsxl, dsxu, dsdl, dsdu, dyc, dyd, dzl, dzu, dvl, dvu)


def barrier_diagonals(it: Iterate, b: Bounds):
    """Dx = Sxl^{-1}Zl + Sxu^{-1}Zu and Dd = Sdl^{-1}Vl + Sdu^{-1}Vu."""
    sxl, sxu, sdl, sdu = _safe_slacks(it, b)
    Dx = torch.where(_on(b.ixl), it.zl / sxl, 0.0) + torch.where(_on(b.ixu), it.zu / sxu, 0.0)
    Dd = torch.where(_on(b.idl), it.vl / sdl, 0.0) + torch.where(_on(b.idu), it.vu / sdu, 0.0)
    return Dx, Dd
