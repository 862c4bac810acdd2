"""Full (unreduced) 12-block KKT operator.

Counterpart of ``hiop_tpu/kkt/full_space.py`` (reference
hiopMatVecKKTFullOpr, hiopKKTLinSys.hpp:615, doc :463-501): the
matrix-vector product of the full primal-dual KKT system on the compound
direction (the reference's hiopVectorCompoundPD is the :class:`Iterate`
NamedTuple). The outer BiCGStab refinement of the dense Newton strategy
uses it, with the compressed direct solve as preconditioner
(compute_directions_w_IR). ``KKTLinsys=full`` assembles the matrix from the
operator (``torch.func.vmap`` over the identity, so the operator stays the
single definition) and factorizes it by LU (``torch.linalg.lu_factor_ex``
on the solver's device; no inertia, so the caller uses the curvature
acceptor, as the reference's nonsymmetric PARDISO branch does).

Row convention matches the Residual storage (A * delta = r): the x-row maps
delta to H dx + delta_wx dx + Jc^T dyc + Jd^T dyd - dzl + dzu.
"""

from __future__ import annotations

import torch

from hiop_tpu_torch.optimization.iterate import Bounds, Iterate
from hiop_tpu_torch.optimization.residual import Residual


def full_kkt_matvec(H, Jc, Jd, it: Iterate, b: Bounds,
                    delta_wx, delta_wd, delta_cc, delta_cd, d: Iterate) -> Residual:
    """A @ d for the full KKT matrix at iterate ``it`` (slacks and duals
    define the complementarity rows). Returns a :class:`Residual`."""
    JcT_dyc = Jc.T @ d.yc if Jc.shape[0] else torch.zeros_like(d.x)
    JdT_dyd = Jd.T @ d.yd if Jd.shape[0] else torch.zeros_like(d.x)
    rx = H @ d.x + delta_wx * d.x + JcT_dyc + JdT_dyd - d.zl + d.zu
    rd = delta_wd * d.d - d.yd - d.vl + d.vu
    ryc = Jc @ d.x - delta_cc * d.yc if Jc.shape[0] else d.x.new_zeros((0,))
    ryd = Jd @ d.x - d.d - delta_cd * d.yd if Jd.shape[0] else d.x.new_zeros((0,))
    rxl = torch.where(b.ixl == 1.0, d.x - d.sxl, 0.0)
    rxu = torch.where(b.ixu == 1.0, -d.x - d.sxu, 0.0)
    rdl = torch.where(b.idl == 1.0, d.d - d.sdl, 0.0)
    rdu = torch.where(b.idu == 1.0, -d.d - d.sdu, 0.0)
    rszl = torch.where(b.ixl == 1.0, it.zl * d.sxl + it.sxl * d.zl, 0.0)
    rszu = torch.where(b.ixu == 1.0, it.zu * d.sxu + it.sxu * d.zu, 0.0)
    rsvl = torch.where(b.idl == 1.0, it.vl * d.sdl + it.sdl * d.vl, 0.0)
    rsvu = torch.where(b.idu == 1.0, it.vu * d.sdu + it.sdu * d.vu, 0.0)
    return Residual(rx, rd, ryc, ryd, rxl, rxu, rdl, rdu, rszl, rszu, rsvl, rsvu)


def residual_to_rhs(res: Residual) -> Residual:
    """The Newton RHS of the full system. The stored bound rows use the
    sign convention dsxl = dx + rxl (see residual.py) while the matvec
    produces dx - dsxl in the xl row, so the RHS entry is -rxl."""
    return res._replace(rxl=-res.rxl, rxu=-res.rxu, rdl=-res.rdl, rdu=-res.rdu)


def direction_residual(H, Jc, Jd, it, b, deltas, res: Residual, d: Iterate) -> Residual:
    """RHS - A @ d: the full-system residual of a computed direction."""
    Ad = full_kkt_matvec(H, Jc, Jd, it, b, *deltas, d)
    rhs = residual_to_rhs(res)
    return Residual(*(r - a for r, a in zip(rhs, Ad)))


def direction_residual_norms(H, Jc, Jd, it, b, delta_wx, delta_wd, delta_cc, delta_cd, res, d):
    """(||rhs - A d||, ||rhs||) as 0-dim tensors — the IR gate check."""
    Ad = full_kkt_matvec(H, Jc, Jd, it, b, delta_wx, delta_wd, delta_cc, delta_cd, d)
    rhs = residual_to_rhs(res)
    diff2 = sum((r - a) @ (r - a) for r, a in zip(rhs, Ad))
    rhs2 = sum(r @ r for r in rhs)
    return torch.sqrt(diff2), torch.sqrt(rhs2)


def _flatten_dir(d: Iterate) -> torch.Tensor:
    return torch.cat(
        [d.x, d.d, d.yc, d.yd, d.sxl, d.sxu, d.sdl, d.sdu, d.zl, d.zu, d.vl, d.vu]
    )


def _unflatten_dir(v: torch.Tensor, t: Iterate) -> Iterate:
    nx, nd = t.x.numel(), t.d.numel()
    myc, myd = t.yc.numel(), t.yd.numel()
    sizes = [nx, nd, myc, myd, nx, nx, nd, nd, nx, nx, nd, nd]
    parts = torch.split(v, sizes)
    return Iterate(
        x=parts[0], d=parts[1], yc=parts[2], yd=parts[3],
        sxl=parts[4], sxu=parts[5], sdl=parts[6], sdu=parts[7],
        zl=parts[8], zu=parts[9], vl=parts[10], vu=parts[11],
    )


def _flatten_res(r: Residual) -> torch.Tensor:
    return torch.cat(
        [r.rx, r.rd, r.ryc, r.ryd, r.rxl, r.rxu, r.rdl, r.rdu,
         r.rszl, r.rszu, r.rsvl, r.rsvu]
    )


def assemble_full(H, Jc, Jd, it: Iterate, b: Bounds,
                  delta_wx, delta_wd, delta_cc, delta_cd):
    """Materialize the full KKT matrix column by column from the operator.

    Rows and columns pair bound rows with their slack columns and
    complementarity rows with their dual columns, so the zero rows and
    columns of *inactive* bound entries sit on the diagonal; those
    diagonals are set to 1 (with zero RHS the decoupled entries solve to 0)."""
    ones_x = torch.ones_like(it.x)
    ones_d = torch.ones_like(it.d)
    mask = torch.cat(
        [ones_x, ones_d, torch.ones_like(it.yc), torch.ones_like(it.yd),
         b.ixl, b.ixu, b.idl, b.idu, b.ixl, b.ixu, b.idl, b.idu]
    )
    n_tot = mask.numel()

    def col(e):
        d = _unflatten_dir(e, it)
        out = full_kkt_matvec(H, Jc, Jd, it, b, delta_wx, delta_wd, delta_cc, delta_cd, d)
        return _flatten_res(out)

    eye = torch.eye(n_tot, dtype=it.x.dtype, device=it.x.device)
    A = torch.func.vmap(col)(eye).T
    return A + torch.diag(1.0 - mask)


class FullFactors:
    """LU factors of the assembled unreduced system."""

    __slots__ = ("ok", "lu", "piv", "template")

    def __init__(self, ok, lu, piv, template):
        self.ok = ok
        self.lu = lu
        self.piv = piv
        self.template = template


def factorize_full(H, Jc, Jd, it: Iterate, b: Bounds, deltas) -> FullFactors:
    A = assemble_full(H, Jc, Jd, it, b, *deltas)
    if not bool(torch.isfinite(A).all()):
        return FullFactors(False, None, None, it)
    lu, piv, _ = torch.linalg.lu_factor_ex(A)
    diag = torch.diagonal(lu).abs()
    eps = torch.finfo(A.dtype).eps
    ok = torch.isfinite(lu).all() & (diag.min() > eps * torch.clamp(diag.max(), min=1.0))
    return FullFactors(bool(ok), lu, piv, it)


def solve_full(f: FullFactors, resid: Residual) -> Iterate:
    rhs = _flatten_res(residual_to_rhs(resid))
    sol = torch.linalg.lu_solve(f.lu, f.piv, rhs[:, None])[:, 0]
    return _unflatten_dir(sol, f.template)
