"""Primal-dual iterate.

Counterpart of ``hiop_tpu/optimization/iterate.py`` (reference hiopIterate,
hiopIterate.hpp:58): the primal-dual point (x, d, slacks sxl/sxu/sdl/sdu,
duals yc/yd/zl/zu/vl/vu) is a NamedTuple of tensors on the solver's device,
and every operation (slack determination, bound projection,
fraction-to-the-boundary, step taking, dual safeguarding, log-barrier
evaluation with damping) is a plain function that returns new tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hiop_tpu_torch.linalg import vector_ops as vo


class Bounds(NamedTuple):
    """Static bound data + finite-bound patterns (0/1 floats).

    xl/xu are variable bounds; dl/du inequality-constraint bounds. The
    patterns ixl/ixu/idl/idu select entries with a finite bound
    (hiopNlpFormulation process_bounds)."""

    xl: torch.Tensor
    xu: torch.Tensor
    ixl: torch.Tensor
    ixu: torch.Tensor
    dl: torch.Tensor
    du: torch.Tensor
    idl: torch.Tensor
    idu: torch.Tensor


class Iterate(NamedTuple):
    """Primal-dual point (hiopIterate.hpp:188-201)."""

    x: torch.Tensor
    d: torch.Tensor
    sxl: torch.Tensor
    sxu: torch.Tensor
    sdl: torch.Tensor
    sdu: torch.Tensor
    yc: torch.Tensor
    yd: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    vl: torch.Tensor
    vu: torch.Tensor

    @staticmethod
    def zeros_like(other: "Iterate") -> "Iterate":
        return Iterate(*(torch.zeros_like(a) for a in other))


def determine_slacks(it: Iterate, b: Bounds) -> Iterate:
    """Recompute slacks from x and d (hiopIterate::determineSlacks);
    off-pattern slack entries are held at 1.0."""
    return it._replace(
        sxl=vo.slack_lower(it.x, b.xl, b.ixl),
        sxu=vo.slack_upper(it.x, b.xu, b.ixu),
        sdl=vo.slack_lower(it.d, b.dl, b.idl),
        sdu=vo.slack_upper(it.d, b.du, b.idu),
    )


def compute_safe_slacks(it: Iterate, it_curr: Iterate, b: Bounds, mu):
    """determineSlacks + adjust_small_slacks (hiopIterate.cpp:293).
    Returns (iterate, num_adjusted)."""
    it = determine_slacks(it, b)
    sxl, n1 = vo.adjust_small_slacks(it.sxl, b.xl, it_curr.zl, b.ixl, mu)
    sxu, n2 = vo.adjust_small_slacks(it.sxu, b.xu, it_curr.zu, b.ixu, mu)
    sdl, n3 = vo.adjust_small_slacks(it.sdl, b.dl, it_curr.vl, b.idl, mu)
    sdu, n4 = vo.adjust_small_slacks(it.sdu, b.du, it_curr.vu, b.idu, mu)
    return it._replace(sxl=sxl, sxu=sxu, sdl=sdl, sdu=sdu), n1 + n2 + n3 + n4


def eval_logbar(it: Iterate, b: Bounds):
    """sum of log(slack) over all four slack blocks (evalLogBarrier)."""
    return (
        vo.logbar_sum(it.sxl, b.ixl)
        + vo.logbar_sum(it.sxu, b.ixu)
        + vo.logbar_sum(it.sdl, b.idl)
        + vo.logbar_sum(it.sdu, b.idu)
    )


def linear_damping_term(it: Iterate, b: Bounds, mu, kappa_d):
    """kappa_d*mu*(sum one-side-bounded slacks) (linearDampingTerm)."""
    return (
        vo.linear_damping_term(it.sxl, b.ixl, b.ixu, mu, kappa_d)
        + vo.linear_damping_term(it.sxu, b.ixu, b.ixl, mu, kappa_d)
        + vo.linear_damping_term(it.sdl, b.idl, b.idu, mu, kappa_d)
        + vo.linear_damping_term(it.sdu, b.idu, b.idl, mu, kappa_d)
    )


def add_logbar_grad_x(grad_x, it: Iterate, b: Bounds, mu):
    """grad_x += -mu/sxl + mu/sxu on patterns (addLogBarGrad_x)."""
    grad_x = vo.add_logbar_grad(grad_x, -mu, it.sxl, b.ixl)
    return vo.add_logbar_grad(grad_x, mu, it.sxu, b.ixu)


def add_logbar_grad_d(grad_d, it: Iterate, b: Bounds, mu):
    grad_d = vo.add_logbar_grad(grad_d, -mu, it.sdl, b.idl)
    return vo.add_logbar_grad(grad_d, mu, it.sdu, b.idu)


def add_damping_grad_x(grad_x, b: Bounds, mu, kappa_d, beta=1.0):
    return vo.add_linear_damping_grad(grad_x, b.ixl, b.ixu, beta * kappa_d * mu)


def add_damping_grad_d(grad_d, b: Bounds, mu, kappa_d, beta=1.0):
    return vo.add_linear_damping_grad(grad_d, b.idl, b.idu, beta * kappa_d * mu)


def fraction_to_the_boundary(it: Iterate, d: Iterate, tau, b: Bounds):
    """Returns (alpha_primal, alpha_dual) (hiopIterate::fractionToTheBdry)."""
    ftb = vo.fraction_to_the_boundary
    ap = torch.minimum(
        torch.minimum(ftb(it.sxl, d.sxl, tau, b.ixl), ftb(it.sxu, d.sxu, tau, b.ixu)),
        torch.minimum(ftb(it.sdl, d.sdl, tau, b.idl), ftb(it.sdu, d.sdu, tau, b.idu)),
    )
    ad = torch.minimum(
        torch.minimum(ftb(it.zl, d.zl, tau, b.ixl), ftb(it.zu, d.zu, tau, b.ixu)),
        torch.minimum(ftb(it.vl, d.vl, tau, b.idl), ftb(it.vu, d.vu, tau, b.idu)),
    )
    return ap, ad


def take_step_primals(it: Iterate, d: Iterate, alpha) -> Iterate:
    """x,d <- x,d + alpha*dir; slacks are recomputed by the caller via
    compute_safe_slacks (takeStep_primals)."""
    return it._replace(x=it.x + alpha * d.x, d=it.d + alpha * d.d)


def take_step_duals(it: Iterate, d: Iterate, alpha_primal, alpha_dual) -> Iterate:
    """Eq-duals step with alpha_primal, bound-duals with alpha_dual
    (takeStep_duals + hiopDualsNewtonLinearUpdate semantics)."""
    return it._replace(
        yc=it.yc + alpha_primal * d.yc,
        yd=it.yd + alpha_primal * d.yd,
        zl=it.zl + alpha_dual * d.zl,
        zu=it.zu + alpha_dual * d.zu,
        vl=it.vl + alpha_dual * d.vl,
        vu=it.vu + alpha_dual * d.vu,
    )


def adjust_duals(it: Iterate, b: Bounds, mu, kappa_sigma) -> Iterate:
    """Primal-log-Hessian dual safeguard (adjustDuals_primalLogHessian)."""
    return it._replace(
        zl=vo.adjust_duals_plh(it.zl, it.sxl, b.ixl, mu, kappa_sigma),
        zu=vo.adjust_duals_plh(it.zu, it.sxu, b.ixu, mu, kappa_sigma),
        vl=vo.adjust_duals_plh(it.vl, it.sdl, b.idl, mu, kappa_sigma),
        vu=vo.adjust_duals_plh(it.vu, it.sdu, b.idu, mu, kappa_sigma),
    )


def norm_one_of_duals(it: Iterate):
    """Returns (||yc,yd||_1, ||zl,zu,vl,vu||_1) (normOneOfDuals)."""
    eq = vo.onenorm(it.yc) + vo.onenorm(it.yd)
    bnd = vo.onenorm(it.zl) + vo.onenorm(it.zu) + vo.onenorm(it.vl) + vo.onenorm(it.vu)
    return eq, bnd


def starting_point_primal(x_user, d_of_x, b: Bounds, kappa1, kappa2):
    """Project user's x0 and d(x0) strictly inside bounds (startingProcedure,
    hiopAlgFilterIPM.cpp:290). Returns (x0, d0)."""
    x0 = vo.project_into_bounds(x_user, b.xl, b.ixl, b.xu, b.ixu, kappa1, kappa2)
    d0 = vo.project_into_bounds(d_of_x, b.dl, b.idl, b.du, b.idu, kappa1, kappa2)
    return x0, d0
