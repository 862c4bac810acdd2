"""Pattern-aware vector operations.

Counterpart of ``hiop_tpu/linalg/vector_ops.py`` (reference hiopVector,
hiopVector.hpp:62): log-barrier terms, linear damping, fraction-to-the-
boundary, dual adjustment, bound projection. A "pattern" is a 0/1 float
tensor selecting entries with a finite bound; non-selected slack entries
are kept at 1.0 and dual entries at 0.0 so that every operation is
branch-free elementwise math. Reductions return 0-dim tensors on the
input's device (no host synchronization).
"""

from __future__ import annotations

import torch

from hiop_tpu_torch.utils.dtensor import is_dtensor, plain, replicate_like


def min_init(v, init: float):
    """min(min(v), init), and init for an empty v (jnp.min(..., initial=))."""
    if v.numel() == 0:
        return v.new_tensor(init)
    return torch.clamp(v.min(), max=init)


def logbar_sum(s, pattern):
    """sum(log(s_i)) over pattern (hiopVectorPar::logBarrier_local)."""
    on = pattern == 1.0
    safe = torch.where(on, s, 1.0)
    return torch.where(on, torch.log(safe), 0.0).sum()


def add_logbar_grad(grad, alpha, s, pattern):
    """grad += alpha / s on pattern (hiopVectorPar::addLogBarrierGrad)."""
    on = pattern == 1.0
    safe = torch.where(on, s, 1.0)
    return grad + torch.where(on, alpha / safe, 0.0)


def linear_damping_term(s, pat_left, pat_right, mu, kappa_d):
    """kappa_d*mu*sum(s_i : left-bounded only) (linearDampingTerm_local)."""
    sel = (pat_left == 1.0) & (pat_right == 0.0)
    return kappa_d * mu * torch.where(sel, s, 0.0).sum()


def add_linear_damping_grad(grad, pat_left, pat_right, ct):
    """grad += (pat_left - pat_right) * ct (addLinearDampingTerm)."""
    return grad + (pat_left - pat_right) * ct


def fraction_to_the_boundary(s, ds, tau, pattern=None):
    """max alpha in (0,1] with s + alpha*ds >= (1-tau)*s, elementwise over
    pattern (fractionToTheBdry_local)."""
    neg = ds < 0
    if pattern is not None:
        neg = neg & (pattern == 1.0)
    ratios = torch.where(neg, -tau * s / torch.where(neg, ds, -1.0), 1.0)
    return min_init(ratios, 1.0)


def adjust_duals_plh(z, s, pattern, mu, kappa_sigma):
    """Clamp duals into [mu/(kappa*s), kappa*mu/s] (adjustDuals_plh,
    Ipopt eq. (16) 'primal-log-Hessian' safeguard)."""
    on = pattern == 1.0
    safe_s = torch.where(on, s, 1.0)
    lo = mu / (kappa_sigma * safe_s)
    hi = kappa_sigma * mu / safe_s
    return torch.where(on, torch.minimum(torch.maximum(z, lo), hi), 0.0)


def project_into_bounds(x, xl, ixl, xu, ixu, kappa1, kappa2):
    """Push x strictly inside its bounds (hiopVector::projectIntoBounds,
    used by startingProcedure, hiopAlgFilterIPM.cpp:290): for two-sided
    bounds use relative shifts kappa2*(xu-xl) capped by kappa1-scaled
    absolute shifts; for one-sided use kappa1 shifts."""
    both = (ixl == 1.0) & (ixu == 1.0)
    lower_only = (ixl == 1.0) & (ixu == 0.0)
    upper_only = (ixl == 0.0) & (ixu == 1.0)

    pl = torch.minimum(kappa1 * torch.clamp(xl.abs(), min=1.0), kappa2 * (xu - xl))
    pu = torch.minimum(kappa1 * torch.clamp(xu.abs(), min=1.0), kappa2 * (xu - xl))

    # jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi)
    x_both = torch.minimum(torch.maximum(x, xl + pl), xu - pu)
    x_low = torch.maximum(x, xl + kappa1 * torch.clamp(xl.abs(), min=1.0))
    x_upp = torch.minimum(x, xu - kappa1 * torch.clamp(xu.abs(), min=1.0))

    out = torch.where(both, x_both, x)
    out = torch.where(lower_only, x_low, out)
    out = torch.where(upper_only, x_upp, out)
    return out


def slack_lower(x, xl, ixl):
    """sxl = x - xl on pattern, else 1.0."""
    return torch.where(ixl == 1.0, x - xl, 1.0)


def slack_upper(x, xu, ixu):
    """sxu = xu - x on pattern, else 1.0."""
    return torch.where(ixu == 1.0, xu - x, 1.0)


def adjust_small_slacks(slack, bound, slack_dual, pattern, mu):
    """Push numerically tiny slacks away from zero
    (hiopIterate::adjust_small_slacks, hiopIterate.cpp:414): where
    slack < eps*min(1,mu), set
      new_slack = min( max(mu/slack_dual, small_val),
                       max(slack,0) + eps^0.75 * max(1,|bound|) ).
    Returns (new_slack, num_adjusted)."""
    eps = torch.finfo(slack.dtype).eps
    # mu is a number, or a device scalar in jit_mode=solve (no host read)
    small_val = eps * (torch.clamp(mu, max=1.0) if isinstance(mu, torch.Tensor) else min(1.0, float(mu)))
    scale_fact = eps**0.75
    sel = pattern == 1.0
    tiny = sel & (slack < small_val)
    s0 = torch.clamp(slack, min=0.0)
    safe_dual = torch.where(slack_dual.abs() > 0, slack_dual, 1.0)
    cand = torch.clamp(mu / safe_dual, min=small_val)
    cap = s0 + scale_fact * torch.clamp(torch.where(sel, bound, 0.0).abs(), min=1.0)
    new_slack = torch.where(tiny, torch.minimum(cand, cap), slack)
    return new_slack, tiny.sum()


def infnorm(v):
    return v.abs().max() if v.numel() else v.new_tensor(0.0)


def onenorm(v):
    return v.abs().sum()


def scatter_add_(out, idx, vals):
    """out[idx] += vals, duplicates in idx summed in a fixed order, so that
    two runs give the same bits: ``index_put_(accumulate=True)`` is
    sort-based on CUDA, where ``index_add_`` adds with atomics. In place;
    returns ``out``. On a mesh (any argument a DTensor: DTensor has no rule
    for ``index_put_`` in every torch version) it runs on this rank's
    replicas and returns a ``Replicate`` DTensor: use the return value."""
    if is_dtensor(out) or is_dtensor(vals) or is_dtensor(idx):
        wrap = replicate_like(out, vals, idx)
        return wrap(plain(out).index_put_((plain(idx),), plain(vals), accumulate=True))
    return out.index_put_((idx,), vals, accumulate=True)
