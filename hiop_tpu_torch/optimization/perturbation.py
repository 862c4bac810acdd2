"""Primal-dual regularization (inertia correction).

Parity with ``hiopPDPerturbation``
(HiOp src/Optimization/hiopPDPerturbation.hpp:216-358): the
Ipopt-style delta curves. The primal regularization delta_w multiplies the
identity added to the Hessian block; the dual regularization delta_c relaxes
the (3,3)/(4,4) KKT blocks when the Jacobian is (near) rank-deficient:

  wrong inertia:  first time  -> delta_w = delta_0_bar
                  afterwards  -> delta_w = max(delta_w_min_bar,
                                               kappa_w_minus * delta_w_last)
                  on repeat   -> delta_w *= kappa_w_plus (or kappa_w_plus_bar
                                 when escalating from far-smaller last value)
                  give up at delta_w_max_bar
  singularity:    delta_c = delta_c_bar * mu^kappa_c

Variants: Null (quasi-Newton path — all deltas stay 0), scalar primal-first
(default), scalar dual-first, and randomized diagonals (regularization_method
option) which scale a fixed uniform random vector by the scalar delta.
"""

from __future__ import annotations

from typing import Optional

from hiop_tpu_torch.utils.options import NlpOptions


class PDPerturbationNull:
    """All deltas zero (hiopPDPerturbationNull) — used by the QN solver."""

    def __init__(self) -> None:
        self.delta_wx = 0.0
        self.delta_wd = 0.0
        self.delta_cc = 0.0
        self.delta_cd = 0.0
        self.mu = 1.0

    def initialize(self, options: Optional[NlpOptions] = None) -> bool:
        return True

    def set_mu(self, mu: float) -> None:
        self.mu = mu

    def compute_initial_deltas(self) -> bool:
        return True

    def compute_perturb_wrong_inertia(self) -> bool:
        return True

    def compute_perturb_singularity(self) -> bool:
        return True

    def update_fact_ok(self) -> None:
        pass


class PDPerturbationPrimalFirstScalar(PDPerturbationNull):
    """Scalar primal-first perturbation (hiopPDPerturbationPrimalFirstScalar,
    hiopPDPerturbation.hpp:250)."""

    def initialize(self, options: NlpOptions) -> bool:
        o = options
        self.delta_w_min_bar = o.num("delta_w_min_bar")
        self.delta_w_max_bar = o.num("delta_w_max_bar")
        self.delta_0_bar = o.num("delta_0_bar")
        self.kappa_w_minus = o.num("kappa_w_minus")
        self.kappa_w_plus = o.num("kappa_w_plus")
        self.kappa_w_plus_bar = o.num("kappa_w_plus_bar")
        self.delta_c_bar = o.num("delta_c_bar")
        self.kappa_c = o.num("kappa_c")
        self.delta_wx = self.delta_wd = 0.0
        self.delta_cc = self.delta_cd = 0.0
        self._delta_w_last = 0.0
        self._num_degen_iters = 0
        return True

    def _compute_delta_c(self, mu: float) -> float:
        return self.delta_c_bar * mu**self.kappa_c

    def compute_initial_deltas(self) -> bool:
        self.delta_wx = self.delta_wd = 0.0
        self.delta_cc = self.delta_cd = 0.0
        return True

    def _guts_wrong_inertia(self) -> bool:
        """guts_of_compute_perturb_wrong_inertia (hiopPDPerturbation.cpp)."""
        if self.delta_wx == 0.0:
            if self._delta_w_last == 0.0:
                self.delta_wx = self.delta_0_bar
            else:
                self.delta_wx = max(self.delta_w_min_bar, self._delta_w_last * self.kappa_w_minus)
        else:
            if self._delta_w_last == 0.0 or 1e5 * self._delta_w_last < self.delta_wx:
                self.delta_wx = self.kappa_w_plus_bar * self.delta_wx
            else:
                self.delta_wx = self.kappa_w_plus * self.delta_wx
        self.delta_wd = self.delta_wx
        if self.delta_wx > self.delta_w_max_bar:
            self._delta_w_last = 0.0
            return False
        return True

    def compute_perturb_wrong_inertia(self) -> bool:
        ok = self._guts_wrong_inertia()
        if not ok and self.delta_cc == 0.0:
            # retry with dual regularization switched on
            self.delta_wx = self.delta_wd = 0.0
            self.delta_cc = self.delta_cd = self._compute_delta_c(self.mu)
            ok = self._guts_wrong_inertia()
        return ok

    def compute_perturb_singularity(self) -> bool:
        if self.delta_cc == 0.0:
            self.delta_cc = self.delta_cd = self._compute_delta_c(self.mu)
            return True
        return self._guts_wrong_inertia()

    def update_fact_ok(self) -> None:
        if self.delta_wx > 0.0:
            self._delta_w_last = self.delta_wx


class PDPerturbationDualFirstScalar(PDPerturbationPrimalFirstScalar):
    """Dual-first variant (hiopPDPerturbationDualFirstScalar, hpp:312):
    bumps the dual regularization before the primal one; used by the
    normal-equations KKT where delta_c controls conditioning."""

    def compute_perturb_wrong_inertia(self) -> bool:
        if self.delta_cc == 0.0:
            self.delta_cc = self.delta_cd = max(
                self._compute_delta_c(self.mu), self.delta_w_min_bar
            )
            return True
        return super().compute_perturb_wrong_inertia()


class PDPerturbationPrimalFirstRand(PDPerturbationPrimalFirstScalar):
    """Randomized-diagonal variant (hiopPDPerturbationPrimalFirstRand,
    hpp:296): the scalar delta scales a fixed uniform random vector in
    [0.5, 1.5), decorrelating the regularization from problem structure.
    The KKT classes consume the scalar `delta_wx` as the mean; callers that
    want the vector use `delta_wx_vec(n)`."""

    _SEED = 12345

    def delta_wx_vec(self, n: int):
        import numpy as np

        rng = np.random.default_rng(self._SEED)
        return self.delta_wx * (0.5 + rng.random(n))


def make_perturbation(options: NlpOptions, for_newton: bool):
    """decideAndCreate (hiopAlgFilterIPM.cpp:2164-2176): Null for QN, else
    primal/dual-first by the normaleqn_regularization_priority option."""
    if not for_newton:
        p = PDPerturbationNull()
        p.initialize(options)
        return p
    if (
        options.str_("KKTLinsys") == "normaleqn"
        and options.str_("normaleqn_regularization_priority") == "dual_first"
    ):
        p: PDPerturbationNull = PDPerturbationDualFirstScalar()
    elif options.str_("regularization_method") == "randomized":
        p = PDPerturbationPrimalFirstRand()
    else:
        p = PDPerturbationPrimalFirstScalar()
    p.initialize(options)
    return p
