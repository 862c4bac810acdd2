"""Run statistics.

Parity with ``hiopRunStats`` / ``hiopRunKKTSolStats`` / ``hiopLinSolStats``
(HiOp src/Utils/hiopRunStats.hpp:304,65,244): wall timers around
every phase of the iteration, per-eval counters, and a per-iteration KKT
timing decomposition reported when option ``time_kkt=on``.
"""

from __future__ import annotations

from hiop_tpu_torch.utils.timer import Timer


class KKTSolveStats:
    """Per-iteration KKT timing decomposition (hiopRunKKTSolStats:65)."""

    def __init__(self) -> None:
        self.tm_total = Timer()
        self.tm_update_init = Timer()       # assembling the KKT operands
        self.tm_update_linsys = Timer()     # building the (condensed) linear system
        self.tm_update_fact = Timer()       # factorization (incl. regularization retries)
        self.tm_solve_rhs_manip = Timer()   # compressing/expanding rhs
        self.tm_solve_inner = Timer()       # triangular/inner solves
        self.tm_resid = Timer()             # residual computations for IR
        self.n_iter_refin_inner = 0
        self.n_iter_refin_outer = 0
        self.n_update_corrections = 0       # regularization (inertia-correction) retries
        #: previous iteration's correction count (start_iter resets the live
        #: counter BEFORE strategy.prepare runs; the de-escalation clean-
        #: streak test reads the value the last iteration ended with)
        self.n_update_corrections_prev = 0
        # cumulative (NOT reset per iteration): mixed-precision accounting —
        # the f64-avoided fraction n_fact_f32/n_fact_total is the adaptive
        # schedule's headline metric
        self.n_fact_total = 0
        self.n_fact_f32 = 0
        #: cumulative: sparse-direct factorizations whose backend could NOT
        #: report pivot-sign inertia (e.g. splu's pivoted fallback engaged)
        #: — acceptance degraded to the inertia-free curvature test
        self.n_fact_no_inertia = 0
        #: device_ldl symbolic analysis refused the pattern and the
        #: strategy fell back to a host backend (filter_ipm)
        self.n_device_ldl_fallback = 0
        self._cum_fact_s = 0.0
        self._cum_total_s = 0.0

    def fact_seconds_total(self) -> float:
        """Whole-solve factorization seconds (per-iteration timers are
        reset by start_iter; this accumulates across resets)."""
        return self._cum_fact_s + self.tm_update_fact.elapsed

    def kkt_seconds_total(self) -> float:
        return self._cum_total_s + self.tm_total.elapsed

    def start_iter(self) -> None:
        self._cum_fact_s += self.tm_update_fact.elapsed
        self._cum_total_s += self.tm_total.elapsed
        for t in (
            self.tm_total,
            self.tm_update_init,
            self.tm_update_linsys,
            self.tm_update_fact,
            self.tm_solve_rhs_manip,
            self.tm_solve_inner,
            self.tm_resid,
        ):
            t.reset()
        self.n_iter_refin_inner = 0
        self.n_iter_refin_outer = 0
        self.n_update_corrections_prev = self.n_update_corrections
        self.n_update_corrections = 0

    def summary_last_iter(self) -> str:
        return (
            "KKT: total %.4fs (assembly %.4fs linsys %.4fs fact %.4fs "
            "rhs %.4fs solve %.4fs resid %.4fs) IR inner/outer %d/%d corrections %d"
            % (
                self.tm_total.elapsed,
                self.tm_update_init.elapsed,
                self.tm_update_linsys.elapsed,
                self.tm_update_fact.elapsed,
                self.tm_solve_rhs_manip.elapsed,
                self.tm_solve_inner.elapsed,
                self.tm_resid.elapsed,
                self.n_iter_refin_inner,
                self.n_iter_refin_outer,
                self.n_update_corrections,
            )
        )


class RunStats:
    """Aggregate solver statistics (hiopRunStats.hpp:304)."""

    def __init__(self) -> None:
        self.tm_optimize_total = Timer()
        self.tm_solver_internal = Timer()
        self.tm_starting_point = Timer()
        self.tm_eval_obj = Timer()
        self.tm_eval_grad = Timer()
        self.tm_eval_cons = Timer()
        self.tm_eval_jac = Timer()
        self.tm_eval_hess = Timer()
        self.n_eval_obj = 0
        self.n_eval_grad = 0
        self.n_eval_cons = 0
        self.n_eval_jac = 0
        self.n_eval_hess = 0
        self.n_iters = 0
        self.kkt = KKTSolveStats()

    def get_summary(self) -> str:
        eval_total = (
            self.tm_eval_obj.elapsed
            + self.tm_eval_grad.elapsed
            + self.tm_eval_cons.elapsed
            + self.tm_eval_jac.elapsed
            + self.tm_eval_hess.elapsed
        )
        return (
            "Total time %.3fs (solver internal %.3fs, evals %.3fs)\n"
            "  evals: obj %d (%.3fs) grad %d (%.3fs) cons %d (%.3fs) "
            "jac %d (%.3fs) hess %d (%.3fs)\n"
            "  iterations: %d"
            % (
                self.tm_optimize_total.elapsed,
                self.tm_solver_internal.elapsed,
                eval_total,
                self.n_eval_obj,
                self.tm_eval_obj.elapsed,
                self.n_eval_grad,
                self.tm_eval_grad.elapsed,
                self.n_eval_cons,
                self.tm_eval_cons.elapsed,
                self.n_eval_jac,
                self.tm_eval_jac.elapsed,
                self.n_eval_hess,
                self.tm_eval_hess.elapsed,
                self.n_iters,
            )
        ) + (
            "\n  KKT factorizations: %d (%.0f%% in f32)"
            % (
                self.kkt.n_fact_total,
                100.0 * self.kkt.n_fact_f32 / self.kkt.n_fact_total,
            )
            if self.kkt.n_fact_total
            else ""
        ) + (
            "\n  inertia-less sparse factorizations (pivoted fallback): %d"
            % self.kkt.n_fact_no_inertia
            if self.kkt.n_fact_no_inertia
            else ""
        )
