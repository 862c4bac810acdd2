"""Primal-decomposition (PriDec) solver for two-stage stochastic programs.

Counterpart of ``hiop_tpu/optimization/pridec.py`` (reference
hiopAlgPrimalDecomposition, hiopAlgPrimalDecomp.hpp:91, run loop
cpp:1804-1990): alternate between (a) evaluating all recourse terms
r_i(x) and their gradients at the current master solution, (b) building a
quadratic recourse model q(x) = rval + g^T(x-x0) + alpha/2 ||x-x0||^2 with
alpha from a trust-region-safeguarded heuristic (HessianApprox: get_alpha_f
with ratio updates, BB rule available), and (c) re-solving the master
problem with the model appended.

Distribution: where the reference dynamically dispatches scenario indices
to MPI workers (cpp:908-999), a problem that implements
``eval_rterms_batched`` has all its scenarios evaluated by one batched call
(one lane-batched solve on the device, :mod:`hiop_tpu_torch.optimization.batch_solve`);
otherwise a host loop deals the scenarios to a thread pool, or, with
``accum_local`` or several processes, evaluates this rank's static
partition and all-reduces (:mod:`hiop_tpu_torch.parallel.scenario_sched`).
With several CUDA devices in the process, the batched scenario axis is
split over them (:meth:`PriDecSolver._eval_recourse_sharded`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from hiop_tpu_torch.interface.pridec import PriDecProblem, RecourseApproxEvaluator
from hiop_tpu_torch.status import SolveStatus
from hiop_tpu_torch.utils.logger import Logger, Verbosity
from hiop_tpu_torch.utils.options import PriDecOptions


class HessianApprox:
    """Quadratic-coefficient (alpha) heuristics
    (hiopAlgPrimalDecomposition::HessianApprox, hpp:235-385)."""

    def __init__(self, n: int, ratio: float, options: PriDecOptions, logger: Logger):
        self.n = n
        self.alpha_ = 1e6
        self.ratio_ = ratio
        self.tr_ratio_ = 1.0
        self.ratio_min = 0.5
        self.ratio_max = 5.0
        self.alpha_min = options.num("alpha_min")
        self.alpha_max = options.num("alpha_max")
        self.fk = 0.0
        self.fkm1 = 0.0
        self.fkm1_lin = 0.0
        self.xkm1 = np.zeros(n)
        self.gkm1 = np.zeros(n)
        self.skm1 = np.zeros(n)
        self.ykm1 = np.zeros(n)
        self.log = logger

    def initialize(self, f_val: float, xk, grad):
        self.fk = float(f_val)
        self.xkm1 = np.asarray(xk, dtype=np.float64).copy()
        self.gkm1 = np.asarray(grad, dtype=np.float64).copy()
        self.skm1 = np.asarray(xk, dtype=np.float64).copy()
        self.ykm1 = np.asarray(xk, dtype=np.float64).copy()

    def update_hess_coeff(self, xk, gk, f_val: float):
        xk = np.asarray(xk, dtype=np.float64)
        gk = np.asarray(gk, dtype=np.float64)
        self.fkm1 = self.fk
        self.fk = float(f_val)
        self.skm1 = xk - self.xkm1
        self.ykm1 = gk - self.gkm1
        self.xkm1 = xk.copy()
        self.fkm1_lin = float(self.gkm1 @ self.skm1)
        self.gkm1 = gk.copy()

    def update_ratio(self, base_v: float, base_vm1: float):
        """Classic TR ratio on the full objective (cpp:391-417)."""
        rk = self.fkm1 + self.fkm1_lin + 0.5 * self.alpha_ * float(self.skm1 @ self.skm1)
        denom = self.fkm1 + base_vm1 - rk - base_v
        rho_k = (base_vm1 + self.fkm1 - self.fk - base_v) / denom if denom != 0 else 1e20
        self._update_ratio_tr(rho_k)

    def _update_ratio_tr(self, rhok: float):
        if rhok < 0.25:
            self.ratio_ /= 0.75
        elif rhok > 0.75:
            self.ratio_ *= 0.75
        if rhok < 0.125:
            self.log.printf(Verbosity.SCALARS, "pridec: step would be rejected (rho=%g)", rhok)
        self.ratio_ = min(max(self.ratio_, self.ratio_min), self.ratio_max)

    def get_alpha_f(self, gk) -> float:
        gk = np.asarray(gk)
        denom = 2.0 * self.fk if self.fk != 0 else 1e-16
        self.alpha_ = float(gk @ gk) / denom * self.ratio_
        self.alpha_ = min(max(self.alpha_, self.alpha_min), self.alpha_max)
        return self.alpha_

    def get_alpha_BB(self) -> float:
        ss = float(self.skm1 @ self.skm1)
        sy = float(self.skm1 @ self.ykm1)
        self.alpha_ = sy / ss if ss > 0 else self.alpha_
        self.alpha_ = min(max(self.alpha_, self.alpha_min), self.alpha_max)
        return self.alpha_

    def check_convergence_grad(self, gk) -> float:
        gk = np.asarray(gk)
        t = -self.alpha_ * self.skm1 + self.ykm1
        gn = float(np.linalg.norm(gk))
        return float(np.linalg.norm(t)) / gn if gn > 0 else 0.0

    def check_convergence_fcn(self, base_v: float, base_vm1: float) -> float:
        pred = self.fkm1_lin + 0.5 * self.alpha_ * float(self.skm1 @ self.skm1)
        return abs(pred + base_v - base_vm1)

    def compute_base(self, val: float) -> float:
        rec = self.fkm1 + self.fkm1_lin + 0.5 * self.alpha_ * float(self.skm1 @ self.skm1)
        return val - rec


@dataclass
class PriDecResult:
    status: SolveStatus
    x: np.ndarray
    obj: float
    iterations: int
    convergence: float


class PriDecSolver:
    """Driver (run_single / run / run_local of the reference collapse into
    one loop whose scenario evaluation is batched where the problem allows)."""

    def __init__(
        self,
        problem: PriDecProblem,
        options: Optional[PriDecOptions] = None,
        xc_index: Optional[np.ndarray] = None,
        scenario_devices=None,
    ):
        """``scenario_devices``: the devices the batched scenario axis is
        split over (default: every CUDA device the process sees, the
        counterpart of ``jax.devices()``)."""
        self.prob = problem
        self.opts = options if options is not None else PriDecOptions()
        self.log = Logger(self.opts.integer("verbosity_level"))
        self.S = problem.get_num_rterms()
        self.n = problem.get_num_vars()
        self.xc_idx = (
            np.arange(self.n) if xc_index is None else np.asarray(xc_index, dtype=np.int64)
        )
        self.nc = int(self.xc_idx.size)
        self.scenario_devices = scenario_devices
        self.alpha_ratio = 1.0
        self.iter_ = 0
        self.obj_ = float("nan")
        # forward options_file_master_prob iff the user's solve_master takes
        # it (the reference passes it unconditionally, cpp:880; here older
        # implementations without the parameter keep working)
        import inspect

        try:
            params = inspect.signature(problem.solve_master).parameters
            accepts = "options_file" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
            )
        except (TypeError, ValueError):
            accepts = False
        self._master_kw = (
            {"options_file": self.opts.str_("options_file_master_prob")}
            if accepts
            else {}
        )

    def _eval_recourse(self, x0: np.ndarray):
        """Evaluate all recourse terms; returns (rval_mean, grad_mean).

        Dispatch (hiopAlgPrimalDecomp run/run_local/run_single):
        * batched problems -> one batched call over the scenario axis (with
          one device, as ``hiop_tpu`` with one device);
        * accum_local=true or multi-process -> static partition by rank,
          local accumulation, cross-process reduce (run_local, cpp:1269);
        * otherwise -> dynamic thread-pool dealing with num_local_workers
          (the master-worker work-stealing loop, cpp:950-995; 1 worker
          degenerates to the serial run_single loop)."""
        from hiop_tpu_torch.parallel import scenario_sched as ssched

        if getattr(self.prob, "batched", False):
            import torch

            devices = self.scenario_devices
            if devices is None:
                devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            shard_opt = self.opts.str_("shard_scenarios")
            if shard_opt != "no" and len(devices) > 1 and self.S >= len(devices):
                if getattr(self.prob, "splits_over_devices", False):
                    return self._eval_recourse_sharded(x0, devices)
                # the counterpart of hiop_tpu's untraceable eval_rterms_batched
                # (numpy, nested solves): yes refuses, auto stays on one device
                msg = (f"{type(self.prob).__name__}.eval_rterms_batched does not evaluate on the "
                       "device of the x it is given (splits_over_devices is False)")
                if shard_opt == "yes":
                    raise ValueError(f"shard_scenarios=yes: {msg}")
                if not getattr(self, "_split_off_logged", False):
                    self._split_off_logged = True
                    self.log.printf(Verbosity.SCALARS, "scenario split disabled: %s", msg)
            rvals, grads = self.prob.eval_rterms_batched(np.arange(self.S), x0)
            rvals = _host(rvals)
            grads = _host(grads)
            return float(rvals.sum()) / self.S, grads.sum(axis=0) / self.S

        def eval_one(i: int):
            return (
                float(self.prob.eval_f_rterm(i, x0)),
                _host(self.prob.eval_grad_rterm(i, x0)),
            )

        rank, nprocs = ssched.process_rank_and_count()
        if self.opts.str_("accum_local") == "true" or nprocs > 1:
            local = ssched.partition_scenarios(self.S, nprocs, rank)
            rsum, gsum = 0.0, np.zeros(self.nc)
            for i in local:
                r, g = eval_one(int(i))
                rsum += r
                gsum = gsum + g
            rsum, gsum = ssched.allreduce_across_processes(rsum, gsum)
            return rsum / self.S, np.asarray(gsum) / self.S

        nw = self.opts.integer("num_local_workers")
        rsum, gsum, _n = ssched.dynamic_schedule(eval_one, range(self.S), nw)
        return rsum / self.S, gsum / self.S

    def _eval_recourse_sharded(self, x0: np.ndarray, devices):
        """The batched scenario axis split over ``devices``: each device
        evaluates its S/n_dev slice (launched one after another, running
        concurrently on their cards), the weighted (value, gradient) sums
        meet on the first device. The scenario count is padded to a device
        multiple with zero-weight repeats, as ``hiop_tpu`` pads its mesh
        (the collective replacement of the reference's MPI_Isend/Irecv
        result gathering, hiopAlgPrimalDecomp.cpp:73-131). Taken only for a
        problem that declares ``splits_over_devices``: it evaluates on the
        device of the ``x`` tensor it is given."""
        import torch

        nd = len(devices)
        S_pad = ((self.S + nd - 1) // nd) * nd
        idx = np.arange(S_pad) % self.S
        w = (np.arange(S_pad) < self.S).astype(np.float64)
        per = S_pad // nd
        parts = []
        for k, dev in enumerate(devices):
            sl = slice(k * per, (k + 1) * per)
            x_d = torch.as_tensor(np.asarray(x0, np.float64), device=dev)
            w_d = torch.as_tensor(w[sl], device=dev)
            rv, gr = self.prob.eval_rterms_batched(torch.as_tensor(idx[sl], device=dev), x_d)
            parts.append((torch.sum(rv * w_d), torch.sum(w_d[:, None] * gr, dim=0)))
        first = devices[0]
        rs = sum(r.to(first) for r, _ in parts)
        gs = sum(g.to(first) for _, g in parts)
        return float(rs) / self.S, _host(gs) / self.S

    def run(self) -> PriDecResult:
        o = self.opts
        max_iter = o.integer("max_iter")
        tol = o.num("tolerance")
        accp_tol = o.num("acceptable_tolerance")
        accp_iters = o.integer("acceptable_iterations")

        x = np.zeros(self.n)
        hess_appx = HessianApprox(self.nc, self.alpha_ratio, o, self.log)
        evaluator = None
        base_val = base_valm1 = 0.0
        convg = convg_f = convg_g = 1e20
        accp_count = 0
        dinf = 0.0
        status = SolveStatus.Max_Iter_Exceeded

        for it in range(max_iter):
            self.iter_ = it
            if it == 0:
                x, obj = self.prob.solve_master(x, include_r=False, **self._master_kw)
                x = _host(x)
                base_val = base_valm1 = float(obj)

            x0 = x[self.xc_idx]
            rval, grad_r = self._eval_recourse(x0)

            if it == 0:
                hess_appx.initialize(rval, x0, grad_r)
                alpha = hess_appx.get_alpha_f(grad_r)
            else:
                hess_appx.update_hess_coeff(x0, grad_r, rval)
                base_valm1 = base_val
                base_val = hess_appx.compute_base(self.obj_)
                hess_appx.update_ratio(base_val, base_valm1)
                alpha = hess_appx.get_alpha_f(grad_r)
                convg_g = hess_appx.check_convergence_grad(grad_r)
                convg_f = hess_appx.check_convergence_fcn(base_val, base_valm1)
                convg = min(convg_f, convg_g)
                self.log.printf(
                    Verbosity.SUMMARY,
                    "pridec it %3d  obj %18.12e  resid %12.6e  step %12.6e  convg %12.6e",
                    it, base_val + rval, convg_f, dinf, convg_g,
                )

            evaluator = RecourseApproxEvaluator(
                self.nc, rval=rval, x0=x0, grad=grad_r,
                hess_diag=np.full(self.nc, alpha),
            )
            self.prob.set_recourse_approx_evaluator(evaluator)
            x_new, obj = self.prob.solve_master(
                x, include_r=True, evaluator=evaluator, **self._master_kw
            )
            x_new = _host(x_new)
            self.obj_ = float(obj)
            dinf = float(np.max(np.abs(x_new[self.xc_idx] - x0))) if self.nc else 0.0
            x = x_new

            if convg <= accp_tol:
                accp_count += 1
            else:
                accp_count = 0
            if convg <= tol:
                status = SolveStatus.Solve_Success
                break
            if accp_count >= accp_iters:
                status = SolveStatus.Solve_Acceptable_Level
                break

        return PriDecResult(
            status=status,
            x=x,
            obj=self.obj_,
            iterations=self.iter_ + 1,
            convergence=convg,
        )


def _host(a) -> np.ndarray:
    """A host f64 array of a tensor, array or list."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy().astype(np.float64)
    return np.asarray(a, dtype=np.float64)
