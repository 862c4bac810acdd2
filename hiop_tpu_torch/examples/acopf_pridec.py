"""PriDec SC-ACOPF: two-stage security-constrained dispatch, with its
evaluations in torch on the solver's device.

Counterpart of ``examples/acopf_pridec.py``, the reference's flagship
PriDec workload (SC-ACOPF, doc/pridec_implpaper.pdf;
hiopAlgPrimalDecomposition, hiopAlgPrimalDecomp.cpp): a master problem
picks the basecase dispatch, each scenario solves a contingency
re-dispatch NLP, and the master is re-solved against a quadratic recourse
model built from the scenario values and gradients. Where the reference
dispatches one CPU IPM per MPI worker (cpp:908-999), every outer iteration
here evaluates all contingencies as one lane-batched solve on the device
(:func:`hiop_tpu_torch.optimization.batch_solve.solve_batched` over
:class:`AcopfRecourseMds`, with the inertia-revealing LDL^T ladder). A
lane that does not succeed there is solved again on its own through the
general loop, as in the reference example.

Stage 1 (master): the basecase ACOPF (:mod:`.acopf_mds`) over dispatch g,
plus the PriDec quadratic recourse model on g. Stage 2 (scenario k): the
grid with line k outaged, re-dispatching at cost rho_track/2 ||g_k - g||^2
around the master setpoint; by the envelope theorem dr_k/dg =
rho_track (g - g_k*).

Run: ``python -m hiop_tpu_torch.examples.acopf_pridec 16 4 -selfcheck``
(on cuda:0; add ``-cpu`` for the CPU).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from hiop_tpu_torch import FilterIPMNewton, NlpMDS, NlpOptions
from hiop_tpu_torch.backends.execspace import resolve_device
from hiop_tpu_torch.examples.acopf_mds import AcopfContingencyMds, AcopfMds, acopf_options
from hiop_tpu_torch.interface.pridec import PriDecProblem, RecourseApproxEvaluator
from hiop_tpu_torch.optimization.pridec import PriDecSolver
from hiop_tpu_torch.utils.logger import Logger, Verbosity
from hiop_tpu_torch.utils.options import PriDecOptions

RHO_TRACK = 1.0  # re-dispatch tracking weight around the master setpoint
# (kept soft: a near-pinned dispatch makes outaged scenarios infeasible)


class AcopfRecourseMds(AcopfContingencyMds):
    """Contingency re-dispatch NLP: the outaged-grid ACOPF plus
    rho_track/2 ||g - g_ref||^2, parameterized by th = {gv, bv, gref}
    (admittances and the master dispatch)."""

    def th0(self):
        base = super().th0()
        base["gref"] = self.core.start_dense()
        return base

    def eval_f(self, x, th):
        z, g = self._split(x)
        return (
            self.core.obj_sparse(z)
            + self.core.obj_dense(g)
            + 0.5 * RHO_TRACK * torch.sum((g - th["gref"]) ** 2)
        )

    def eval_grad_f(self, x, th):
        z, g = self._split(x)
        return torch.cat([
            self.core.grad_sparse(z),
            self.core.grad_dense(g) + RHO_TRACK * (g - th["gref"]),
        ])

    def eval_hess_blocks(self, x, obj_factor, lam, th):
        hss, hdd = super().eval_hess_blocks(x, obj_factor, lam, th)
        eye = torch.eye(self.nd, dtype=hdd.dtype, device=hdd.device)
        return hss, hdd + obj_factor * RHO_TRACK * eye


class _MasterAcopf(AcopfMds):
    """Basecase ACOPF with the PriDec recourse model appended on the dense
    dispatch block (the role of the reference's
    set_recourse_approx_evaluator + include_r master solves)."""

    def __init__(self, n_bus, seed, evaluator=None):
        super().__init__(n_bus, seed)
        self._ev = evaluator

    def eval_f(self, x):
        f = super().eval_f(x)
        if self._ev is not None:
            x0, g0, h = self._ev.on(x.device)
            dg = x[self.n_sp:] - x0
            f = f + (self._ev.rval + g0 @ dg + 0.5 * torch.sum(h * dg * dg))
        return f

    def eval_grad_f(self, x):
        gr = super().eval_grad_f(x)
        if self._ev is not None:
            x0, g0, h = self._ev.on(x.device)
            dg = x[self.n_sp:] - x0
            gr = torch.cat([gr[: self.n_sp], gr[self.n_sp:] + (g0 + h * dg)])
        return gr

    def eval_hess_blocks(self, x, obj_factor, lam):
        hss, hdd = super().eval_hess_blocks(x, obj_factor, lam)
        if self._ev is not None:
            hdd = hdd + obj_factor * torch.diag(self._ev.on(x.device)[2])
        return hss, hdd


class AcopfPriDec(PriDecProblem):
    """Two-stage SC-ACOPF through the PriDec interface: the coupled
    variables are the ng dispatch setpoints; the recourse terms are the
    N-1 line-outage re-dispatch problems, evaluated batched.

    ``host_fallbacks`` lists (PriDec evaluation, lane, outaged line, status)
    of each lane that went to its own host solve; ``seconds`` sums the wall
    time of the master solves, the batched recourse solves and those host
    solves."""

    batched = True

    def __init__(self, n_bus: int = 16, n_cont: int = 4, seed: int = 0,
                 compute_mode: str = "auto", verbosity: int = 1):
        self.n_bus = n_bus
        self.seed = seed
        self.compute_mode = compute_mode
        self.device = resolve_device(compute_mode)
        self.rec = AcopfRecourseMds(n_bus, seed)
        self.ng = self.rec.nd
        n_ring = n_bus
        self.lines = [(i * n_ring) // max(n_cont, 1) for i in range(n_cont)]
        self._th_gb = self.rec.contingency_params(self.lines)
        self._pnlp = None
        self._ev = None
        self.log = Logger(verbosity)
        self.host_fallbacks: list = []
        self.n_evals = 0
        self.seconds = dict(master=0.0, recourse_batched=0.0, recourse_host=0.0)

    # -- PriDec interface -----------------------------------------------------
    def get_num_rterms(self) -> int:
        return len(self.lines)

    def get_num_vars(self) -> int:
        return self.ng

    def _options(self, **kw) -> NlpOptions:
        return acopf_options(verbosity_level=0, compute_mode=self.compute_mode, **kw)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def solve_master(self, x, include_r, evaluator=None, options_file=""):
        t0 = time.perf_counter()
        o = self._options()
        if options_file:
            try:
                o.load_from_file(options_file)
            except FileNotFoundError:
                pass
        prob = _MasterAcopf(self.n_bus, self.seed, evaluator if include_r else None)
        r = FilterIPMNewton(NlpMDS(prob, o)).run()
        if not r.status.is_success:
            raise RuntimeError(f"master solve failed: {r.status.name}")
        out = np.asarray(r.x[prob.n_sp:]), float(r.obj)
        self.seconds["master"] += time.perf_counter() - t0
        return out

    def eval_rterms_batched(self, idxs, x):
        from hiop_tpu_torch.optimization.batch_solve import ParametricMdsNlp, solve_batched

        t0 = time.perf_counter()
        self.n_evals += 1
        if self._pnlp is None:
            z0_np = self.rec.core.start_sparse()
            z0_on: dict = {}

            def x0_of_th(th):
                # warm-start the scenario at the master dispatch: the network
                # state starts flat, the dense block at gref
                g = th["gref"]
                key = str(g.device)
                if key not in z0_on:
                    z0_on[key] = torch.as_tensor(z0_np, dtype=g.dtype, device=g.device)
                return torch.cat([z0_on[key], g])

            self._pnlp = ParametricMdsNlp(
                self.rec, self.rec.th0(), self._options(linear_solver_dense="ldl_nopiv"),
                x0_of_th=x0_of_th,
            )
        idxs = np.asarray(idxs)
        x = np.asarray(x, np.float64)
        th = dict(
            gv=self._th_gb["gv"][idxs],
            bv=self._th_gb["bv"][idxs],
            gref=np.broadcast_to(x, (idxs.size, self.ng)),
        )
        res = solve_batched(self._pnlp, th)
        g_opt = res.x[:, self.rec.n_sp:].cpu().numpy()
        rvals = np.array(res.obj, dtype=np.float64)
        self._sync()
        self.seconds["recourse_batched"] += time.perf_counter() - t0
        # scenarios the fused solve cannot finish (a failed factorization or
        # a rejected line search needs the general loop's restoration and
        # safe tiers) are solved again on their own, the reference's one
        # host IPM per scenario
        for i, st in enumerate(res.status):
            if st.is_success:
                continue
            self.host_fallbacks.append((self.n_evals, i, self.lines[int(idxs[i])], st.name))
            self.log.printf(
                Verbosity.SUMMARY,
                "acopf_pridec: lane %d (outage of line %d) ended %s in the batched "
                "solve; solving it alone in the general loop",
                i, self.lines[int(idxs[i])], st.name,
            )
            t1 = time.perf_counter()
            rvals[i], g_opt[i] = self._solve_recourse_host(
                dict(gv=th["gv"][i], bv=th["bv"][i], gref=th["gref"][i])
            )
            self.seconds["recourse_host"] += time.perf_counter() - t1
        # envelope theorem: dr_k/dg = rho_track (g - g_k*)
        grads = RHO_TRACK * (x[None, :] - g_opt)
        return rvals, grads

    def _solve_recourse_host(self, th_k):
        from hiop_tpu_torch.optimization.batch_solve import _BoundThMds

        r = FilterIPMNewton(NlpMDS(_BoundThMds(self.rec, th_k), self._options())).run()
        if not r.status.is_success:
            raise RuntimeError(f"host recourse solve failed: {r.status.name}")
        return float(r.obj), np.asarray(r.x[self.rec.n_sp:])

    def set_recourse_approx_evaluator(self, evaluator: RecourseApproxEvaluator):
        self._ev = evaluator


def solve(n_bus: int = 16, n_cont: int = 4, seed: int = 0, compute_mode: str = "auto",
          problem=None, **opts):
    """Run PriDec on :class:`AcopfPriDec` (or on ``problem``, an instance
    the caller keeps to read its counters)."""
    o = PriDecOptions()
    o.update(verbosity_level=1, max_iter=30, tolerance=1e-5)
    o.update(**opts)
    prob = problem if problem is not None else AcopfPriDec(
        n_bus, n_cont, seed, compute_mode, o.integer("verbosity_level"))
    return PriDecSolver(prob, o).run()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")]
    n_bus = int(pos[0]) if pos else 16
    n_cont = int(pos[1]) if len(pos) > 1 else 4
    r = solve(n_bus, n_cont, compute_mode="cpu" if "-cpu" in argv else "auto")
    print(f"PriDec SC-ACOPF: status {r.status.name} obj {r.obj:.9e} "
          f"iters {r.iterations} convergence {r.convergence:.3e}")
    if "-selfcheck" in argv:
        ok = r.status.name in ("Solve_Success", "Solve_Acceptable_Level")
        print("selfcheck OK" if ok else "selfcheck FAILED")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
