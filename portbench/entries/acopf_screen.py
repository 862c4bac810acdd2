"""N-1 security screening: each request is one family, the basecase and
ring-line outages of the grid at a new load snapshot, solved in lockstep by
the port's batched solve.

The request's loads are set as the grid's ``p_load`` of a new
``AcopfContingencyMds``; a new ``ParametricMdsNlp`` is built over it with the
example's screening options (``contingency_options``), and the entry the
window drives is ``solve_batched`` over the family's parameters. A lane
that exits needs-host (``Err_Step_Computation``, ``Steplength_Too_Small``)
is an answer that failed.
"""

from __future__ import annotations

from hiop_tpu_torch.examples import acopf_mds
from hiop_tpu_torch.optimization.batch_solve import ParametricMdsNlp, solve_batched
from hiop_tpu_torch.status import SolveStatus

from portbench.entries import Answer, Served


def grid(config: dict, reference) -> dict:
    """The configuration's grid from the reference's own build, checked
    against the port's: both sides serve the same instance."""
    g = reference.build_grid(config["n_bus"], config["grid_seed"])
    port = acopf_mds.build_grid(config["n_bus"], config["grid_seed"])
    for k in ("rows", "cols", "g_vals", "b_vals", "p_load", "alpha", "g_max", "cost_c", "cost_Q"):
        if not (g[k].shape == port[k].shape and (g[k] == port[k]).all()):
            raise RuntimeError(f"the port's grid differs from the reference's in {k}")
    return g


def serve(config: dict, request, device: str, **changes) -> Served:
    opts = dict(config["options"], **changes)
    if device == "cpu":
        opts["compute_mode"] = "cpu"
    prob = acopf_mds.AcopfContingencyMds(config["n_bus"], config["grid_seed"])
    prob.core.gd["p_load"] = request.p_load.copy()
    pnlp = ParametricMdsNlp(prob, prob.th0(), acopf_mds.contingency_options(**opts))
    res = solve_batched(pnlp, prob.contingency_params(request.lines))
    # the batched loop's own counter: trips of the lockstep loop
    stats = getattr(getattr(pnlp, "_batched_solve_cache", None), "stats", None)
    trips = stats.trips if stats is not None else int(res.iterations.max()) + 1
    answers = [Answer(st.name, st == SolveStatus.Solve_Success, res.x[k], res.yc[k],
                      float(res.obj[k]), line, request.p_load)
               for k, (st, line) in enumerate(zip(res.status, request.lines))]
    return Served(answers, iterations=int(trips))
