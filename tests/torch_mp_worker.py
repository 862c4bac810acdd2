"""Rank program of tests/test_torch_mesh.py and tests/test_torch_multiprocess.py.

Launched by :func:`hiop_tpu_torch.parallel.multiprocess.launch` over gloo
on the CPU; imports torch and the port only. ``python torch_mp_worker.py
SUITE`` runs every case of SUITE and prints one JSON line per case and
rank: ``{"case": ..., "rank": ..., ...}`` (an ``"error"`` key holds the
traceback of a case that raised).

Every suite runs on 2 ranks with DTensor's sharding rules for four
operations taken away (``linalg_cholesky_ex``, ``cholesky_solve``,
``index_put_``, ``index_put``; torch 2.11 lacks the first and the third):
the solver runs them on each rank's replica at named sites, so a call of
one of them on a DTensor anywhere else fails here as it would on such a
torch.

Suites:

* ``mesh``: DenseConsEx1 n=512 (general loop and ``jit_mode=iteration``),
  DenseConsEx2 n=512, ACOPF B=16 under MDS Newton, DenseConsEx1 n=509
  (pad-and-mask), the dense Newton pad case (n=13), the sharded triplet
  Schur assembly, the allreduce ladder, and an operation without a rule
  outside the sites (it raises).
* ``mp``: ACOPF B=32 MDS Newton, PriDec Ex1 with the scenario partition
  and a cross-process reduce, and a DCP (``checkpoint_format=orbax``)
  checkpoint written by a sharded QN solve and resumed, and
  ``allgather_json``.
"""

import faulthandler
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from threadpoolctl import threadpool_limits  # noqa: E402

from hiop_tpu_torch.parallel.multiprocess import initialize  # noqa: E402

CPU = dict(compute_mode="cpu", verbosity_level=0)


def _opts(**kw):
    from hiop_tpu_torch import NlpOptions

    o = NlpOptions()
    o.update(**CPU, **kw)
    return o


def _result(r, **extra):
    return dict(obj=float(r.obj), iterations=int(r.iterations), status=r.status.name, **extra)


def _qn(prob, mesh, **opts):
    from hiop_tpu_torch import FilterIPMQuasiNewton, NlpDenseConstraints
    from hiop_tpu_torch.parallel.mesh import shard_formulation

    nlp = NlpDenseConstraints(prob, _opts(**opts))
    shard_formulation(nlp, mesh)
    return FilterIPMQuasiNewton(nlp).run()


def dense_ex1(mesh):
    from torch.distributed.tensor import DTensor

    from hiop_tpu_torch.examples.dense_ex1 import DenseConsEx1

    seen = {}

    class Recording(DenseConsEx1):
        def solution_callback(self, status, x, *rest):
            seen.update(x_type=type(x).__name__, placements=[str(p) for p in getattr(x, "placements", ())],
                        local_shape=list(x.to_local().shape) if isinstance(x, DTensor) else None)

    r = _qn(Recording(512), mesh)
    return _result(r, **seen)


def dense_ex2(mesh):
    from hiop_tpu_torch.examples.dense_ex2 import DenseConsEx2

    return _result(_qn(DenseConsEx2(512), mesh))


def jit_iteration(mesh):
    from hiop_tpu_torch.examples.dense_ex1 import DenseConsEx1

    return _result(_qn(DenseConsEx1(512), mesh, jit_mode="iteration"))


def acopf(B):
    def case(mesh):
        from hiop_tpu_torch import FilterIPMNewton, NlpMDS
        from hiop_tpu_torch.examples.acopf_mds import AcopfMds
        from hiop_tpu_torch.parallel.mesh import shard_formulation

        nlp = NlpMDS(AcopfMds(B), _opts(Hessian="analytical_exact", fixed_var="relax",
                                         tolerance=1e-6, mu0=0.1))
        shard_formulation(nlp, mesh)
        return _result(FilterIPMNewton(nlp).run())
    return case


def pad_509(mesh):
    from hiop_tpu_torch.examples.dense_ex1 import DenseConsEx1

    r = _qn(DenseConsEx1(509), mesh)
    return _result(r, x=r.x.tolist())


def newton_pad(mesh):
    from hiop_tpu_torch import AutoDiffNlpProblem, FilterIPMNewton, NlpDenseConstraints
    from hiop_tpu_torch.parallel.mesh import shard_formulation

    n = 13
    prob = AutoDiffNlpProblem(
        f=lambda x: torch.sum((x - 0.7) ** 2) + 0.05 * torch.sum(x**4),
        c=lambda x: torch.stack([torch.sum(x)]),
        xl=np.full(n, -3.0), xu=np.full(n, 3.0),
        cl=np.array([1.0]), cu=np.array([4.0]), x0=np.full(n, 0.2),
    )
    nlp = NlpDenseConstraints(prob, _opts(Hessian="analytical_exact"))
    shard_formulation(nlp, mesh)
    r = FilterIPMNewton(nlp).run()
    return _result(r, x=r.x.tolist())


def schur_case():
    """The data of tests/test_sharding.py's sharded Schur assembly."""
    rng = np.random.default_rng(3)
    m, ns, nnz = 48, 160, 420
    rc = rng.choice(m * ns, nnz, replace=False)
    rows, cols = rc // ns, rc % ns
    vals = rng.standard_normal(nnz)
    ksinv = rng.uniform(0.5, 2.0, ns) * np.sign(rng.standard_normal(ns))
    return m, ns, rows, cols, vals, ksinv


def schur_sharded(mesh):
    from hiop_tpu_torch.kkt import mds as kkt_mds
    from hiop_tpu_torch.parallel.mesh import to_host

    m, ns, rows, cols, vals, ksinv = schur_case()
    pairs = kkt_mds.build_schur_pairs(rows, cols, ns)
    out = kkt_mds.schur_js_triplets_sharded(torch.as_tensor(vals), torch.as_tensor(ksinv), pairs, m, mesh)
    return dict(placements=[str(p) for p in out.placements], S=to_host(out).tolist())


def ladder(mesh):
    from hiop_tpu_torch.parallel import collectives_bench

    return dict(rungs=collectives_bench.run(mesh, base_count=1024, num_sizes=2, reps=2))


#: the operations whose DTensor rules every suite takes away
NO_RULE_OPS = ("linalg_cholesky_ex", "cholesky_solve", "index_put_", "index_put")


def _take_rules_away():
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    for name in NO_RULE_OPS:
        op = getattr(torch.ops.aten, name).default
        for table in ("op_strategy_funcs", "op_to_rules", "op_single_dim_strategy_funcs"):
            getattr(prop, table, {}).pop(op, None)


def no_rule_raises(mesh):
    """Each of the four operations on a replicated DTensor, outside the
    solver's sites and in the scope a sharded solve runs in: DTensor
    raises, nothing replicates it quietly."""
    from torch.distributed.tensor.experimental import implicit_replication

    from hiop_tpu_torch.parallel.mesh import replicate

    A = replicate(mesh, torch.eye(3, dtype=torch.float64) * 2.0)
    b = replicate(mesh, torch.ones((3, 1), dtype=torch.float64))
    idx = torch.tensor([0, 2])
    calls = {
        "linalg_cholesky_ex": lambda: torch.linalg.cholesky_ex(A),
        "cholesky_solve": lambda: torch.cholesky_solve(b, A),
        "index_put_": lambda: A.clone().index_put_((idx,), A[:2], accumulate=True),
        "index_put": lambda: A.index_put((idx,), A[:2], accumulate=True),
    }
    raised = {}
    for name, call in calls.items():
        try:
            with implicit_replication():
                call()
            raised[name] = None
        except NotImplementedError as e:
            raised[name] = "sharding strategy" in str(e)
    return dict(raised=raised)


def pridec(mesh):
    from hiop_tpu_torch import PriDecOptions, PriDecSolver
    from hiop_tpu_torch.examples.pridec_ex1 import PriDecEx1

    prob = PriDecEx1(nx=8, S=24, compute_mode="cpu")
    prob.batched = False  # the per-rank partition and the cross-process reduce
    o = PriDecOptions()
    o.update(verbosity_level=0, max_iter=60)
    return _result(PriDecSolver(prob, o).run())


def checkpoint_dcp(mesh):
    """Uninterrupted, then stopped at 5 with a DCP checkpoint every 2
    iterations, then resumed from it (test_torch_aux's schedule)."""
    from hiop_tpu_torch.examples.dense_ex1 import DenseConsEx1

    path = os.environ["HIOP_TPU_MP_TMP"] + "/dcp_state"
    full = _qn(DenseConsEx1(200), mesh)
    part = _qn(DenseConsEx1(200), mesh, max_iter=5, checkpoint_save="yes",
               checkpoint_save_every_N_iter=2, checkpoint_file=path, checkpoint_format="orbax")
    resumed = _qn(DenseConsEx1(200), mesh, checkpoint_load_on_start="yes", checkpoint_file=path)
    return dict(full=_result(full, x=full.x.tolist()), part=_result(part),
                resumed=_result(resumed, x=resumed.x.tolist()), is_dir=os.path.isdir(path))


def allgather(mesh):
    from hiop_tpu_torch.parallel.multiprocess import allgather_json

    r = mesh.get_local_rank()
    return dict(gathered=allgather_json({"rank": r, "payload": "x" * (3 + 5 * r)}))


def _run(name, fn, mesh, rank):
    t0 = time.perf_counter()
    try:
        out = fn(mesh)
    except Exception:
        out = dict(error=traceback.format_exc())
    out.update(case=name, rank=rank, seconds=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)


def main() -> int:
    import torch.distributed as dist

    from hiop_tpu_torch.parallel.mesh import make_mesh

    faulthandler.enable()
    torch.set_num_threads(1)
    threadpool_limits(limits=1)
    rank, world = initialize()
    assert world == 2
    suite = sys.argv[1]
    mesh = make_mesh(compute_mode="cpu")
    _take_rules_away()
    if suite == "mesh":
        cases = (("dense_ex1", dense_ex1), ("jit_iteration", jit_iteration), ("dense_ex2", dense_ex2),
                 ("acopf16", acopf(16)), ("pad_509", pad_509), ("newton_pad", newton_pad),
                 ("schur_sharded", schur_sharded), ("ladder", ladder), ("no_rule_raises", no_rule_raises))
    elif suite == "mp":
        cases = (("acopf32", acopf(32)), ("pridec", pridec), ("checkpoint_dcp", checkpoint_dcp),
                 ("allgather", allgather))
    else:
        raise SystemExit(f"unknown suite {suite!r}")
    for name, fn in cases:
        _run(name, fn, mesh, rank)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
