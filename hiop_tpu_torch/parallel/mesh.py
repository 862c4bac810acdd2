"""Device-mesh placement for the distributed solver.

Counterpart of ``hiop_tpu/parallel/mesh.py`` (reference MPI data
distribution, SURVEY.md §2.9): the variable axis n of x, bounds, Jacobian
columns and BFGS memory is partitioned across ranks, and every global
reduction (dot, norms, min, fraction-to-the-boundary) is an allreduce.
Here the partition is a ``torch.distributed.tensor`` (DTensor) placement
on a one-dimensional :class:`~torch.distributed.device_mesh.DeviceMesh`,
``Shard`` and ``Replicate`` taking the place of ``PartitionSpec``: the
solver's arithmetic on DTensors turns each n-axis reduction into a
collective through DTensor's sharding rules, as GSPMD does for
``hiop_tpu``, and the solver's code has no communication of its own.

These make DTensor carry a solver that was written for plain tensors:

* :func:`solve_scope` lets a plain tensor meet a DTensor as a replicated
  value (``implicit_replication``). Every plain tensor the solver makes
  (a fresh ``torch.zeros``, an index, a cached problem constant) holds the
  same values on every rank, which is what that rule assumes.
* A host read of a DTensor (``float``, ``item``, ``bool``, ``tolist``,
  ``numpy``, ``cpu``) first makes it ``Replicate``: DTensor's own read of
  a partial or sharded value returns this rank's piece. This is an
  explicit collective site, HiOp's MPI_Allreduce before a norm leaves
  ``hiopVectorPar`` (hiopVectorPar.cpp:474-1303).
* The small replicated systems are factored on each rank's replica
  (:func:`hiop_tpu_torch.utils.dtensor.local`), at named sites: the
  kernel wrappers, the LSQ duals' Cholesky, the Newton strategies' KKT
  data, the formulation's in-place writes, and the evaluations of a
  problem that takes plain tensors (``takes_dtensor = False``, as
  :class:`~hiop_tpu_torch.interface.base.AutoDiffNlpProblem`, whose
  ``torch.func`` transforms take no DTensor). Any other operation that
  DTensor has no sharding rule for raises.
* Over gloo, DTensor's all-gathers go through c10d's synchronous
  collective (:func:`_install_gloo_all_gather`).
* Every rank makes the same reads in the same order, because every rank
  runs the same solver on the same replicated scalars, and hashes strings
  alike (:func:`hiop_tpu_torch.parallel.multiprocess.initialize` checks).

One rank drives one device (:mod:`hiop_tpu_torch.parallel.multiprocess`).
A solve without a mesh meets only the no-op checks of
:mod:`hiop_tpu_torch.utils.dtensor` and :func:`solve_scope`, and every
mesh branch of the solver is taken only when the formulation carries
``_mesh``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from hiop_tpu_torch.utils.dtensor import is_dtensor


def _install_host_reads() -> None:
    """Make every host read of a DTensor read the global value (see the
    module docstring). Process-wide, affects DTensors only."""
    from torch.distributed.tensor import DTensor

    def scalar_read(op, args, kwargs):
        return op(args[0].full_tensor(), **kwargs)

    DTensor._op_dispatcher._custom_op_handlers[torch.ops.aten._local_scalar_dense.default] = scalar_read
    DTensor.tolist = lambda self: self.full_tensor().tolist()
    DTensor.numpy = lambda self, **kw: self.full_tensor().numpy(**kw)
    # ``cpu`` too: a partial or sharded value copied to the host first would
    # be reduced there, which NCCL cannot do
    DTensor.cpu = lambda self, *a, **kw: self.full_tensor().cpu(*a, **kw)


def _install_gloo_all_gather() -> None:
    """Route the functional all-gathers that DTensor makes to assemble a
    sharded value over a gloo group through c10d's synchronous
    ``all_gather_into_tensor``. gloo's functional all-gather (an async
    work the caller waits on later) kills the process on CUDA tensors
    (torch 2.11 on the card) and crashed a rank once on the CPU; the
    synchronous collective carries both. NCCL groups keep the functional
    path. Process-wide."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.distributed_c10d import _resolve_process_group

    def gather(functional):
        def run(self, gather_dim, group, tag=""):
            pg = _resolve_process_group(funcol._resolve_group_name(group, tag))
            if dist.get_backend(pg) != "gloo":
                return functional(self, gather_dim, group, tag)
            world = dist.get_world_size(pg)
            x = self.contiguous()
            out = x.new_empty((world * x.shape[0], *x.shape[1:]))
            dist.all_gather_into_tensor(out, x, group=pg)
            if gather_dim != 0:
                out = torch.cat(torch.chunk(out, world, dim=0), dim=gather_dim)
            return out
        return run

    for name in ("all_gather_single", "all_gather_tensor"):
        if hasattr(funcol, name):
            setattr(funcol, name, gather(getattr(funcol, name)))


_HOOKS_INSTALLED = False


def _install_hooks() -> None:
    """The two process-wide DTensor hooks of the module docstring, once."""
    global _HOOKS_INSTALLED
    if not _HOOKS_INSTALLED:
        _install_host_reads()
        _install_gloo_all_gather()
        _HOOKS_INSTALLED = True


def _device_type(compute_mode: str) -> str:
    return "cpu" if compute_mode == "cpu" else "cuda"


def _ensure_process_group(device_type: str) -> None:
    """A world of one when no process group exists yet (a mesh inside one
    process: gloo on the CPU, NCCL on the card)."""
    import torch.distributed as dist

    from hiop_tpu_torch.parallel.multiprocess import _free_port, initialize

    if not dist.is_initialized():
        initialize(f"127.0.0.1:{_free_port()}", 1, 0, platform=device_type)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "n",
              compute_mode: str = "auto"):
    """A one-dimensional DeviceMesh over the first ``n_devices`` ranks of
    the world (all of them by default). Every rank calls it; a rank outside
    the mesh gets a mesh it is not part of. The device type follows the
    solver's ``compute_mode`` (``cpu``, else ``cuda``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device_type = _device_type(compute_mode)
    _ensure_process_group(device_type)
    _install_hooks()
    world = dist.get_world_size()
    n_devices = world if n_devices is None else int(n_devices)
    if not 1 <= n_devices <= world:
        raise ValueError(f"n_devices={n_devices} outside 1..{world} (the world size)")
    return DeviceMesh(device_type, torch.arange(n_devices), mesh_dim_names=(axis_name,))


def _local_chunk(mesh, a: torch.Tensor, dim: int) -> torch.Tensor:
    P = mesh.size()
    if a.shape[dim] % P:
        raise ValueError(f"axis of length {a.shape[dim]} not divisible by the mesh size {P}")
    return a.chunk(P, dim=dim)[mesh.get_local_rank()].contiguous()


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    return torch.as_tensor(a, device=device)


def mesh_device(mesh) -> torch.device:
    """The device this rank's part of ``mesh`` lives on."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def shard_n(mesh, a, axis_name: str = "n"):
    """A vector (n,) or matrix (..., n) with its last axis sharded. Every
    rank holds the full (identical) value and keeps its own slice: no
    communication (the hiopVectorPar 'local slice of a replicated source'
    constructor)."""
    from torch.distributed.tensor import DTensor, Shard

    if is_dtensor(a):
        return a.redistribute(mesh, [Shard(a.dim() - 1)])
    t = _as_tensor(a, mesh_device(mesh))
    dim = t.dim() - 1
    return DTensor.from_local(_local_chunk(mesh, t, dim), mesh, [Shard(dim)], run_check=False)


def replicate(mesh, a):
    """The same value on every rank of the mesh."""
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(a):
        return a.redistribute(mesh, [Replicate()])
    return DTensor.from_local(_as_tensor(a, mesh_device(mesh)), mesh, [Replicate()], run_check=False)


def to_host(a) -> np.ndarray:
    """A host numpy copy of the global value (``full_tensor`` of a DTensor:
    the all-gather the reference expresses with MPI_Allgatherv)."""
    if is_dtensor(a):
        a = a.full_tensor()
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@contextlib.contextmanager
def solve_scope(nlp):
    """The context a sharded solve runs in (plain tensors meet DTensors as
    replicated values); a no-op for a formulation without a mesh."""
    if getattr(nlp, "_mesh", None) is None:
        yield
        return
    import warnings

    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication(), warnings.catch_warnings():
        # a one-element vector (an m=1 constraint block) meets a DTensor as
        # a replicated value like any other plain tensor
        warnings.filterwarnings("ignore", message="Found a non-scalar tensor with numel=1")
        yield


class PaddedDenseProblem:
    """Pad a dense-constrained problem's variable axis to a multiple of the
    mesh size (a DTensor shard here needs even division, like an XLA
    sharding; the reference's MPI column partition has no such constraint,
    hiopInterface.hpp:262, so the port masks instead, as ``hiop_tpu``).

    The extra variables are inert: free (no bounds, so no barrier terms),
    zero objective gradient, zero Jacobian columns, zero starting point;
    every search direction component on the pad is exactly zero, and the
    trajectory equals the unpadded problem's up to reduction order."""

    def __init__(self, inner, n_pad: int):
        n, m = inner.get_prob_sizes()
        assert n_pad >= n
        self.inner = inner
        self.n_orig = n
        self._hiop_pad_n_orig = n  # read by the solver to trim the result
        self.pad = n_pad - n
        self._m = m

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def get_prob_sizes(self):
        return self.n_orig + self.pad, self._m

    def get_vars_info(self):
        from hiop_tpu_torch.interface.base import INF

        xl, xu = self.inner.get_vars_info()
        return (
            np.concatenate([np.asarray(xl, np.float64), np.full(self.pad, -INF)]),
            np.concatenate([np.asarray(xu, np.float64), np.full(self.pad, INF)]),
        )

    def get_starting_point(self):
        x0 = np.asarray(self.inner.get_starting_point(), np.float64)
        return np.concatenate([x0, np.zeros(self.pad, x0.dtype)])

    def _t(self, a, like):
        return torch.as_tensor(a, dtype=torch.float64, device=like.device)

    def eval_f(self, x):
        return self.inner.eval_f(x[: self.n_orig])

    def eval_grad_f(self, x):
        g = self._t(self.inner.eval_grad_f(x[: self.n_orig]), x).reshape(self.n_orig)
        return torch.cat([g, g.new_zeros(self.pad)])

    def eval_cons(self, x):
        return self.inner.eval_cons(x[: self.n_orig])

    def eval_jac_cons(self, x):
        J = self._t(self.inner.eval_jac_cons(x[: self.n_orig]), x).reshape(self._m, self.n_orig)
        return torch.cat([J, J.new_zeros((self._m, self.pad))], dim=1)

    def eval_hess_lagr(self, x, obj_factor, lam):
        """The inner Hessian in the top-left block and the IDENTITY in the
        pad block: with zero pad gradient and Jacobian the Newton direction
        on the pad is exactly H_pad^{-1} 0 = 0, and the pad block adds no
        spurious singularity (an all-zero block would make the KKT
        factorization singular and trigger regularization that perturbs the
        real variables' trajectory)."""
        H = self._t(self.inner.eval_hess_lagr(x[: self.n_orig], obj_factor, lam), x)
        H = H.reshape(self.n_orig, self.n_orig)
        top = torch.cat([H, H.new_zeros((self.n_orig, self.pad))], dim=1)
        bot = torch.cat([H.new_zeros((self.pad, self.n_orig)),
                         torch.eye(self.pad, dtype=H.dtype, device=H.device)], dim=1)
        return torch.cat([top, bot], dim=0)


def shard_formulation(nlp, mesh, axis_name: str = "n") -> None:
    """Shard an initialized formulation's n-sized data over the mesh.

    After this the whole solver runs distributed: x-sized iterate leaves
    inherit the sharding through elementwise operations, Jacobian
    contractions over n give replicated m-sized results through an
    all-reduce, and the small KKT/Schur systems stay replicated: the layout
    of the reference's hiopVectorPar / hiopMatrixDenseRowMajor /
    hiopHessianLowRank trio. Applies to :class:`NlpDenseConstraints` and
    :class:`NlpMDS`.

    When n is not a multiple of the mesh size and the formulation has not
    been finalized yet, a dense-constrained problem is wrapped in
    :class:`PaddedDenseProblem` (pad-and-mask)."""
    from hiop_tpu_torch.formulation.dense import NlpDenseConstraints
    from hiop_tpu_torch.formulation.mds import NlpMDS

    if not isinstance(nlp, (NlpDenseConstraints, NlpMDS)):
        raise TypeError(f"shard_formulation applies to NlpDenseConstraints and NlpMDS, not {type(nlp).__name__}")
    if _device_type(nlp.options.str_("compute_mode")) != mesh.device_type:
        raise ValueError(
            f"the mesh is on {mesh.device_type!r} and the solve's compute_mode is "
            f"{nlp.options.str_('compute_mode')!r}"
        )
    P = mesh.size()
    if not getattr(nlp, "_finalized", False):
        n, _ = nlp.problem.get_prob_sizes()
        if n % P != 0:
            if type(nlp) is not NlpDenseConstraints:
                raise ValueError(
                    f"n={n} not divisible by mesh size {P}; automatic "
                    "pad-and-mask is implemented for NlpDenseConstraints only"
                )
            nlp.problem = PaddedDenseProblem(nlp.problem, ((n + P - 1) // P) * P)
    nlp.finalize_initialization()
    if nlp.n % P != 0:
        raise ValueError(
            f"n={nlp.n} must be divisible by the mesh size {P} "
            "(shard before finalize_initialization to get automatic padding)"
        )
    b = nlp.bounds
    nlp.bounds = b._replace(
        xl=shard_n(mesh, b.xl, axis_name),
        xu=shard_n(mesh, b.xu, axis_name),
        ixl=shard_n(mesh, b.ixl, axis_name),
        ixu=shard_n(mesh, b.ixu, axis_name),
        dl=replicate(mesh, b.dl),
        du=replicate(mesh, b.du),
        idl=replicate(mesh, b.idl),
        idu=replicate(mesh, b.idu),
    )
    nlp._mesh = mesh
    nlp._mesh_axis = axis_name
    # the primal iterate starts sharded
    orig_start = nlp.get_starting_point

    def sharded_start():
        return shard_n(mesh, orig_start(), axis_name)

    nlp.get_starting_point = sharded_start
