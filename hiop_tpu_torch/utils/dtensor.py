"""A DTensor's local replica, for code below the mesh layer.

A mesh-sharded solve (:mod:`hiop_tpu_torch.parallel.mesh`) hands the
solver ``torch.distributed.tensor.DTensor`` values. Where a computation
must run on plain tensors (a hand-written kernel, a library factorization
DTensor has no rule for, an in-place write, ``torch.func``), it runs on
this rank's replica of its inputs and, where the result goes on through
DTensor arithmetic, the result is wrapped back as ``Replicate``: a Pallas
kernel runs the same way on each device's copy of a replicated array.
These helpers are no-ops on plain tensors and never import DTensor in a
process that has not made one.
"""

from __future__ import annotations

import sys


def is_dtensor(a) -> bool:
    """True for a DTensor."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(a, mod.DTensor)


def replicate_like(*args):
    """A function that wraps a plain result as ``Replicate`` on the mesh of
    the first DTensor among ``args`` (the identity when there is none)."""
    src = next((a for a in args if is_dtensor(a)), None)
    if src is None:
        return lambda t: t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = src.device_mesh
    return lambda t: DTensor.from_local(t, mesh, [Replicate()], run_check=False)


def local(a):
    """This rank's local tensor of ``a`` made ``Replicate`` (the value
    itself for a plain tensor), and a function that wraps a result back as
    ``Replicate`` on the same mesh (the identity for a plain tensor)."""
    if not is_dtensor(a):
        return a, lambda t: t
    from torch.distributed.tensor import Replicate

    rep = a.redistribute(a.device_mesh, [Replicate()]) if any(not p.is_replicate() for p in a.placements) else a
    return rep.to_local(), replicate_like(a)


def plain(a):
    """This rank's replica of a DTensor as a plain tensor (a plain tensor as
    it is)."""
    return local(a)[0]
