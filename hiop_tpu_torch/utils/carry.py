"""Carry state from ``hiop_tpu`` (given as numpy arrays) into the port.

The two packages share no objects: a test or a script that wants both to
start from the same state hands each one numpy arrays. These helpers turn
such arrays into the port's tensors on a given device:

- :func:`to_iterate` / :func:`to_bounds`: the primal-dual point and the
  bound data (NamedTuples with the same field names in both packages);
- :func:`to_mds_factors` / :func:`to_ldl_factors`: KKT factors;
- :func:`to_tensors` and :class:`DeviceCache`: problem data (``build_grid``'s
  dict, the example matrices ``Qd``/``Md``), converted once per device.

Integer arrays stay integer (int64); floating arrays become float64.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from hiop_tpu_torch.kkt.mds import MdsFactors
from hiop_tpu_torch.linalg.ldl_blocked import LdlFactors
from hiop_tpu_torch.optimization.iterate import Bounds, Iterate


def to_tensor(a, device) -> torch.Tensor:
    """One array-like as a tensor on ``device`` (float64 or int64; bool stays
    bool), copied: a JAX array's numpy view is read-only."""
    arr = np.array(a)
    if arr.dtype == np.bool_:
        return torch.as_tensor(arr, device=device)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.as_tensor(arr.astype(np.int64), device=device)
    return torch.as_tensor(arr.astype(np.float64), device=device)


def _fields(src, fields) -> list:
    if isinstance(src, Mapping):
        return [src[k] for k in fields]
    if hasattr(src, "_asdict"):
        d = src._asdict()
        return [d[k] for k in fields]
    return list(src)


def to_iterate(src, device) -> Iterate:
    """An :class:`Iterate` from a NamedTuple, mapping or sequence of arrays
    in ``Iterate._fields`` order."""
    return Iterate(*(to_tensor(a, device) for a in _fields(src, Iterate._fields)))


def to_bounds(src, device) -> Bounds:
    return Bounds(*(to_tensor(a, device) for a in _fields(src, Bounds._fields)))


def to_mds_factors(src, device) -> MdsFactors:
    return MdsFactors(*(to_tensor(a, device) for a in _fields(src, MdsFactors._fields)))


def to_ldl_factors(src, device) -> LdlFactors:
    L, d, n, n_neg, ok = _fields(src, LdlFactors._fields)
    return LdlFactors(
        to_tensor(L, device), to_tensor(d, device), int(n),
        to_tensor(n_neg, device), to_tensor(ok, device),
    )


def to_tensors(data: Mapping[str, Any], device) -> dict:
    """The numeric arrays of a data dict as tensors; scalars and other
    entries (edge lists, complex admittances) are passed through."""
    out = {}
    for k, v in data.items():
        if isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
            out[k] = to_tensor(v, device)
        else:
            out[k] = v
    return out


class DeviceCache:
    """Problem data kept as numpy, handed out as tensors on the device a
    solver asks for (converted on first use per device)."""

    def __init__(self, **arrays) -> None:
        self._np = arrays
        self._by_device: dict = {}

    def on(self, device) -> dict:
        key = str(torch.device(device))
        t = self._by_device.get(key)
        if t is None:
            t = self._by_device[key] = to_tensors(self._np, device)
        return t
