"""Solver-state checkpointing.

Counterpart of ``hiop_tpu/utils/checkpoint.py`` (the reference's axom/sidre
checkpointing, SidreHelper.hpp:73; hiopAlgFilterIPMQuasiNewton::
save_state_to_sidre_group, hiopAlgFilterIPM.cpp:1553-1760): the full
iterate (all 12 blocks), the L-BFGS memory, the barrier parameter,
iteration counters and the filter, with a size check on restore. The file
is ``hiop_tpu``'s single ``.npz`` format, key for key and shape for shape,
so a checkpoint written by either package resumes in the other. The
solver hands this module host numpy arrays; it never sees a tensor.

Trigger: every ``checkpoint_save_every_N_iter`` iterations when
``checkpoint_save=yes`` (checkpointing_stuff(), cpp:1152), or explicitly
via the solver's ``save_state_to_file``/``save_checkpoint``
(hiopAlgFilterIPM.hpp:399-421).

``checkpoint_format=orbax`` writes a directory, as ``hiop_tpu``'s orbax
format does, through ``torch.distributed.checkpoint`` (DCP): the same keys,
``format_version`` among them, and a zero-size array recorded as
``__empty__{key}__{dtype}`` holding its shape, as ``hiop_tpu`` records it.
In a multi-process solve every rank calls the save and the load (they are
collective), and DCP writes each replicated entry once. The two packages'
directory formats differ (orbax/tensorstore against DCP's), so neither
reads the other's directory; the ``.npz`` file stays the cross-package
format.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

FORMAT_VERSION = 1


def save_state(path: str, state: Dict[str, Any], fmt: str = "npz") -> None:
    """Write a checkpoint: one portable ``.npz`` file (written to a
    temporary name, then renamed into place), or with ``fmt="orbax"`` a
    DCP directory."""
    if fmt == "orbax":
        return _save_dcp(path, state)
    if fmt != "npz":
        raise ValueError(f"unknown checkpoint_format {fmt!r}")
    arrays = {}
    for k, v in state.items():
        if v is None:
            continue
        if isinstance(v, (int, float, bool)):
            arrays[f"scalar__{k}"] = np.asarray(v)
        elif isinstance(v, (list, tuple)) and k == "filter_entries":
            arrays["filter_entries"] = np.asarray(v, dtype=np.float64).reshape(-1, 2)
        else:
            arrays[f"array__{k}"] = np.asarray(v)
    arrays["format_version"] = np.asarray(FORMAT_VERSION)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _distributed() -> bool:
    import warnings

    import torch.distributed as dist

    # DCP warns on every single-process call that it assumes one process
    warnings.filterwarnings("ignore", message="torch.distributed is disabled")
    return dist.is_available() and dist.is_initialized()


def _save_dcp(path: str, state: Dict[str, Any]) -> None:
    import torch
    import torch.distributed.checkpoint as dcp

    tree: Dict[str, Any] = {"format_version": torch.tensor(FORMAT_VERSION)}
    for k, v in state.items():
        if v is None:
            continue
        if k == "filter_entries":
            v = np.asarray(v, dtype=np.float64).reshape(-1, 2)
        a = np.asarray(v)
        if a.ndim > 0 and a.size == 0:
            # recorded as hiop_tpu records it for orbax: shape under a key
            # that carries the dtype
            tree[f"__empty__{k}__{a.dtype.str}"] = torch.tensor(a.shape, dtype=torch.int64)
        else:
            tree[k] = torch.as_tensor(a).clone()
    dcp.save(tree, checkpoint_id=os.path.abspath(path), no_dist=not _distributed())


def _load_dcp(path: str) -> Dict[str, Any]:
    import torch
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    tree = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype) for k, m in meta.items()}
    dcp.load(tree, checkpoint_id=path, no_dist=not _distributed())
    if int(tree["format_version"]) != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {int(tree['format_version'])} != {FORMAT_VERSION}")
    out: Dict[str, Any] = {}
    for k, t in tree.items():
        if k == "format_version":
            continue
        v = t.numpy()
        if k.startswith("__empty__"):
            name, _, dtypestr = k[len("__empty__"):].rpartition("__")
            out[name] = np.zeros(tuple(int(s) for s in v), dtype=np.dtype(dtypestr))
        elif k == "filter_entries":
            out[k] = [tuple(row) for row in v]
        elif v.ndim == 0:
            out[k] = v.item()
        else:
            out[k] = v
    return out


def load_state(path: str) -> Dict[str, Any]:
    """Read a checkpoint: a directory is the DCP format, a file the npz."""
    if os.path.isdir(path):
        return _load_dcp(path)
    with np.load(path, allow_pickle=False) as z:
        if int(z["format_version"]) != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {int(z['format_version'])} != {FORMAT_VERSION}"
            )
        out: Dict[str, Any] = {}
        for k in z.files:
            if k.startswith("scalar__"):
                out[k[len("scalar__"):]] = z[k].item()
            elif k.startswith("array__"):
                out[k[len("array__"):]] = z[k]
            elif k == "filter_entries":
                out["filter_entries"] = [tuple(row) for row in z[k]]
    return out


def validate(state: Dict[str, Any], n: int, m_eq: int, m_ineq: int) -> None:
    """Schema check mirroring the reference's size/rank assertions
    (hiopAlgFilterIPM.cpp:1688)."""
    if int(state.get("n", -1)) != n or int(state.get("m_eq", -1)) != m_eq or int(
        state.get("m_ineq", -1)
    ) != m_ineq:
        raise ValueError(
            f"checkpoint sizes (n={state.get('n')}, m_eq={state.get('m_eq')}, "
            f"m_ineq={state.get('m_ineq')}) do not match the problem "
            f"(n={n}, m_eq={m_eq}, m_ineq={m_ineq})"
        )
