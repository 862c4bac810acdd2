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
(hiopAlgFilterIPM.hpp:399-421). ``checkpoint_format=orbax`` (a JAX
library's sharded directory format) is not ported: its counterpart,
``torch.distributed.checkpoint``, belongs to the distributed port
(ROADMAP.md section 1, item 15).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

FORMAT_VERSION = 1


def save_state(path: str, state: Dict[str, Any], fmt: str = "npz") -> None:
    """Write a checkpoint as one portable ``.npz`` file (written to a
    temporary name, then renamed into place)."""
    if fmt != "npz":
        raise NotImplementedError(
            f"checkpoint_format={fmt} is not ported to hiop_tpu_torch yet "
            "(ROADMAP.md section 1, item 15: sharded checkpoints)"
        )
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


def load_state(path: str) -> Dict[str, Any]:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint); only the npz format "
            "is ported to hiop_tpu_torch (ROADMAP.md section 1, item 15)"
        )
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
