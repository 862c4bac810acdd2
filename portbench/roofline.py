"""A kernel's share of its roofline (%) over a traced window, for the
readers ``metrics/<kernel>_roofline.py``.

Over the window's launches of the wrapper that the traffic mix names
(``factor_kernel``), those at the largest order recorded factor the
matrix whose logical order the configuration gives (``logical_n``) and
which the wrapper may have padded. Each launch's bound is its batch (1 for
a single launch) times that of one matrix at the logical order: the larger
of its operations at the dtype's peak and its bytes at the memory's
(``work/<kernel>.py``, ``peaks.json``). The time is the launches' CUDA
events.
"""

from __future__ import annotations

from pathlib import Path

from portbench.spec import load_module

ITEMSIZE = {"float64": 8, "float32": 4}


def work(name: str):
    """``work/<name>.py``: the kernel's operations and bytes."""
    return load_module(Path(__file__).resolve().parent / "work" / f"{name}.py")


def share(trace, work, logical: str):
    """The share (%), None where the window launched nothing at the
    logical order ``trace.logical_n[logical]`` or above."""
    kernel = trace.mix.get("factor_kernel")
    n = trace.logical_n.get(logical)
    ev = [e for r in trace.requests for e in r.kernel_ms
          if e[0] == kernel and n is not None and e[1] >= n]
    if not ev:
        return None
    top = max(e[1] for e in ev)
    bound_ms = ms = 0.0
    for _, n_pad, dt, batch, t in ev:
        if n_pad != top:
            continue
        t_ops = work.flops(n) / trace.peaks["flops"][dt]
        t_bytes = work.bytes_moved(n, ITEMSIZE[dt]) / trace.peaks["bytes_per_s"]
        bound_ms += batch * max(t_ops, t_bytes) * 1e3
        ms += t
    return 100.0 * bound_ms / ms
