"""What decides ``correct``: every answer of the window that claims
``Solve_Success`` is judged by the configuration's plain reference, which
works out the snapshot's equations and the lane's outage again from the
inputs and reads the program's answer only to judge it.

The numbers compared are the largest over the judged answers of each of
the reference's certificate numbers (``feas``, ``stat``, ``comp``,
``obj_gap`` for ACOPF); each has a limit of its own in
``limits/<cell>.json``. A run is
correct when every request returned, at least one answer claimed success,
and every number is at most its limit (a NaN is never).
"""

from __future__ import annotations

import numpy as np


def to_host(a) -> np.ndarray:
    """An answer's vector as a float64 host array."""
    if hasattr(a, "detach"):
        a = a.detach().to("cpu").double().numpy()
    return np.asarray(a, dtype=np.float64).reshape(-1)


def host_answers(answers) -> list:
    """The answers with their vectors copied to the host (after the
    window, once the device values are no longer timed)."""
    for a in answers:
        a.x = to_host(a.x)
        a.y = to_host(a.y) if a.y is not None else None
    return answers


def numbers(answers, grid: dict, reference, rounding=None) -> dict:
    """The largest of each certificate number over the answers that claim
    success. ``rounding`` maps (x, y) to another answer first (the
    lower-precision control)."""
    out: dict = {}
    for a in answers:
        if not a.ok:
            continue
        x, y = (a.x, a.y) if rounding is None else rounding(a.x, a.y)
        cert = reference.certificate(grid, a.p_load, a.line, x, y, a.obj)
        for k, v in cert.items():
            v = float(v) if np.isfinite(v) else float("inf")
            out[k] = max(out.get(k, 0.0), v)
    return out


def as_float32(x, y):
    """The best answer a computation in float32 could return: the float64
    answer rounded to float32."""
    return (x.astype(np.float32).astype(np.float64),
            None if y is None else y.astype(np.float32).astype(np.float64))


def verdict(found: dict, limits: dict, complete: bool) -> tuple:
    """(correct, [(name, value, limit)]) of one run."""
    rows = [(k, found.get(k, float("nan")), lim) for k, lim in limits.items()]
    ok = complete and bool(found) and all(v <= lim for _, v, lim in rows)
    return ok, rows
