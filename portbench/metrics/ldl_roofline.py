"""ldl_roofline.<cell kind>: the no-pivot LDL^T's share of its roofline (%)
over the traced window's launches of the wrapper that the traffic mix
names (``factor_kernel``) that factor the KKT saddle.

Each launch's bound is its batch (1 for a single solve) times that of one
matrix at the saddle's logical order (``saddle`` in the configuration),
the larger of its operations at the dtype's peak and its bytes at the
memory's (``work/ldl_nopiv.py``, ``peaks.json``); the time is the launch's
CUDA events. The launches that factor the saddle are those at the largest
order recorded, which is the saddle's padded order."""

from pathlib import Path

from portbench.spec import load_module

WORK = load_module(Path(__file__).resolve().parents[1] / "work" / "ldl_nopiv.py")
ITEMSIZE = {"float64": 8, "float32": 4}


def read(trace):
    kernel = trace.mix.get("factor_kernel")
    ev = [e for r in trace.requests for e in r.kernel_ms if e[0] == kernel]
    n = trace.logical_n.get("saddle")
    ev = [e for e in ev if n is not None and e[1] >= n]
    if not ev:
        return None
    top = max(e[1] for e in ev)
    bound_ms = ms = 0.0
    for _, n_pad, dt, batch, t in ev:
        if n_pad != top:
            continue
        t_ops = WORK.flops(n) / trace.peaks["flops"][dt]
        t_bytes = WORK.bytes_moved(n, ITEMSIZE[dt]) / trace.peaks["bytes_per_s"]
        bound_ms += batch * max(t_ops, t_bytes) * 1e3
        ms += t
    return 100.0 * bound_ms / ms
