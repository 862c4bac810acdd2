"""What a traced run (``--trace 1``) records around the program, from the
benchmark's own files: host reads of device values, the kernel wrappers'
launch counts and CUDA events, and the device's activity from
``torch.profiler``. The per-layer readers under ``metrics/`` reduce it.

The end-to-end run (``--trace 0``) installs none of it.
"""

from __future__ import annotations

import bisect
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

#: the tensor methods that make the host wait for the device
SYNC_METHODS = ("item", "tolist", "__bool__", "__float__", "__int__", "cpu")


class HostReads:
    """Counts ``.item()``, ``.tolist()``, ``bool``/``float``/``int`` and
    ``.cpu()`` of a CUDA tensor while installed (a copy of
    ``chip_smoke._count_syncs``)."""

    def __init__(self) -> None:
        self.count = 0
        self._saved: dict = {}

    def install(self) -> None:
        import torch

        T = torch.Tensor
        self._saved = {k: getattr(T, k) for k in SYNC_METHODS}

        def wrap(f):
            def counted(t, *a, **k):
                if t.is_cuda:
                    self.count += 1
                return f(t, *a, **k)
            return counted

        for k, f in self._saved.items():
            setattr(T, k, wrap(f))

    def remove(self) -> None:
        import torch

        for k, f in self._saved.items():
            setattr(torch.Tensor, k, f)
        self._saved = {}


@dataclass
class RequestTrace:
    """What one request of the traced window did."""
    iterations: int                 # outer iterations (a family: batched loop trips)
    answers: int                    # solves or lanes
    reads: int                      # host reads of device values
    launches: Counter               # kernel wrapper -> launches
    kernel_ms: list                 # (wrapper, padded n, dtype, batch, ms) per launch


@dataclass
class Trace:
    """The traced window, as the per-layer readers see it."""
    requests: list
    window_s: float
    busy_s: float
    logical_n: dict                 # the configuration's logical orders by name
    peaks: dict
    mix: dict = field(default_factory=dict)           # the cell's traffic mix
    device_ops: list = field(default_factory=list)    # [(name, seconds)] most time first
    idle_gaps: list = field(default_factory=list)     # [(host op, seconds)] longest first


class KernelLog:
    """Per-request snapshots of ``hiop_tpu_torch.linalg.kernels.stats``,
    with its per-launch CUDA events on."""

    def __init__(self) -> None:
        from hiop_tpu_torch.linalg import kernels

        self.stats = kernels.stats

    def start(self) -> None:
        self.stats.timing = True
        self._launches = Counter(self.stats.launches)
        self._events = len(self.stats.events)
        self._batches = Counter(self.stats.batches)

    def take(self) -> tuple:
        """(launches, [(name, n, dtype, batch, start, end)]) since start()."""
        launches = Counter(self.stats.launches)
        launches.subtract(self._launches)
        batches = Counter(self.stats.batches)
        batches.subtract(self._batches)
        sizes = {(name, n, dt): S for (name, n, dt, S), k in batches.items() if k > 0}
        events = [(name, n, dt, sizes.get((name, n, dt), 1), s, e)
                  for name, n, dt, s, e in self.stats.events[self._events:]]
        self.start()
        return +launches, events

    def stop(self) -> None:
        self.stats.timing = False


def event_ms(events) -> list:
    """The launches' device milliseconds (synchronizes)."""
    import torch

    torch.cuda.synchronize()
    return [(name, n, dt, S, s.elapsed_time(e)) for name, n, dt, S, s, e in events]


def union_seconds(intervals: np.ndarray) -> float:
    """Length of the union of [start, end) intervals, (k, 2) in ns."""
    if len(intervals) == 0:
        return 0.0
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    # a new run of overlap starts where an interval begins after every earlier end
    new = np.empty(len(iv), dtype=bool)
    new[0] = True
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(new)
    run_end = np.append(ends[last[1:] - 1], ends[-1])
    return float(np.sum(run_end - starts)) / 1e9


def read_profile(prof, top: int = 10) -> dict:
    """Device activity from a stopped ``torch.profiler.profile`` that
    spanned the window: busy seconds (the union of device operations), the
    device operations with most time, and the longest idle gaps by the
    innermost host-side event that covers each (a CUDA runtime call, or an
    operator where the profiler recorded them)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    for i, e in enumerate(events):
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            dev.append((s, s + d, i))
        elif d > 0:
            host.append((s, s + d, i))
    if not dev:
        return dict(busy_s=0.0, device_ops=[], idle_gaps=[])
    t0_ns = min(v[0] for v in dev + host)
    t1_ns = max(v[1] for v in dev + host)
    iv = np.array([(s, e) for s, e, _ in dev], dtype=np.int64)
    by_op: Counter = Counter()
    for s, e, i in dev:
        by_op[events[i].name()] += (e - s) / 1e9
    device_ops = [[name[:120], sec] for name, sec in by_op.most_common(top)]
    host = [(s, e, events[i]) for s, e, i in host]
    return dict(busy_s=union_seconds(iv), device_ops=device_ops,
                idle_gaps=_idle_gaps(iv, host, t0_ns, t1_ns, top))


def _name(e) -> str:
    return e if isinstance(e, str) else e.name()


def _idle_gaps(iv: np.ndarray, host: list, t0: int, t1: int, top: int) -> list:
    """The idle gaps between device operations, summed by what the host was
    doing in each (the innermost host event at the gap's middle, or "host
    (no operation)": Python between launches), longest first; the 500
    longest gaps are attributed. ``host``: (start, end, event or name)."""
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    g_start = np.concatenate([[t0], ends])
    g_end = np.concatenate([iv[:, 0], [t1]])
    keep = g_end > g_start
    g_start, g_end = g_start[keep], g_end[keep]
    if len(g_start) == 0:
        return []
    longest = np.argsort(g_start - g_end, kind="stable")[:500]
    host.sort()
    h_start = np.array([h[0] for h in host], dtype=np.int64)
    h_end = np.array([h[1] for h in host], dtype=np.int64)
    h_len = h_end - h_start
    by_host: Counter = Counter()
    for i in longest:
        mid = (g_start[i] + g_end[i]) // 2
        hi = bisect.bisect_right(h_start, mid)
        cover = np.flatnonzero(h_end[:hi] >= mid)
        name = _name(host[cover[np.argmin(h_len[cover])]][2]) if len(cover) else "host (no operation)"
        by_host[name[:120]] += (g_end[i] - g_start[i]) / 1e9
    return [[name, sec] for name, sec in by_host.most_common(top)]
