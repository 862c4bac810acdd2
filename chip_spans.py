#!/usr/bin/env python3
"""The solver's spans laid over the profiler's trace, for one traced window
of a benchmark cell, on one CUDA card.

    python3 chip_spans.py [--workload scacopf-b256.screen32] [--seed N] [--seconds S]
                          [--out build/spans]

Runs the cell as ``python3 -m portbench.run ... --trace 1`` does (set-up,
warm-up, ``torch.profiler`` with CUDA activity alone, ``probe.HostReads``,
``kernels.stats.timing`` on for the window) and prints one JSON line:

- ``clock``: at the window's start and end, a span around one synchronized
  kernel, against that kernel's launch call in the profiler's trace: how
  far the call starts after the span does and ends before it does (ns; both
  positive when the two clocks agree);
- ``requests``: per request, its seconds, the ``batch.family`` span's
  duration, the host reads that ``probe.HostReads`` counted and the
  ``host.read`` spans recorded while it ran;
- ``coverage``: per family, the share of it that its direct children
  cover, and the least such share of one of its ``batch.trip`` spans;
- ``table``: per span name, its count, the host's self seconds, the
  device-busy seconds of the operations whose launch call lies in it (the
  innermost span), and the idle seconds of every gap between device
  operations whose midpoint lies in it; ``(no span)`` holds the rest;
- ``idle_named``: the share of the window's idle time that falls in a span.

The spans go to ``<out>/spans.json`` (Chrome trace), the line also to
``<out>/spans_table.json``. Imports nothing of JAX or of ``hiop_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np

SPIN_CYCLES = 20_000    # a few microseconds of one kernel on the card
NO_SPAN = "(no span)"


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 chip_spans.py")
    p.add_argument("--workload", default="scacopf-b256.screen32")
    p.add_argument("--seed", type=int, default=2_718_281_828)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--out", default="build/spans")
    return p.parse_args(argv)


def clock_mark(torch, recorder):
    """A span around one launch of a spin kernel and the wait for it."""
    torch.cuda.synchronize()
    with recorder.span("clock.check") as span:
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
    return span


def innermost(spans, times):
    """For each of ``times`` (sorted ascending), the innermost span open at
    it (None outside all); ``spans`` properly nested, in order of start."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i].start <= t:
            while stack and stack[-1].end < spans[i].start:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def clock_offsets(events, cuda, span) -> dict:
    """The spin kernel launched inside ``span``: its launch call's start
    after the span's start and end before the span's end (ns)."""
    kern = [e for e in events if e.device_type() == cuda and "spin_kernel" in e.name()
            and span.start - 10**9 <= e.start_ns() <= span.end + 10**9]
    if not kern:
        return {"found": False}
    corr = kern[-1].correlation_id()
    call = [e for e in events if e.device_type() != cuda and e.correlation_id() == corr]
    if not call:
        return {"found": False, "kernel": True}
    c = call[0]
    return {"found": True, "call": c.name(), "after_start_ns": c.start_ns() - span.start,
            "before_end_ns": span.end - (c.start_ns() + c.duration_ns()),
            "span_ns": span.duration}


def merge(events, cuda, spans, w0, w1) -> dict:
    """The per-span table over the window [w0, w1] (ns)."""
    from portbench import probe

    launch = {}
    dev = []
    for e in events:
        if e.device_type() == cuda:
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id()))
        elif e.duration_ns() > 0 and e.correlation_id():
            launch[e.correlation_id()] = e.start_ns()
    dev = [d for d in dev if w0 <= d[0] and d[1] <= w1]
    spans = [s for s in spans if s.end is not None and s.start < w1 and s.end > w0]
    table: dict = defaultdict(lambda: {"count": 0, "self_s": 0.0, "busy_s": 0.0, "idle_s": 0.0})
    from hiop_tpu_torch.utils.trace import self_ns

    kids = defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    for s in spans:
        row = table[s.name]
        row["count"] += 1
        row["self_s"] += self_ns(s, kids[s.id]) / 1e9
    # device operations by the innermost span around their launch call
    placed = sorted((launch[c], e - s) for s, e, c in dev if c in launch)
    unplaced = sum(e - s for s, e, c in dev if c not in launch) / 1e9
    at = innermost(spans, [t for t, _ in placed])
    for (_, d), s in zip(placed, at):
        table[NO_SPAN if s is None else s.name]["busy_s"] += d / 1e9
    # every idle gap by the innermost span at its midpoint
    iv = np.array([(s, e) for s, e, _ in dev], dtype=np.int64).reshape(-1, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1]) if len(iv) else np.array([], dtype=np.int64)
    g0 = np.concatenate([[w0], ends])
    g1 = np.concatenate([iv[:, 0], [w1]])
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    mids = ((g0 + g1) // 2).tolist()
    order = np.argsort(mids, kind="stable")
    at = innermost(spans, [mids[i] for i in order])
    idle_total = float(np.sum(g1 - g0)) / 1e9
    named = 0.0
    for i, s in zip(order, at):
        d = float(g1[i] - g0[i]) / 1e9
        table[NO_SPAN if s is None else s.name]["idle_s"] += d
        named += d if s is not None else 0.0
    busy = probe.union_seconds(iv)
    rows = sorted(table.items(), key=lambda kv: -(kv[1]["busy_s"] + kv[1]["idle_s"]))
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy, "idle_s": idle_total,
            "idle_named": named / idle_total if idle_total else None,
            "device_ops": len(dev), "unplaced_busy_s": unplaced,
            "table": [dict(name=k, **v) for k, v in rows]}


def coverage(spans) -> list:
    from hiop_tpu_torch.utils.trace import self_ns

    kids = defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    out = []
    for f in (s for s in spans if s.name == "batch.family"):
        trips = [s for s in kids[f.id] if s.name == "batch.trip"]
        out.append({"family": f.id, "trips": len(trips),
                    "covered": 1 - self_ns(f, kids[f.id]) / f.duration,
                    "least_trip_covered": min(1 - self_ns(t, kids[t.id]) / t.duration
                                              for t in trips)})
    return out


def main(argv=None) -> int:
    a = _args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_spans: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _nvidia_smi
    from hiop_tpu_torch.utils.trace import recorder
    from portbench import probe, run, traffic

    args = run._parse(["--workload", a.workload, "--seed", str(a.seed),
                       "--seconds", str(a.seconds), "--trace", "1"])
    cell, dev, grid = run.prepare(args)
    run.warm_up(cell, dev, grid)
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(8, device=dev).sum().item()
    reads, klog = probe.HostReads(), probe.KernelLog()
    stream = traffic.requests(cell.traffic, grid, cell.reference, a.seed)
    recorder.clear()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    klog.start()
    marks = [clock_mark(torch, recorder)]
    reads.install()
    requests = []
    t0 = time.perf_counter()
    while True:
        req = next(stream)
        r0, q0, n0 = reads.count, time.time_ns(), len(recorder.spans)
        out = cell.entry.serve(cell.config, req, dev)
        torch.cuda.synchronize()
        q1 = time.time_ns()
        new = recorder.spans[n0:]
        fam = [s for s in new if s.name == "batch.family"]
        requests.append({"index": req.index, "seconds": (q1 - q0) / 1e9,
                         "family_s": fam[0].duration / 1e9 if fam else None,
                         "outside_family_s": (q1 - q0 - (fam[0].duration if fam else 0)) / 1e9,
                         "trips": out.iterations, "answers": len(out.answers),
                         "ok": sum(x.ok for x in out.answers),
                         "host_reads": reads.count - r0,
                         "read_spans": sum(s.name == "host.read" for s in new),
                         "_w": (q0, q1)})
        klog.take()
        if time.perf_counter() - t0 >= a.seconds:
            break
    reads.remove()
    marks.append(clock_mark(torch, recorder))
    klog.stop()
    prof.stop()
    w0, w1 = requests[0]["_w"][0], requests[-1]["_w"][1]
    for r in requests:
        del r["_w"]
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    spans = [s for s in recorder.spans if s.name != "clock.check"]
    result = {
        "card": _nvidia_smi(), "torch": torch.__version__, "cuda": torch.version.cuda,
        "workload": a.workload, "seed": a.seed, "clock": [clock_offsets(events, cuda, m)
                                                          for m in marks],
        "spans": len(recorder.spans), "dropped": recorder.dropped,
        "requests": requests,
        "coverage": coverage(spans), **merge(events, cuda, spans, w0, w1),
    }
    os.makedirs(a.out, exist_ok=True)
    recorder.export_chrome(os.path.join(a.out, "spans.json"))
    with open(os.path.join(a.out, "spans_table.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
