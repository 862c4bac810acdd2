"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. Set-up: load the cell's files, check the card, build the instance, and
   warm up with the mix's one warm-up request (capped iterations), which
   builds the kernels on a checkout's first run and captures their graphs
   at the cell's sizes. ``setup_s`` runs from the process's start to the
   window's start.
2. The window: one client in a closed loop, the next request when the last
   returns. A request that starts in the window runs to its end; the window
   closes at the end of the request in flight once ``--seconds`` have
   passed. Rates and times are all the work over the window's length.
3. After the window: the peak device memory, the answers copied to the
   host, the program's state freed, then every answer that claims success
   judged by the plain reference. The numbers compared and their limits go
   to standard error as its last lines and into the result line, last.

``--trace 1`` records host reads, kernel launches and their CUDA events,
and the device's activity (``torch.profiler``) over the window, and
reports the cell's per-layer metrics instead of its end-to-end ones.

No CUDA device (or fewer than the cell asks for): exit 2, no result.
``--rehearse`` runs on the CPU instead, with ``--set key=value`` to shrink
the configuration or the mix, and reports no metric: it exists for the
harness's own tests.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import resource
import sys
import time
import traceback

# load from one process with one host thread: the program's host side is
# one Python thread launching work on the card; idle BLAS and OpenMP
# workers only compete with it for cores shared with the machine's other
# tenants (set before numpy and torch are imported)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

from portbench import device, judge, probe, spec, traffic  # noqa: E402


def _parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="run on the CPU, report no metric (the harness's tests)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="with --rehearse: replace a key of the configuration or the mix")
    return p.parse_args(argv)


def _overrides(pairs) -> dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        out[k] = json.loads(v)
    return out


def _err(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Window:
    """What the end-to-end readers read."""

    def __init__(self, setup_s, window_s, answers, ok):
        self.setup_s, self.window_s, self.answers, self.ok = setup_s, window_s, answers, ok


class HostLog:
    """What the host did while one request ran, for the run's log on
    standard error: CPU seconds, involuntary context switches, major page
    faults, the collector's pauses, and the device segments that the
    caching allocator newly asked the driver for (``cudaMalloc``)."""

    def __init__(self, cuda: bool) -> None:
        self.cuda, self.gc_s, self._gc_t0 = cuda, 0.0, None
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self._gc_t0 = None

    def mark(self) -> tuple:
        import torch

        ru = resource.getrusage(resource.RUSAGE_SELF)
        seg = torch.cuda.memory_stats().get("segment.all.allocated", 0) if self.cuda else 0
        return (ru.ru_utime + ru.ru_stime, ru.ru_nivcsw, ru.ru_majflt, self.gc_s, seg)

    def since(self, m0: tuple) -> str:
        d = [b - a for a, b in zip(m0, self.mark())]
        return (f"host cpu {d[0]:.3f} s, preempted {d[1]}, major faults {d[2]}, "
                f"gc {d[3]:.3f} s, new segments {d[4]}")

    def close(self) -> None:
        gc.callbacks.remove(self._on_gc)


def prepare(args):
    """(cell, device, grid) of a run; raises device.NoDevice without the
    card (unless rehearsing)."""
    cell = spec.load_cell(args.workload, overrides=_overrides(args.set))
    dev = "cpu"
    if not args.rehearse:
        device.require_cuda(cell.chips)
        dev = "cuda"
    return cell, dev, cell.entry.grid(cell.config, cell.reference)


def stream(cell):
    """What makes the cell's requests: its entry where the entry defines
    ``warmup`` and ``requests`` of its own (an instance that is not a grid
    snapshot), else :mod:`portbench.traffic`'s grid snapshots."""
    entry = cell.entry
    return entry if hasattr(entry, "warmup") and hasattr(entry, "requests") else traffic


def warm_up(cell, dev: str, grid: dict) -> None:
    """The mix's warm-up requests: they build and load the kernels and
    capture their graphs at the sizes and on the paths of the window."""
    warm = stream(cell).warmup(cell.traffic, grid, cell.reference)
    for w in cell.traffic["warmup"]:
        cell.entry.serve(cell.config, warm, dev, max_iter=int(w["max_iter"]))


def main(argv=None) -> int:
    args = _parse(argv)
    if args.set and not args.rehearse:
        _err("--set is for rehearsals only")
        return 2
    import torch

    try:
        cell, dev, grid = prepare(args)
    except device.NoDevice as e:
        _err(f"portbench: {e}")
        return 2
    config, mix = cell.config, cell.traffic
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    warm_up(cell, dev, grid)
    tracing = bool(args.trace) and dev == "cuda"
    if tracing:
        from torch.profiler import ProfilerActivity, profile

        # the device's activity alone (CUPTI's kernels, copies and runtime
        # calls): recording every operator on the host as well slowed the
        # host-bound window by 1.4-1.75x and read as idle time
        activities = [ProfilerActivity.CUDA]
        # the process's first profiler pays CUPTI's start-up: pay it here
        with profile(activities=activities):
            torch.ones(8, device=dev).sum().item()
        reads, klog = probe.HostReads(), probe.KernelLog()
    if dev == "cuda":
        torch.cuda.synchronize()
    gc.collect()

    # -- the window
    reqs = stream(cell).requests(mix, grid, cell.reference, args.seed)
    answers, traces, error = [], [], None
    if tracing:
        prof = profile(activities=activities)
        prof.start()
        reads.install()
        klog.start()
    host = HostLog(dev == "cuda")
    setup_s = device.process_age()
    t0 = time.perf_counter()
    while True:
        req = next(reqs)
        r0 = reads.count if tracing else 0
        h0 = host.mark()
        q0 = time.perf_counter()
        try:
            out = cell.entry.serve(config, req, dev)
            if dev == "cuda":
                torch.cuda.synchronize()
        except Exception:   # the answer never came: the run is not correct
            error = traceback.format_exc()
            break
        answers += out.answers
        _err(f"request {req.index} (snapshot {req.snapshot}): {len(out.answers)} answers, "
             f"{sum(a.ok for a in out.answers)} ok, {out.iterations} iterations, "
             f"{time.perf_counter() - q0:.3f} s; {host.since(h0)}")
        if tracing:
            launches, events = klog.take()
            traces.append(probe.RequestTrace(out.iterations, len(out.answers),
                                             reads.count - r0, launches, events))
        if time.perf_counter() - t0 >= args.seconds:
            break
    window_s = time.perf_counter() - t0
    host.close()
    if tracing:
        klog.stop()
        reads.remove()
        t_stop = time.perf_counter()
        prof.stop()
        t_stop = time.perf_counter() - t_stop

    # -- after the window
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    answers = judge.host_answers(answers)
    trace = None
    if tracing:
        for t in traces:
            t.kernel_ms = probe.event_ms(t.kernel_ms)
        t_read = time.perf_counter()
        act = probe.read_profile(prof)
        del prof
        _err(f"trace: {len(traces)} requests; profiler stopped in {t_stop:.1f} s, "
             f"read in {time.perf_counter() - t_read:.1f} s")
        with open(spec.PACKAGE / "peaks.json") as f:
            peaks = json.load(f)
        trace = probe.Trace(traces, window_s, act["busy_s"], config.get("logical_n", {}),
                            peaks, mix, act["device_ops"], act["idle_gaps"])
    reqs = out = None
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()

    ok = sum(a.ok for a in answers)
    found = judge.numbers(answers, grid, cell.reference)
    correct, rows = judge.verdict(found, cell.limits, complete=error is None)
    if error:
        _err(error)

    metrics = {}
    if dev == "cuda":
        if tracing:
            todo = [(m, m.reader.read(trace)) for m in cell.per_layer]
        else:
            w = Window(setup_s, window_s, answers, ok)
            todo = [(m, m.reader.read(w)) for m in cell.end_to_end]
        metrics = {m.name: {"value": v, "unit": m.unit} for m, v in todo if v is not None}

    bad = device.forbidden_loaded()
    if bad:
        _err(f"portbench: the process holds modules of JAX or the JAX package: {bad}")
        return 3

    statuses: dict = {}
    for a in answers:
        statuses[a.status] = statuses.get(a.status, 0) + 1
    if dev == "cuda":
        desc = device.describe(cell.chips)
        desc["memory_peak_bytes"] = int(peak)
        desc["power_limit"] = device.power_limit()
        if tracing:
            desc["busy_s"] = trace.busy_s
            desc["window_s"] = trace.window_s
        _err(f"device: {desc['kind']} x{desc['count']}, power limit {desc['power_limit']}")
    else:
        desc = {"platform": "cpu", "kind": "rehearsal", "count": 0}
    _err(f"setup_s {setup_s} window_s {window_s} answers {len(answers)} statuses {statuses}")
    result = {"correct": correct, "attempted": len(answers), "failed": len(answers) - ok,
              "metrics": metrics, "device": desc}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.device_ops, "idle_gaps": trace.idle_gaps}
    # a number that is not finite (no answer to judge, a NaN) fails its
    # limit and is written as null: the line stays strict JSON
    result["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim}
                        for k, v, lim in rows}
    for k, v, lim in rows:
        _err(f"check {k} {v!r} limit {lim!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
