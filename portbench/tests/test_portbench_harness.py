"""The benchmark's own tests, on the CPU: the contract of BENCHMARK.json,
finding files by name, the work counts, and the imports.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import ast
import hashlib
import json
import re
import shutil
from collections import Counter
from pathlib import Path

import pytest

from portbench import judge, probe, run, spec, traffic
from portbench.device import FORBIDDEN

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and all(_line(w) for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    cells = 24
    assert (2 + 14 * cells) * (b["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and _line(c["source"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    seen = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert (PACKAGE / "limits" / f"{w['name']}.json").is_file()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert spec.reader_path(PACKAGE / ("e2e" if m["name"] in e2e else "metrics"),
                                m["name"]).is_file()
    for w in b["workloads"]:
        reported = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _digest(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_config_mix_and_metric_are_found_by_name_from_new_files(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric by adding files and entries only."""
    pkg = tmp_path / "portbench"
    shutil.copytree(PACKAGE, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(pkg)
    b = _bench()
    cfg = json.loads((PACKAGE / "configs" / "scacopf-b256.json").read_text())
    cfg.update(name="scacopf-b128", n_bus=128)
    (pkg / "configs" / "scacopf-b128.json").write_text(json.dumps(cfg))
    mix = json.loads((PACKAGE / "traffic" / "screen32.json").read_text())
    mix.update(lanes=8, loads=[0.9, 1.1])
    (pkg / "traffic" / "screen8.json").write_text(json.dumps(mix))
    (pkg / "limits" / "scacopf-b128.screen8.json").write_text(
        json.dumps({"limits": {"feas": 1e-6, "stat": 1e-2, "comp": 1e-4, "obj_gap": 1e-9}}))
    (pkg / "metrics" / "answers_per_request.screen8.py").write_text(
        "def read(trace):\n    return sum(r.answers for r in trace.requests) / len(trace.requests)\n")
    b["configs"].append({"name": "scacopf-b128", "source": "https://github.com/LLNL/hiop",
                         "file": "portbench/configs/scacopf-b128.json", "reduced": ["n_bus"],
                         "why": "a smaller grid"})
    b["workloads"].append({"name": "scacopf-b128.screen8", "config": "scacopf-b128",
                           "traffic": "screen8", "chips": 1, "why": "families of 8, wider loads"})
    next(m for m in b["end_to_end"] if m["name"] == "screen_rate")["workloads"].append(
        "scacopf-b128.screen8")
    b["per_layer"].append({"name": "answers_per_request.screen8", "unit": "answers",
                           "better": "higher", "source": "program_counter", "layer": "outer loop",
                           "moves": "screen_rate", "workloads": ["scacopf-b128.screen8"]})
    # a metric of a reader that is there already: an entry, no file
    b["per_layer"].append({"name": "iters.screen8", "unit": "trips",
                           "better": "lower", "source": "program_counter", "layer": "outer loop",
                           "moves": "screen_rate", "workloads": ["scacopf-b128.screen8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.load_cell("scacopf-b128.screen8", root=tmp_path, package=pkg)
    assert cell.config["n_bus"] == 128 and cell.traffic["lanes"] == 8
    assert [m.name for m in cell.end_to_end] == ["setup_s", "screen_rate"]
    assert [m.name for m in cell.per_layer] == ["answers_per_request.screen8", "iters.screen8"]
    trace = probe.Trace([probe.RequestTrace(90, 8, 0, Counter(), [])], 1.0, 0.5, {}, {})
    assert [m.reader.read(trace) for m in cell.per_layer] == [8.0, 90.0]
    assert cell.limits == {"feas": 1e-6, "stat": 1e-2, "comp": 1e-4, "obj_gap": 1e-9}
    # every file that was there is as it was
    after = _digest(pkg)
    assert {k: after[k] for k in before} == before
    # and the cell that was there still loads as before: its first metrics
    # as the benchmark began with them, any later ones after them
    old = spec.load_cell("scacopf-b256.screen32", root=tmp_path, package=pkg)
    assert [m.name for m in old.per_layer][:5] == [
        "iters.screen", "fact_per_iter.screen", "reads_per_iter.screen",
        "ldl_roofline.screen", "idle_share.screen"]
    assert [m.name for m in old.per_layer] == [
        m["name"] for m in _bench()["per_layer"] if "scacopf-b256.screen32" in m["workloads"]]


def test_a_configuration_that_is_no_grid_brings_its_own_stream_in_new_files(tmp_path):
    """A configuration that is not an ACOPF grid (the dense example at
    n = 40) comes with an entry that makes its own requests, its
    reference, its limits and a reader, all in new files; the harness takes
    its requests from that entry, and nothing that was there changes."""
    pkg = tmp_path / "portbench"
    shutil.copytree(PACKAGE, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(pkg)
    b = _bench()
    cfg = json.loads((PACKAGE / "configs" / "dense-ex2-n20k.json").read_text())
    cfg.update(name="dense-ex2-n40", n=40, logical_n={"K": 40}, reference="dense_ex2_n40")
    (pkg / "configs" / "dense-ex2-n40.json").write_text(json.dumps(cfg))
    # a new entry and a new reference: copies under names of their own
    (pkg / "entries" / "dense_solve_n40.py").write_text(
        (PACKAGE / "entries" / "dense_solve.py").read_text())
    (pkg / "reference" / "dense_ex2_n40.py").write_text(
        (PACKAGE / "reference" / "dense_ex2.py").read_text())
    (pkg / "traffic" / "solve1-n40.json").write_text(json.dumps(
        {"entry": "dense_solve_n40", "factor_kernel": "cholesky", "warmup": [{"max_iter": 2}]}))
    (pkg / "limits" / "dense-ex2-n40.solve1-n40.json").write_text(
        json.dumps({"limits": {"feas": 1e-6, "stat": 1e-7, "comp": 1e-7, "obj_gap": 1e-11}}))
    (pkg / "metrics" / "answers_per_request.n40.py").write_text(
        "def read(trace):\n    return sum(r.answers for r in trace.requests) / len(trace.requests)\n")
    b["configs"].append({"name": "dense-ex2-n40", "source": "https://github.com/LLNL/hiop",
                         "file": "portbench/configs/dense-ex2-n40.json", "reduced": ["n"],
                         "why": "a small dense problem"})
    b["workloads"].append({"name": "dense-ex2-n40.solve1-n40", "config": "dense-ex2-n40",
                           "traffic": "solve1-n40", "chips": 1, "why": "one solve a request"})
    next(m for m in b["end_to_end"] if m["name"] == "solve_s")["workloads"].append(
        "dense-ex2-n40.solve1-n40")
    b["per_layer"].append({"name": "answers_per_request.n40", "unit": "answers",
                           "better": "higher", "source": "program_counter", "layer": "outer loop",
                           "moves": "solve_s", "workloads": ["dense-ex2-n40.solve1-n40"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.load_cell("dense-ex2-n40.solve1-n40", root=tmp_path, package=pkg)
    assert [m.name for m in cell.end_to_end] == ["setup_s", "solve_s"]
    assert [m.name for m in cell.per_layer] == ["answers_per_request.n40"]
    assert run.stream(cell) is cell.entry and cell.entry.__file__.endswith("dense_solve_n40.py")
    grid = cell.entry.grid(cell.config, cell.reference)
    assert grid == {"n": 40}
    first = next(run.stream(cell).requests(cell.traffic, grid, cell.reference, 1414213562))
    served = cell.entry.serve(cell.config, first, "cpu")
    found = judge.numbers(judge.host_answers(served.answers), grid, cell.reference)
    assert judge.verdict(found, cell.limits, complete=True)[0], found
    after = _digest(pkg)
    assert {k: after[k] for k in before} == before


def _bound_ms(n, dtype, batch):
    peaks = json.loads((PACKAGE / "peaks.json").read_text())
    item = {"float64": 8, "float32": 4}[dtype]
    return batch * max(n ** 3 / 3 / peaks["flops"][dtype], 2 * n * n * item / peaks["bytes_per_s"]) * 1e3


@pytest.mark.parametrize("cell,metric,wrapper,key,n,padded,batch", [
    ("scacopf-b256.screen32", "ldl_roofline.screen", "ldl_nopiv_batched", "saddle", 2355, 2432, 32),
    ("dense-ex2-newton-n20k.solve", "chol_roofline.solve", "cholesky", "K", 20000, 20000, 1),
])
def test_a_roofline_counts_the_logical_order_not_the_padded_one(cell, metric, wrapper, key, n,
                                                                padded, batch):
    """The wrapper records the order it launched at (the LDL^T pads the
    saddle, 2355 to 2432; the Cholesky factors K as it is); the work is that
    of the matrix the caller factors. Launches at a smaller order (another
    matrix: the dense KKT's small Schur complement) are left out."""
    c = spec.load_cell(cell, root=ROOT)
    assert c.config["logical_n"][key] == n and c.traffic["factor_kernel"] == wrapper
    reader = next(m for m in c.per_layer if m.name == metric).reader
    ev = [(wrapper, padded, "float32", batch, 2.0), (wrapper, padded, "float64", batch, 1.5),
          (wrapper, 4, "float64", batch, 0.2),          # another order: not the factored matrix
          ("another_kernel", padded, "float64", batch, 9.0)]
    trace = probe.Trace([probe.RequestTrace(10, batch, 0, Counter(), ev)], 1.0, 0.5,
                        c.config["logical_n"], json.loads((PACKAGE / "peaks.json").read_text()),
                        c.traffic)
    want = 100 * (_bound_ms(n, "float32", batch) + _bound_ms(n, "float64", batch)) / 3.5
    assert reader.read(trace) == pytest.approx(want, rel=1e-12)
    if padded > n:
        as_padded = 100 * (_bound_ms(padded, "float32", batch) + _bound_ms(padded, "float64", batch)) / 3.5
        assert reader.read(trace) < as_padded
    work = spec.load_module(PACKAGE / "work" / f"{wrapper.removesuffix('_batched')}.py")
    assert work.flops(n) == n ** 3 / 3 and work.bytes_moved(n, 4) == 2 * n ** 2 * 4


@pytest.mark.parametrize("cell", ["scacopf-b256.screen32", "dense-ex2-newton-n20k.solve"])
def test_every_reader_finds_nothing_in_an_empty_trace(cell):
    """A reader that finds nothing returns nothing (never a 0 share)."""
    c = spec.load_cell(cell, root=ROOT)
    empty = probe.Trace([], 0.0, 0.0, c.config["logical_n"], {}, c.traffic)
    assert all(m.reader.read(empty) is None for m in c.per_layer)


#: sha256 of the first 4 requests of the screening cell's stream (each
#: request's p_load bytes, its lane order, its index and snapshot), as the
#: stream was before entries could own theirs; and of its warm-up request
_SCREEN_STREAM = {
    (20260, False): "5a469ffcc5405c856bb5586d2e07a6b0149b610f341a88a2c72fd1222d917ad2",
    (1414213562, False): "2c51677e0d2f11c0a516043e11dba125542358eb409bba87eb1d380835d0cc66",
    (1618033988, False): "b68f6b8652456a28c1a2b2c6ef9d9199fc52bbd33398c8b339c8858c01fbbaa2",
    (20260, True): "8105b32a7b4ef5808b20a6e6a20d29875d7654f1a2d6702e29b7a2e63d4bc5d5",
    (1414213562, True): "183369b16bafc5a0acfda61710d0d3c8e55a5c679736d764067c729a21cb3412",
    (1618033988, True): "09d64cffb63b6b09ff68732feefe49545ea02cfa8e4b6ab8db42939135f61429",
}
_SCREEN_WARMUP = "3c2a9615ac03d7797c610daaf305597fb0808c6b1e28f872c1cbc18d0cc0f9d6"


def _request_digest(h, req):
    h.update(req.p_load.tobytes())
    h.update(json.dumps([int(k) for k in req.lines]).encode())


@pytest.mark.parametrize("seed,fresh", sorted(_SCREEN_STREAM))
def test_the_screening_stream_is_what_it_was(monkeypatch, seed, fresh):
    """The route that run.py and calibrate.py take (``run.prepare``,
    ``run.stream``) gives the screening cell the same requests and warm-up
    as the grid-snapshot generator always has, in both modes."""
    import argparse
    import itertools

    monkeypatch.chdir(ROOT)
    args = argparse.Namespace(workload="scacopf-b256.screen32", set=[], rehearse=True)
    cell, _, grid = run.prepare(args)
    source = run.stream(cell)
    assert source is traffic
    h = hashlib.sha256()
    for req in itertools.islice(source.requests(cell.traffic, grid, cell.reference, seed,
                                                fresh=fresh), 4):
        _request_digest(h, req)
        h.update(json.dumps([req.index, req.snapshot]).encode())
    assert h.hexdigest() == _SCREEN_STREAM[(seed, fresh)]
    h = hashlib.sha256()
    _request_digest(h, source.warmup(cell.traffic, grid, cell.reference))
    assert h.hexdigest() == _SCREEN_WARMUP


def test_union_and_idle_gaps():
    import numpy as np

    iv = np.array([[0, 10], [5, 20], [30, 40], [35, 36]], dtype=np.int64)
    assert probe.union_seconds(iv) == pytest.approx(30e-9)
    gaps = probe._idle_gaps(iv, [(18, 34, "aten::item"), (0, 100, "request")], 0, 50, 10)
    assert gaps[0][0] == "aten::item" and gaps[0][1] == pytest.approx(10e-9)
    assert ["request", pytest.approx(10e-9)] in gaps


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


def test_nothing_imports_jax_and_the_reference_imports_nothing_of_the_program():
    files = [p for p in PACKAGE.rglob("*.py") if "__pycache__" not in p.parts]
    assert len(files) > 20
    for p in files:
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & FORBIDDEN, (p, tops & FORBIDDEN)
    for p in (PACKAGE / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(p)}
        assert tops <= {"__future__", "numpy"}, (p, tops)
    # compared whole: the port's name begins with the JAX package's
    assert "hiop_tpu_torch" not in FORBIDDEN and "hiop_tpu" in FORBIDDEN
