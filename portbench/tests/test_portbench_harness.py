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

from portbench import probe, spec
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
    b["end_to_end"][1]["workloads"].append("scacopf-b128.screen8")
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
    # and the cell that was there still loads as before
    old = spec.load_cell("scacopf-b256.screen32", root=tmp_path, package=pkg)
    assert [m.name for m in old.per_layer] == [
        "iters.screen", "fact_per_iter.screen", "reads_per_iter.screen",
        "ldl_roofline.screen", "idle_share.screen"]


def _ldl_bound_ms(n, dtype):
    peaks = json.loads((PACKAGE / "peaks.json").read_text())
    item = {"float64": 8, "float32": 4}[dtype]
    return max(n ** 3 / 3 / peaks["flops"][dtype], 2 * n * n * item / peaks["bytes_per_s"]) * 1e3


@pytest.mark.parametrize("cell,wrapper,batch", [
    ("scacopf-b256.screen32", "ldl_nopiv_batched", 32),
])
def test_ldl_roofline_counts_the_logical_order_not_the_padded_one(cell, wrapper, batch):
    """The wrapper records the padded order (2432); the work is that of
    the saddle the caller factors (2355)."""
    c = spec.load_cell(cell, root=ROOT)
    assert c.config["logical_n"]["saddle"] == 2355
    metric = next(m for m in c.per_layer if m.name.startswith("ldl_roofline"))
    ev = [(wrapper, 2432, "float32", batch, 2.0), (wrapper, 2432, "float64", batch, 1.5),
          (wrapper, 384, "float64", batch, 0.2)]       # another order: not the saddle's
    trace = probe.Trace([probe.RequestTrace(10, batch, 0, Counter(), ev)], 1.0, 0.5,
                        c.config["logical_n"], json.loads((PACKAGE / "peaks.json").read_text()),
                        c.traffic)
    assert c.traffic["factor_kernel"] == wrapper
    want = 100 * batch * (_ldl_bound_ms(2355, "float32") + _ldl_bound_ms(2355, "float64")) / 3.5
    assert metric.reader.read(trace) == pytest.approx(want, rel=1e-12)
    padded = 100 * batch * (_ldl_bound_ms(2432, "float32") + _ldl_bound_ms(2432, "float64")) / 3.5
    assert metric.reader.read(trace) < padded
    work = spec.load_module(PACKAGE / "work" / "ldl_nopiv.py")
    assert work.flops(2355) == 2355 ** 3 / 3 and work.bytes_moved(2355, 4) == 2 * 2355 ** 2 * 4
    chol = spec.load_module(PACKAGE / "work" / "cholesky.py")
    assert chol.flops(10000) == 10000 ** 3 / 3


def test_every_reader_finds_nothing_in_an_empty_trace():
    """A reader that finds nothing returns nothing (never a 0 share)."""
    for cell in ("scacopf-b256.screen32",):
        c = spec.load_cell(cell, root=ROOT)
        empty = probe.Trace([], 0.0, 0.0, c.config["logical_n"], {})
        assert all(m.reader.read(empty) is None for m in c.per_layer)


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
