"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. :func:`load_cell` gathers what one run of the cell needs: the
configuration's file, the traffic mix's file, the cell's limits, the
metrics that the cell reports, the modules that read them, the entry that
the mix names and the reference that the configuration names. Adding a
cell, a configuration, a traffic mix or a metric adds files and entries;
no file here changes. That holds for a configuration of any kind: one
that is an ACOPF grid takes its requests from :mod:`portbench.traffic`'s
grid snapshots, and one that is not brings an entry that makes its own
requests (``warmup`` and ``requests``, as ``entries/dense_solve.py``
does; ``run.stream`` chooses), and a reference with the same
``certificate`` call.

A metric's reader is ``<folder>/<name>.py``, or where there is none, the
reader of its stem, the name up to its first dot: ``ldl_roofline.solve``
and ``ldl_roofline.screen`` share ``metrics/ldl_roofline.py``, which takes
what differs between cells from the cell's files (the traffic mix's
``factor_kernel``, the configuration's ``logical_n``).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    reader: object          # the module with read(...)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration's file, as it is run
    traffic: dict           # the traffic mix's file
    limits: dict            # number -> limit
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    entry: object = None    # portbench/entries/<traffic["entry"]>.py
    reference: object = None  # portbench/reference/<config["reference"]>.py


def load_module(path: Path, name: str | None = None):
    """A module loaded from its file (metric names hold dots, so metric
    readers are loaded by path, not imported by name)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name or f"portbench._by_path.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(folder: Path, name: str) -> Path:
    """The file of the metric ``name``'s reader under ``folder``."""
    own = folder / f"{name}.py"
    return own if own.is_file() else folder / f"{name.split('.')[0]}.py"


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path | None = None, package: Path | None = None,
              overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, with every file it
    needs found under ``package`` (``portbench/`` by default).
    ``overrides`` replaces keys of the configuration and the traffic mix
    (rehearsals at a small size only)."""
    root = Path.cwd() if root is None else Path(root)
    package = PACKAGE if package is None else Path(package)
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    traffic = _read_json(package / "traffic" / f"{w['traffic']}.json")
    for k, v in (overrides or {}).items():
        if k in config:
            config[k] = v
        elif k in traffic:
            traffic[k] = v
        else:
            raise KeyError(f"override {k!r} is no key of the configuration or the traffic mix")
    limits = _read_json(package / "limits" / f"{name}.json")

    def metrics(entries, folder):
        return [Metric(m["name"], m["unit"], m["better"], m["source"],
                       load_module(reader_path(package / folder, m["name"])))
                for m in entries if _reports(m, name)]

    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        limits={k: float(v) for k, v in limits["limits"].items()},
        end_to_end=metrics(bench["end_to_end"], "e2e"),
        per_layer=metrics(bench["per_layer"], "metrics"),
        entry=load_module(package / "entries" / f"{traffic['entry']}.py"),
        reference=load_module(package / "reference" / f"{config['reference']}.py"),
    )
