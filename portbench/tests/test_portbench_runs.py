"""Each cell end to end in rehearsal (on the CPU: screening at B=16 and a
family of 4, the dense solve at n = 40), the lower-precision control, and
a run with the timed path broken underneath: each must come out not
correct.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import pytest
import torch

from portbench import calibrate, faults, judge, run, spec

ROOT = Path(__file__).resolve().parents[2]
SMALL = {
    "scacopf-b256.screen32": ["--set", "n_bus=16", "--set", "lanes=4",
                              "--set", 'logical_n={"saddle": 195}'],
    "dense-ex2-newton-n20k.solve": ["--set", "n=40", "--set", 'logical_n={"K": 40}'],
}
#: answers of one request in rehearsal: a family's lanes, or one solve
ANSWERS = {"scacopf-b256.screen32": 4, "dense-ex2-newton-n20k.solve": 1}


@pytest.fixture(autouse=True)
def _small_and_here(monkeypatch):
    monkeypatch.chdir(ROOT)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(capsys, cell, seed=20260, seconds=0.0):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", "0", "--rehearse", *SMALL[cell]])
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_rehearsal_runs_the_mix_and_the_reference_agrees(capsys, cell):
    rc, res, err = _run(capsys, cell, seed=2 ** 31 + 12345)
    assert rc == 0 and res["correct"] is True, err
    assert res["attempted"] == ANSWERS[cell]
    assert res["attempted"] - res["failed"] >= 1
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "checks"
    checks = res["checks"]
    assert set(checks) == {"feas", "stat", "comp", "obj_gap"}
    assert all(c["value"] <= c["limit"] for c in checks.values())
    tail = err.strip().splitlines()[-4:]
    assert [t.split()[:2] for t in tail] == [["check", k] for k in checks]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_reference_refuses_answers_computed_in_float32(capsys, cell):
    """The control: the answers rounded to float32 (the best a float32
    computation could hand back) fail a limit."""
    rc = calibrate.main(["--workload", cell, "--seeds", "5", "--rehearse", *SMALL[cell]])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    summary = json.loads(out[-1])
    limits = json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())["limits"]
    sound_ok, _ = judge.verdict(summary["lower"], limits, complete=True)
    control_ok, rows = judge.verdict(summary["upper"], limits, complete=True)
    assert sound_ok and not control_ok, rows


def _entry(cell):
    return spec.load_cell(cell, root=ROOT).entry


@pytest.mark.parametrize("cell,fault", [
    ("scacopf-b256.screen32", "unchanged"),
    ("scacopf-b256.screen32", "half"),
    ("scacopf-b256.screen32", "altered_lane"),
    ("scacopf-b256.screen32", "cost_gradient"),
    ("dense-ex2-newton-n20k.solve", "unchanged"),
    ("dense-ex2-newton-n20k.solve", "altered"),
    ("dense-ex2-newton-n20k.solve", "grad_f"),
])
def test_a_run_with_the_timed_path_broken_is_not_correct(capsys, cell, fault):
    with faults.plant(fault, _entry(cell)):
        rc, res, err = _run(capsys, cell)
    assert rc == 0 and res["correct"] is False, err
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", ["scacopf-b256.screen32"])
def test_a_feasible_dispatch_that_is_not_optimal_fails_on_comp_alone(capsys, cell):
    """A wrong cost gradient for the generators: every lane's answer is feasible,
    stationary in the variables without bounds and reports its own
    objective, so only the bounded variables' complementarity tells."""
    with faults.plant("cost_gradient=0.001"):
        rc, res, err = _run(capsys, cell)
    assert rc == 0 and res["correct"] is False, err
    failed = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert failed == {"comp"}, res["checks"]


@pytest.mark.parametrize("fault,fails", [("grad_f=0.01", "stat"), ("grad_f=-0.01@3", "comp")])
def test_a_dense_solve_that_is_not_optimal_fails_on_one_number_alone(capsys, fault, fails):
    """The 1 % gradient error: the solve ends feasible and reports the
    objective of its point. At the free x_1 only the residual there tells
    (stat); at x_4, bounded below and not active, only the multiplier that
    its bound would need does (comp)."""
    cell = "dense-ex2-newton-n20k.solve"
    with faults.plant(fault, _entry(cell)):
        rc, res, err = _run(capsys, cell)
    assert rc == 0 and res["correct"] is False, err
    failed = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert failed == {fails}, res["checks"]


def test_a_run_that_holds_jax_prints_no_result(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, res, err = _run(capsys, "scacopf-b256.screen32")
    assert rc != 0 and res is None and "jax" in err


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "scacopf-b256.screen32", "--seed", "1", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "no CUDA device" in err


@pytest.mark.gpu
def test_on_the_card_one_short_run_of_each_cell_is_correct(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in sorted(SMALL):
        rc = run.main(["--workload", cell, "--seed", "77", "--seconds", "1", "--trace", "0"])
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and res["correct"] is True
        assert res["device"]["platform"] == "gpu" and "setup_s" in res["metrics"]
