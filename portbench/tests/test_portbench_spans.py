"""The readers of the program's spans (``metrics/`` over ``spans.py``) on a
synthetic recorder, on the CPU.

    python -m pytest portbench/tests/test_portbench_spans.py -q
"""

from __future__ import annotations

from collections import Counter

import pytest

from portbench import probe, spec

pytest.importorskip("hiop_tpu_torch.utils.trace")
from hiop_tpu_torch.utils import trace as T  # noqa: E402

CELL = "scacopf-b256.screen32"
NEW = ("ladder_per_iter.screen", "ls_rounds_per_iter.screen", "lane_occupancy.screen",
       "nlp_host_ms.screen", "kkt_host_ms.screen", "read_wait_ms.screen")
MS = 1_000_000


def _span(rec, name, parent, family, start, end, **attrs):
    s = T.Span(rec, name, rec._next, None if parent is None else parent.id,
               family if family is not None else rec._next)
    rec._next += 1
    s.start, s.end = start, end
    s.attrs.update(attrs)
    rec.spans.append(s)
    return s


def _family(rec, t0, S, counts):
    """A family of two trips: in each, a residual with one hook call (3 ms),
    a factorization phase with kkt.factor (4 ms, 1 ms of it a read) and a
    read (2 ms); an update (1 ms)."""
    fam = _span(rec, "batch.family", None, None, t0, t0 + 40 * MS, S=S, **counts)
    f = fam.id
    for k in range(2):
        a = t0 + k * 20 * MS
        trip = _span(rec, "batch.trip", fam, f, a, a + 20 * MS, index=k, live=S)
        res = _span(rec, "batch.residual", trip, f, a, a + 5 * MS)
        _span(rec, "nlp.eval_hess_blocks", res, f, a, a + 3 * MS)
        fac = _span(rec, "batch.factor", trip, f, a + 5 * MS, a + 15 * MS)
        kf = _span(rec, "kkt.factor", fac, f, a + 5 * MS, a + 9 * MS)
        _span(rec, "host.read", kf, f, a + 8 * MS, a + 9 * MS)
        _span(rec, "host.read", fac, f, a + 10 * MS, a + 12 * MS)
        _span(rec, "batch.update", trip, f, a + 15 * MS, a + 16 * MS)
    return fam


COUNTS = dict(trips=4, reads=20, lanes_live=10, ladder_trips=6, ladder_lanes=3,
              soc_trips=2, soc_lanes=2, bt_trips=8, bt_lanes=9)


@pytest.fixture
def recorder(monkeypatch):
    rec = T.Recorder()
    monkeypatch.setattr(T, "recorder", rec)
    return rec


def _read(requests):
    c = spec.load_cell(CELL)
    trace = probe.Trace([probe.RequestTrace(4, 8, 0, Counter(), [])] * requests, 1.0, 0.5,
                        c.config["logical_n"], {})
    return {m.name: m.reader.read(trace) for m in c.per_layer if m.name in NEW}


def test_the_six_readers_read_the_last_families(recorder):
    # an earlier family (the warm-up's) is not the window's
    _family(recorder, 0, 8, dict(COUNTS, trips=99))
    _family(recorder, 100 * MS, 8, COUNTS)
    _span(recorder, "host.read", None, None, 150 * MS, 151 * MS)   # outside every family
    _family(recorder, 200 * MS, 4, COUNTS)
    got = _read(2)
    assert got["ladder_per_iter.screen"] == pytest.approx(12 / 8)
    assert got["ls_rounds_per_iter.screen"] == pytest.approx((4 + 16) / 8)
    lanes = 2 * (10 + 3 + 2 + 9)
    computed = (8 + 4) * (4 + 6 + 2 + 8)
    assert got["lane_occupancy.screen"] == pytest.approx(100 * lanes / computed)
    # 2 families x 2 trips x (3 ms of hooks, 3 of kkt.factor's own, 3 of reads), over 8 trips
    assert got["nlp_host_ms.screen"] == pytest.approx(4 * 3 / 8)
    assert got["kkt_host_ms.screen"] == pytest.approx(4 * 3 / 8)
    assert got["read_wait_ms.screen"] == pytest.approx(4 * 3 / 8)


def test_the_readers_find_nothing_without_whole_families(recorder):
    assert all(v is None for v in _read(1).values())           # no spans
    _family(recorder, 0, 8, COUNTS)
    assert all(v is None for v in _read(2).values())           # fewer families than requests
    assert all(v is not None for v in _read(1).values())
    recorder.dropped = 1
    assert all(v is None for v in _read(1).values())           # a span was dropped
    assert all(v is None for v in _read(0).values())


def test_a_full_recorder_counts_what_it_drops():
    rec = T.Recorder(capacity=2)
    rec.on = True
    with rec.span("batch.family", True) as fam:
        with rec.span("batch.trip") as trip, rec.span("batch.residual") as res:
            assert res is T.NOOP
    assert rec.dropped == 1 and [s.name for s in rec.spans] == ["batch.family", "batch.trip"]
    assert trip.parent == fam.id and trip.family == fam.id and fam.family == fam.id
    rec.on = False
    assert rec.span("batch.family", True) is T.NOOP and len(rec.spans) == 2
