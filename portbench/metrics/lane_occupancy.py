"""lane_occupancy.<cell kind>: the share (%) of the lanes computed in
lockstep whose test held, over the traced window: every trip, ladder, SOC
and backtracking round computes all S lanes of its family, and the
``batch.family`` spans count the lanes live in each (``lanes_live``,
``ladder_lanes``, ``soc_lanes``, ``bt_lanes``)."""

from portbench import spans

ROUNDS = ("trips", "ladder_trips", "soc_trips", "bt_trips")
LANES = ("lanes_live", "ladder_lanes", "soc_lanes", "bt_lanes")


def read(trace):
    fams = spans.families(trace)
    if not fams:
        return None
    computed = sum(f.attrs["S"] * sum(f.attrs[k] for k in ROUNDS) for f, _ in fams)
    if not computed:
        return None
    return 100.0 * sum(spans.total(fams, k) for k in LANES) / computed
