"""ls_rounds_per_iter.<cell kind>: line-search rounds after the first
trial (second-order corrections and backtracking trials) per trip of a
family's lockstep loop, over the traced window: the ``batch.family``
spans' ``soc_trips + bt_trips`` over their ``trips``. Each round evaluates
every lane."""

from portbench import spans


def read(trace):
    fams = spans.families(trace)
    if not fams or not spans.total(fams, "trips"):
        return None
    rounds = spans.total(fams, "soc_trips") + spans.total(fams, "bt_trips")
    return rounds / spans.total(fams, "trips")
