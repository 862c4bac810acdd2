"""ladder_per_iter.<cell kind>: refactorizations of the regularization
ladder (the inertia correction) per trip of a family's lockstep loop, over
the traced window: the ``batch.family`` spans' ``ladder_trips`` over their
``trips``. Each is one more batched factorization of all S lanes."""

from portbench import spans


def read(trace):
    fams = spans.families(trace)
    if not fams or not spans.total(fams, "trips"):
        return None
    return spans.total(fams, "ladder_trips") / spans.total(fams, "trips")
