"""read_wait_ms.<cell kind>: the host's milliseconds inside its reads of
device values (``host.read`` spans: the host waiting for the card to reach
the value and copy it back) per trip of a family's lockstep loop, over the
traced window."""

from portbench import spans


def read(trace):
    fams = spans.families(trace)
    if not fams:
        return None
    ns = sum(s.duration for _, under in fams for s in under if s.name == "host.read")
    return spans.per_trip_ms(fams, ns)
