"""kkt_host_ms.<cell kind>: the host's milliseconds in the KKT strategy's
own code (``kkt.factor`` and ``kkt.solve`` spans, less the spans under
them, such as a host read) per trip of a family's lockstep loop, over the
traced window."""

from portbench import spans


def read(trace):
    fams = spans.families(trace)
    if not fams:
        return None
    from hiop_tpu_torch.utils.trace import self_ns

    ns = 0
    for _, under in fams:
        kids: dict = {}
        for s in under:
            kids.setdefault(s.parent, []).append(s)
        ns += sum(self_ns(s, kids.get(s.id, [])) for s in under if s.name.startswith("kkt."))
    return spans.per_trip_ms(fams, ns)
