"""nlp_host_ms.<cell kind>: the host's milliseconds inside the NLP's
vmapped evaluation hooks (``nlp.*`` spans: launching the lanes' function,
constraint, Jacobian and Hessian evaluations) per trip of a family's
lockstep loop, over the traced window."""

from portbench import spans


def read(trace):
    fams = spans.families(trace)
    if not fams:
        return None
    ns = 0
    for _, under in fams:
        nlp = {s.id for s in under if s.name.startswith("nlp.")}
        ns += sum(s.duration for s in under if s.id in nlp and s.parent not in nlp)
    return spans.per_trip_ms(fams, ns)
