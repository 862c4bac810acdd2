"""iters.<cell kind>: outer iterations per request, averaged over the
traced window's requests: a solve's iterations (``iters.solve``), or the
trips of a family's lockstep loop, which runs while any lane runs
(``iters.screen``)."""


def read(trace):
    if not trace.requests:
        return None
    return sum(r.iterations for r in trace.requests) / len(trace.requests)
