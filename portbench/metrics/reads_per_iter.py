"""reads_per_iter.<cell kind>: host reads of device values (``item``,
``tolist``, ``bool``/``float``/``int``, ``cpu`` of a CUDA tensor) per
outer iteration (a family: per trip of its lockstep loop), over the
traced window."""


def read(trace):
    its = sum(r.iterations for r in trace.requests)
    if not its:
        return None
    return sum(r.reads for r in trace.requests) / its
