"""fact_per_iter.<cell kind>: launches of the factorization's wrapper that
the traffic mix names (``factor_kernel``: ``ldl_nopiv`` for a single
solve, ``ldl_nopiv_batched`` for a family, where one batched launch counts
once), every dtype, per outer iteration (a family: per trip), over the
traced window."""


def read(trace):
    its = sum(r.iterations for r in trace.requests)
    if not its:
        return None
    kernel = trace.mix["factor_kernel"]
    return sum(r.launches.get(kernel, 0) for r in trace.requests) / its
