"""The program's own spans over the traced window, for the readers of
``metrics/`` whose source is the program (``program_span``,
``program_counter`` from a span's attributes).

The port records them in :data:`hiop_tpu_torch.utils.trace.recorder`
while ``kernels.stats.timing`` is set, which :class:`probe.KernelLog` does
for the window. A family of batched solves is one ``batch.family`` span
that carries the family's ``BatchStats`` (``trips``, ``ladder_trips``, ...)
and its lanes ``S``; every span under it holds its id as ``family``.
"""

from __future__ import annotations


def families(trace):
    """[(family span, [the spans under it])] of the window's requests: the
    recorder's last ``len(trace.requests)`` ``batch.family`` spans. None
    where the program records no spans (no recorder, fewer families than
    requests), or where it dropped any."""
    n = len(trace.requests)
    if not n:
        return None
    try:
        from hiop_tpu_torch.utils.trace import recorder
    except ImportError:
        return None
    if recorder.dropped:
        return None
    fams = [s for s in recorder.spans if s.name == "batch.family" and s.end is not None]
    if len(fams) < n:
        return None
    fams = fams[-n:]
    under = {f.id: [] for f in fams}
    for s in recorder.spans:
        if s.family in under and s.id != s.family:
            under[s.family].append(s)
    return [(f, under[f.id]) for f in fams]


def total(fams, key: str) -> int:
    """A family counter summed over the window."""
    return sum(f.attrs[key] for f, _ in fams)


def per_trip_ms(fams, ns: int):
    """``ns`` nanoseconds over the window's trips, in milliseconds."""
    trips = total(fams, "trips")
    return ns / 1e6 / trips if trips else None
