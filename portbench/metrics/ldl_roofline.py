"""ldl_roofline.<cell kind>: the no-pivot LDL^T's share of its roofline (%)
over the traced window's launches of the wrapper that the traffic mix
names (``factor_kernel``) that factor the KKT saddle
(:func:`portbench.roofline.share`).

Each launch's bound is its batch (1 for a single solve) times that of one
matrix at the saddle's logical order (``saddle`` in the configuration),
the larger of its operations at the dtype's peak and its bytes at the
memory's (``work/ldl_nopiv.py``, ``peaks.json``); the time is the launch's
CUDA events. The launches that factor the saddle are those at the largest
order recorded, which is the saddle's padded order."""

from portbench import roofline

WORK = roofline.work("ldl_nopiv")


def read(trace):
    return roofline.share(trace, WORK, "saddle")
