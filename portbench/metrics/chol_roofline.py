"""chol_roofline.<cell kind>: the Cholesky kernel's share of its roofline
(%) over the traced window's launches of the wrapper that the traffic mix
names (``factor_kernel``: ``cholesky``) that factor the dense KKT matrix K
(:func:`portbench.roofline.share`).

Each launch's bound is that of one matrix at K's logical order (``K`` in
the configuration): n^3/3 operations at the dtype's peak against the input
read and the factor written once at the memory's (``work/cholesky.py``,
``peaks.json``); the time is the launch's CUDA events. The launches that
factor K are those at the largest order recorded (the wrapper does not
pad, so that is K's own); the small Schur complements that the same
wrapper factors are left out."""

from portbench import roofline

WORK = roofline.work("cholesky")


def read(trace):
    return roofline.share(trace, WORK, "K")
