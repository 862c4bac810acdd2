"""HiOp's nonconvex MDS example 2 through the port's main path against the
JAX package, on the CPU, in f64.

``FilterIPMNewton`` over ``NlpMDS`` with the test-3 options of HiOp's example
(``duals_update_type=linear``, mu0 = 0.1): the indefinite dense block keeps
the quick tier's Cholesky regularized, so the chronic escalation and the
safe ladder run. Full-rank and rank-deficient (duplicated equality block,
two dependent inequality rows), at ns = 40, nd = 10: below the JAX
package's own cases (400/100 and 48/12, ``tests/slow_tests.txt``). The
standard: the same status, the same iteration count, the objective to 1e-8
relative, and the same factorization slots in the same order. The saved
objective at 400/100 is checked on the card (``chip_smoke.py`` phase 20).
"""

import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import scipy.sparse.linalg  # noqa: F401
import torch
from threadpoolctl import threadpool_limits

import examples.mds_ex2 as jax_ex2
import hiop_tpu.optimization.filter_ipm as jfi
import hiop_tpu_torch.optimization.filter_ipm as tfi
from hiop_tpu_torch.examples import mds_ex2

# The matrices here are small: torch's intra-op thread pool costs more than it
# gains, and its spinning threads slow the other test workers.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One OpenBLAS thread for numpy/scipy inside these tests: the host
    LU/eigen and SuperLU tiers factorize small matrices, and under six
    pytest-xdist workers on an 8-core CPU OpenBLAS's spinning threads made
    the AcopfSparse test 40x slower (1134 s against 28 s). Only this
    module's tests run under the limit; it is lifted after each."""
    with threadpool_limits(limits=1):
        yield


def _slots(fi, solve, **opts):
    slots = []
    S = fi._MdsStrategy
    factorize = S._factorize

    def tagged(self):
        slots.append(self._safe_tiers[self._safe_mode - 1] if self._safe_mode else "quick")
        return factorize(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "_factorize", tagged)
        r = solve(40, 10, verbosity_level=0, **opts)
    return r, slots


@pytest.mark.parametrize("rank_deficient", [False, True], ids=["full_rank", "rank_deficient"])
def test_mds_ex2_matches_jax(rank_deficient):
    kw = dict(rankdefic_eq=True, rankdefic_ineq=True) if rank_deficient else {}
    rj, sj = _slots(jfi, jax_ex2.solve, **kw)
    rt, st = _slots(tfi, mds_ex2.solve, compute_mode="cpu", **kw)
    assert rt.status.is_success
    assert rt.status.name == rj.status.name
    assert rt.iterations == rj.iterations
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))
    assert st == sj
    assert any(s != "quick" for s in st)   # the nonconvex block reaches the safe ladder
