"""The lane-batched solve of the port (``optimization/batch_solve``) against
the JAX package's ``solve_batched`` (``jax.vmap`` of the fused whole
solve), on the CPU in f64.

Families: the dense family of ``tests/test_batch_solve.py`` (n=6, 4
scenarios), MdsEx1 with a per-scenario objective shift (ns=40, nd=12, 3
shifts), and the ACOPF contingency family at B=8 and B=16 with 3 scenarios
(the basecase and two line outages; at B=16 one lane exits
Steplength_Too_Small at iteration 21 while the others run on to 46 and 42).

Per lane: the same status code and iterations as ``hiop_tpu``, the history
counters (``ls_count``, ``ls_status``, ``use_soc``, ``n_refact``,
``soc_rounds``) equal row by row, the objective to 1e-8 relative and x to
1e-6; and the same decisions as the scenario solved alone (S=1) in the
port. Where ``hiop_tpu`` itself is rounding-decided on a lane (its outcome
changes when its starting point is scaled by 1 + 1e-15, as ROADMAP.md
section 3 records), the lane is held to every decision until ``hiop_tpu``'s
own perturbed runs part from its unperturbed one or its constraint
violation reaches rounding level (1e-13), then to a status that either
package reaches under those perturbations, to the objective and to x.

Also: the batched plain factorizations against the single-matrix ones, one
batched factorization per loop trip, one host read per loop trip for the
whole batch, the reuse of the built solve, and the solver's spans (the
tree, the family's counters, nothing recorded and no bit changed when off,
self time, the Chrome export).

Every ``hiop_tpu`` reference runs once, in a module-scoped fixture.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch
from threadpoolctl import threadpool_limits

import examples.acopf_mds as j_acopf
import hiop_tpu
from examples.mds_ex1 import MdsEx1 as JMdsEx1
from hiop_tpu.optimization import batch_solve as jbs
from hiop_tpu_torch import NlpOptions
from hiop_tpu_torch.examples import acopf_mds
from hiop_tpu_torch.examples.mds_ex1 import MdsEx1
from hiop_tpu_torch.linalg import cholesky as tchol
from hiop_tpu_torch.linalg import ldl_blocked as tldl
from hiop_tpu_torch.optimization import batch_solve as tbs

# The matrices here are small: torch's intra-op thread pool costs more than it
# gains, and its spinning threads slow the other test workers.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One OpenBLAS thread for numpy/scipy inside these tests: under six
    pytest-xdist workers on an 8-core CPU, OpenBLAS's spinning threads starve
    each other (tests/test_torch_sparse_solve.py). Lifted after each test."""
    with threadpool_limits(limits=1):
        yield


#: the history columns held equal row by row
COUNTERS = [6, 7, 9, 12, 14]   # ls_count, ls_status, use_soc, n_refact, soc_rounds
#: the scaling of a family's starting point that tests for rounding
PERTURB = (1 + 1e-15,)
#: a constraint violation at rounding level
NOISE = 1e-13


def _parting_row(h_a, h_b, it_a, it_b):
    """The first history row whose decisions differ (or the shorter run's
    last row + 1 when every shared row agrees)."""
    last = min(int(it_a), int(it_b))
    for r in range(last + 1):
        if not np.array_equal(h_a[r, COUNTERS], h_b[r, COUNTERS]):
            return r
    return last + 1


def _jax_run(jp, th):
    (_, core), _mu, it, st, _err, hist = jbs.build_batched_solve(jp)(th)
    return dict(st=np.asarray(st), it=np.asarray(it), obj=np.asarray(core.f),
                x=np.asarray(core.it.x), hist=np.asarray(hist))


def _port_run(tp, th):
    batched = tbs.build_batched_solve(tp)
    (_, core), _mu, it, st, _err, hist = batched(th)
    return dict(st=st.numpy(), it=it.numpy(), obj=core.f.numpy(), x=core.it.x.numpy(),
                hist=hist.numpy(), stats=batched.stats)


def _jax_reference(make, th):
    """hiop_tpu's run and its runs with the starting point scaled by
    PERTURB (``make(s)`` builds the family with that scaling); a lane is
    rounding-decided where any of them ends with another status or
    iteration count."""
    ref = _jax_run(make(1.0), th)
    pert = [_jax_run(make(s), th) for s in PERTURB]
    ref["decided"] = [
        any(p["st"][k] != ref["st"][k] or p["it"][k] != ref["it"][k] for p in pert)
        for k in range(ref["st"].size)
    ]
    ref["statuses"] = [{int(ref["st"][k])} | {int(p["st"][k]) for p in pert}
                       for k in range(ref["st"].size)]
    ref["part"] = [min(_parting_row(ref["hist"][k], p["hist"][k], ref["it"][k], p["it"][k])
                       for p in pert) for k in range(ref["st"].size)]
    # the first row whose constraint violation is at rounding level: from
    # there the filter's and SOC's theta tests compare noise (ROADMAP.md
    # section 3, linear constraints)
    ref["noise"] = [int(np.argmax(np.append(ref["hist"][k, : ref["it"][k] + 1, 1] <= NOISE, True)))
                    for k in range(ref["st"].size)]
    return ref


def _assert_matches_jax(port, ref, port_perturbed=()):
    """``port_perturbed``: the port's runs with its starting point scaled by
    PERTURB, whose statuses also count as reachable on a lane that rounding
    decides."""
    for k in range(ref["st"].size):
        part = _parting_row(port["hist"][k], ref["hist"][k], port["it"][k], ref["it"][k])
        rel = abs(port["obj"][k] - ref["obj"][k]) / max(1.0, abs(ref["obj"][k]))
        assert rel < 1e-8, (k, port["obj"][k], ref["obj"][k])
        if ref["decided"][k]:
            # rounding decides this lane in hiop_tpu itself: every decision
            # up to where its own perturbed runs part or its theta reaches
            # rounding level, then a status it reaches under those
            # perturbations
            assert part >= min(ref["part"][k], ref["noise"][k]), (
                k, part, ref["part"][k], ref["noise"][k])
            reachable = ref["statuses"][k] | {int(p["st"][k]) for p in port_perturbed}
            assert int(port["st"][k]) in reachable, (k, port["st"][k], reachable)
            assert np.abs(port["x"][k] - ref["x"][k]).max() < 1e-6, k
            continue
        assert port["st"][k] == ref["st"][k] and port["it"][k] == ref["it"][k], (
            k, port["st"][k], port["it"][k], ref["st"][k], ref["it"][k])
        assert part == port["it"][k] + 1, (k, part)
        assert np.abs(port["x"][k] - ref["x"][k]).max() < 1e-6, k


def _assert_lanes_equal_alone(tp, th, port, lanes, take):
    """Each lane against the same scenario solved alone (S=1) in the port:
    the same decisions, status and iterations, the objective to 1e-9."""
    for k in lanes:
        one = _port_run(tp, take(th, k))
        part = _parting_row(port["hist"][k], one["hist"][0], port["it"][k], one["it"][0])
        assert part == port["it"][k] + 1, (k, part)
        assert one["st"][0] == port["st"][k] and one["it"][0] == port["it"][k], k
        assert abs(one["obj"][0] - port["obj"][k]) <= 1e-9 * max(1.0, abs(port["obj"][k])), k


# ---------------------------------------------------------------------------
# the batched plain factorizations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [5, 70, 300])
def test_batched_plain_factors_equal_single(n):
    """cholesky_plain_batched / ldl_nopiv_plain_batched repeat the
    single-matrix plain versions bit for bit on each matrix (the Cholesky's
    NaN fill included), ldl_factor_batched gives each matrix ldl_factor's
    n_neg and ok, and cholesky under torch.func.vmap is the batched one."""
    rng = np.random.default_rng(n)
    B = torch.from_numpy(rng.standard_normal((3, n, n)))
    A = B @ B.mT + n * torch.eye(n, dtype=torch.float64)
    A[1] = -A[1]
    Lb = tchol.cholesky_plain_batched(A)
    for s in range(3):
        assert torch.equal(Lb[s].nan_to_num(7.0), tchol.cholesky_plain(A[s]).nan_to_num(7.0))
    assert bool(torch.isnan(Lb[1].diagonal()).all())
    assert torch.equal(torch.func.vmap(tchol.cholesky)(A).nan_to_num(7.0), Lb.nan_to_num(7.0))
    M = B + B.mT
    Wb, db = tldl.ldl_nopiv_plain_batched(M)
    fb = tldl.ldl_factor_batched(M)
    for s in range(3):
        W1, d1 = tldl.ldl_nopiv_plain(M[s])
        assert torch.equal(Wb[s], W1) and torch.equal(db[s], d1)
        f1 = tldl.ldl_factor(M[s])
        assert torch.equal(fb.L[s], f1.L) and torch.equal(fb.d[s], f1.d)
        assert int(fb.n_neg[s]) == int(f1.n_neg) and bool(fb.ok[s]) == bool(f1.ok)


# ---------------------------------------------------------------------------
# the dense family of tests/test_batch_solve.py
# ---------------------------------------------------------------------------
N_DENSE = 6
DENSE_VALS = (0.3, 0.7, 1.0, 1.4)
DENSE_KW = dict(xl=np.full(N_DENSE, -2.0), xu=np.full(N_DENSE, 5.0),
                cl=np.array([2.0, -1.0]), cu=np.array([2.0, 1.0]), x0=np.full(N_DENSE, 0.5))


def _dense_th():
    return np.stack([np.full(N_DENSE, v) for v in DENSE_VALS])


def _port_dense(scale=1.0):
    def f(x, th):
        return torch.sum((x - th) ** 2) + 0.1 * torch.sum(x ** 4)

    def c(x, th):
        return torch.stack([torch.sum(x), x[0] * x[1]])

    o = NlpOptions()
    o.update(Hessian="analytical_exact", verbosity_level=0, compute_mode="cpu")
    x0 = torch.from_numpy(DENSE_KW["x0"] * scale)
    return tbs.ParametricDenseNlp(f, c, th0=np.ones(N_DENSE), options=o,
                                  x0_of_th=lambda th: x0, **DENSE_KW)


@pytest.fixture(scope="module")
def jax_dense():
    def f(x, th):
        return jnp.sum((x - th) ** 2) + 0.1 * jnp.sum(x ** 4)

    def c(x, th):
        return jnp.stack([jnp.sum(x), x[0] * x[1]])

    def make(s):
        o = hiop_tpu.NlpOptions()
        o.update(Hessian="analytical_exact", verbosity_level=0)
        x0 = jnp.asarray(DENSE_KW["x0"] * s)
        return jbs.ParametricDenseNlp(f, c, th0=np.ones(N_DENSE), options=o,
                                      x0_of_th=lambda th: x0, **DENSE_KW)

    return _jax_reference(make, jnp.asarray(_dense_th()))


def test_dense_family_matches_jax(jax_dense):
    """Every lane of this family is rounding-decided in hiop_tpu: from row 9
    its constraint violation is at rounding level (2e-16), and each lane
    ends Steplength_Too_Small (a needs-host exit) or Solve_Acceptable_Level
    after 9 to 138 iterations depending on a 1e-15 scaling of the starting
    point, all at one objective. The port holds every decision up to
    there, and its lanes end at hiop_tpu's objective and x."""
    tp = _port_dense()
    port = _port_run(tp, _dense_th())
    assert all(jax_dense["decided"])
    pert = [_port_run(_port_dense(s), _dense_th()) for s in PERTURB]
    _assert_matches_jax(port, jax_dense, pert)
    # each lane alone (S=1): the same bits as in the batch
    for k in range(len(DENSE_VALS)):
        one = _port_run(tp, _dense_th()[k:k + 1])
        assert one["st"][0] == port["st"][k] and one["it"][0] == port["it"][k]
        assert one["obj"][0] == port["obj"][k]


# ---------------------------------------------------------------------------
# MdsEx1 with a per-scenario objective shift
# ---------------------------------------------------------------------------
NS, ND = 40, 12
SHIFTS = np.array([0.6, 1.0, 1.5])
SHIFTED_OPTS = dict(Hessian="analytical_exact", verbosity_level=0, tolerance=1e-6,
                    mu0=0.1, duals_init="zero", duals_update_type="linear")


class ShiftedMds(MdsEx1):
    """The port's MdsEx1 with its objective's x-target shifted by the
    scalar scenario parameter (tests/test_batch_solve.py's family)."""

    def __init__(self):
        super().__init__(NS, ND)

    def eval_f(self, z, th):
        x, s, y = self._split(z)
        Qd = self._data.on(z.device)["Qd"]
        return 0.5 * torch.sum(x * (x - th)) + 0.5 * y @ (Qd @ y) + 0.5 * torch.sum(s * s)

    def eval_grad_f(self, z, th):
        x, s, y = self._split(z)
        return torch.cat([x - 0.5 * th, s, self._data.on(z.device)["Qd"] @ y])

    def eval_cons(self, z, th):
        return super().eval_cons(z)

    def eval_jac_blocks(self, z, th):
        return super().eval_jac_blocks(z)

    def eval_hess_blocks(self, z, obj_factor, lam, th):
        return super().eval_hess_blocks(z, obj_factor, lam)


def _port_shifted():
    o = NlpOptions()
    o.update(compute_mode="cpu", **SHIFTED_OPTS)
    return tbs.ParametricMdsNlp(ShiftedMds(), th0=1.0, options=o)


@pytest.fixture(scope="module")
def jax_shifted():
    class JShifted(JMdsEx1):
        def __init__(self):
            super().__init__(NS, ND)

        def eval_f(self, z, th):
            x, s, y = self._split(z)
            return 0.5 * jnp.sum(x * (x - th)) + 0.5 * y @ (self.Qd @ y) + 0.5 * jnp.sum(s * s)

        def eval_grad_f(self, z, th):
            x, s, y = self._split(z)
            return jnp.concatenate([x - 0.5 * th, s, self.Qd @ y])

        def eval_cons(self, z, th):
            return super().eval_cons(z)

        def eval_jac_blocks(self, z, th):
            return super().eval_jac_blocks(z)

        def eval_hess_blocks(self, z, obj_factor, lam, th):
            return super().eval_hess_blocks(z, obj_factor, lam)

    prob = JShifted()
    x_start = np.asarray(prob.get_starting_point(), np.float64)

    def make(s):
        o = hiop_tpu.NlpOptions()
        o.update(**SHIFTED_OPTS)
        x0 = jnp.asarray(x_start * s)
        return jbs.ParametricMdsNlp(prob, th0=jnp.asarray(1.0), options=o,
                                    x0_of_th=lambda th: x0)

    return _jax_reference(make, jnp.asarray(SHIFTS))


def test_shifted_mds_family_matches_jax(jax_shifted):
    """The MDS quick ladder (Cholesky of K_d and S) over the lanes."""
    tp = _port_shifted()
    port = _port_run(tp, SHIFTS)
    assert not any(jax_shifted["decided"])
    assert (port["st"] == 1).all()
    _assert_matches_jax(port, jax_shifted)
    _assert_lanes_equal_alone(tp, SHIFTS, port, range(3), lambda th, k: th[k:k + 1])


def test_batched_reuses_built_solve():
    tp = _port_shifted()
    r1 = tbs.solve_batched(tp, SHIFTS[:2])
    built = tp._batched_solve_cache
    assert built is not None
    r2 = tbs.solve_batched(tp, SHIFTS[:2])
    assert tp._batched_solve_cache is built
    assert np.array_equal(r1.obj, r2.obj) and list(r1.status) == list(r2.status)


def test_a_hook_that_cannot_be_batched_names_itself():
    """A hook that reads the host (here ``float`` of the parameter) cannot
    run under torch.func.vmap; the batched solve raises naming it."""

    class HostRead(ShiftedMds):
        def eval_f(self, z, th):
            return super().eval_f(z, float(th))

    o = NlpOptions()
    o.update(compute_mode="cpu", **SHIFTED_OPTS)
    tp = tbs.ParametricMdsNlp(HostRead(), th0=1.0, options=o)
    with pytest.raises(RuntimeError, match="hook eval_f of ParametricMdsNlp"):
        tbs.solve_batched(tp, SHIFTS)


def test_one_batched_factorization_and_one_read_per_loop_trip(monkeypatch):
    """Every factorization of a loop trip is one call of the batched
    Cholesky over all lanes (two per trip: K_d and S), and each loop trip
    reads the host once for the whole batch: one read for the ladder's
    first test (with the solve loop's), one after the first trial (the SOC
    and backtracking loops' first tests), one per ladder, SOC and
    backtracking trip, and the solve loop's last test."""
    calls = []
    batched = tchol.cholesky_batched

    def counted(A):
        calls.append(A.shape[0])
        return batched(A)

    monkeypatch.setattr(tchol, "cholesky_batched", counted)
    port = _port_run(_port_shifted(), SHIFTS)
    s = port["stats"]
    assert set(calls) == {3}
    assert len(calls) == 2 * (s.trips + 1 + s.ladder_trips)
    assert s.trips == int(port["it"].max()) + 1
    assert s.reads == 2 * s.trips + 1 + s.ladder_trips + s.soc_trips + s.bt_trips
    assert s.lanes_live == int((port["it"] + 1).sum())


# ---------------------------------------------------------------------------
# the ACOPF contingency family (linear_solver_dense=ldl_nopiv)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_acopf():
    """hiop_tpu's solve_contingencies(B, 3) families (options and outages
    as there: the basecase and ring lines 0 and B/2). Their lanes are not
    rounding-decided: under 1 +- 1e-15 and 1 +- 1e-14 scalings of the
    starting point hiop_tpu gives the same statuses and iterations (at
    B=16: [1, 7, 1] in [46, 21, 42]; ROADMAP.md section 3), so the
    reference runs once and every lane is held exactly."""
    out = {}
    for n_bus in (8, 16):
        lines = [-1, 0, n_bus // 2]
        jprob = j_acopf.AcopfContingencyMds(n_bus)
        o = hiop_tpu.NlpOptions()
        o.update(Hessian="analytical_exact", fixed_var="relax", tolerance=1e-6, mu0=0.1,
                 linear_solver_dense="ldl_nopiv", verbosity_level=0, max_iter=300)
        ref = _jax_run(jbs.ParametricMdsNlp(jprob, jprob.th0(), o), jprob.contingency_params(lines))
        ref["decided"] = [False] * len(lines)
        out[n_bus] = ref
    return out


def _port_acopf(n_bus):
    assert acopf_mds.contingency_lines(n_bus, 3) == [-1, 0, n_bus // 2]
    tprob = acopf_mds.AcopfContingencyMds(n_bus)
    tp = tbs.ParametricMdsNlp(tprob, tprob.th0(),
                              acopf_mds.contingency_options(max_iter=300, compute_mode="cpu"))
    return tp, tprob.contingency_params(acopf_mds.contingency_lines(n_bus, 3))


def _take(th, k):
    return {key: v[k:k + 1] for key, v in th.items()}


def test_acopf_contingencies_b8_match_jax(jax_acopf):
    tp, th = _port_acopf(8)
    port = _port_run(tp, th)
    assert (port["st"] == 1).all() and port["it"].tolist() == [31, 24, 28]
    assert not any(jax_acopf[8]["decided"])
    _assert_matches_jax(port, jax_acopf[8])
    _assert_lanes_equal_alone(tp, th, port, range(3), _take)


def test_acopf_contingencies_b16_match_jax(jax_acopf):
    """One lane exits needs-host (Steplength_Too_Small, 7) at iteration 21
    while the others run on to 46 and 42; the exited lane keeps its state.

    Lane 2 alone (S=1) is rounding-decided in the port: torch's batched
    matrix products special-case a batch of one, and this lane's trajectory
    amplifies the difference (err_nlp passes 1e3 near iteration 25) until a
    regularization decision parts at row 35 and the run exits
    Steplength_Too_Small at 41; with its starting point scaled by 1 + 1e-15
    (or 1 - 1e-15, 1 +- 1e-14) the lone run converges in 42 iterations, as
    the batch and hiop_tpu do. Lanes 0 and 1 are held to their S=1 runs
    exactly."""
    tp, th = _port_acopf(16)
    port = _port_run(tp, th)
    assert port["st"].tolist() == [1, 7, 1] and port["it"].tolist() == [46, 21, 42]
    assert not any(jax_acopf[16]["decided"])
    _assert_matches_jax(port, jax_acopf[16])
    _assert_lanes_equal_alone(tp, th, port, (0, 1), _take)
    one = _port_run(tp, _take(th, 2))
    part = _parting_row(port["hist"][2], one["hist"][0], port["it"][2], one["it"][0])
    assert part >= 30
    assert abs(one["obj"][0] - port["obj"][2]) < 1e-6 * abs(port["obj"][2])
    x0 = np.asarray(tp._p.get_starting_point(), np.float64)
    for s in PERTURB:
        tps = tbs.ParametricMdsNlp(
            tp._p, tp._p.th0(), acopf_mds.contingency_options(max_iter=300, compute_mode="cpu"),
            x0_of_th=lambda _th, xs=torch.from_numpy(x0 * s): xs)
        pert = _port_run(tps, _take(th, 2))
        assert pert["st"][0] == port["st"][2] and pert["it"][0] == port["it"][2]


# ---------------------------------------------------------------------------
# the solver's spans (hiop_tpu_torch.utils.trace), on while kernels.stats.timing
# ---------------------------------------------------------------------------
#: where each span may sit: its parent's name (None: a root)
SPAN_PARENTS = {
    "batch.family": {None},
    "batch.init": {"batch.family"}, "batch.trip": {"batch.family"},
    "batch.results": {"batch.family"},
    **{p: {"batch.trip"} for p in ("batch.residual", "batch.factor", "batch.ladder",
                                    "batch.direction", "batch.soc", "batch.backtrack",
                                    "batch.finish", "batch.update")},
    "kkt.factor": {"batch.factor", "batch.ladder"},
    "kkt.solve": {"batch.direction", "batch.soc"},
    "host.read": {"batch.factor", "batch.ladder", "batch.direction", "batch.soc",
                  "batch.backtrack", "batch.results"},
}
NLP_CALLERS = {"batch.init", "batch.residual", "batch.direction", "batch.soc",
               "batch.backtrack", "batch.finish"}


@pytest.fixture(scope="module", params=["shifted_b3", "acopf_b8"])
def traced(request):
    """One family solved through solve_batched with the spans on, and
    again by _port_run with them off."""
    from hiop_tpu_torch.linalg import kernels
    from hiop_tpu_torch.utils.trace import recorder

    if request.param == "shifted_b3":
        tp, th = _port_shifted(), SHIFTS
    else:
        tp, th = _port_acopf(8)
    recorder.clear()
    kernels.stats.timing = True
    try:
        res = tbs.solve_batched(tp, th)
    finally:
        kernels.stats.timing = False
    spans, dropped = list(recorder.spans), recorder.dropped
    recorder.clear()
    off = _port_run(tp, th)
    off_spans = len(recorder.spans)
    return dict(res=res, stats=tp._batched_solve_cache.stats, spans=spans, dropped=dropped,
                off=off, off_spans=off_spans, S=len(res.status), n=tp.n, m=tp.m)


def _kids(spans):
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    return kids


def test_batched_spans_form_the_solve_tree(traced):
    """One family root; init, a trip per step (the last, empty one too) and
    the results under it; the phases under the trips; hooks, KKT calls and
    reads under the phase that made them."""
    spans, st = traced["spans"], traced["stats"]
    assert traced["dropped"] == 0 and all(s.end is not None for s in spans)
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "batch.family"
    for s in spans:
        assert s.family == root.id
        parent = None if s.parent is None else by_id[s.parent].name
        allowed = NLP_CALLERS if s.name.startswith("nlp.") else SPAN_PARENTS[s.name]
        assert parent in allowed, (s.name, parent)
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start <= s.start <= s.end <= p.end
    kids = _kids(spans)
    top = [s.name for s in kids[root.id]]
    assert top == ["batch.init"] + ["batch.trip"] * (st.trips + 1) + ["batch.results"]
    trips = kids[root.id][1:-1]
    assert [t.attrs["index"] for t in trips] == list(range(st.trips + 1))
    assert trips[-1].attrs["live"] == 0
    assert [s.name for s in kids[trips[-1].id]] == ["batch.residual", "batch.factor"]
    assert sum(t.attrs["live"] for t in trips) == st.lanes_live
    names = Counter(s.name for s in spans)
    assert names["kkt.factor"] == st.trips + 1 + st.ladder_trips
    for name, rounds, lanes in (("batch.ladder", st.ladder_trips, st.ladder_lanes),
                                ("batch.soc", st.soc_trips, st.soc_lanes),
                                ("batch.backtrack", st.bt_trips, st.bt_lanes)):
        assert names[name] == rounds
        assert sum(s.attrs["lanes"] for s in spans if s.name == name) == lanes
    assert {n for n in names if n.startswith("nlp.")} >= {
        "nlp.starting_point", "nlp.eval_f", "nlp.eval_cons", "nlp.eval_jac",
        "nlp.eval_grad_f", "nlp.eval_hess_blocks"}


def test_batched_family_span_carries_the_batch_stats(traced):
    """The family span's counters are BatchStats; one host.read span per
    read of the loop, and one for the results' copy."""
    spans, st = traced["spans"], traced["stats"]
    (root,) = [s for s in spans if s.name == "batch.family"]
    assert root.attrs == dict(st.as_dict(), S=traced["S"], n=traced["n"], m=traced["m"])
    assert sum(s.name == "host.read" for s in spans) == st.reads + 1


def test_batched_spans_off_record_nothing_and_change_no_bit(traced):
    res, off = traced["res"], traced["off"]
    assert traced["off_spans"] == 0
    assert [tbs._STATUS_MAP[int(c)] for c in off["st"]] == list(res.status)
    assert np.array_equal(off["it"], res.iterations)
    assert np.array_equal(off["obj"], res.obj)
    assert torch.equal(torch.from_numpy(off["x"]), res.x)


def test_span_self_time_is_duration_less_children_cover(traced):
    from hiop_tpu_torch.utils.trace import Recorder, Span, self_ns

    kids = _kids(traced["spans"])
    for s in traced["spans"]:
        # the solver's children follow one another
        assert self_ns(s, kids.get(s.id, [])) == s.duration - sum(
            k.duration for k in kids.get(s.id, []))
    rec = Recorder()

    def at(start, end):
        s = Span(rec, "x", 0, None, None)
        s.start, s.end = start, end
        return s

    # overlapping children, and one reaching past the parent's end
    assert self_ns(at(0, 100), [at(10, 30), at(20, 40), at(90, 120)]) == 100 - 30 - 10
    assert self_ns(at(0, 100), []) == 100


def test_export_chrome_writes_one_event_per_span(traced, tmp_path):
    import json

    from hiop_tpu_torch.utils.trace import Recorder

    rec = Recorder()
    rec.spans = traced["spans"]
    path = tmp_path / "spans.json"
    assert rec.export_chrome(path) == len(traced["spans"])
    doc = json.loads(path.read_text())
    ev = doc["traceEvents"]
    assert len(ev) == len(traced["spans"]) and {e["ph"] for e in ev} == {"X"}
    first = traced["spans"][0]
    assert ev[0]["name"] == first.name and ev[0]["ts"] == first.start / 1e3
    assert ev[0]["args"]["family"] == first.family
    # beside a profiler trace: its time base
    base = tmp_path / "profiler.json"
    base.write_text(json.dumps({"baseTimeNanoseconds": first.start, "traceEvents": []}))
    rec.export_chrome(path, beside=base)
    assert json.loads(path.read_text())["traceEvents"][0]["ts"] == 0.0


# ---------------------------------------------------------------------------
# the ldl_nopiv saddle's triplet route (kkt.mds.factorize_saddle_triplets)
# against its dense route (factorize_saddle_device), under torch.func.vmap
# ---------------------------------------------------------------------------
#: the regularizations tried: none, and a ladder step's (delta_w, delta_c)
DELTAS = [(0.0, 0.0), (1e-4, 1e-8)]


def _rel(a, b):
    """Per lane: the largest difference over the largest entry of ``a``."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return ((a - b).abs().amax(-1) / a.abs().amax(-1).clamp(min=1e-300)).max().item()


def _assert_routes_agree(blocks, js, S, dw, dc, seed):
    """``blocks``: (hss, Hdd, Dxs, Dxd, Dd, Jc, Jd) stacked over S lanes, the
    Jacobians dense with the sparse columns first. The saddle M to 1e-13,
    the same ok and pivot-sign inertia, the directions to 1e-10."""
    from hiop_tpu_torch.kkt import mds as kkt_mds

    hss, Hdd, Dxs, Dxd, Dd, Jc, Jd = blocks
    ns = hss.shape[-1]
    d = [torch.full((S,), v, dtype=torch.float64) for v in (dw, dw, dc, dc)]
    dense = (hss, Hdd, Dxs, Dxd, Dd, Jc[..., :ns], Jc[..., ns:], Jd[..., :ns], Jd[..., ns:], *d)
    js_vals = torch.func.vmap(lambda a, b: kkt_mds.js_values(a, b, js))(Jc, Jd)
    trip = (hss, Hdd, Dxs, Dxd, Dd, Jc[..., ns:], Jd[..., ns:], js_vals)

    def triplet_saddle(*a):
        return kkt_mds._triplet_saddle(*a[:8], js, *a[8:])[-1]

    M_d = torch.func.vmap(lambda *a: kkt_mds._dense_saddle(*a)[-1])(*dense)
    M_t = torch.func.vmap(triplet_saddle)(*trip, *d)
    assert _rel(M_d, M_t) < 1e-13

    f_d = torch.func.vmap(kkt_mds.factorize_saddle_device)(*dense)
    f_t = torch.func.vmap(lambda *a: kkt_mds.factorize_saddle_triplets(*a[:8], js, *a[8:]))(
        *trip, *d)
    assert torch.equal(f_d.ok, f_t.ok)
    assert torch.equal((f_d.d < 0).sum(-1), (f_t.d < 0).sum(-1))

    g = torch.Generator().manual_seed(seed)
    mc, md = Jc.shape[-2], Jd.shape[-2]
    rhs = [torch.randn((S, k), generator=g, dtype=torch.float64)
           for k in (ns, Hdd.shape[-1], md, mc, md)]
    out_d = torch.func.vmap(kkt_mds.solve_saddle_device)(f_d, *rhs)
    out_t = torch.func.vmap(lambda f, *r: kkt_mds.solve_saddle_device(f, *r, js=js))(f_t, *rhs)
    for a, b in zip(out_d, out_t):
        if a.shape[-1]:
            assert _rel(a, b) < 1e-10


@pytest.mark.parametrize("dw, dc", DELTAS)
def test_triplet_saddle_equals_dense_on_acopf_first_iterate(dw, dc):
    """The ACOPF B=16 contingency family (S=3) at its first iterate."""
    from hiop_tpu_torch.kkt import mds as kkt_mds
    from hiop_tpu_torch.optimization import residual as res_mod

    tp, th = _port_acopf(16)
    js = kkt_mds.js_triplets(tp)
    assert js is not None
    params = tbs.tree_on(th, tp.device)
    state0, _, _ = tbs._build_init(tp)(params)
    it = state0.it
    Dx, Dd = torch.func.vmap(lambda i: res_mod.barrier_diagonals(i, tp.bounds))(it)
    hss, Hdd = torch.func.vmap(lambda x, yc, yd, p: tp.eval_hess_blocks(x, 1.0, yc, yd, p))(
        it.x, it.yc, it.yd, params)
    ns = tp.n_sparse
    _assert_routes_agree((hss, Hdd, Dx[:, :ns], Dx[:, ns:], Dd, state0.Jc, state0.Jd),
                         js, 3, dw, dc, seed=16)


def _random_mds(seed, dup=False, S=4, ns=60, nd=7, mc=25, md=15):
    """A random duplicate-free MDS structure (2 nonzeros a column, rows
    drawn at random), or with one entry listed twice (``dup``), as a
    formulation's attributes, and S lanes of random blocks on it: K_s with
    negative entries, K_d indefinite, Dd > 0."""
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    m = mc + md
    cols = np.repeat(np.arange(ns), 2)
    rows = np.concatenate([rng.choice(m, 2, replace=False) for _ in range(ns)])
    if dup:
        rows, cols = np.append(rows, rows[0]), np.append(cols, cols[0])
    eq = rows < mc
    nlp = SimpleNamespace(
        m=m, m_eq=mc, n_sparse=ns, device=torch.device("cpu"),
        jac_sp_eq_rows=rows[eq], jac_sp_eq_cols=cols[eq],
        jac_sp_in_rows=rows[~eq] - mc, jac_sp_in_cols=cols[~eq],
        _jac_eq_rc_t=(torch.from_numpy(rows[eq]), torch.from_numpy(cols[eq])),
        _jac_in_rc_t=(torch.from_numpy(rows[~eq] - mc), torch.from_numpy(cols[~eq])),
    )
    J = np.zeros((S, m, ns + nd))
    J[:, rows, cols] = rng.standard_normal((S, rows.size))
    J[:, :, ns:] = rng.standard_normal((S, m, nd))
    B = rng.standard_normal((S, nd, nd))
    blocks = (rng.uniform(-1.0, 3.0, (S, ns)), B + np.swapaxes(B, 1, 2),
              rng.uniform(0.1, 2.0, (S, ns)), rng.uniform(0.1, 2.0, (S, nd)),
              rng.uniform(0.1, 2.0, (S, md)), J[:, :mc], J[:, mc:])
    return nlp, tuple(torch.from_numpy(np.ascontiguousarray(b)) for b in blocks)


@pytest.mark.parametrize("dw, dc", DELTAS)
def test_triplet_saddle_equals_dense_on_a_random_structure(dw, dc):
    from hiop_tpu_torch.kkt import mds as kkt_mds

    nlp, blocks = _random_mds(5)
    js = kkt_mds.js_triplets(nlp)
    assert js is not None
    _assert_routes_agree(blocks, js, 4, dw, dc, seed=5)


def test_dense_route_where_the_structure_gives_no_triplets():
    """A duplicate entry (build_schur_pairs declines), or pairs above
    TRIPLET_SHARE of the dense product's multiply-adds (a dense J_s),
    leaves the saddle on the dense route."""
    from hiop_tpu_torch.kkt import mds as kkt_mds

    nlp, _ = _random_mds(5, dup=True)
    assert kkt_mds.build_schur_pairs(*kkt_mds.stacked_js(nlp), nlp.n_sparse) is None
    assert kkt_mds.js_triplets(nlp) is None
    nlp, _ = _random_mds(5)
    m, ns = nlp.m, nlp.n_sparse
    r, c = np.divmod(np.arange(m * ns), ns)
    nlp.jac_sp_eq_rows, nlp.jac_sp_eq_cols = r[r < nlp.m_eq], c[r < nlp.m_eq]
    nlp.jac_sp_in_rows, nlp.jac_sp_in_cols = r[r >= nlp.m_eq] - nlp.m_eq, c[r >= nlp.m_eq]
    assert kkt_mds.build_schur_pairs(*kkt_mds.stacked_js(nlp), ns) is not None
    assert kkt_mds.js_triplets(nlp) is None


class DupShiftedMds(ShiftedMds):
    """ShiftedMds with J_s's (0, 0) entry listed twice, half its value in
    each: the same Jacobian, which the triplets cannot hold."""

    def __init__(self):
        from hiop_tpu_torch.utils.carry import DeviceCache

        super().__init__()
        self._jr, self._jc = np.append(self._jr, 0), np.append(self._jc, 0)
        jv = np.ones(self._jr.size)
        jv[0] = jv[-1] = 0.5
        self._data = DeviceCache(**dict(self._data._np, jv=jv))


def test_duplicate_entries_send_an_ldl_family_to_the_dense_route():
    """MdsEx1 with ldl_nopiv: its structure gives triplets, so every
    batched factorization is counted; with an entry listed twice the family
    takes the dense route (counter 0) and solves the same problem."""
    runs = []
    for prob in (ShiftedMds(), DupShiftedMds()):
        o = NlpOptions()
        o.update(compute_mode="cpu", linear_solver_dense="ldl_nopiv", **SHIFTED_OPTS)
        runs.append(_port_run(tbs.ParametricMdsNlp(prob, th0=1.0, options=o), SHIFTS))
    trip, dense = runs
    s = trip["stats"]
    assert s.triplet_factors == s.trips + 1 + s.ladder_trips
    assert dense["stats"].triplet_factors == 0
    assert (trip["st"] == 1).all() and (dense["st"] == 1).all()
    assert np.array_equal(trip["it"], dense["it"])
    assert np.allclose(trip["obj"], dense["obj"], rtol=1e-9, atol=0.0)


def test_batched_acopf_solve_repeats_its_bits():
    """Two batched solves of the ACOPF B=8 family on the triplet route: the
    same history, objective and x, bit for bit."""
    tp, th = _port_acopf(8)
    a, b = _port_run(tp, th), _port_run(tp, th)
    assert a["stats"].triplet_factors > 0
    for k in ("st", "it", "obj", "x", "hist"):
        assert np.array_equal(a[k], b[k]), k


def test_batched_family_counts_its_triplet_factorizations(traced):
    """The family span's triplet_factors: every kkt.factor span on the
    ACOPF family (ldl_nopiv), none on ShiftedMds (the quick Cholesky)."""
    (root,) = [s for s in traced["spans"] if s.name == "batch.family"]
    n_fact = sum(s.name == "kkt.factor" for s in traced["spans"])
    acopf = traced["n"] != 2 * NS + ND
    assert root.attrs["triplet_factors"] == (n_fact if acopf else 0)


def test_dense_family_counts_no_triplet_factorization():
    tp = _port_dense()
    tp.options.update(max_iter=3)
    s = _port_run(tp, _dense_th())["stats"]
    assert s.trips == 4 and s.triplet_factors == 0
