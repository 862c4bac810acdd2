"""ACOPF-class mixed dense-sparse NLP (the BASELINE.json north-star shape),
with its evaluations in torch on the solver's device.

Counterpart of ``examples/acopf_mds.py`` (the MDS formulation, and its
twin through the sparse interface, :class:`AcopfSparse`): a
synthetic AC optimal power flow over a ring-plus-chords grid. Sparse block:
the network state in rectangular voltage coordinates with bus current
injections and bilinear products diagonalized through auxiliaries
(10B variables, diagonal Lagrangian Hessian). Dense block: ng generator
outputs coupled to every bus through a dense participation matrix.

Constraints (9B equalities)::

  a - G e + B f = 0, b - G f - B e = 0          (current definition, 2B)
  p1 = e+a, m1 = e-a, p2 = f+b, m2 = f-b        (auxiliaries, 4B)
  (p1^2 - m1^2 + p2^2 - m2^2)/4 + A g = Pload   (active power balance, B)
  v = e^2 + f^2,  w = a^2 + b^2                 (magnitudes, 2B)

Bounds: v in [0.81, 1.21], w in [0, Imax^2], g in [0, gmax], f_0 = 0
(a fixed variable, relaxed by ``fixed_var=relax``).

``build_grid`` is numpy and identical to the JAX example's, so both
packages build the same instance from the same seed.

Run: ``python -m hiop_tpu_torch.examples.acopf_mds 32 -selfcheck``
(on cuda:0; add ``-cpu`` for the CPU, ``-sparse`` for ``AcopfSparse``,
``-production`` for the fused whole solve in :data:`PRODUCTION_OPTIONS`).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hiop_tpu_torch import FilterIPMNewton, MdsProblem, NlpMDS, NlpOptions, NlpSparse, SparseProblem
from hiop_tpu_torch.interface.base import INF
from hiop_tpu_torch.linalg.vector_ops import scatter_add_
from hiop_tpu_torch.utils.carry import DeviceCache

# converged objectives (seed=0), recorded by hiop_tpu
SELFCHECK = {
    32: (2.054726213295e01, 1e-6),
    128: (5.773825703419e01, 1e-5),
    256: (1.538081406685e02, 1e-5),
    512: (3.703093290606e02, 1e-4),
}


def _grid_y_values(n_bus, edges, line_y, order, mask=None):
    """(g_vals, b_vals) on the grid's fixed COO pattern (lexsort `order`),
    with lines where ``mask`` is False removed — line outages keep the
    sparsity pattern, so every contingency shares one XLA program."""
    diag_g = np.full(n_bus, 0.01)          # small shunt conductance
    diag_b = np.full(n_bus, 0.001)
    gv, bv = [], []
    for k, (i, j) in enumerate(edges):
        y = line_y[k] if (mask is None or mask[k]) else 0.0j
        diag_g[i] += y.real
        diag_g[j] += y.real
        diag_b[i] += y.imag
        diag_b[j] += y.imag
        gv += [-y.real, -y.real]
        bv += [-y.imag, -y.imag]
    g_vals = np.concatenate([diag_g, np.asarray(gv)])
    b_vals = np.concatenate([diag_b, np.asarray(bv)])
    return g_vals[order], b_vals[order]


def build_grid(n_bus: int, seed: int = 0):
    """Ring + chords admittance matrix in COO parts, loads, participation."""
    rng = np.random.default_rng(seed)
    edges = [(i, (i + 1) % n_bus) for i in range(n_bus)]
    if n_bus >= 8:
        for i in range(0, n_bus // 2, 4):
            edges.append((i, i + n_bus // 2))
    n_line = len(edges)
    line_y = []
    for k in range(n_line):
        r = (0.01 if k < n_bus else 0.02) * (1.0 + 0.2 * rng.random())
        x = (0.10 if k < n_bus else 0.20) * (1.0 + 0.2 * rng.random())
        line_y.append(1.0 / complex(r, x))
    ii = [e for i, j in edges for e in (i, j)]
    jj = [e for i, j in edges for e in (j, i)]
    rows = np.concatenate([np.arange(n_bus), np.asarray(ii)])
    cols = np.concatenate([np.arange(n_bus), np.asarray(jj)])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    g_vals, b_vals = _grid_y_values(n_bus, edges, line_y, order)

    p_load = rng.uniform(0.05, 0.30, n_bus)
    ng = max(4, n_bus // 5)
    # dense participation factors, LOCALIZED: generator g's output is
    # distributed around its home bus with exponential ring-distance decay
    # (every entry still > 0, so the Jacobian block is genuinely dense).
    # Uniform-random participation makes power traverse O(B) ring hops and
    # the instance goes voltage-collapse-infeasible beyond ~100 buses;
    # localization keeps line flows O(1) at every network size.
    homes = (np.arange(ng) * n_bus) // ng
    dist = np.abs(np.arange(n_bus)[:, None] - homes[None, :])
    dist = np.minimum(dist, n_bus - dist)          # ring distance
    tau = max(2.0, n_bus / (2.0 * ng))
    alpha = np.exp(-dist / tau) * rng.uniform(0.8, 1.2, (n_bus, ng))
    alpha /= alpha.sum(axis=0, keepdims=True)
    g_max = np.full(ng, 3.0 * p_load.sum() / ng)
    cost_c = rng.uniform(1.0, 3.0, ng)
    d = rng.uniform(0.5, 1.5, ng)
    u = rng.uniform(0.1, 0.5, ng)
    cost_Q = np.diag(d) + np.outer(u, u)   # dense PD market-coupled cost
    return dict(
        n_bus=n_bus, n_line=n_line, ng=ng,
        rows=rows, cols=cols, g_vals=g_vals, b_vals=b_vals,
        p_load=p_load, alpha=alpha, g_max=g_max, cost_c=cost_c, cost_Q=cost_Q,
        rho_v=5.0, rho_w=0.05, rho_w2=0.01, i_max2=9.0,
        edges=edges, line_y=line_y, order=order,
    )


class _AcopfCore:
    """The math of the MDS formulation. Sparse variable layout:
    [e, f, a, b, p1, m1, p2, m2, v, w], each of length B."""

    def __init__(self, n_bus: int = 32, seed: int = 0):
        self.gd = gd = build_grid(n_bus, seed)
        self.B = B = n_bus
        self.ng = gd["ng"]
        self.n_sp = 10 * B
        self.m = 9 * B
        self._yr = np.asarray(gd["rows"])
        self._yc = np.asarray(gd["cols"])
        self._build_jac_structure()
        self._data = DeviceCache(
            yr=self._yr, yc=self._yc, gv=gd["g_vals"], bv=gd["b_vals"],
            alpha=gd["alpha"], Q=gd["cost_Q"], c=gd["cost_c"],
        )

    def t(self, z) -> dict:
        """The instance data as tensors on ``z``'s device."""
        return self._data.on(z.device)

    # offsets into the sparse variable vector
    def _off(self):
        B = self.B
        return {k: i * B for i, k in enumerate(
            ["e", "f", "a", "b", "p1", "m1", "p2", "m2", "v", "w"])}

    def _ymatvec(self, t, vals, x):
        out = torch.zeros(self.B, dtype=x.dtype, device=x.device)
        return scatter_add_(out, t["yr"], vals * x[t["yc"]])

    def split(self, z):
        B = self.B
        return [z[i * B:(i + 1) * B] for i in range(10)]

    def obj_sparse(self, z):
        """Voltage-deviation cost on (e, f) directly, NOT on v, so the
        Lagrangian keeps +rho_v curvature on the voltage variables."""
        e, f, a, b, p1, m1, p2, m2, v, w = self.split(z)
        gd = self.gd
        return (
            0.5 * gd["rho_v"] * torch.sum((e - 1.0) ** 2 + f ** 2)
            + gd["rho_w"] * torch.sum(w)
            + 0.5 * gd["rho_w2"] * torch.sum(w ** 2)
        )

    def grad_sparse(self, z):
        e, f, a, b, p1, m1, p2, m2, v, w = self.split(z)
        gd = self.gd
        zero = torch.zeros_like(e)
        return torch.cat([
            gd["rho_v"] * (e - 1.0), gd["rho_v"] * f,
            zero, zero, zero, zero, zero, zero,
            zero, gd["rho_w"] + gd["rho_w2"] * w,
        ])

    def obj_dense(self, g):
        t = self.t(g)
        return 0.5 * g @ (t["Q"] @ g) + t["c"] @ g

    def grad_dense(self, g):
        t = self.t(g)
        return t["Q"] @ g + t["c"]

    def cons_all(self, z, g):
        """All 9B rows: [Ia, Ib, p1,m1,p2,m2 defs, Pbal, vdef, wdef]."""
        t = self.t(z)
        gv, bv = t["gv"], t["bv"]
        e, f, a, b, p1, m1, p2, m2, v, w = self.split(z)
        ia = a - self._ymatvec(t, gv, e) + self._ymatvec(t, bv, f)
        ib = b - self._ymatvec(t, gv, f) - self._ymatvec(t, bv, e)
        d1 = p1 - e - a
        d2 = m1 - e + a
        d3 = p2 - f - b
        d4 = m2 - f + b
        pbal = 0.25 * (p1 ** 2 - m1 ** 2 + p2 ** 2 - m2 ** 2) + t["alpha"] @ g
        vdef = v - e ** 2 - f ** 2
        wdef = w - a ** 2 - b ** 2
        return torch.cat([ia, ib, d1, d2, d3, d4, pbal, vdef, wdef])

    def cons_bounds(self):
        B = self.B
        cl = np.zeros(self.m)
        cl[6 * B:7 * B] = self.gd["p_load"]
        return cl, cl.copy()    # all equalities

    def var_bounds_sparse(self):
        B, gd = self.B, self.gd
        xl = np.full(self.n_sp, -INF)
        xu = np.full(self.n_sp, INF)
        o = self._off()
        xl[o["v"]:o["v"] + B] = 0.81
        xu[o["v"]:o["v"] + B] = 1.21
        xl[o["w"]:o["w"] + B] = 0.0
        xu[o["w"]:o["w"] + B] = gd["i_max2"]
        xl[o["f"]] = xu[o["f"]] = 0.0       # reference bus: fixed variable
        return xl, xu

    def start_sparse(self):
        B = self.B
        e0 = np.ones(B)
        f0 = np.zeros(B)
        a0 = np.zeros(B)
        b0 = np.zeros(B)
        np.add.at(a0, self._yr, self.gd["g_vals"] * e0[self._yc])
        np.add.at(b0, self._yr, self.gd["b_vals"] * e0[self._yc])
        return np.concatenate([
            e0, f0, a0, b0, e0 + a0, e0 - a0, f0 + b0, f0 - b0,
            np.ones(B), a0 ** 2 + b0 ** 2,
        ])

    def start_dense(self):
        return np.full(self.ng, 1.2 * self.gd["p_load"].sum() / self.ng)

    def _build_jac_structure(self):
        """Static triplets of the constraint Jacobian w.r.t. sparse vars
        (segment layout must match jac_vals_sparse)."""
        B = self.B
        o = self._off()
        yr, yc = self._yr, self._yc
        seg_rows, seg_cols = [], []
        # Ia rows 0..B: d/da = I, d/de = -G, d/df = +B
        seg_rows += [np.arange(B), yr, yr]
        seg_cols += [o["a"] + np.arange(B), o["e"] + yc, o["f"] + yc]
        # Ib rows B..2B: d/db = I, d/df = -G, d/de = -B
        seg_rows += [B + np.arange(B), B + yr, B + yr]
        seg_cols += [o["b"] + np.arange(B), o["f"] + yc, o["e"] + yc]
        # aux defs rows 2B..6B (3 entries each)
        for k, (aux, base) in enumerate([("p1", "e"), ("m1", "e"), ("p2", "f"), ("m2", "f")]):
            r = (2 + k) * B + np.arange(B)
            seg_rows += [r, r, r]
            seg_cols += [o[aux] + np.arange(B), o[base] + np.arange(B),
                         o["a" if k < 2 else "b"] + np.arange(B)]
        # Pbal rows 6B..7B: d/dp1, d/dm1, d/dp2, d/dm2
        r = 6 * B + np.arange(B)
        seg_rows += [r, r, r, r]
        seg_cols += [o["p1"] + np.arange(B), o["m1"] + np.arange(B),
                     o["p2"] + np.arange(B), o["m2"] + np.arange(B)]
        # vdef rows 7B..8B: d/dv = 1, d/de = -2e, d/df = -2f
        r = 7 * B + np.arange(B)
        seg_rows += [r, r, r]
        seg_cols += [o["v"] + np.arange(B), o["e"] + np.arange(B), o["f"] + np.arange(B)]
        # wdef rows 8B..9B
        r = 8 * B + np.arange(B)
        seg_rows += [r, r, r]
        seg_cols += [o["w"] + np.arange(B), o["a"] + np.arange(B), o["b"] + np.arange(B)]
        self._jr = np.concatenate(seg_rows)
        self._jc = np.concatenate(seg_cols)

    def jac_vals_sparse(self, z):
        """Values aligned with the segment layout of _build_jac_structure."""
        t = self.t(z)
        gv, bv = t["gv"], t["bv"]
        B = self.B
        e, f, a, b, p1, m1, p2, m2, v, w = self.split(z)
        one = torch.ones(B, dtype=z.dtype, device=z.device)
        vals = [
            one, -gv, bv,                             # Ia
            one, -gv, -bv,                            # Ib
            one, -one, -one,                          # p1 = e + a
            one, -one, +one,                          # m1 = e - a
            one, -one, -one,                          # p2 = f + b
            one, -one, +one,                          # m2 = f - b
            0.5 * p1, -0.5 * m1, 0.5 * p2, -0.5 * m2,  # Pbal
            one, -2.0 * e, -2.0 * f,                  # vdef
            one, -2.0 * a, -2.0 * b,                  # wdef
        ]
        return torch.cat(vals)

    def hess_diag_sparse(self, z, obj_factor, lam):
        """Diagonal of the Lagrangian Hessian w.r.t. sparse vars."""
        B = self.B
        gd = self.gd
        lp = lam[6 * B:7 * B]
        lv = lam[7 * B:8 * B]
        lw = lam[8 * B:9 * B]
        zero = torch.zeros(B, dtype=z.dtype, device=z.device)
        rv = obj_factor * gd["rho_v"]
        return torch.cat([
            rv - 2.0 * lv,        # e
            rv - 2.0 * lv,        # f
            -2.0 * lw,            # a
            -2.0 * lw,            # b
            0.5 * lp,             # p1
            -0.5 * lp,            # m1
            0.5 * lp,             # p2
            -0.5 * lp,            # m2
            zero,                 # v (bounds only)
            obj_factor * gd["rho_w2"] * torch.ones(B, dtype=z.dtype, device=z.device),  # w
        ])


class AcopfMds(MdsProblem):
    """MDS formulation: sparse network state + dense dispatch block."""

    jittable = True
    jac_constant = False

    def __init__(self, n_bus: int = 32, seed: int = 0):
        self.core = c = _AcopfCore(n_bus, seed)
        self.n_sp, self.nd, self.m = c.n_sp, c.ng, c.m

    def get_prob_sizes(self):
        return self.n_sp + self.nd, self.m

    def get_sparse_dense_blocks_info(self):
        return self.n_sp, self.nd

    def get_vars_info(self):
        xl, xu = self.core.var_bounds_sparse()
        gl = np.zeros(self.nd)
        gu = np.asarray(self.core.gd["g_max"])
        return np.concatenate([xl, gl]), np.concatenate([xu, gu])

    def get_cons_info(self):
        return self.core.cons_bounds()

    def get_starting_point(self):
        return np.concatenate([self.core.start_sparse(), self.core.start_dense()])

    def _split(self, x):
        return x[: self.n_sp], x[self.n_sp:]

    def eval_f(self, x):
        z, g = self._split(x)
        return self.core.obj_sparse(z) + self.core.obj_dense(g)

    def eval_grad_f(self, x):
        z, g = self._split(x)
        return torch.cat([self.core.grad_sparse(z), self.core.grad_dense(g)])

    def eval_cons(self, x):
        z, g = self._split(x)
        return self.core.cons_all(z, g)

    def jac_sparse_structure(self):
        return self.core._jr, self.core._jc

    def eval_jac_blocks(self, x):
        z, _ = self._split(x)
        B = self.core.B
        dense = torch.zeros((self.m, self.nd), dtype=x.dtype, device=x.device)
        dense[6 * B:7 * B, :] = self.core.t(x)["alpha"]
        return self.core.jac_vals_sparse(z), dense

    def eval_hess_blocks(self, x, obj_factor, lam):
        z, _ = self._split(x)
        hss = self.core.hess_diag_sparse(z, obj_factor, lam)
        hdd = obj_factor * self.core.t(x)["Q"]
        return hss, hdd


class AcopfSparse(SparseProblem):
    """The same NLP through the fully sparse interface (generators appended
    to the sparse variables), the cross-check twin of :class:`AcopfMds`.
    The Jacobian is the sparse block's triplets followed by the dense
    participation block's as triplets on the Pbal rows; the Hessian's upper
    triangle is the sparse diagonal followed by the dense cost block Q's
    upper triangle."""

    jittable = True

    def __init__(self, n_bus: int = 32, seed: int = 0):
        self.core = c = _AcopfCore(n_bus, seed)
        self.n = c.n_sp + c.ng
        self.m = c.m
        B, ng = c.B, c.ng
        ar = 6 * B + np.repeat(np.arange(B), ng)
        ac = c.n_sp + np.tile(np.arange(ng), B)
        self._jr = np.concatenate([c._jr, ar])
        self._jc = np.concatenate([c._jc, ac])
        qr, qc = np.triu_indices(ng)
        self._hr = np.concatenate([np.arange(c.n_sp), c.n_sp + qr])
        self._hc = np.concatenate([np.arange(c.n_sp), c.n_sp + qc])
        self._data = DeviceCache(
            q_ut=np.asarray(c.gd["cost_Q"])[qr, qc],
            alpha_flat=np.ravel(c.gd["alpha"]),
        )

    def get_prob_sizes(self):
        return self.n, self.m

    def get_sparse_blocks_info(self):
        return self.n, self._jr.size, self._hr.size

    def get_vars_info(self):
        xl, xu = self.core.var_bounds_sparse()
        return (
            np.concatenate([xl, np.zeros(self.core.ng)]),
            np.concatenate([xu, np.asarray(self.core.gd["g_max"])]),
        )

    def get_cons_info(self):
        return self.core.cons_bounds()

    def get_starting_point(self):
        return np.concatenate([self.core.start_sparse(), self.core.start_dense()])

    def eval_f(self, x):
        c = self.core
        return c.obj_sparse(x[: c.n_sp]) + c.obj_dense(x[c.n_sp:])

    def eval_grad_f(self, x):
        c = self.core
        return torch.cat([c.grad_sparse(x[: c.n_sp]), c.grad_dense(x[c.n_sp:])])

    def eval_cons(self, x):
        c = self.core
        return c.cons_all(x[: c.n_sp], x[c.n_sp:])

    def jac_structure(self):
        return self._jr, self._jc

    def eval_jac_vals(self, x):
        c = self.core
        return torch.cat([c.jac_vals_sparse(x[: c.n_sp]), self._data.on(x.device)["alpha_flat"]])

    def hess_structure(self):
        return self._hr, self._hc

    def eval_hess_vals(self, x, obj_factor, lam):
        c = self.core
        hd = c.hess_diag_sparse(x[: c.n_sp], obj_factor, lam)
        return torch.cat([hd, obj_factor * self._data.on(x.device)["q_ut"]])


#: the JAX package's production setting for this example (bench_subs.py:70-75):
#: the fused whole solve (jit_mode=solve) with the f32 device LDL^T of the
#: saddle, f64 refinement and the adaptive mixed-precision schedule
PRODUCTION_OPTIONS = dict(jit_mode="solve", kkt_fact_dtype="float32",
                          linear_solver_dense="ldl_nopiv", mp_schedule="adaptive")


def acopf_options(**opts) -> NlpOptions:
    """The example's options, updated with ``opts``."""
    o = NlpOptions()
    o.update(
        Hessian="analytical_exact",
        fixed_var="relax",
        tolerance=1e-6,
        mu0=0.1,
    )
    o.update(**opts)
    return o


def solve(n_bus: int = 32, seed: int = 0, sparse: bool = False, **opts):
    """``sparse=True`` solves :class:`AcopfSparse` under ``NlpSparse``
    (from B=64 on, n + m >= 2000: the host sparse-direct KKT)."""
    o = acopf_options(**opts)
    if sparse:
        nlp = NlpSparse(AcopfSparse(n_bus, seed), o)
    else:
        nlp = NlpMDS(AcopfMds(n_bus, seed), o)
    return FilterIPMNewton(nlp).run()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")]
    n_bus = int(pos[0]) if pos else 32
    extra = dict(compute_mode="cpu") if "-cpu" in argv else {}
    if "-production" in argv:
        # the fused whole solve in bench_subs.py's options
        extra.update(PRODUCTION_OPTIONS)
    r = solve(n_bus, sparse="-sparse" in argv, **extra)
    print(f"Objective: {r.obj:.12e} status {r.status.name} iters {r.iterations}")
    if "-selfcheck" in argv:
        if not r.status.is_success:
            print(f"selfcheck FAILED: status {r.status.name}")
            return 1
        if n_bus not in SELFCHECK:
            print(f"selfcheck: no saved objective for B={n_bus}")
            return 1
        ref, tol = SELFCHECK[n_bus]
        if abs(r.obj - ref) > tol * max(1.0, abs(ref)):
            print(f"selfcheck FAILED: obj {r.obj} vs saved {ref}")
            return 1
        print("selfcheck OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
