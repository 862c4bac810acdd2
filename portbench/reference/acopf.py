"""Plain NumPy reference of the synthetic ACOPF: its grid, its line outages,
its equations, and the first-order certificate that judges a solver's
answer.

FROZEN. This is a copy, made once and never to follow later edits of the
program, of ``hiop_tpu_torch/examples/acopf_mds.py``: ``build_grid``
(lines 76-122), ``_grid_y_values`` (lines 56-73), the MDS formulation's
objective, constraints, bounds and Jacobian (``_AcopfCore``, lines
125-324) and ``contingency_lines`` (lines 549-552). It imports nothing of
the program, of JAX, or of the JAX package, and takes nothing the program
made: the benchmark gives it the same inputs it gives the program (the grid
seed, each snapshot's loads, each lane's outaged line) and the program's
answers, which it only judges.

The formulation (B buses, ng generators; sparse variables
z = [e, f, a, b, p1, m1, p2, m2, v, w], each of length B, then g)::

  min  rho_v/2 sum((e-1)^2 + f^2) + rho_w sum(w) + rho_w2/2 sum(w^2)
       + g'Qg/2 + c'g
  s.t. a - G e + Bm f = 0,  b - G f - Bm e = 0
       p1 = e+a, m1 = e-a, p2 = f+b, m2 = f-b
       (p1^2 - m1^2 + p2^2 - m2^2)/4 + alpha g = Pload
       v = e^2 + f^2,  w = a^2 + b^2
       0.81 <= v <= 1.21, 0 <= w <= Imax^2, 0 <= g <= gmax, f_0 = 0

A solver that reports a solution hands its primal point x and the
equality multipliers y. With HiOp's sign convention (grad f + J'y - zl +
zu = 0) the certificate's numbers are:

- ``feas``: the largest violation of a constraint or a bound at x;
- ``stat``: the dual residual max|grad f + J'y| over the variables that
  have no bound (e, a, b, p1, m1, p2, m2 and f but f_0), where no bound
  multiplier enters: nought where (x, y) is stationary;
- ``comp``: over the variables that have a bound (v, w, the dispatch g
  and f_0), the residual r = grad f + J'y is what the bound multipliers
  have to take up (r = zl - zu, zl, zu >= 0). Split it the least way
  (zl = max(r, 0), zu = max(-r, 0)) and take the largest complementarity
  product zl (x - l) + zu (u - x): nought at a KKT point, large where a
  multiplier pushes away from a bound that is not active (a dispatch that
  is not optimal) or has the wrong sign at one that is;
- ``obj_gap``: the gap between the objective the solver reports and f(x),
  relative to max(1, |f(x)|).
"""

from __future__ import annotations

import numpy as np

RHO_V, RHO_W, RHO_W2, I_MAX2 = 5.0, 0.05, 0.01, 9.0
V_LO, V_HI = 0.81, 1.21


def grid_y_values(n_bus, edges, line_y, order, mask=None):
    """(g_vals, b_vals) on the grid's fixed pattern (lexsort ``order``),
    with the lines where ``mask`` is False taken out."""
    diag_g = np.full(n_bus, 0.01)
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


def build_grid(n_bus: int, seed: int = 0) -> dict:
    """Ring plus chords: admittance pattern and values, loads, the dense
    participation matrix, generator limits and costs."""
    rng = np.random.default_rng(seed)
    edges = [(i, (i + 1) % n_bus) for i in range(n_bus)]
    if n_bus >= 8:
        for i in range(0, n_bus // 2, 4):
            edges.append((i, i + n_bus // 2))
    line_y = []
    for k in range(len(edges)):
        r = (0.01 if k < n_bus else 0.02) * (1.0 + 0.2 * rng.random())
        x = (0.10 if k < n_bus else 0.20) * (1.0 + 0.2 * rng.random())
        line_y.append(1.0 / complex(r, x))
    ii = [e for i, j in edges for e in (i, j)]
    jj = [e for i, j in edges for e in (j, i)]
    rows = np.concatenate([np.arange(n_bus), np.asarray(ii)])
    cols = np.concatenate([np.arange(n_bus), np.asarray(jj)])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    g_vals, b_vals = grid_y_values(n_bus, edges, line_y, order)
    p_load = rng.uniform(0.05, 0.30, n_bus)
    ng = max(4, n_bus // 5)
    homes = (np.arange(ng) * n_bus) // ng
    dist = np.abs(np.arange(n_bus)[:, None] - homes[None, :])
    dist = np.minimum(dist, n_bus - dist)
    tau = max(2.0, n_bus / (2.0 * ng))
    alpha = np.exp(-dist / tau) * rng.uniform(0.8, 1.2, (n_bus, ng))
    alpha /= alpha.sum(axis=0, keepdims=True)
    g_max = np.full(ng, 3.0 * p_load.sum() / ng)
    cost_c = rng.uniform(1.0, 3.0, ng)
    d = rng.uniform(0.5, 1.5, ng)
    u = rng.uniform(0.1, 0.5, ng)
    cost_Q = np.diag(d) + np.outer(u, u)
    return dict(n_bus=n_bus, ng=ng, rows=rows, cols=cols, g_vals=g_vals, b_vals=b_vals,
                p_load=p_load, alpha=alpha, g_max=g_max, cost_c=cost_c, cost_Q=cost_Q,
                edges=edges, line_y=line_y, order=order)


def contingency_lines(n_bus: int, n_cont: int) -> list:
    """The basecase (-1) and n_cont - 1 ring-line outages spread around the
    ring."""
    return [-1] + [(i * n_bus) // max(n_cont - 1, 1) for i in range(n_cont - 1)]


def outage_y_values(grid: dict, line: int):
    """The admittance values with ``line`` out (-1: none, the basecase)."""
    mask = np.ones(len(grid["edges"]), dtype=bool)
    if line >= 0:
        mask[line] = False
    return grid_y_values(grid["n_bus"], grid["edges"], grid["line_y"], grid["order"], mask)


class Acopf:
    """One member of the family: the grid at a load snapshot, with one
    line out or none."""

    def __init__(self, grid: dict, p_load: np.ndarray, line: int = -1):
        self.B, self.ng = grid["n_bus"], grid["ng"]
        self.rows, self.cols = grid["rows"], grid["cols"]
        self.gv, self.bv = outage_y_values(grid, line)
        self.alpha, self.Q, self.c = grid["alpha"], grid["cost_Q"], grid["cost_c"]
        self.p_load = np.asarray(p_load, dtype=np.float64)
        B = self.B
        self.n, self.m = 10 * B + self.ng, 9 * B
        self.xl = np.full(self.n, -np.inf)
        self.xu = np.full(self.n, np.inf)
        self.xl[8 * B:9 * B], self.xu[8 * B:9 * B] = V_LO, V_HI
        self.xl[9 * B:10 * B], self.xu[9 * B:10 * B] = 0.0, I_MAX2
        self.xl[B] = self.xu[B] = 0.0                       # f_0, the reference bus
        self.xl[10 * B:], self.xu[10 * B:] = 0.0, grid["g_max"]

    def _y(self, vals, x):
        return np.bincount(self.rows, vals * x[self.cols], minlength=self.B)

    def _yt(self, vals, y):
        return np.bincount(self.cols, vals * y[self.rows], minlength=self.B)

    def split(self, x):
        B = self.B
        return [x[i * B:(i + 1) * B] for i in range(10)] + [x[10 * B:]]

    def objective(self, x) -> float:
        e, f, a, b, p1, m1, p2, m2, v, w, g = self.split(x)
        return float(0.5 * RHO_V * np.sum((e - 1.0) ** 2 + f ** 2) + RHO_W * np.sum(w)
                     + 0.5 * RHO_W2 * np.sum(w ** 2) + 0.5 * g @ (self.Q @ g) + self.c @ g)

    def gradient(self, x):
        e, f, a, b, p1, m1, p2, m2, v, w, g = self.split(x)
        z = np.zeros(self.B)
        return np.concatenate([RHO_V * (e - 1.0), RHO_V * f, z, z, z, z, z, z, z,
                               RHO_W + RHO_W2 * w, self.Q @ g + self.c])

    def constraints(self, x):
        """c(x) - rhs, all 9B rows (every row an equality)."""
        e, f, a, b, p1, m1, p2, m2, v, w, g = self.split(x)
        G, Bm = self.gv, self.bv
        return np.concatenate([
            a - self._y(G, e) + self._y(Bm, f),
            b - self._y(G, f) - self._y(Bm, e),
            p1 - e - a, m1 - e + a, p2 - f - b, m2 - f + b,
            0.25 * (p1 ** 2 - m1 ** 2 + p2 ** 2 - m2 ** 2) + self.alpha @ g - self.p_load,
            v - e ** 2 - f ** 2,
            w - a ** 2 - b ** 2,
        ])

    def jac_t(self, x, y):
        """J(x)' y."""
        e, f, a, b, p1, m1, p2, m2, v, w, g = self.split(x)
        ya, yb, y1, y2, y3, y4, yp, yv, yw = [y[i * self.B:(i + 1) * self.B] for i in range(9)]
        G, Bm = self.gv, self.bv
        return np.concatenate([
            -self._yt(G, ya) - self._yt(Bm, yb) - y1 - y2 - 2.0 * e * yv,
            self._yt(Bm, ya) - self._yt(G, yb) - y3 - y4 - 2.0 * f * yv,
            ya - y1 + y2 - 2.0 * a * yw,
            yb - y3 + y4 - 2.0 * b * yw,
            y1 + 0.5 * p1 * yp, y2 - 0.5 * m1 * yp, y3 + 0.5 * p2 * yp, y4 - 0.5 * m2 * yp,
            yv, yw, self.alpha.T @ yp,
        ])

    def certificate(self, x, y, obj_reported: float) -> dict:
        """The numbers that judge the answer (x, y, reported objective)."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        bound = np.maximum(np.maximum(self.xl - x, x - self.xu), 0.0)
        feas = max(float(np.abs(self.constraints(x)).max()), float(bound.max()))
        r = self.gradient(x) + self.jac_t(x, y)
        free = np.isinf(self.xl) & np.isinf(self.xu)
        stat = float(np.abs(r)[free].max())
        zl, zu = np.maximum(r, 0.0)[~free], np.maximum(-r, 0.0)[~free]
        gap_l = np.maximum(x - self.xl, 0.0)[~free]
        gap_u = np.maximum(self.xu - x, 0.0)[~free]
        with np.errstate(invalid="ignore"):      # inf x 0: no multiplier on a bound that is not there
            prod = np.where(zl > 0, zl * gap_l, 0.0) + np.where(zu > 0, zu * gap_u, 0.0)
        comp = float(prod.max()) if np.isfinite(prod).all() else np.inf
        f = self.objective(x)
        gap = abs(float(obj_reported) - f) / max(1.0, abs(f))
        if not np.isfinite(gap):
            gap = np.inf
        return dict(feas=feas, stat=stat, comp=comp, obj_gap=gap)


def certificate(grid: dict, p_load, line: int, x, y, obj_reported: float) -> dict:
    """The certificate of one answer of the family member (p_load, line);
    ``y`` None (no multipliers handed back) fails every number but feas
    and obj_gap."""
    problem = Acopf(grid, p_load, line)
    if y is None:
        y = np.full(problem.m, np.nan)
    return problem.certificate(x, y, obj_reported)
