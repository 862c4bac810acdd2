"""Device-resident fixed-pattern sparse LDL^T refactorization.

Counterpart of ``hiop_tpu/linalg/sparse_device.py`` (the ReSolve pattern,
HiOp's src/LinAlg/ReSolve/RefactorizationSolver.hpp:74): the SYMBOLIC
analysis runs once on the host (the native up-looking LDL, native/ldl.cpp,
gives the elimination tree and the exact L pattern), then every NUMERIC
(re)factorization and triangular solve runs on the solver's device as
level-scheduled gathers and scatter-adds, so the IPM's regularization
retries (new delta values, same pattern) never round-trip to the host
beyond one read of ``(ok, n_clamped, n_neg)``.

- Columns are grouped into LEVELS by elimination-tree height (leaves
  first). Column j's left-looking updates come only from descendants of j,
  which live in strictly earlier levels, so all columns of one level
  factorize at once.
- Each level is two steps: (1) scatter-add every update product
  L[i,k] * d_k * L[j,k] into the target entries (duplicate targets summed
  by the sort-based :func:`~hiop_tpu_torch.linalg.vector_ops.scatter_add_`,
  so two runs give the same bits); (2) clamp the level's pivots d_j and
  scale the level's columns.
- The triangular solves follow the same levels (forward leaves to root,
  backward root to leaves; column j's below-diagonal rows are ancestors of
  j in the elimination tree).

The factor lives in one combined vector ``S = [Lx | d]`` (lnz + n
entries): the host maps every assembler entry, every update target and
every operand to a position in it, so the off-diagonal and diagonal
updates of a level are one scatter-add and every index is in range (the
reference parks wrong-kind entries at an out-of-range index and drops
them). No numerical pivoting, as in the reference's cusolverRf and
MAGMA-nopiv paths: a pivot below ``sqrt(eps) * max(max|v|, 1)`` is
clamped to that size with its sign (the SuperLU_DIST static-pivoting
discipline), counted in ``n_clamped``; inertia comes from the pivot signs
(Sylvester), the MA57 contract (hiopLinSolverSymSparseMA57.hpp:109).

The reference compiles each of the numeric factorization and the solve into
one XLA program. Run eagerly, a level costs a few dozen launches, so on a
CUDA device :meth:`DeviceSparseLDL.get_numeric` and
:meth:`DeviceSparseLDL.get_solve` capture them in CUDA graphs (one per
factor dtype) at their first call and replay those; on the CPU they run
eagerly. A capture that fails raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from hiop_tpu_torch.linalg.vector_ops import scatter_add_


class DeviceLdlFactors(NamedTuple):
    Lx: torch.Tensor         # (lnz,) scaled unit-lower factor values
    d: torch.Tensor          # (n,) pivots
    n_neg: torch.Tensor      # 0-dim int64: negative pivots
    ok: torch.Tensor         # 0-dim bool: finite factorization
    n_clamped: torch.Tensor  # 0-dim int64: pivots statically clamped to
    #                          +/-tau; when nonzero the inertia count is
    #                          unreliable and the factors approximate A + E
    #                          (certify solves by IR)


def read_factor_stats(f: DeviceLdlFactors):
    """``(ok, n_clamped, n_neg)`` as Python values, in one host read."""
    ok, n_clamped, n_neg = torch.stack([f.ok.to(torch.int64), f.n_clamped, f.n_neg]).tolist()
    return bool(ok), n_clamped, n_neg


class _Program(NamedTuple):
    """The static index program of one pattern on one device. Every index
    tensor is sorted by level; level L takes entries [b[L], b[L + 1]) of
    its bounds ``b`` (three per op in ``gather``)."""
    e_pos: torch.Tensor   # assembler entry -> position in S = [Lx | d]
    gather: torch.Tensor  # per op: positions of L[i,k] (or L[j,k]), d_k, L[j,k]
    tgt: torch.Tensor     # per op: the updated position
    op_b: list
    cols: torch.Tensor    # the pivots' positions in S
    c_b: list
    epos: torch.Tensor    # the L entries' positions
    eloc: torch.Tensor    # each L entry's column, as an index into its level's pivots
    ecol: torch.Tensor    # each L entry's column
    erow: torch.Tensor    # each L entry's row
    e_b: list
    perm: object          # new -> old (or None)
    rank: object          # old -> new (or None)


class DeviceSparseLDL:
    """Symbolic-once / device-numeric-per-retry sparse LDL^T.

    Parameters
    ----------
    rows, cols : assembler COO coordinates (duplicates allowed, summed) of
        the FULL symmetric matrix (both triangles or mixed; mirrored
        entries collapse onto the lower triangle).
    n : dimension.
    ordering : 'amd' (default: fill-reducing; safe without pivoting because
        the IPM's regularized KKT systems are quasi-definite, hence
        strongly factorizable under any symmetric permutation
        [Vanderbei]), 'rcm', or 'none' (natural order).
    max_ops : guard on the scalar-update count (the flop count of the
        factorization); patterns denser than this raise ValueError so that
        callers fall back to a host backend instead of building a
        multi-GB index program.
    max_lnz : guard on the symbolic fill.
    perm : an explicit symmetric permutation (new -> old) instead of
        ``ordering``.
    weights : per-entry symmetrization weights declared by the caller.
    device : where the numeric factorization and the solves run; None means
        ``cuda:0`` (raising when no CUDA device is visible).
    """

    def __init__(self, rows, cols, n: int, ordering: str = "amd",
                 max_ops: int = 30_000_000, max_lnz: int = 30_000_000,
                 perm=None, weights=None, device=None):
        from hiop_tpu_torch.backends.execspace import resolve_device

        self.device = resolve_device("auto") if device is None else torch.device(device)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        self.n = int(n)
        n = self.n
        if weights is not None:
            weights = np.asarray(weights, np.float64)
            assert weights.shape == rows.shape

        # ---- fill-reducing permutation -----------------------------------
        self._perm = None
        if perm is not None:
            perm = np.asarray(perm, np.int64)
        elif ordering not in ("none", None):
            import scipy.sparse as _sp

            from hiop_tpu_torch.native import amd_ordering, rcm_ordering

            S = _sp.coo_matrix(
                (np.ones(rows.size), (rows, cols)), shape=(n, n)
            ).tocsr()
            fn = amd_ordering if ordering == "amd" else rcm_ordering
            perm = np.asarray(
                fn(n, np.asarray(S.indptr, np.int64), np.asarray(S.indices, np.int64)),
                np.int64,
            )
        if perm is not None:
            rank = np.empty(n, np.int64)
            rank[perm] = np.arange(n)
            rows = rank[rows]
            cols = rank[cols]
            self._perm = perm
            self._rank = rank

        # ---- collapse the assembler COO onto the lower triangle ----------
        # orientation-aware symmetrization: an off-diagonal entry whose
        # OPPOSITE orientation is also listed (assemblers emit Jc and Jc^T,
        # H upper + strict-lower mirror, ...) contributes with weight 1/2, so
        # that the mirrored pair sums back to the full value, while a
        # lone-orientation entry (the condensed path's lower-only J^T D J
        # product triplets) contributes with weight 1. True duplicates at one
        # (i, j) still sum. This stays correct under the fill-reducing
        # permutation, which can flip an entry's triangle. The weights may
        # also be declared by the caller (overlapping patterns, such as the
        # condensed union of mirrored H and lower-only J^T D J triplets,
        # defeat the orientation heuristic).
        self._nnz_in = rows.size
        if weights is not None:
            self._e_w = weights
        else:
            is_diag = rows == cols
            okeys = np.unique(rows * (n + 1) + cols)
            rev = cols * (n + 1) + rows
            pos = np.searchsorted(okeys, rev)
            pos = np.minimum(pos, okeys.size - 1)
            has_mirror = (okeys[pos] == rev) & ~is_diag
            self._e_w = np.where(has_mirror, 0.5, 1.0)
        lr = np.maximum(rows, cols)
        lc = np.minimum(rows, cols)

        # unique lower-triangle pattern (CSC by column then row)
        keys = lc * (n + 1) + lr
        uniq, inv = np.unique(keys, return_inverse=True)
        u_cols = (uniq // (n + 1)).astype(np.int64)
        u_rows = (uniq % (n + 1)).astype(np.int64)
        diag_mask = u_rows == u_cols
        if int(diag_mask.sum()) != n:
            raise ValueError("pattern must contain every diagonal entry")

        # ---- host symbolic via the native up-looking LDL -----------------
        import scipy.sparse as sp

        from hiop_tpu_torch.native import ldl as _nldl

        lib = _nldl._try_load()
        if lib is None:
            raise RuntimeError("native LDL library unavailable")
        # upper-triangle CSC pattern for ldl_symbolic
        A_lo = sp.coo_matrix(
            (np.ones(uniq.size), (u_rows, u_cols)), shape=(n, n)
        ).tocsc()
        U = sp.triu(A_lo.T).tocsc()
        Ap = np.ascontiguousarray(U.indptr, np.int64)
        Ai = np.ascontiguousarray(U.indices, np.int64)
        parent = np.empty(n, np.int64)
        Lnz = np.empty(n, np.int64)
        Lp = np.empty(n + 1, np.int64)
        flag = np.empty(n, np.int64)
        lnz = lib.ldl_symbolic(n, Ap, Ai, parent, Lnz, Lp, flag)
        if lnz < 0:
            raise ValueError("invalid pattern")
        if lnz > max_lnz:
            raise ValueError(
                f"symbolic fill lnz={lnz} exceeds max_lnz={max_lnz} "
                f"(ordering={ordering!r})"
            )
        self.lnz = int(lnz)
        # the update-op guard needs only the column counts: checked before
        # the surrogate numeric, which costs O(update ops) on the host
        deg = np.diff(Lp).astype(np.int64)
        total_pairs = int((deg * (deg + 1) // 2).sum())
        if total_pairs > max_ops:
            raise ValueError(
                f"update-op count {total_pairs} exceeds max_ops={max_ops}"
            )
        self.n_update_ops = total_pairs
        # surrogate numeric (diagonally dominant, so it completes without
        # pivoting) to materialize the row indices Li of the L pattern
        Ax = np.full(Ai.size, 1e-3)
        Ax[Ai == np.repeat(np.arange(n), np.diff(Ap))] = float(n)
        Li = np.empty(self.lnz, np.int64)
        Lx = np.empty(self.lnz, np.float64)
        D = np.empty(n, np.float64)
        npos = ctypes.c_int64()
        nneg = ctypes.c_int64()
        nzero = ctypes.c_int64()
        pattern = np.empty(n, np.int64)
        lnz_cnt = np.empty(n, np.int64)
        Y = np.empty(n, np.float64)
        bad = lib.ldl_numeric(
            n, Ap, Ai, Ax, Lp, parent, Li, Lx, D, 0.0,
            ctypes.byref(npos), ctypes.byref(nneg), ctypes.byref(nzero),
            flag, pattern, lnz_cnt, Y,
        )
        assert bad < 0, "surrogate numeric hit a zero pivot"
        self.Lp, self.Li, self.parent = Lp, Li, parent

        # ---- levels: etree height, leaves first --------------------------
        lvl = np.zeros(n, np.int64)
        for j in range(n):
            p = parent[j]
            if p >= 0 and lvl[p] < lvl[j] + 1:
                lvl[p] = lvl[j] + 1
        self.n_levels = int(lvl.max()) + 1 if n else 0

        # ---- A-entry -> L-slot map (strictly lower vs diagonal) ----------
        col_of = np.repeat(np.arange(n), np.diff(Lp))
        l_keys = Li * (n + 1) + col_of  # key by (row, col), as the uniq keys
        order = np.argsort(l_keys)
        sl_keys = l_keys[order]
        off_mask = ~diag_mask
        off_keys = u_rows[off_mask] * (n + 1) + u_cols[off_mask]
        pos_in_sorted = np.searchsorted(sl_keys, off_keys)
        if not (
            pos_in_sorted.size == 0
            or (
                (pos_in_sorted < sl_keys.size).all()
                and np.array_equal(sl_keys[pos_in_sorted], off_keys)
            )
        ):
            raise ValueError("pattern entry missing from the symbolic L")
        slot_to_lpos = np.full(uniq.size, -1, np.int64)
        slot_to_lpos[off_mask] = order[pos_in_sorted]
        # assembler entry -> position in S = [Lx | d]
        e_is_diag = diag_mask[inv]
        self._e_pos = np.where(e_is_diag, self.lnz + u_cols[inv], slot_to_lpos[inv])

        # ---- update-op program -------------------------------------------
        # every (a <= b) local index pair of each column
        sq = deg * deg
        cum = np.concatenate([[0], np.cumsum(sq)])
        op_col = np.repeat(np.arange(n), sq)
        local = np.arange(int(cum[-1])) - cum[op_col]
        a = local // np.maximum(deg[op_col], 1)
        b = local % np.maximum(deg[op_col], 1)
        keep = a <= b
        op_col = op_col[keep]
        a = a[keep]
        b = b[keep]
        # the native up-looking LDL emits each column's rows in etree-
        # topological order, NOT sorted by row index: decide the target
        # (row i, col j) = (max, min) of the two row values explicitly
        pa = Lp[op_col] + a
        pb = Lp[op_col] + b
        ra, rb = Li[pa], Li[pb]
        a_is_j = ra <= rb
        p_jk = np.where(a_is_j, pa, pb)            # L[j,k] position
        p_ik = np.where(a_is_j, pb, pa)            # L[i,k] position
        j_t = np.minimum(ra, rb)                   # target column j
        i_t = np.maximum(ra, rb)                   # target row i
        is_diag_op = a == b
        off = ~is_diag_op
        t_keys = i_t[off] * (n + 1) + j_t[off]
        t_sorted = np.searchsorted(sl_keys, t_keys)
        assert t_keys.size == 0 or np.array_equal(sl_keys[t_sorted], t_keys), (
            "fill pattern closure violated"
        )
        # an off-diagonal op subtracts L[i,k] d_k L[j,k] from L[i,j]; a
        # diagonal one L[j,k] d_k L[j,k] from d_j: both as S[pa] * (S[pk] *
        # S[pb]) into S[target]
        tgt = np.empty(op_col.size, np.int64)
        tgt[off] = order[t_sorted]
        tgt[is_diag_op] = self.lnz + j_t[is_diag_op]
        p_a = np.where(off, p_ik, p_jk)
        op_level = lvl[j_t]
        # per level (exact sizes; the levels run in order): the off-diagonal
        # ops then the diagonal ones, each in op order, as the reference
        # scatters them; the columns and the L entries of each level in
        # ascending order. Each kind of index is one device tensor, sorted
        # by level, and a level takes slices of it.
        levels = np.arange(self.n_levels + 1)
        by_level = np.lexsort((is_diag_op, op_level))
        op_b = np.searchsorted(op_level[by_level], levels)
        c_order = np.argsort(lvl, kind="stable")
        c_b = np.searchsorted(lvl[c_order], levels)
        e_order = np.argsort(lvl[col_of], kind="stable")
        e_b = np.searchsorted(lvl[col_of][e_order], levels)
        pos_in_level = np.empty(n, np.int64)
        pos_in_level[c_order] = np.arange(n) - c_b[lvl[c_order]]
        ecol = col_of[e_order]
        gather = np.concatenate([
            np.stack([p_a[sel], self.lnz + op_col[sel], p_jk[sel]]).reshape(-1)
            for sel in (by_level[op_b[L]:op_b[L + 1]] for L in range(self.n_levels))
        ]) if self.n_levels else np.zeros(0, np.int64)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64, device=self.device)

        self._prog = _Program(
            e_pos=t(self._e_pos), gather=t(gather), tgt=t(tgt[by_level]), op_b=op_b.tolist(),
            cols=t(self.lnz + c_order), c_b=c_b.tolist(),
            epos=t(e_order), eloc=t(pos_in_level[ecol]), ecol=t(ecol), erow=t(Li[e_order]),
            e_b=e_b.tolist(),
            perm=t(self._perm) if self._perm is not None else None,
            rank=t(self._rank) if self._perm is not None else None,
        )
        # the symmetrization weights by factor dtype, on the device before
        # any capture (a host copy cannot run inside one)
        w64 = torch.as_tensor(self._e_w, dtype=torch.float64, device=self.device)
        self._weights = {torch.float64: w64, torch.float32: w64.to(torch.float32)}
        self._graphs = {}

    # ------------------------------------------------------------------
    def _numeric(self, coo_vals, dtype) -> DeviceLdlFactors:
        """The level-scheduled numeric factorization, run eagerly."""
        prog = self._prog
        lnz, n = self.lnz, self.n
        v = coo_vals.to(dtype) * self._weights[dtype]
        # static-pivot threshold (the SuperLU_DIST discipline): a pivot
        # smaller than tau is replaced by sign * tau instead of failing; the
        # factorization completes as LDL^T of A + E and the IR certification
        # absorbs or rejects the perturbation
        tau = math.sqrt(torch.finfo(dtype).eps) * torch.clamp(v.abs().max(), min=1.0)
        S = scatter_add_(v.new_zeros(lnz + n), prog.e_pos, v)
        n_clamped = torch.zeros((), dtype=torch.int64, device=self.device)
        for L in range(self.n_levels):
            a, b = prog.op_b[L], prog.op_b[L + 1]
            if b > a:
                g = S[prog.gather[3 * a:3 * b]].view(3, -1)
                scatter_add_(S, prog.tgt[a:b], (g[0] * (g[1] * g[2])).neg_())
            a, b = prog.c_b[L], prog.c_b[L + 1]
            cols = prog.cols[a:b]
            dl = S[cols]
            small = dl.abs() < tau
            n_clamped += small.sum()
            dl = torch.where(small, torch.where(dl < 0, -tau, tau), dl)
            S.index_put_((cols,), dl)
            a, b = prog.e_b[L], prog.e_b[L + 1]
            if b > a:
                epos = prog.epos[a:b]
                inv_d = torch.where(dl.abs() > 0, dl.reciprocal(), 0.0)
                S.index_put_((epos,), S[epos] * inv_d[prog.eloc[a:b]])
        Lx, d = S[:lnz], S[lnz:]
        ok = torch.isfinite(S).all()
        n_neg = (d < 0).sum()
        return DeviceLdlFactors(Lx, d, n_neg, ok, n_clamped)

    def _solve(self, Lx, d, b):
        """The level-scheduled triangular solves, run eagerly; ``b`` is cast
        to the factors' dtype."""
        prog = self._prog
        x = (b[prog.perm] if prog.perm is not None else b).to(Lx.dtype, copy=True)
        neg_l = Lx.neg()[prog.epos]  # the L values level by level
        levels = [(prog.e_b[L], prog.e_b[L + 1]) for L in range(self.n_levels)]
        levels = [(a, b) for a, b in levels if b > a]
        # forward: L y = b, leaves -> root
        for a, b in levels:
            scatter_add_(x, prog.erow[a:b], neg_l[a:b] * x[prog.ecol[a:b]])
        x = x * torch.where(d.abs() > 0, d.reciprocal(), 0.0)
        # backward: L^T z = y, root -> leaves
        for a, b in reversed(levels):
            scatter_add_(x, prog.ecol[a:b], neg_l[a:b] * x[prog.erow[a:b]])
        return x[prog.rank] if prog.rank is not None else x

    def _graphed(self, key, fn, args):
        """``fn(*args)`` captured in a CUDA graph over static copies of
        ``args`` (made at the first call under ``key``); each call copies its
        arguments in, replays the graph, and returns clones of its
        outputs."""
        g = self._graphs.get(key)
        if g is None:
            static = [a.clone() for a in args]
            side = torch.cuda.Stream(device=self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                fn(*static)  # the first run's lazy initialization stays out of the capture
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn(*static)
            g = self._graphs[key] = (graph, static, out)
        graph, static, out = g
        for s, a in zip(static, args):
            s.copy_(a)
        graph.replay()
        return out

    def get_numeric(self, dtype=torch.float32):
        """``numeric(coo_vals) -> DeviceLdlFactors`` for the assembler's COO
        value vector (the entry order of the (rows, cols) the symbolic
        analysis was built from): eager on the CPU, a CUDA-graph replay on a
        CUDA device (one graph per dtype)."""
        dtype = _torch_dtype(dtype)

        def numeric(coo_vals):
            v = torch.as_tensor(coo_vals, dtype=torch.float64, device=self.device)
            if self.device.type != "cuda":
                return self._numeric(v, dtype)
            f = self._graphed(("num", dtype), lambda x: self._numeric(x, dtype), (v,))
            return DeviceLdlFactors(*(t.clone() for t in f))

        return numeric

    def get_solve(self):
        """``solve(factors, b) -> x`` (the level-scheduled triangular
        solves, computed at the factors' dtype; b may be f64): eager on the
        CPU, a CUDA-graph replay on a CUDA device (one graph per factor
        dtype)."""
        def solve(f: DeviceLdlFactors, b):
            b = torch.as_tensor(b, device=self.device)
            if self.device.type != "cuda":
                return self._solve(f.Lx, f.d, b)
            key = ("solve", f.Lx.dtype, b.dtype)
            return self._graphed(key, self._solve, (f.Lx, f.d, b)).clone()

        return solve


def equilibrate(vals, rows, cols, n: int):
    """Symmetric row-max scaling s A s of a COO value vector (a congruence:
    the inertia is preserved): bounds the f32 factorization's conditioning
    under the barrier-diagonal blowup, as the saddle mp path of kkt/mds.py
    does. Returns (the scaled values, s)."""
    rmax = vals.new_zeros(n).scatter_reduce_(0, rows, vals.abs(), "amax", include_self=True)
    s = torch.where(rmax > 0, 1.0 / torch.sqrt(torch.clamp(rmax, min=1e-300)), 1.0)
    return vals * s[rows] * s[cols], s


def solve_refined(solve, factors, s, matvec, vals64, rhs, tol: float, max_ir: int = 10):
    """x ~= A^{-1} rhs refined in f64 until
    ||rhs - A x|| <= tol (||rhs|| + max|A| ||x||), at most ``max_ir`` steps,
    where ``factors`` factorize s A s (``solve`` sweeps through them) and
    ``matvec(vals64, x)`` applies A in f64. Returns (x, certified, steps).
    The reference's device while-loop as a host loop with one host read per
    test: it stops at the step the reference's condition stops at, so it
    returns the same x."""
    def approx_solve(r):
        return s * solve(factors, s * r).to(torch.float64)

    x = approx_solve(rhs)
    b_norm = torch.linalg.vector_norm(rhs)
    m_norm = vals64.abs().max()
    r = rhs - matvec(vals64, x)
    k = 0
    while True:
        rel = torch.linalg.vector_norm(r) / torch.clamp(
            b_norm + m_norm * torch.linalg.vector_norm(x), min=1e-300)
        rel, finite = torch.stack([rel, torch.isfinite(x).all().to(rel.dtype)]).tolist()
        if not (rel > tol and k < max_ir):
            break
        x = x + approx_solve(r)
        r = rhs - matvec(vals64, x)
        k += 1
    return x, bool(rel <= tol and finite), k


def _torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype, numpy scalar type or torch dtype as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "float64": torch.float64}[np.dtype(dtype).name]
