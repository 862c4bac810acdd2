// Native sparse LDL^T factorization with inertia (host runtime).
//
// Plays the role of the reference's HSL MA57 backend
// (HiOp's src/LinAlg/hiopLinSolverSymSparseMA57.hpp:109): a host
// symmetric factorization of the augmented KKT system whose pivot signs
// give the inertia used by the inertia-correction acceptance test
// (hiopFactAcceptor.hpp:97). Like the reference's no-pivoting GPU paths
// (hiopLinSolverSymDenseMagmaNopiv, cuSOLVER-chol), there is no numerical
// pivoting: a zero/tiny pivot aborts the factorization and the caller's
// regularization ladder (hiopPDPerturbation) retries with larger deltas —
// the IPM's deltas make the KKT matrix quasi-definite, which is exactly
// the class for which unpivoted LDL^T is backward stable (Vanderbei).
//
// Algorithm: classic up-looking simplicial LDL^T (elimination-tree based;
// Davis, "Direct Methods for Sparse Linear Systems", ch. 4): symbolic pass
// computes the etree and per-column counts of L from the upper-triangle
// CSC pattern of A; the numeric pass solves one sparse triangular system
// per row of L. O(|L|) numeric work, symbolic once per sparsity pattern.
//
// Exposed as a plain C ABI for ctypes; built with: g++ -O3 -shared -fPIC

#include <cmath>
#include <cstdint>

extern "C" {

// Symbolic analysis of the upper-triangle CSC pattern (Ap[n+1], Ai with
// row indices i <= k per column k, diagonal entries optional).
// Outputs: parent[n] (elimination tree), Lnz[n] (count of below-diagonal
// entries per column of L), Lp[n+1] (column pointers of L).
// Returns total |L| (excluding the unit diagonal), or -1 on bad input.
int64_t ldl_symbolic(int64_t n, const int64_t* Ap, const int64_t* Ai,
                     int64_t* parent, int64_t* Lnz, int64_t* Lp,
                     int64_t* flag /* workspace[n] */) {
  for (int64_t k = 0; k < n; ++k) {
    parent[k] = -1;
    flag[k] = k;
    Lnz[k] = 0;
    for (int64_t p = Ap[k]; p < Ap[k + 1]; ++p) {
      int64_t i = Ai[p];
      if (i < 0 || i > k) return -1;  // strictly-upper storage required
      // walk from i up the etree toward the root, stopping at nodes
      // already reached for this k; each new node contributes L(k,i)
      while (flag[i] != k) {
        if (parent[i] == -1) parent[i] = k;
        Lnz[i]++;
        flag[i] = k;
        i = parent[i];
      }
    }
  }
  int64_t lnz = 0;
  for (int64_t k = 0; k < n; ++k) {
    Lp[k] = lnz;
    lnz += Lnz[k];
  }
  Lp[n] = lnz;
  return lnz;
}

// Numeric factorization. Inputs as in ldl_symbolic plus values Ax and the
// symbolic outputs. Outputs: Li/Lx (|L| entries, columns in Lp order),
// D[n], and the inertia counts (|d| <= zero_tol counts as zero).
// Returns -1 on success, or the index k of the first zero pivot.
int64_t ldl_numeric(int64_t n, const int64_t* Ap, const int64_t* Ai,
                    const double* Ax, const int64_t* Lp,
                    const int64_t* parent, int64_t* Li, double* Lx,
                    double* D, double zero_tol,
                    int64_t* n_pos, int64_t* n_neg, int64_t* n_zero,
                    int64_t* flag, int64_t* pattern, int64_t* lnz_cnt,
                    double* Y /* workspaces[n] */) {
  *n_pos = *n_neg = *n_zero = 0;
  for (int64_t k = 0; k < n; ++k) {
    Y[k] = 0.0;
    lnz_cnt[k] = 0;
  }
  for (int64_t k = 0; k < n; ++k) {
    // scatter column k of A (== row k of the lower triangle) into Y and
    // compute the pattern of row k of L as etree paths, in topological
    // order (deepest first on a stack growing down from n)
    int64_t top = n;
    flag[k] = k;
    D[k] = 0.0;
    for (int64_t p = Ap[k]; p < Ap[k + 1]; ++p) {
      const int64_t i0 = Ai[p];
      if (i0 == k) {
        D[k] += Ax[p];
        continue;
      }
      Y[i0] += Ax[p];  // += merges duplicate entries
      int64_t len = 0, i = i0;
      while (flag[i] != k) {
        pattern[len++] = i;
        flag[i] = k;
        i = parent[i];
      }
      while (len > 0) pattern[--top] = pattern[--len];
    }
    // sparse triangular solve: for each column i in the pattern of row k
    // (topological order), eliminate and update
    double dk = D[k];
    for (int64_t t = top; t < n; ++t) {
      const int64_t i = pattern[t];
      const double yi = Y[i];
      Y[i] = 0.0;
      const double l_ki = yi / D[i];
      const int64_t pend = Lp[i] + lnz_cnt[i];
      for (int64_t p = Lp[i]; p < pend; ++p) Y[Li[p]] -= Lx[p] * yi;
      dk -= l_ki * yi;
      Li[pend] = k;  // append L(k,i) to column i
      Lx[pend] = l_ki;
      lnz_cnt[i]++;
    }
    D[k] = dk;
    if (std::abs(dk) <= zero_tol || !std::isfinite(dk)) {
      *n_zero += 1;
      return k;  // singular (to working precision): caller regularizes
    }
    if (dk > 0.0) *n_pos += 1; else *n_neg += 1;
  }
  return -1;
}

// Solve L D L^T x = b in place (b[n] -> x[n]).
void ldl_solve(int64_t n, const int64_t* Lp, const int64_t* Li,
               const double* Lx, const double* D, double* b) {
  for (int64_t j = 0; j < n; ++j) {  // L z = b (unit lower, by columns)
    const double bj = b[j];
    for (int64_t p = Lp[j]; p < Lp[j + 1]; ++p) b[Li[p]] -= Lx[p] * bj;
  }
  for (int64_t j = 0; j < n; ++j) b[j] /= D[j];
  for (int64_t j = n - 1; j >= 0; --j) {  // L^T x = z
    double s = b[j];
    for (int64_t p = Lp[j]; p < Lp[j + 1]; ++p) s -= Lx[p] * b[Li[p]];
    b[j] = s;
  }
}

// Batched ldl_solve over nrhs right-hand sides stored column-major
// (B[n*nrhs], column j at B + j*n).
void ldl_solve_multi(int64_t n, int64_t nrhs, const int64_t* Lp,
                     const int64_t* Li, const double* Lx, const double* D,
                     double* B) {
  for (int64_t j = 0; j < nrhs; ++j) ldl_solve(n, Lp, Li, Lx, D, B + j * n);
}

}  // extern "C"
