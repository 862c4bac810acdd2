// Host-side sparse symbolic utilities.
//
// Native equivalent of the reference's host-side sparse analysis phase
// (triplet handling in hiopMatrixSparseTriplet.cpp, the CSR
// symbolic/numeric split of hiopMatrixSparseCSRSeq, and the fill-reducing
// ordering selection of hiopLinSolverCholCuSparse —
// HiOp's src/LinAlg/). These run once per problem at
// construction time on the host (the TPU never sees sparse formats; the
// symbolic phase produces the static index maps that the jitted
// scatter/gather kernels close over), so C++ is the right tool — exactly
// where the reference keeps its KLU/analysis phase.
//
// Exposed as a plain C ABI for ctypes; built with:  g++ -O3 -shared -fPIC
//
// Functions:
//   coo_to_csr_index  — sort triplets row-major (stable by column),
//                       merge duplicates; returns permutation + merge map
//   csr_transpose_index — column-wise permutation for CSR^T
//   rcm_ordering      — reverse Cuthill-McKee fill-reducing ordering of a
//                       symmetric sparsity pattern
//   amd_ordering      — approximate-minimum-degree fill-reducing ordering
//                       (quotient graph + element absorption), the role of
//                       MA57's internal AMD / cuSOLVER's symamd option
//                       (linear_solver_sparse_ordering, hiopOptions.cpp)

#include <algorithm>
#include <cstdint>
#include <queue>
#include <vector>

extern "C" {

// Sort COO triplets (rows, cols) of length nnz into CSR order and merge
// duplicates. Outputs:
//   perm[nnz]      — for each sorted slot, the original triplet index
//   merge_to[nnz]  — for each sorted slot, the output (deduped) slot
//   out_rows/out_cols[<=nnz] — deduped structure
//   row_ptr[m+1]   — CSR row pointers over the deduped structure
// Returns the deduped nnz (or -1 on bad input).
int64_t coo_to_csr_index(int64_t m, int64_t /*n*/, int64_t nnz,
                         const int64_t* rows, const int64_t* cols,
                         int64_t* perm, int64_t* merge_to,
                         int64_t* out_rows, int64_t* out_cols,
                         int64_t* row_ptr) {
  std::vector<int64_t> idx(nnz);
  for (int64_t i = 0; i < nnz; ++i) idx[i] = i;
  std::stable_sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
    if (rows[a] != rows[b]) return rows[a] < rows[b];
    return cols[a] < cols[b];
  });
  int64_t out = -1;
  int64_t prev_r = -1, prev_c = -1;
  for (int64_t k = 0; k < nnz; ++k) {
    const int64_t i = idx[k];
    if (rows[i] < 0 || rows[i] >= m) return -1;
    perm[k] = i;
    if (rows[i] != prev_r || cols[i] != prev_c) {
      ++out;
      out_rows[out] = rows[i];
      out_cols[out] = cols[i];
      prev_r = rows[i];
      prev_c = cols[i];
    }
    merge_to[k] = out;
  }
  const int64_t nnz_out = out + 1;
  for (int64_t r = 0; r <= m; ++r) row_ptr[r] = 0;
  for (int64_t k = 0; k < nnz_out; ++k) row_ptr[out_rows[k] + 1]++;
  for (int64_t r = 0; r < m; ++r) row_ptr[r + 1] += row_ptr[r];
  return nnz_out;
}

// Permutation taking CSR values to CSR^T (CSC) order.
// row_ptr[m+1], cols[nnz] describe the CSR matrix with n columns.
void csr_transpose_index(int64_t m, int64_t n, int64_t nnz,
                         const int64_t* row_ptr, const int64_t* cols,
                         int64_t* t_row_ptr, int64_t* t_cols,
                         int64_t* perm) {
  std::vector<int64_t> cnt(n + 1, 0);
  for (int64_t k = 0; k < nnz; ++k) cnt[cols[k] + 1]++;
  for (int64_t c = 0; c < n; ++c) cnt[c + 1] += cnt[c];
  for (int64_t c = 0; c <= n; ++c) t_row_ptr[c] = cnt[c];
  std::vector<int64_t> next(cnt.begin(), cnt.end() - 1);
  for (int64_t r = 0; r < m; ++r) {
    for (int64_t k = row_ptr[r]; k < row_ptr[r + 1]; ++k) {
      const int64_t c = cols[k];
      const int64_t slot = next[c]++;
      t_cols[slot] = r;
      perm[slot] = k;
    }
  }
}

// Reverse Cuthill-McKee ordering of a symmetric pattern given in CSR
// (pattern of A + A^T expected). Writes the permutation (new -> old).
void rcm_ordering(int64_t n, const int64_t* row_ptr, const int64_t* cols,
                  int64_t* order) {
  std::vector<int64_t> degree(n);
  for (int64_t i = 0; i < n; ++i) degree[i] = row_ptr[i + 1] - row_ptr[i];
  std::vector<char> visited(n, 0);
  int64_t pos = 0;
  for (;;) {
    // pick the unvisited node of minimum degree as the next component seed
    int64_t seed = -1, best = INT64_MAX;
    for (int64_t i = 0; i < n; ++i)
      if (!visited[i] && degree[i] < best) { best = degree[i]; seed = i; }
    if (seed < 0) break;
    std::queue<int64_t> q;
    q.push(seed);
    visited[seed] = 1;
    while (!q.empty()) {
      const int64_t u = q.front();
      q.pop();
      order[pos++] = u;
      std::vector<int64_t> nbrs;
      for (int64_t k = row_ptr[u]; k < row_ptr[u + 1]; ++k) {
        const int64_t v = cols[k];
        if (v >= 0 && v < n && !visited[v]) {
          visited[v] = 1;
          nbrs.push_back(v);
        }
      }
      std::sort(nbrs.begin(), nbrs.end(),
                [&](int64_t a, int64_t b) { return degree[a] < degree[b]; });
      for (int64_t v : nbrs) q.push(v);
    }
  }
  // reverse for RCM
  for (int64_t i = 0; i < n / 2; ++i) std::swap(order[i], order[n - 1 - i]);
}

// Approximate minimum degree (AMD) ordering of a symmetric pattern given
// in CSR (pattern of A + A^T expected; the diagonal is ignored). Writes
// the permutation (new -> old), i.e. order[k] = original index eliminated
// at step k. Returns 0 on success.
//
// Standard quotient-graph scheme (Amestoy–Davis–Duff): eliminating pivot p
// turns it into an *element* whose member list is the union of p's
// remaining variable neighbors and the members of p's adjacent elements
// (which are absorbed). Degrees of the affected variables are updated with
// the approximate external degree
//   d(j) = |A_j \ Le| + |Le \ j| + sum_{e in E_j, e != p} |Le \ Lp|,
// where the |Le \ Lp| terms are computed in one linear pass with a stamped
// counter. Elements whose members are all inside the new element are
// absorbed aggressively. No supervariable compression: quality is
// unaffected, only speed for patterns with many duplicate rows.
int64_t amd_ordering(int64_t n, const int64_t* row_ptr, const int64_t* cols,
                     int64_t* order) {
  if (n <= 0) return 0;
  // state: 0 = live variable, 1 = element (eliminated pivot), 2 = dead
  std::vector<char> state(n, 0);
  std::vector<std::vector<int64_t>> adjvar(n), adjel(n), members(n);
  std::vector<int64_t> deg(n);
  for (int64_t i = 0; i < n; ++i) {
    auto& av = adjvar[i];
    for (int64_t k = row_ptr[i]; k < row_ptr[i + 1]; ++k) {
      const int64_t v = cols[k];
      if (v < 0 || v >= n) return -1;
      if (v != i) av.push_back(v);
    }
    std::sort(av.begin(), av.end());
    av.erase(std::unique(av.begin(), av.end()), av.end());
    deg[i] = static_cast<int64_t>(av.size());
  }

  // degree buckets (doubly linked lists)
  std::vector<int64_t> head(n + 1, -1), nxt(n, -1), prv(n, -1);
  auto bucket_insert = [&](int64_t i, int64_t d) {
    nxt[i] = head[d];
    prv[i] = -1;
    if (head[d] >= 0) prv[head[d]] = i;
    head[d] = i;
  };
  auto bucket_remove = [&](int64_t i, int64_t d) {
    if (prv[i] >= 0) nxt[prv[i]] = nxt[i]; else head[d] = nxt[i];
    if (nxt[i] >= 0) prv[nxt[i]] = prv[i];
  };
  for (int64_t i = 0; i < n; ++i) bucket_insert(i, deg[i]);

  std::vector<int64_t> vstamp(n, -1), estamp(n, -1), ew(n, 0);
  std::vector<int64_t> Le;
  int64_t mindeg = 0;

  for (int64_t k = 0; k < n; ++k) {
    while (mindeg <= n && head[mindeg] < 0) ++mindeg;
    const int64_t p = head[mindeg];
    bucket_remove(p, mindeg);
    order[k] = p;
    state[p] = 1;

    // Le = (A_p ∪ ∪_{e in E_p} members(e)) \ {p, eliminated}
    Le.clear();
    const int64_t stamp = k;
    vstamp[p] = stamp;
    for (int64_t v : adjvar[p])
      if (state[v] == 0 && vstamp[v] != stamp) { vstamp[v] = stamp; Le.push_back(v); }
    for (int64_t e : adjel[p]) {
      if (state[e] != 1) continue;  // already absorbed
      for (int64_t v : members[e])
        if (state[v] == 0 && vstamp[v] != stamp) { vstamp[v] = stamp; Le.push_back(v); }
      state[e] = 2;  // absorbed into the new element p
      members[e].clear();
      members[e].shrink_to_fit();
    }
    adjvar[p].clear();
    adjvar[p].shrink_to_fit();
    adjel[p].clear();
    adjel[p].shrink_to_fit();
    members[p] = Le;
    const int64_t le_size = static_cast<int64_t>(Le.size());

    // prune adjacency of the affected variables; |Le' \ Le| via stamping
    for (int64_t j : Le) {
      auto& av = adjvar[j];
      int64_t w = 0;
      for (int64_t v : av)
        // drop p, eliminated vars, and members of Le (covered by element p)
        if (state[v] == 0 && vstamp[v] != stamp) av[w++] = v;
      av.resize(w);
      auto& ae = adjel[j];
      w = 0;
      for (int64_t e : ae)
        if (state[e] == 1) {
          ae[w++] = e;
          if (estamp[e] != stamp) {
            estamp[e] = stamp;
            ew[e] = static_cast<int64_t>(members[e].size());
          }
          ew[e] -= 1;  // j ∈ Le ∩ Le'
        }
      ae.resize(w);
      ae.push_back(p);
    }

    // aggressive absorption: Le' ⊆ Le ⇒ element e' is redundant
    for (int64_t j : Le)
      for (int64_t e : adjel[j])
        if (e != p && state[e] == 1 && estamp[e] == stamp && ew[e] == 0) {
          state[e] = 2;
          members[e].clear();
          members[e].shrink_to_fit();
        }

    // approximate external degrees
    for (int64_t j : Le) {
      int64_t d = static_cast<int64_t>(adjvar[j].size()) + (le_size - 1);
      for (int64_t e : adjel[j])
        if (e != p && state[e] == 1) d += (estamp[e] == stamp) ? ew[e]
                                       : static_cast<int64_t>(members[e].size());
      const int64_t cap = n - k - 1;
      if (d > cap) d = cap;
      if (d < 0) d = 0;
      bucket_remove(j, deg[j]);
      deg[j] = d;
      bucket_insert(j, d);
      if (d < mindeg) mindeg = d;
    }
  }
  return 0;
}

}  // extern "C"
