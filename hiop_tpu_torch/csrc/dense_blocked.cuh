// Building blocks shared by the blocked dense factorizations (cholesky.cu,
// ldl_nopiv.cu): right-looking with delayed updates, on a row-major n x n
// working copy W whose lower triangle ends up holding the factor.
//
// The matrix is walked in outer blocks of OB = 4 NB columns.  Inside an
// outer block, each NB-wide block column k0 takes three launches:
//
//   1. diag_factor   one CTA factors the kb x kb diagonal block and builds
//                    the inverse X of its lower factor, recursively: two
//                    32-wide leaves, each factored by one warp in registers
//                    (one __syncwarp per column, no block barrier inside a
//                    leaf), joined by four small CTA-wide products;
//   2. panel         the rows below the block: P = W_panel X^T (LDL^T:
//                    scaled by the inverse pivots), a 64-deep tile product;
//   3. update        the rank-NB update of the columns of the outer block
//                    that lie right of k0 (all rows below).
//
// After the outer block, one rank-OB update A22 -= P diag(s) P^T of the
// lower triangle of everything right of it.  The rank-OB update reads and
// writes the trailing matrix once per OB columns instead of once per NB
// columns: at n = 4608 f64 a rank-64 update moves ~8 GB through HBM over
// the factorization (~2.4 ms at 3.35 TB/s), a rank-256 one a quarter.
//
// The tile products (update and panel) run, in f64, on the FP64 tensor
// cores: mma.sync m16n8k8 (DMMA), 64 x 64 output tiles per 128-thread CTA,
// K in chunks of 32 loaded with cp.async into a double-buffered, padded
// shared-memory layout in which every fragment load is free of bank
// conflicts.  f32 has no IEEE tensor-core path (TF32 is forbidden here), so
// its tile products stay on FP32 FMAs with 4 x 4 register tiles.  Updates
// launch only the tiles on or below the diagonal.  No atomics and no
// split-K: every sum is taken in a fixed order, so a factorization repeats
// bit for bit.
//
// Every kernel reads its pointers from a small device-resident Args
// struct, so that the whole launch sequence of one (n, dtype) can be
// captured once as a CUDA graph and replayed for new inputs (see
// run_graph below).  A batch of matrices of one n is one launch sequence
// over an array of Args: every kernel takes its matrix's Args by
// blockIdx.z (gridDim.z = 1 for a single matrix).
//
// Everything lives in an anonymous namespace so that each translation unit
// carries its own instantiations (the two .cu files are compiled apart and
// linked into one shared library without relocatable device code).
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace {

constexpr int NB = 64;           // block column width (any n; the last block is ragged)
constexpr int OB = 4 * NB;       // outer block: depth of the delayed trailing update
constexpr int LDS = NB + 1;      // padded row of the diagonal block in shared memory
constexpr int DIAG_THREADS = 128;
constexpr int TILE = 64;         // output tile of the tile products (TILE x TILE per CTA)
constexpr unsigned FULL = 0xffffffffu;

// pointers of one factorization, read by every kernel at its start
struct Args {
  const void* A;
  void* W;
  void* X;      // NB x NB inverse of the current diagonal block's factor
  void* d;      // LDL^T pivots (n)
  void* invd;   // inverse pivots of the current block (NB)
  int* info;    // Cholesky: set to 1 by a pivot that is not finite and positive
};

#define HIOP_RETURN_IF_LAUNCH_FAILED()           \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

#define HIOP_RETURN_IF_ERROR(call)               \
  do {                                           \
    cudaError_t e_ = (call);                     \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// W = lower triangle of A, zeros above the diagonal.
template <typename T>
__global__ void copy_lower(const Args* __restrict__ args_all, int n) {
  const Args* __restrict__ args = args_all + blockIdx.z;
  const T* A = static_cast<const T*>(args->A);
  T* W = static_cast<T*>(args->W);
  const long long total = (long long)n * n;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(idx / n), j = (int)(idx % n);
    W[idx] = (j <= i) ? A[idx] : T(0);
  }
}

// ---------------------------------------------------------------------------
// 1. The diagonal block
// ---------------------------------------------------------------------------

// One 32 x 32 leaf S[o:o+32, o:o+32] (lower triangle, updated) factored by
// the calling warp: lane r owns row r of the leaf and column r of the
// leaf's inverse in registers.  Column j: every lane scales its entry of
// column j by the pivot's inverse and publishes it, one __syncwarp, and
// every lane reads the published column once, as shared-memory broadcasts,
// for both of its rank-1 updates: its row of the leaf,
// s_r[c] -= a_r L[c][j], and its column of the inverse,
// x_r[c] -= L[c][j] X[j][r] (c > j), whose multiplier X[j][r] it holds
// itself.  (Warp shuffles would need no shared memory, but in code that
// runs for one warp of the CTA the compiler wraps each one in a collective
// sequence, and the 1024 shuffles of a leaf then cost ~20k cycles.)  The
// broadcast buffer bc (2 x 33 values) is double-buffered, so one
// __syncwarp a column is enough.
//
// What bounds a leaf is the chain from one pivot to the next, so the
// chain is kept short: the Cholesky pivot's inverse is one rsqrt (its
// square root one multiply), and lane j+1 forms and publishes its next
// diagonal from its own values, before the rank-1 updates.  The loops are
// unrolled, so registers are never indexed at run time, and the body has
// no branch that depends on the lane: lanes update entries they never
// read (above the diagonal of the leaf, below it in the inverse, where the
// multiplier is zero).  Writes L (Cholesky: positive diagonal; LDL^T: unit
// diagonal) back into S, the leaf's inverse into Xs (zeros above its
// diagonal), and the pivots and their inverses into dsm / invsm.
// Arithmetic as cholesky_plain's / ldl_nopiv_plain's _leaf.
template <typename T, bool LDL>
__device__ __noinline__ void leaf32(T* S, T* Xs, T* dsm, T* invsm, T* bc, int o) {
  const int r = threadIdx.x & 31;
  T s[32], x[32];  // row r of the leaf; column r of its inverse
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    s[c] = (c <= r) ? S[(o + r) * LDS + o + c] : T(0);
    x[c] = (c == r) ? T(1) : T(0);
  }
  if (r == 0) bc[32] = s[0];  // the first pivot
  __syncwarp();
  T my_d = T(0), my_inv = T(0);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    T* b = bc + (j & 1) * 33;        // [0, 32) column j of L, [32] pivot j
    T* bn = bc + ((j + 1) & 1) * 33;
    const T sjj = b[32];
    T piv, inv;
    if (LDL) {
      piv = T(1);
      inv = (fabs(sjj) > T(0)) ? T(1) / sjj : T(0);
    } else {
      inv = rsqrt(sjj);  // NaN for a negative pivot; the caller records it
      piv = sjj * inv;
    }
    const T l = s[j] * inv;          // L[r][j] for r > j
    const T a = LDL ? s[j] : l;      // LDL^T: d_j L[r][j], unscaled
    if (j + 1 < 32 && r == j + 1) bn[32] = fma(-a, l, s[j + 1]);
    b[r] = l;
    __syncwarp();
    // the inverse: row j times 1/L[j][j] (Cholesky), then rows c > j
    // take -L[c][j] times it
    const T xj = LDL ? x[j] : x[j] * inv;
#pragma unroll
    for (int c = j + 1; c < 32; ++c) {
      const T lc = b[c];
      s[c] = fma(-a, lc, s[c]);
      x[c] = fma(-lc, xj, x[c]);
    }
    x[j] = xj;
    s[j] = (r == j) ? piv : l;
    my_d = (r == j) ? sjj : my_d;
    my_inv = (r == j) ? inv : my_inv;
  }
  dsm[o + r] = my_d;
  invsm[o + r] = my_inv;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    if (c <= r) S[(o + r) * LDS + o + c] = s[c];
    Xs[(o + c) * LDS + o + r] = (c >= r) ? x[c] : T(0);
  }
}

// out[i][v] = sum_{j < 32} P[(prow + ri) * LDS + pcol + j] * Q(c_v, j) for
// this thread's rows ri = 2 (tid / 8) + i, i < 2, and columns
// c_v = tid % 8 + 8v, v < 4, with Q(c, j) = Q[(qrow0 + c) * LDS + qcol + j]
// or, transposed, Q[(qrow0 + j) * LDS + qcol + c] (the 32 x 32 products
// of the diagonal step; all 128 threads, 2 x 4 register tiles).
template <typename T>
__device__ __forceinline__ void prod32(const T* P, int prow, int pcol, const T* Q, int qrow0,
                                       int qcol, bool q_transposed, T out[2][4]) {
  const int ri = 2 * (threadIdx.x >> 3), c0 = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) out[i][v] = T(0);
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const T p0 = P[(prow + ri) * LDS + pcol + j], p1 = P[(prow + ri + 1) * LDS + pcol + j];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = c0 + 8 * v;
      const T q = q_transposed ? Q[(qrow0 + j) * LDS + qcol + c] : Q[(qrow0 + c) * LDS + qcol + j];
      out[0][v] = fma(p0, q, out[0][v]);
      out[1][v] = fma(p1, q, out[1][v]);
    }
  }
}

// Factor the kb x kb diagonal block W[k0:k0+kb, k0:k0+kb] (lower triangle
// read) in place, write the inverse of its lower factor to X (NB x NB,
// row-major, zeros above the diagonal), LDL^T: the pivots to d[k0 + j] and
// their inverses to invd (a zero pivot gives d = 0 and inv_d = 0, so its
// column is zeroed, as hiop_tpu's _ldl_diag_block does); Cholesky: a pivot
// that is not finite and positive sets *info.  A ragged block (kb < NB) is
// padded with identity.
//
// With L = [[L11, 0], [L21, L22]] (32-wide halves):
//   leaf(A11) -> L11, X11 = L11^-1
//   T21 = A21 X11^T;  L21 = T21 (Cholesky) or T21 D1^-1 (LDL^T)
//   A22 -= L21 T21^T (LDL^T: L21 D1 L21^T; Cholesky: L21 L21^T)
//   leaf(A22) -> L22, X22
//   X21 = -X22 (L21 X11)
template <typename T, bool LDL>
__global__ void __launch_bounds__(DIAG_THREADS)
diag_factor(const Args* __restrict__ args_all, int ld, int k0, int kb) {
  const Args* __restrict__ args = args_all + blockIdx.z;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // the block, then L
  T* Xs = S + NB * LDS;                    // the inverse; rows 32.. cols ..32 scratch
  T* dsm = Xs + NB * LDS;
  T* invsm = dsm + NB;
  T* bc = invsm + NB;                      // the leaves' broadcast buffer
  T* W = static_cast<T*>(args->W);
  const int tid = threadIdx.x, warp = tid >> 5;

  // all loads first, then the shared-memory stores: W is a generic pointer,
  // so a store to S between two loads would keep them from overlapping
  constexpr int PER = NB * NB / DIAG_THREADS;
  T stage[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * DIAG_THREADS, r = e / NB, c = e % NB;
    stage[i] = (r == c) ? T(1) : T(0);
    if (r < kb && c <= r) stage[i] = W[(long long)(k0 + r) * ld + k0 + c];
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * DIAG_THREADS;
    S[(e / NB) * LDS + e % NB] = stage[i];
  }
  __syncthreads();
  if (warp == 0) leaf32<T, LDL>(S, Xs, dsm, invsm, bc, 0);
  __syncthreads();

  // thread tile of the 32 x 32 products: rows 32 + ri + i, columns c0 + 8v
  const int ri = 2 * (tid >> 3), c0 = tid & 7;
  T acc[2][4];
  // T21 = A21 X11^T (X11 is zero above its diagonal)
  prod32(S, 32, 0, Xs, 0, 0, false, acc);
  __syncwarp();  // the 8 threads of rows ri, ri+1 have read them before they are overwritten
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int rr = 32 + ri + i, c = c0 + 8 * v;
      S[rr * LDS + c] = LDL ? acc[i][v] * invsm[c] : acc[i][v];
      Xs[rr * LDS + c] = acc[i][v];  // T21, scratch
    }
  __syncthreads();
  // A22 -= L21 T21^T, lower triangle
  prod32(S, 32, 0, Xs, 32, 0, false, acc);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = c0 + 8 * v;
      if (c <= ri + i) S[(32 + ri + i) * LDS + 32 + c] -= acc[i][v];
    }
  __syncthreads();
  if (warp == 0) leaf32<T, LDL>(S, Xs, dsm, invsm, bc, 32);
  __syncthreads();
  // U = L21 X11 (into the scratch), then X21 = -X22 U
  prod32(S, 32, 0, Xs, 0, 0, true, acc);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) Xs[(32 + ri + i) * LDS + c0 + 8 * v] = acc[i][v];
  __syncthreads();
  prod32(Xs, 32, 32, Xs, 32, 0, true, acc);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) Xs[(32 + ri + i) * LDS + c0 + 8 * v] = -acc[i][v];
  __syncthreads();

  // shared-memory loads first, then the stores (as for the loads above)
  T* X = static_cast<T*>(args->X);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * DIAG_THREADS;
    stage[i] = S[(e / NB) * LDS + e % NB];
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * DIAG_THREADS, rr = e / NB, c = e % NB;
    if (rr < kb && c <= rr) W[(long long)(k0 + rr) * ld + k0 + c] = stage[i];
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * DIAG_THREADS;
    stage[i] = (e % NB <= e / NB) ? Xs[(e / NB) * LDS + e % NB] : T(0);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) X[tid + i * DIAG_THREADS] = stage[i];
  if (tid < kb) {
    const T sjj = dsm[tid];
    if (LDL) {
      static_cast<T*>(args->d)[k0 + tid] = sjj;
      static_cast<T*>(args->invd)[tid] = invsm[tid];
    } else if (!(isfinite(sjj) && sjj > T(0))) {
      *args->info = 1;
    }
  }
}

template <typename T>
constexpr size_t diag_smem() { return (2 * NB * LDS + 2 * NB + 2 * 33) * sizeof(T); }

// ---------------------------------------------------------------------------
// 2. Tile products C(64 x 64) = A_rows(64 x K) B_rows(64 x K)^T
// ---------------------------------------------------------------------------

// f64: DMMA.  4 warps in a 2 x 2 layout, each a 32 x 32 warp tile of
// 2 x 4 m16n8k8 tiles.  K in chunks of KC = 32, double-buffered cp.async.
constexpr int KC = 32;
constexpr int LDK = KC + 4;  // 36 doubles: rows 16-byte aligned, fragment loads conflict-free
constexpr int DMMA_THREADS = 128;
constexpr int STAGES = 2;                      // cp.async pipeline depth
constexpr size_t DMMA_STAGE = 2 * TILE * LDK;  // doubles per stage (A and B)
constexpr size_t DMMA_SMEM = STAGES * (DMMA_STAGE + KC) * sizeof(double);

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// acc += a (16 x 8) b (8 x 8), FP64 tensor cores
__device__ __forceinline__ void dmma_16x8x8(double* c, const double* a, const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Rows [0, a_rows) of A (row stride lda) and [0, b_rows) of B, columns
// [0, K) (K a multiple of KC), times the optional column scale s of A;
// calls emit(row, col, value) for every element of the 64 x 64 product
// (rows beyond a_rows / b_rows come out as 0).  vec16: lda, ldb even, so
// 16-byte copies are aligned.
template <typename Emit>
__device__ __forceinline__ void tile_nt_dmma(const double* A, long long lda, int a_rows,
                                             const double* B, long long ldb, int b_rows, int K,
                                             const double* s, bool vec16, Emit emit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sm = reinterpret_cast<double*>(smem_raw);
  double* ssm = sm + STAGES * DMMA_STAGE;  // [STAGES][KC] column scales
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  auto load = [&](int stage, int kc) {
    double* As = sm + stage * DMMA_STAGE;
    double* Bs = As + TILE * LDK;
    if (vec16) {
      for (int e = tid; e < TILE * KC / 2; e += DMMA_THREADS) {
        const int row = e / (KC / 2), col = 2 * (e % (KC / 2));
        const bool va = row < a_rows, vb = row < b_rows;
        cp_async16(As + row * LDK + col, va ? A + row * lda + kc + col : A, va);
        cp_async16(Bs + row * LDK + col, vb ? B + row * ldb + kc + col : B, vb);
      }
    } else {
      for (int e = tid; e < TILE * KC; e += DMMA_THREADS) {
        const int row = e / KC, col = e % KC;
        const bool va = row < a_rows, vb = row < b_rows;
        cp_async8(As + row * LDK + col, va ? A + row * lda + kc + col : A, va);
        cp_async8(Bs + row * LDK + col, vb ? B + row * ldb + kc + col : B, vb);
      }
    }
    if (s != nullptr && tid < KC) cp_async8(ssm + stage * KC + tid, s + kc + tid, true);
    cp_async_commit();
  };

  double acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0;

  const int nchunks = K / KC;
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nchunks) load(p, p * KC);
    else cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    const int next = ch + STAGES - 1;  // one commit group per chunk, empty past the end
    if (next < nchunks) load(next % STAGES, next * KC);
    else cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const double* As = sm + (ch % STAGES) * DMMA_STAGE;
    const double* Bs = As + TILE * LDK;
    const double* sc = ssm + (ch % STAGES) * KC;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 8) {
      double a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm + mt * 16 + g;
        a[mt][0] = As[row * LDK + ks + t];
        a[mt][1] = As[(row + 8) * LDK + ks + t];
        a[mt][2] = As[row * LDK + ks + t + 4];
        a[mt][3] = As[(row + 8) * LDK + ks + t + 4];
        if (s != nullptr) {
          const double s0 = sc[ks + t], s1 = sc[ks + t + 4];
          a[mt][0] *= s0;
          a[mt][1] *= s0;
          a[mt][2] *= s1;
          a[mt][3] *= s1;
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn + nt * 8 + g;
        b[nt][0] = Bs[col * LDK + ks + t];
        b[nt][1] = Bs[col * LDK + ks + t + 4];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) dmma_16x8x8(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();  // the stage is free for the load STAGES chunks on
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        emit(wm + mt * 16 + g + 8 * (q >> 1), wn + nt * 8 + 2 * t + (q & 1), acc[mt][nt][q]);
}

// f32: IEEE FMAs.  16 x 16 threads, each a 4 x 4 register tile (rows
// ty + 16u, columns tx + 16v); K in chunks of 16 staged transposed in
// shared memory.
constexpr int SIMT_THREADS = 256;
constexpr int KCS = 16;
constexpr size_t SIMT_SMEM = 2 * KCS * (TILE + 1) * sizeof(float);

template <typename Emit>
__device__ __forceinline__ void tile_nt_simt(const float* A, long long lda, int a_rows,
                                             const float* B, long long ldb, int b_rows, int K,
                                             const float* s, bool, Emit emit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // As[k][i] = s[k] * A[i][k]
  float* Bs = As + KCS * (TILE + 1);               // Bs[k][c] = B[c][k]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
  for (int kk = 0; kk < K; kk += KCS) {
    for (int e = tid; e < TILE * KCS; e += SIMT_THREADS) {
      const int r = e / KCS, k = e % KCS;
      float va = 0.0f, vb = 0.0f;
      if (r < a_rows) {
        va = A[r * lda + kk + k];
        if (s != nullptr) va *= s[kk + k];
      }
      if (r < b_rows) vb = B[r * ldb + kk + k];
      As[k * (TILE + 1) + r] = va;
      Bs[k * (TILE + 1) + r] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KCS; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = As[k * (TILE + 1) + ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) b[v] = Bs[k * (TILE + 1) + tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * b[v];
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) emit(ty + 16 * u, tx + 16 * v, acc[u][v]);
}

template <typename T>
struct TileCfg;
template <>
struct TileCfg<double> {
  static constexpr int threads = DMMA_THREADS;
  static constexpr size_t smem = DMMA_SMEM;
};
template <>
struct TileCfg<float> {
  static constexpr int threads = SIMT_THREADS;
  static constexpr size_t smem = SIMT_SMEM;
};

template <typename T, typename Emit>
__device__ __forceinline__ void tile_nt(const T* A, long long lda, int a_rows, const T* B, long long ldb,
                                        int b_rows, int K, const T* s, bool vec16, Emit emit) {
  if constexpr (std::is_same<T, double>::value)
    tile_nt_dmma(A, lda, a_rows, B, ldb, b_rows, K, s, vec16, emit);
  else
    tile_nt_simt(A, lda, a_rows, B, ldb, b_rows, K, s, vec16, emit);
}

// Panel rows [r0, r0+m) of columns [k0, k0+NB): P = W_panel X^T, written
// back in place (LDL^T: column c scaled by inv_d[c]).  One CTA per 64 rows;
// each CTA has read all of its rows before it writes them.
template <typename T, bool LDL>
__global__ void __launch_bounds__(TileCfg<T>::threads)
panel(const Args* __restrict__ args_all, int ld, int r0, int m, int k0, bool vec16) {
  const Args* __restrict__ args = args_all + blockIdx.z;
  T* W = static_cast<T*>(args->W);
  const T* X = static_cast<const T*>(args->X);
  const T* invd = static_cast<const T*>(args->invd);
  const int row0 = r0 + blockIdx.x * TILE;
  T* Wp = W + (long long)row0 * ld + k0;
  const int rows = min(TILE, r0 + m - row0);
  tile_nt<T>(Wp, ld, rows, X, NB, NB, NB, static_cast<const T*>(nullptr), vec16,
             [&](int i, int c, T v) {
               if (i < rows) Wp[(long long)i * ld + c] = LDL ? v * invd[c] : v;
             });
}

// The tile (bi, bj) that this CTA updates.  tri: a linear grid over the
// lower triangle of an nt x nt tile matrix; otherwise a 2D grid (columns
// x rows) whose tiles above the diagonal exit.
__device__ __forceinline__ bool update_tile(bool tri, int& bi, int& bj) {
  if (!tri) {
    bi = blockIdx.y;
    bj = blockIdx.x;
    return bj <= bi;
  }
  const long long lin = blockIdx.x;
  int i = (int)((sqrt(8.0 * (double)lin + 1.0) - 1.0) * 0.5);
  while ((long long)i * (i + 1) / 2 > lin) --i;
  while ((long long)(i + 1) * (i + 2) / 2 <= lin) ++i;
  bi = i;
  bj = (int)(lin - (long long)i * (i + 1) / 2);
  return true;
}

// Lower triangle of rows [r0, n) x columns [r0, c_end):
//   W[i][j] -= sum_{k in [kk0, kk0+K)} W[i][k] s[k] W[j][k]    (j <= i),
// s = d (SCALED, LDL^T) or 1.
template <typename T, bool SCALED>
__global__ void __launch_bounds__(TileCfg<T>::threads)
update(const Args* __restrict__ args_all, int n, int r0, int c_end, int kk0, int K, bool tri,
       bool vec16) {
  const Args* __restrict__ args = args_all + blockIdx.z;
  int bi, bj;
  if (!update_tile(tri, bi, bj)) return;
  T* W = static_cast<T*>(args->W);
  const T* s = SCALED ? static_cast<const T*>(args->d) + kk0 : nullptr;
  const int i0 = r0 + bi * TILE, j0 = r0 + bj * TILE;
  const int a_rows = min(TILE, n - i0), b_rows = min(TILE, c_end - j0);
  tile_nt<T>(W + (long long)i0 * n + kk0, n, a_rows, W + (long long)j0 * n + kk0, n, b_rows, K, s,
             vec16, [&](int i, int j, T v) {
               if (i < a_rows && j < b_rows && j0 + j <= i0 + i) W[(long long)(i0 + i) * n + j0 + j] -= v;
             });
}

inline int grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T, bool LDL>
int launch_update(const Args* args, int n, int r0, int c_end, int kk0, int K, bool vec16, int batch,
                  cudaStream_t stream) {
  const int m = n - r0, w = c_end - r0;
  const int nrt = (m + TILE - 1) / TILE, nct = (w + TILE - 1) / TILE;
  constexpr int th = TileCfg<T>::threads;
  constexpr size_t sm = TileCfg<T>::smem;
  if (nct == nrt) {
    const long long tiles = (long long)nrt * (nrt + 1) / 2;
    update<T, LDL><<<dim3((unsigned)tiles, 1, batch), th, sm, stream>>>(args, n, r0, c_end, kk0, K,
                                                                       true, vec16);
  } else {
    update<T, LDL><<<dim3(nct, nrt, batch), th, sm, stream>>>(args, n, r0, c_end, kk0, K, false,
                                                             vec16);
  }
  HIOP_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// The launch sequence of one factorization (copy, then per block column
// diag / panel / update, and one rank-OB update per outer block).  With
// batch > 1 every launch gets gridDim.z = batch: the CTAs of z work on
// matrix z, with the pointers of Args z, in the same order as a single
// factorization, so each matrix's factor is bit for bit the one a single
// launch gives; the batch's diagonal-block chains run side by side.
template <typename T, bool LDL>
int blocked_factor_launches(const Args* args, int n, int batch, cudaStream_t stream) {
  constexpr int th = TileCfg<T>::threads;
  constexpr size_t sm = TileCfg<T>::smem;
  const bool vec16 = (n % 2) == 0;
  copy_lower<T><<<dim3(grid_for((long long)n * n, 256), 1, batch), 256, 0, stream>>>(args, n);
  HIOP_RETURN_IF_LAUNCH_FAILED();
  for (int K0 = 0; K0 < n; K0 += OB) {
    const int kend = (n - K0 < OB) ? n : K0 + OB;
    for (int k0 = K0; k0 < kend; k0 += NB) {
      const int kb = (n - k0 < NB) ? (n - k0) : NB;
      diag_factor<T, LDL><<<dim3(1, 1, batch), DIAG_THREADS, diag_smem<T>(), stream>>>(args, n, k0,
                                                                                      kb);
      HIOP_RETURN_IF_LAUNCH_FAILED();
      const int r0 = k0 + kb, m = n - r0;
      if (m <= 0) break;
      panel<T, LDL><<<dim3((m + TILE - 1) / TILE, 1, batch), th, sm, stream>>>(args, n, r0, m, k0,
                                                                              vec16);
      HIOP_RETURN_IF_LAUNCH_FAILED();
      if (r0 < kend) {
        int rc = launch_update<T, LDL>(args, n, r0, kend, k0, NB, vec16, batch, stream);
        if (rc) return rc;
      }
    }
    if (kend < n) {
      int rc = launch_update<T, LDL>(args, n, kend, n, K0, kend - K0, vec16, batch, stream);
      if (rc) return rc;
    }
  }
  return 0;
}

template <typename T, bool LDL>
int set_attributes() {
  HIOP_RETURN_IF_ERROR(cudaFuncSetAttribute(diag_factor<T, LDL>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)diag_smem<T>()));
  HIOP_RETURN_IF_ERROR(cudaFuncSetAttribute(panel<T, LDL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)TileCfg<T>::smem));
  HIOP_RETURN_IF_ERROR(cudaFuncSetAttribute(update<T, LDL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)TileCfg<T>::smem));
  return 0;
}

// Args z of a batch from the pointers of matrix 0: the matrices, their
// pivots and scratch lie back to back (n x n, n, NB x NB, NB, one info).
template <typename T>
__global__ void set_args(Args* __restrict__ out, Args in, int n, int batch) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= batch) return;
  const long long nn = (long long)n * n;
  Args a;
  a.A = static_cast<const T*>(in.A) + z * nn;
  a.W = static_cast<T*>(in.W) + z * nn;
  a.X = static_cast<T*>(in.X) + z * (NB * NB);
  a.d = in.d ? static_cast<void*>(static_cast<T*>(in.d) + (long long)z * n) : nullptr;
  a.invd = in.invd ? static_cast<void*>(static_cast<T*>(in.invd) + z * NB) : nullptr;
  a.info = in.info ? in.info + z : nullptr;
  out[z] = a;
}

// Replay the launch sequence of (LAUNCHES, n, batch) on `stream` with the
// pointers in `in`.  The sequence is captured once per (kernel, n, batch,
// args buffer) into a CUDA graph (on a private stream, then instantiated);
// each call writes its batch's pointers into the device buffer `args`
// (batch x sizeof(Args) bytes) with one small kernel and launches the
// graph.  Calls that share an args buffer must share a stream.
template <typename T, typename Key, typename Launches>
int run_graph(Key key, Args* args, const Args& in, int n, int batch, cudaStream_t stream,
              Launches launches) {
  static std::mutex mu;
  static std::map<Key, cudaGraphExec_t> cache;
  std::lock_guard<std::mutex> lock(mu);
  cudaGraphExec_t exec = nullptr;
  auto it = cache.find(key);
  if (it != cache.end()) {
    exec = it->second;
  } else {
    cudaStream_t cs;
    HIOP_RETURN_IF_ERROR(cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking));
    cudaGraph_t graph = nullptr;
    int rc = (int)cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
    if (rc == 0) {
      rc = launches(cs);
      cudaError_t e = cudaStreamEndCapture(cs, &graph);
      if (rc == 0) rc = (int)e;
    }
    if (rc == 0) rc = (int)cudaGraphInstantiate(&exec, graph, 0);
    if (graph != nullptr) cudaGraphDestroy(graph);
    cudaStreamDestroy(cs);
    if (rc != 0) return rc;
    cache.emplace(key, exec);
  }
  set_args<T><<<(batch + 63) / 64, 64, 0, stream>>>(args, in, n, batch);
  HIOP_RETURN_IF_LAUNCH_FAILED();
  HIOP_RETURN_IF_ERROR(cudaGraphLaunch(exec, stream));
  return 0;
}

// `batch` factorizations of one n, their launch sequence followed by
// `epilogue`'s launches, as one CUDA graph on `stream`.
template <typename T, bool LDL, typename Epilogue>
int blocked_factor(const Args& in, Args* args, int n, int batch, cudaStream_t stream,
                   Epilogue epilogue) {
  int rc = set_attributes<T, LDL>();
  if (rc) return rc;
  const auto key = std::make_tuple(std::is_same<T, double>::value, LDL, n, batch, (void*)args);
  return run_graph<T>(key, args, in, n, batch, stream, [&](cudaStream_t cs) {
    int r = blocked_factor_launches<T, LDL>(args, n, batch, cs);
    return r ? r : epilogue(cs);
  });
}

}  // namespace
