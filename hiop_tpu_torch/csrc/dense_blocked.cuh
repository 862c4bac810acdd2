// Building blocks shared by the blocked dense factorizations (cholesky.cu,
// ldl_nopiv.cu): right-looking, block column by block column, on a
// row-major n x n working copy W whose lower triangle ends up holding the
// factor.  One step at block column k0 (width kb <= NB):
//
//   1. diag_factor    one CTA factors the updated kb x kb diagonal block in
//                     registers (Crout, column by column, one barrier a
//                     column) and, in the same loop, builds the inverse X
//                     of its lower factor;
//   2. panel_solve    the rows below the block: P = W_panel X^T
//                     (LDL^T: scaled by the inverse pivots);
//   3. trailing_update the rank-kb update of the lower triangle of the
//                     trailing matrix, A22 -= P diag(s) P^T, as a tiled
//                     product with 4x4 register tiles per thread.
//
// Everything lives in an anonymous namespace so that each translation unit
// carries its own instantiations (the two .cu files are compiled apart and
// linked into one shared library without relocatable device code).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int NB = 64;           // block column width (any n; the last block is ragged)
constexpr int LDS = NB + 1;      // padded shared-memory row length
constexpr int DIAG_THREADS = 256;
constexpr int PANEL_ROWS = 64;   // panel rows per CTA
constexpr int PANEL_THREADS = 256;
constexpr int TILE = 64;         // trailing-update output tile (TILE x TILE per CTA)
constexpr int KC = 16;           // trailing-update depth chunk staged in shared memory
constexpr int TRAIL_THREADS = 256;

template <typename T>
constexpr size_t two_blocks_smem() { return 2 * NB * LDS * sizeof(T); }

#define HIOP_RETURN_IF_LAUNCH_FAILED()           \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// W = lower triangle of A, zeros above the diagonal.
template <typename T>
__global__ void copy_lower(const T* __restrict__ A, T* __restrict__ W, int n) {
  const long long total = (long long)n * n;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(idx / n), j = (int)(idx % n);
    W[idx] = (j <= i) ? A[idx] : T(0);
  }
}

// Factor the kb x kb diagonal block W[k0:k0+kb, k0:k0+kb] (lower triangle
// read) in place and write the inverse of its lower factor to X (NB x NB,
// row-major).  LDL = false: Cholesky, L_kk with positive diagonal; a pivot
// that is not finite and positive sets *info.  LDL = true: no-pivot
// LDL^T, unit-lower L_kk and pivots d[k0+j]; a zero pivot gives d = 0 and a
// zeroed column (inv_d = 0), as hiop_tpu's _ldl_diag_block does.
//
// Layout: thread t owns row r = t % NB of the block and the NB / 4 columns
// c = g + 4u (g = t / NB, u < NB / 4), in registers, for both the block
// and its inverse.  A ragged block (kb < NB) is padded with identity, so
// the column loop is unrolled at compile time and a register is never
// indexed at run time.  Step j: the threads that own column j publish it
// (and the owners of row j of the inverse publish that row) to shared
// memory, one barrier, then every thread applies the rank-1 update to its
// registers.  The published vectors are double-buffered, so one barrier a
// column is enough: a thread can only overwrite a buffer two steps later,
// after every thread has passed the barrier that follows its last read.
template <typename T, bool LDL>
__global__ void __launch_bounds__(DIAG_THREADS)
diag_factor(T* __restrict__ W, int ld, int k0, int kb, T* __restrict__ X,
            T* __restrict__ d, T* __restrict__ invd, int* __restrict__ info) {
  static_assert(DIAG_THREADS == 4 * NB, "diag_factor: 4 column groups of NB rows");
  constexpr int NU = NB / 4;
  __shared__ T colbuf[2][NB];   // column j of the block (unscaled)
  __shared__ T xrow[2][NB];     // row j of the inverse (unscaled)
  const int r = threadIdx.x % NB, g = threadIdx.x / NB;
  T s[NU], x[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int c = g + 4 * u;
    T v = (r == c) ? T(1) : T(0);
    if (r < kb && c <= r) v = W[(long long)(k0 + r) * ld + k0 + c];
    s[u] = v;
    x[u] = (r == c) ? T(1) : T(0);
  }

#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int U = j / 4, buf = j & 1;
    if (g == (j & 3)) colbuf[buf][r] = s[U];
    if (r == j) {
#pragma unroll
      for (int u = 0; u < NU; ++u) xrow[buf][g + 4 * u] = x[u];
    }
    __syncthreads();
    const T sjj = colbuf[buf][j];
    T piv, inv;
    if (LDL) {
      piv = sjj;
      inv = (fabs(sjj) > T(0)) ? T(1) / sjj : T(0);
    } else {
      piv = sqrt(sjj);  // NaN for a negative pivot; *info records it
      inv = T(1) / piv;
    }
    const T col_r = colbuf[buf][r] * inv;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int c = g + 4 * u;
      if (c > j && r >= c) {
        const T col_c = colbuf[buf][c] * inv;
        if (LDL) s[u] -= sjj * (col_r * col_c);
        else s[u] -= col_r * col_c;
      }
      if (c <= j) {
        const T xr = LDL ? xrow[buf][c] : xrow[buf][c] * inv;
        if (r > j) x[u] -= col_r * xr;
        else if (r == j) x[u] = xr;
      }
    }
    if (j < kb) {
      if (g == (j & 3) && r >= j && r < kb)
        W[(long long)(k0 + r) * ld + k0 + j] = (r == j) ? (LDL ? T(1) : piv) : col_r;
      if (threadIdx.x == 0) {
        if (LDL) {
          d[k0 + j] = sjj;
          invd[j] = inv;
        } else if (!(isfinite(sjj) && sjj > T(0))) {
          *info = 1;
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int c = g + 4 * u;
    if (r < kb && c < kb) X[r * NB + c] = x[u];
  }
}

// Panel rows [r0, r0+m) of columns [k0, k0+kb): P = W_panel X^T, written
// back in place (LDL: each column c scaled by inv_d[c]).  Each CTA stages
// PANEL_ROWS rows and X in shared memory, so CTAs touch disjoint rows.
template <typename T, bool LDL>
__global__ void __launch_bounds__(PANEL_THREADS)
panel_solve(T* __restrict__ W, int ld, int r0, int m, int k0, int kb,
            const T* __restrict__ X, const T* __restrict__ invd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);  // Xs[c * LDS + j] = X[c][j]
  T* Ws = Xs + NB * LDS;                   // Ws[r * LDS + j] = panel row r
  const int row0 = blockIdx.x * PANEL_ROWS;
  const int tid = threadIdx.x;
  for (int e = tid; e < kb * kb; e += blockDim.x) {
    const int c = e / kb, j = e % kb;
    Xs[c * LDS + j] = X[c * NB + j];
  }
  for (int e = tid; e < PANEL_ROWS * kb; e += blockDim.x) {
    const int r = e / kb, j = e % kb;
    const int gr = row0 + r;
    Ws[r * LDS + j] = (gr < m) ? W[(long long)(r0 + gr) * ld + k0 + j] : T(0);
  }
  __syncthreads();
  for (int e = tid; e < PANEL_ROWS * kb; e += blockDim.x) {
    const int r = e / kb, c = e % kb;
    const int gr = row0 + r;
    if (gr >= m) continue;
    T acc = T(0);
    for (int j = 0; j <= c; ++j) acc += Ws[r * LDS + j] * Xs[c * LDS + j];
    if (LDL) acc *= invd[c];
    W[(long long)(r0 + gr) * ld + k0 + c] = acc;
  }
}

// Lower triangle of the trailing matrix, rows/cols [r0, r0+m):
//   W[r0+i][r0+c] -= sum_j P[i][j] s[j] P[c][j]   (c <= i),
// where P = W[r0:r0+m, k0:k0+kb] and s = d[k0:k0+kb] (SCALED) or 1.
// Grid (nt, nt) over TILE x TILE output tiles; tiles above the diagonal
// exit at once.  Thread (tx, ty) of the 16 x 16 layout owns rows
// ty + 16u and columns tx + 16v, u, v < 4.
template <typename T, bool SCALED>
__global__ void __launch_bounds__(TRAIL_THREADS)
trailing_update(T* __restrict__ W, int ld, int r0, int m, int k0, int kb,
                const T* __restrict__ s) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bj > bi) return;
  __shared__ T As[KC][TILE + 1];  // As[k][i] = s[k] * P[bi*TILE + i][k]
  __shared__ T Bs[KC][TILE + 1];  // Bs[k][c] = P[bj*TILE + c][k]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int rowA0 = bi * TILE, rowB0 = bj * TILE;
  T acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = T(0);

  for (int kk = 0; kk < kb; kk += KC) {
    for (int e = tid; e < TILE * KC; e += blockDim.x) {
      const int r = e / KC, k = e % KC;
      const int gk = kk + k;
      const int ga = rowA0 + r, gb = rowB0 + r;
      T va = T(0), vb = T(0);
      if (gk < kb) {
        if (ga < m) {
          va = W[(long long)(r0 + ga) * ld + k0 + gk];
          if (SCALED) va *= s[gk];
        }
        if (gb < m) vb = W[(long long)(r0 + gb) * ld + k0 + gk];
      }
      As[k][r] = va;
      Bs[k][r] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      T a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = As[k][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) b[v] = Bs[k][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * b[v];
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = rowA0 + ty + 16 * u;
    if (i >= m) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = rowB0 + tx + 16 * v;
      if (c < m && c <= i) W[(long long)(r0 + i) * ld + r0 + c] -= acc[u][v];
    }
  }
}

inline int grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  return blocks < 1 ? 1 : (int)blocks;
}

// One factorization: copy the lower triangle, then diag/panel/trailing per
// block column.  Returns the first launch error (0 on success).
template <typename T, bool LDL>
int blocked_factor(const T* A, T* W, int n, T* X, T* d, T* invd, int* info,
                   cudaStream_t stream) {
  const size_t smem = two_blocks_smem<T>();
  cudaFuncSetAttribute(panel_solve<T, LDL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  HIOP_RETURN_IF_LAUNCH_FAILED();
  copy_lower<T><<<grid_for((long long)n * n, 256), 256, 0, stream>>>(A, W, n);
  HIOP_RETURN_IF_LAUNCH_FAILED();
  for (int k0 = 0; k0 < n; k0 += NB) {
    const int kb = (n - k0 < NB) ? (n - k0) : NB;
    diag_factor<T, LDL><<<1, DIAG_THREADS, 0, stream>>>(W, n, k0, kb, X, d, invd, info);
    HIOP_RETURN_IF_LAUNCH_FAILED();
    const int r0 = k0 + kb, m = n - r0;
    if (m <= 0) break;
    panel_solve<T, LDL><<<(m + PANEL_ROWS - 1) / PANEL_ROWS, PANEL_THREADS, smem, stream>>>(
        W, n, r0, m, k0, kb, X, invd);
    HIOP_RETURN_IF_LAUNCH_FAILED();
    const int nt = (m + TILE - 1) / TILE;
    trailing_update<T, LDL><<<dim3(nt, nt), TRAIL_THREADS, 0, stream>>>(
        W, n, r0, m, k0, kb, LDL ? d + k0 : nullptr);
    HIOP_RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

}  // namespace
