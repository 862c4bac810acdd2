// Blocked lower Cholesky factorization for the MDS quick tier (the dense
// block K_d and the Schur complement S, hiop_tpu_torch/kkt/mds.py).
//
// Replaces: hiop_tpu/linalg/cholesky.py, _chol_kernel (launched by
// pallas_cholesky) with its helper _factor_diag_block.  The TPU kernel held
// the whole matrix in VMEM (2 n^2 <= 2048^2, f32/bf16 only) and walked
// 128-wide block columns with full-width masked products; the f64 main
// path therefore never ran it.  This kernel takes f32 and f64 at any n.
//
// What bounds it on an H100: the n^3/3 flops of the trailing updates
// (operations, not bytes: the factor is n^2 words, read and written
// O(n/NB) times, while the work grows as n^3), and, below n ~ 2000, the
// chain of n/NB diagonal-block steps that no parallelism shortens.  The
// design keeps the updates in a tiled product (64 x 64 output tiles,
// 4 x 4 register tiles per thread, 16-deep shared-memory staging) over the
// lower triangle only, and keeps each 64 x 64 diagonal block, with the
// inverse of its factor built in the same Crout loop, in the registers of
// one CTA (one barrier per column), so that the panel becomes a product
// with that inverse.  The FP64 tensor cores (DMMA), TMA and a persistent
// trailing update are not used yet.
//
// Failure semantics follow jnp.linalg.cholesky, which the f64 main path of
// hiop_tpu uses: a pivot that is not finite and positive makes the whole
// lower triangle NaN (the upper triangle stays 0).  The factorization keeps
// running after a failed pivot; nan_fill_if_failed then overwrites it.

#include <math.h>

#include "dense_blocked.cuh"

namespace {

template <typename T>
__global__ void nan_fill_if_failed(T* __restrict__ W, int n, const int* __restrict__ info) {
  if (*info == 0) return;
  const long long total = (long long)n * n;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(idx / n), j = (int)(idx % n);
    if (j <= i) W[idx] = T(NAN);
  }
}

template <typename T>
int cholesky(const void* A, void* L, int n, void* X, void* info, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  T* W = static_cast<T*>(L);
  int rc = blocked_factor<T, false>(static_cast<const T*>(A), W, n, static_cast<T*>(X),
                                    nullptr, nullptr, static_cast<int*>(info), s);
  if (rc) return rc;
  nan_fill_if_failed<T><<<grid_for((long long)n * n, 256), 256, 0, s>>>(W, n, static_cast<int*>(info));
  return (int)cudaGetLastError();
}

}  // namespace

// A: n x n row-major input (lower triangle read); L: n x n output;
// X: NB x NB scratch; info: one int, zero on entry.
extern "C" int hiop_cholesky_f64(const void* A, void* L, int n, void* X, void* info, void* stream) {
  return cholesky<double>(A, L, n, X, info, stream);
}

extern "C" int hiop_cholesky_f32(const void* A, void* L, int n, void* X, void* info, void* stream) {
  return cholesky<float>(A, L, n, X, info, stream);
}
