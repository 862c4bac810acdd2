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
// (operations: 0.49 ms at 4608^2 at the 67 TFLOP/s FP64 tensor-core peak),
// the HBM traffic of those updates (the trailing matrix is read and written
// once per update), and the chain of n/64 diagonal-block steps, each
// latency-bound, that no parallelism shortens.  The design
// (dense_blocked.cuh) answers each: the updates are f64 DMMA tile products
// (mma.sync m16n8k8) delayed to rank 256, so the trailing matrix moves a
// quarter as often as with rank-64 updates; the diagonal block is factored
// recursively by warp-level 32-wide leaves (register rows, shared-memory
// broadcasts, no block barrier per column) that also build the inverse of
// the block's factor, so the panel is a DMMA product with it; and the
// ~220 launches of one factorization replay as one CUDA graph.
//
// Failure semantics follow jnp.linalg.cholesky, which the f64 main path of
// hiop_tpu uses: a pivot that is not finite and positive makes the whole
// lower triangle NaN (the upper triangle stays 0).  The factorization keeps
// running after a failed pivot; nan_fill_if_failed then overwrites it.

#include <math.h>

#include "dense_blocked.cuh"

namespace {

template <typename T>
__global__ void nan_fill_if_failed(const Args* __restrict__ args_all, int n) {
  const Args* __restrict__ args = args_all + blockIdx.z;
  if (*args->info == 0) return;
  T* W = static_cast<T*>(args->W);
  const long long total = (long long)n * n;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(idx / n), j = (int)(idx % n);
    if (j <= i) W[idx] = T(NAN);
  }
}

template <typename T>
int cholesky(const void* A, void* L, int n, int batch, void* X, void* info, void* args,
             void* stream) {
  const Args in{A, L, X, nullptr, nullptr, static_cast<int*>(info)};
  Args* dev_args = static_cast<Args*>(args);
  return blocked_factor<T, false>(
      in, dev_args, n, batch, reinterpret_cast<cudaStream_t>(stream), [&](cudaStream_t cs) {
        nan_fill_if_failed<T><<<dim3(grid_for((long long)n * n, 256), 1, batch), 256, 0, cs>>>(
            dev_args, n);
        return (int)cudaGetLastError();
      });
}

}  // namespace

// A: n x n row-major input (lower triangle read); L: n x n output;
// X: NB x NB scratch; info: one int, zero on entry; args: a device buffer
// of sizeof(Args) bytes, the same one for every call of one (n, dtype) on
// one stream (its address keys the cached CUDA graph).
extern "C" int hiop_cholesky_f64(const void* A, void* L, int n, void* X, void* info, void* args,
                                 void* stream) {
  return cholesky<double>(A, L, n, 1, X, info, args, stream);
}

extern "C" int hiop_cholesky_f32(const void* A, void* L, int n, void* X, void* info, void* args,
                                 void* stream) {
  return cholesky<float>(A, L, n, 1, X, info, args, stream);
}

// The same for `batch` matrices of one n, factored by one launch sequence
// (one CUDA graph): A and L are batch x n x n, X batch x NB x NB, info
// batch ints (zero on entry), args batch x sizeof(Args) bytes.  Each
// matrix's factor is bit for bit the single-matrix entry point's.
extern "C" int hiop_cholesky_batched_f64(const void* A, void* L, int n, int batch, void* X,
                                         void* info, void* args, void* stream) {
  return cholesky<double>(A, L, n, batch, X, info, args, stream);
}

extern "C" int hiop_cholesky_batched_f32(const void* A, void* L, int n, int batch, void* X,
                                         void* info, void* args, void* stream) {
  return cholesky<float>(A, L, n, batch, X, info, args, stream);
}

extern "C" int hiop_args_bytes() { return (int)sizeof(Args); }
