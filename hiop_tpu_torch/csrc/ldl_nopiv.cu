// Blocked no-pivot LDL^T of a symmetric indefinite matrix, the
// inertia-revealing factorization of the MDS safe tier
// (factorize_safe(host=False), hiop_tpu_torch/kkt/mds.py).
//
// Replaces: hiop_tpu/linalg/ldl_blocked.py, _ldl_kernel (launched by
// pallas_ldl) with its helpers _ldl_panel_math, _ldl_diag_block and
// _unit_lower_inverse; the same function's XLA lane is _ldl_xla_unrolled
// with _ldl_diag_block_inv.  The TPU kernel held the whole matrix in VMEM
// (2 n_p^2 <= 2048^2, f32/bf16 only), so the f64 main path used the XLA
// lane.  This kernel takes f32 and f64 at any size.
//
// What bounds it on an H100: as cholesky.cu, the n^3/3 flops and the HBM
// traffic of the trailing updates A22 -= P diag(d) P^T, and the serial
// chain of diagonal blocks.  Same design (dense_blocked.cuh): recursive
// warp-level factor of each 64 x 64 diagonal block with its unit-lower
// inverse, the scaled panel P = W X^T diag(d)^-1 and the rank-256 delayed
// updates as f64 DMMA tile products (f32: FP32 FMAs), one CUDA graph per
// factorization.  The no-pivot factor is unique, so the blocking (64 and
// 256 here, 128 on the TPU) does not change the result beyond rounding.
//
// Semantics: a zero pivot gives d = 0 and a zeroed column, not NaN.  The
// identity padding to a multiple of 128 and the ok / n_neg reductions stay
// in the Python wrapper (hiop_tpu_torch/linalg/ldl_blocked.py).

#include <math.h>

#include "dense_blocked.cuh"

namespace {

template <typename T>
int ldl_nopiv(const void* A, void* L, void* d, int n, int batch, void* X, void* invd, void* args,
              void* stream) {
  const Args in{A, L, X, d, invd, nullptr};
  return blocked_factor<T, true>(in, static_cast<Args*>(args), n, batch,
                                 reinterpret_cast<cudaStream_t>(stream),
                                 [](cudaStream_t) { return 0; });
}

}  // namespace

// A: n x n row-major input (lower triangle read); L: n x n unit-lower
// output; d: n pivots; X: NB x NB scratch; invd: NB scratch; args: as for
// hiop_cholesky_*.
extern "C" int hiop_ldl_nopiv_f64(const void* A, void* L, void* d, int n, void* X, void* invd,
                                  void* args, void* stream) {
  return ldl_nopiv<double>(A, L, d, n, 1, X, invd, args, stream);
}

extern "C" int hiop_ldl_nopiv_f32(const void* A, void* L, void* d, int n, void* X, void* invd,
                                  void* args, void* stream) {
  return ldl_nopiv<float>(A, L, d, n, 1, X, invd, args, stream);
}

// The same for `batch` matrices of one n (one launch sequence, one CUDA
// graph): A and L batch x n x n, d batch x n, X batch x NB x NB, invd
// batch x NB, args batch x sizeof(Args) bytes.  Each matrix's factor is
// bit for bit the single-matrix entry point's.
extern "C" int hiop_ldl_nopiv_batched_f64(const void* A, void* L, void* d, int n, int batch,
                                          void* X, void* invd, void* args, void* stream) {
  return ldl_nopiv<double>(A, L, d, n, batch, X, invd, args, stream);
}

extern "C" int hiop_ldl_nopiv_batched_f32(const void* A, void* L, void* d, int n, int batch,
                                          void* X, void* invd, void* args, void* stream) {
  return ldl_nopiv<float>(A, L, d, n, batch, X, invd, args, stream);
}
