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
// What bounds it on an H100: the n^3/3 flops of the trailing updates
// A22 -= P diag(d) P^T (operations), and the serial chain of diagonal
// blocks below n ~ 2000.  Same design as cholesky.cu: a Crout + unit-lower
// inverse of each 64 x 64 diagonal block in one CTA's registers, the
// scaled panel P = W X^T diag(d)^-1 as a product with that inverse, and a
// tiled rank-64 update of the lower triangle.
// The no-pivot factor is unique, so the block width (64 here, 128 on the
// TPU) does not change the result beyond rounding.
//
// Semantics: a zero pivot gives d = 0 and a zeroed column, not NaN.  The
// identity padding to a multiple of 128 and the ok / n_neg reductions stay
// in the Python wrapper (hiop_tpu_torch/linalg/ldl_blocked.py).

#include <math.h>

#include "dense_blocked.cuh"

namespace {

template <typename T>
int ldl_nopiv(const void* A, void* L, void* d, int n, void* X, void* invd, void* stream) {
  return blocked_factor<T, true>(static_cast<const T*>(A), static_cast<T*>(L), n,
                                 static_cast<T*>(X), static_cast<T*>(d),
                                 static_cast<T*>(invd), nullptr,
                                 reinterpret_cast<cudaStream_t>(stream));
}

}  // namespace

// A: n x n row-major input (lower triangle read); L: n x n unit-lower
// output; d: n pivots; X: NB x NB scratch; invd: NB scratch.
extern "C" int hiop_ldl_nopiv_f64(const void* A, void* L, void* d, int n, void* X, void* invd,
                                  void* stream) {
  return ldl_nopiv<double>(A, L, d, n, X, invd, stream);
}

extern "C" int hiop_ldl_nopiv_f32(const void* A, void* L, void* d, int n, void* X, void* invd,
                                  void* stream) {
  return ldl_nopiv<float>(A, L, d, n, X, invd, stream);
}
