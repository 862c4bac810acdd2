/* C interface for hiop_tpu.
 *
 * Parity with the reference's C interface
 * (HiOp's src/Interface/hiopInterface.h:63-176 and
 * chiopInterface.cpp): the user fills a struct of callback function
 * pointers describing a sparse NLP; the solver host (Python) loads the
 * user's shared library via hiop_tpu.capi or hiop_tpu_torch.capi and
 * drives these callbacks.
 *
 * Every callback returns 0 on success, nonzero on error. Arrays are
 * caller-allocated; the user fills them in place (same convention as the
 * reference's hiop_sparse_create_problem).
 *
 * The user's shared library must export a single symbol
 *
 *     const hiop_tpu_sparse_problem* hiop_tpu_get_problem(void);
 *
 * returning a pointer with static lifetime. See
 * tests/data/c_problem_example.c for a complete example.
 */

#ifndef HIOP_TPU_C_H
#define HIOP_TPU_C_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct hiop_tpu_sparse_problem {
  /* sizes */
  int64_t n;        /* number of variables */
  int64_t m;        /* number of constraints */
  int64_t nnz_jac;  /* Jacobian nonzeros (static structure) */
  int64_t nnz_hess; /* upper-triangle Hessian nonzeros (static structure) */

  /* bounds: fill xlow/xupp (length n) and clow/cupp (length m);
   * magnitudes >= 1e20 mean unbounded */
  int (*get_vars_info)(int64_t n, double* xlow, double* xupp);
  int (*get_cons_info)(int64_t m, double* clow, double* cupp);

  /* starting point (length n) */
  int (*get_starting_point)(int64_t n, double* x0);

  /* objective, gradient, constraints */
  int (*eval_f)(int64_t n, const double* x, double* obj);
  int (*eval_grad_f)(int64_t n, const double* x, double* grad);
  int (*eval_cons)(int64_t n, int64_t m, const double* x, double* cons);

  /* static structures: fill iJac/jJac (length nnz_jac), iHess/jHess
   * (length nnz_hess, upper triangle) */
  int (*get_jac_structure)(int64_t nnz, int64_t* iJac, int64_t* jJac);
  int (*get_hess_structure)(int64_t nnz, int64_t* iHess, int64_t* jHess);

  /* values aligned with the structures */
  int (*eval_jac)(int64_t n, const double* x, int64_t nnz, double* values);
  int (*eval_hess)(int64_t n, const double* x, double obj_factor,
                   int64_t m, const double* lambda, int64_t nnz,
                   double* values);
} hiop_tpu_sparse_problem;

/* Dense-constrained NLP (parity with hiop_dense_create_problem,
 * hiopInterface.h:150 and chiopInterface.cpp): few constraints with a
 * dense row-major Jacobian, solved with the quasi-Newton IPM. The shared
 * library exports
 *
 *     const hiop_tpu_dense_problem* hiop_tpu_get_dense_problem(void);
 */
typedef struct hiop_tpu_dense_problem {
  int64_t n; /* number of variables */
  int64_t m; /* number of constraints */

  int (*get_vars_info)(int64_t n, double* xlow, double* xupp);
  int (*get_cons_info)(int64_t m, double* clow, double* cupp);
  int (*get_starting_point)(int64_t n, double* x0);
  int (*eval_f)(int64_t n, const double* x, double* obj);
  int (*eval_grad_f)(int64_t n, const double* x, double* grad);
  int (*eval_cons)(int64_t n, int64_t m, const double* x, double* cons);
  /* dense row-major (m x n) Jacobian of all constraints */
  int (*eval_jac_cons)(int64_t n, int64_t m, const double* x, double* jac);
} hiop_tpu_dense_problem;

/* Mixed dense-sparse NLP (parity with hiop_mds_create_problem,
 * hiopInterface.h:63 and chiopInterface.cpp:161): variables ordered
 * [x_sparse, x_dense]; the Jacobian has a static sparse triplet block over
 * the sparse variables plus a dense row-major (m x n_dense) block; the
 * Hessian is block-diagonal with a *diagonal* sparse block (length
 * n_sparse) and a dense (n_dense x n_dense) block. The shared library
 * exports
 *
 *     const hiop_tpu_mds_problem* hiop_tpu_get_mds_problem(void);
 */
typedef struct hiop_tpu_mds_problem {
  int64_t n_sparse;
  int64_t n_dense;
  int64_t m;
  int64_t nnz_jac_sparse; /* sparse-block Jacobian nonzeros (static) */

  int (*get_vars_info)(int64_t n, double* xlow, double* xupp);
  int (*get_cons_info)(int64_t m, double* clow, double* cupp);
  int (*get_starting_point)(int64_t n, double* x0);
  int (*eval_f)(int64_t n, const double* x, double* obj);
  int (*eval_grad_f)(int64_t n, const double* x, double* grad);
  int (*eval_cons)(int64_t n, int64_t m, const double* x, double* cons);
  /* static sparse-block structure: fill i/j (length nnz_jac_sparse),
   * column indices in [0, n_sparse) */
  int (*get_jac_sparse_structure)(int64_t nnz, int64_t* iJac, int64_t* jJac);
  /* values aligned with the structure + the dense block, row-major
   * (m x n_dense) */
  int (*eval_jac_blocks)(int64_t n, const double* x, int64_t nnz,
                         double* sparse_values, double* dense_block);
  /* hss_diag: length n_sparse; hdd: row-major (n_dense x n_dense) */
  int (*eval_hess_blocks)(int64_t n, const double* x, double obj_factor,
                          int64_t m, const double* lambda, double* hss_diag,
                          double* hdd);
} hiop_tpu_mds_problem;

#ifdef __cplusplus
}
#endif

#endif /* HIOP_TPU_C_H */
