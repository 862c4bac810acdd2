"""C interface loader.

Counterpart of ``hiop_tpu/capi/__init__.py`` (the reference's C/Fortran
interfaces, hiopInterface.h and chiopInterface.cpp): a user problem written
in C, or in any language with a C ABI (Fortran through iso_c_binding), is
compiled to a shared library that exports one of the symbols of
``capi/hiop_tpu_c.h`` (a copy of ``hiop_tpu``'s header, so that one
compiled library loads in both packages):

- ``hiop_tpu_get_problem``: a sparse NLP, :class:`CSparseProblem`, solved
  by :func:`solve_sparse_problem` (Newton over ``NlpSparse``);
- ``hiop_tpu_get_dense_problem``: a dense-constrained NLP,
  :class:`CDenseProblem`, solved by :func:`solve_dense_problem`
  (quasi-Newton over ``NlpDenseConstraints``, as the reference solves
  dense C problems);
- ``hiop_tpu_get_mds_problem``: a mixed dense-sparse NLP,
  :class:`CMdsProblem`, solved by :func:`solve_mds_problem` (Newton over
  ``NlpMDS``).

The callbacks read and write host buffers: this is the reference's
``callback_mem_space=host`` mode. Each evaluation copies ``x`` (and the
multipliers) to the host, one host read of the solver's device, calls the
C function, and returns numpy arrays that the formulation moves back to the
device; the linear algebra stays on the device. The problems are not
``jittable`` (the fused modes cannot run host callbacks) and take plain
tensors only (``takes_dtensor = False``). The ``solve_*`` functions run on
the card unless the options say ``compute_mode="cpu"``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hiop_tpu_torch.interface.base import (
    DenseConstraintsProblem,
    MdsProblem,
    SparseProblem,
)

_F64P = ctypes.POINTER(ctypes.c_double)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I64 = ctypes.c_int64


def _fn(*args):
    return ctypes.CFUNCTYPE(ctypes.c_int, *args)


#: the callbacks every problem struct starts with, in the header's order
_COMMON_FIELDS = [
    ("get_vars_info", _fn(_I64, _F64P, _F64P)),
    ("get_cons_info", _fn(_I64, _F64P, _F64P)),
    ("get_starting_point", _fn(_I64, _F64P)),
    ("eval_f", _fn(_I64, _F64P, _F64P)),
    ("eval_grad_f", _fn(_I64, _F64P, _F64P)),
    ("eval_cons", _fn(_I64, _I64, _F64P, _F64P)),
]


class _CProblemStruct(ctypes.Structure):
    _fields_ = [
        ("n", _I64), ("m", _I64), ("nnz_jac", _I64), ("nnz_hess", _I64),
        *_COMMON_FIELDS,
        ("get_jac_structure", _fn(_I64, _I64P, _I64P)),
        ("get_hess_structure", _fn(_I64, _I64P, _I64P)),
        ("eval_jac", _fn(_I64, _F64P, _I64, _F64P)),
        ("eval_hess", _fn(_I64, _F64P, ctypes.c_double, _I64, _F64P, _I64, _F64P)),
    ]


class _CDenseStruct(ctypes.Structure):
    _fields_ = [
        ("n", _I64), ("m", _I64),
        *_COMMON_FIELDS,
        ("eval_jac_cons", _fn(_I64, _I64, _F64P, _F64P)),
    ]


class _CMdsStruct(ctypes.Structure):
    _fields_ = [
        ("n_sparse", _I64), ("n_dense", _I64), ("m", _I64), ("nnz_jac_sparse", _I64),
        *_COMMON_FIELDS,
        ("get_jac_sparse_structure", _fn(_I64, _I64P, _I64P)),
        ("eval_jac_blocks", _fn(_I64, _F64P, _I64, _F64P, _F64P)),
        ("eval_hess_blocks", _fn(_I64, _F64P, ctypes.c_double, _I64, _F64P, _F64P, _F64P)),
    ]


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(_F64P)


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _host(v) -> np.ndarray:
    """A contiguous f64 host copy of an evaluation argument (a tensor on
    the solver's device, or anything numpy takes)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(v, dtype=np.float64))


class _CProblem:
    """The callbacks all three C problem kinds share."""

    jittable = False
    takes_dtensor = False

    def _load(self, lib_path: str, symbol: str, struct):
        self._dll = ctypes.CDLL(lib_path)
        getter = getattr(self._dll, symbol)
        getter.restype = ctypes.POINTER(struct)
        self._p = getter().contents

    def _check(self, ret: int, what: str):
        if ret != 0:
            raise RuntimeError(f"C callback {what} returned {ret}")

    def get_prob_sizes(self):
        return self.n, self.m

    def get_vars_info(self):
        xl, xu = np.empty(self.n), np.empty(self.n)
        self._check(self._p.get_vars_info(self.n, _dptr(xl), _dptr(xu)), "get_vars_info")
        return xl, xu

    def get_cons_info(self):
        cl, cu = np.empty(self.m), np.empty(self.m)
        self._check(self._p.get_cons_info(self.m, _dptr(cl), _dptr(cu)), "get_cons_info")
        return cl, cu

    def get_starting_point(self):
        x0 = np.empty(self.n)
        self._check(self._p.get_starting_point(self.n, _dptr(x0)), "get_starting_point")
        return x0

    def eval_f(self, x):
        out = np.empty(1)
        self._check(self._p.eval_f(self.n, _dptr(_host(x)), _dptr(out)), "eval_f")
        return out[0]

    def eval_grad_f(self, x):
        g = np.empty(self.n)
        self._check(self._p.eval_grad_f(self.n, _dptr(_host(x)), _dptr(g)), "eval_grad_f")
        return g

    def eval_cons(self, x):
        c = np.empty(self.m)
        self._check(self._p.eval_cons(self.n, self.m, _dptr(_host(x)), _dptr(c)), "eval_cons")
        return c


class CSparseProblem(_CProblem, SparseProblem):
    """A :class:`SparseProblem` backed by C callbacks
    (``hiop_tpu_sparse_problem``, hiopInterface.h:63)."""

    def __init__(self, lib_path: str):
        self._load(lib_path, "hiop_tpu_get_problem", _CProblemStruct)
        self.n = int(self._p.n)
        self.m = int(self._p.m)
        self.nnz_jac = int(self._p.nnz_jac)
        self.nnz_hess = int(self._p.nnz_hess)

    def get_sparse_blocks_info(self):
        return self.n, self.nnz_jac, self.nnz_hess

    def jac_structure(self):
        i, j = np.empty(self.nnz_jac, np.int64), np.empty(self.nnz_jac, np.int64)
        self._check(self._p.get_jac_structure(self.nnz_jac, _iptr(i), _iptr(j)), "get_jac_structure")
        return i, j

    def hess_structure(self):
        i, j = np.empty(self.nnz_hess, np.int64), np.empty(self.nnz_hess, np.int64)
        self._check(self._p.get_hess_structure(self.nnz_hess, _iptr(i), _iptr(j)), "get_hess_structure")
        return i, j

    def eval_jac_vals(self, x):
        v = np.empty(self.nnz_jac)
        self._check(self._p.eval_jac(self.n, _dptr(_host(x)), self.nnz_jac, _dptr(v)), "eval_jac")
        return v

    def eval_hess_vals(self, x, obj_factor, lam):
        v = np.empty(self.nnz_hess)
        self._check(self._p.eval_hess(self.n, _dptr(_host(x)), float(obj_factor), self.m,
                                      _dptr(_host(lam)), self.nnz_hess, _dptr(v)), "eval_hess")
        return v


class CDenseProblem(_CProblem, DenseConstraintsProblem):
    """A :class:`DenseConstraintsProblem` backed by C callbacks
    (``hiop_tpu_dense_problem``, hiopInterface.h:150)."""

    def __init__(self, lib_path: str):
        self._load(lib_path, "hiop_tpu_get_dense_problem", _CDenseStruct)
        self.n = int(self._p.n)
        self.m = int(self._p.m)

    def eval_jac_cons(self, x):
        jac = np.empty((self.m, self.n))
        self._check(self._p.eval_jac_cons(self.n, self.m, _dptr(_host(x)), _dptr(jac)), "eval_jac_cons")
        return jac


class CMdsProblem(_CProblem, MdsProblem):
    """An :class:`MdsProblem` backed by C callbacks
    (``hiop_tpu_mds_problem``, hiopInterface.h:63)."""

    def __init__(self, lib_path: str):
        self._load(lib_path, "hiop_tpu_get_mds_problem", _CMdsStruct)
        self.n_sparse = int(self._p.n_sparse)
        self.n_dense = int(self._p.n_dense)
        self.n = self.n_sparse + self.n_dense
        self.m = int(self._p.m)
        self.nnz_jac_sparse = int(self._p.nnz_jac_sparse)

    def get_sparse_dense_blocks_info(self):
        return self.n_sparse, self.n_dense

    def jac_sparse_structure(self):
        k = self.nnz_jac_sparse
        i, j = np.empty(k, np.int64), np.empty(k, np.int64)
        self._check(self._p.get_jac_sparse_structure(k, _iptr(i), _iptr(j)), "get_jac_sparse_structure")
        return i, j

    def eval_jac_blocks(self, x):
        sv = np.empty(self.nnz_jac_sparse)
        db = np.empty((self.m, self.n_dense))
        self._check(self._p.eval_jac_blocks(self.n, _dptr(_host(x)), self.nnz_jac_sparse,
                                            _dptr(sv), _dptr(db)), "eval_jac_blocks")
        return sv, db

    def eval_hess_blocks(self, x, obj_factor, lam):
        hss = np.empty(self.n_sparse)
        hdd = np.empty((self.n_dense, self.n_dense))
        self._check(self._p.eval_hess_blocks(self.n, _dptr(_host(x)), float(obj_factor), self.m,
                                             _dptr(_host(lam)), _dptr(hss), _dptr(hdd)),
                    "eval_hess_blocks")
        return hss, hdd


def solve_sparse_problem(lib_path: str, **options):
    """hiop_sparse_create_problem + solve_problem in one call: load the C
    problem, run the Newton IPM over ``NlpSparse``, return the result."""
    from hiop_tpu_torch import FilterIPMNewton, NlpOptions, NlpSparse

    o = NlpOptions()
    o.update(Hessian="analytical_exact", **options)
    return FilterIPMNewton(NlpSparse(CSparseProblem(lib_path), o)).run()


def solve_dense_problem(lib_path: str, **options):
    """hiop_dense_create_problem + solve_problem in one call: the
    quasi-Newton IPM over ``NlpDenseConstraints`` (chiopInterface.cpp)."""
    from hiop_tpu_torch import FilterIPMQuasiNewton, NlpDenseConstraints, NlpOptions

    o = NlpOptions()
    o.update(**options)
    return FilterIPMQuasiNewton(NlpDenseConstraints(CDenseProblem(lib_path), o)).run()


def solve_mds_problem(lib_path: str, **options):
    """hiop_mds_create_problem + solve_problem in one call: the Newton IPM
    over ``NlpMDS``."""
    from hiop_tpu_torch import FilterIPMNewton, NlpMDS, NlpOptions

    o = NlpOptions()
    o.update(Hessian="analytical_exact", **options)
    return FilterIPMNewton(NlpMDS(CMdsProblem(lib_path), o)).run()
