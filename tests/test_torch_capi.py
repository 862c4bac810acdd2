"""The port's C interface (``hiop_tpu_torch.capi``) against the JAX
package's, on the CPU in f64.

The three C examples of ``tests/data`` are compiled once with the system C
compiler, and the same shared library is loaded by both packages (the
port's header is a copy of ``hiop_tpu``'s). Each solve gives the same
status and iterations in both, and the objective to 1e-8 relative; the
sparse and dense problems also reach the reference's own expectations
(``tests/test_capi.py``). The callbacks' values at the starting point are
the same bits through both loaders.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS before the thread limit)
import torch
from threadpoolctl import threadpool_limits

import examples.sparse_ex1 as jax_sx1
from hiop_tpu import capi as jcapi
from hiop_tpu_torch import capi as tcapi

# The problems here are small: torch's intra-op thread pool costs more than
# it gains, and its spinning threads slow the other test workers.
torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))
_EXAMPLES = {"sparse": "c_problem_example", "dense": "c_dense_problem_example",
             "mds": "c_mds_problem_example"}
_SOLVE = {"sparse": "solve_sparse_problem", "dense": "solve_dense_problem",
          "mds": "solve_mds_problem"}
_CLASS = {"sparse": "CSparseProblem", "dense": "CDenseProblem", "mds": "CMdsProblem"}


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One OpenBLAS thread for numpy/scipy inside these tests: under six
    pytest-xdist workers on an 8-core CPU, OpenBLAS's spinning threads starve
    each other (tests/test_torch_sparse_solve.py). Lifted after each test."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    cc = shutil.which("gcc") or shutil.which("cc")
    assert cc is not None, "no C compiler"
    d = tmp_path_factory.mktemp("torch_capi")
    out = {}
    for kind, name in _EXAMPLES.items():
        path = str(d / f"{name}.so")
        subprocess.run([cc, "-O2", "-shared", "-fPIC", os.path.join(_HERE, "data", f"{name}.c"),
                        "-o", path, "-lm"], check=True, capture_output=True)
        out[kind] = path
    return out


@pytest.fixture(scope="module")
def jax_results(libs):
    """``hiop_tpu``'s solve of each library, once per module."""
    with threadpool_limits(limits=1):
        return {kind: getattr(jcapi, _SOLVE[kind])(path, verbosity_level=0)
                for kind, path in libs.items()}


def _solve_port(libs, kind):
    return getattr(tcapi, _SOLVE[kind])(libs[kind], verbosity_level=0, compute_mode="cpu")


@pytest.mark.parametrize("kind", list(_EXAMPLES))
def test_c_problem_solve_matches_jax(libs, jax_results, kind):
    rt, rj = _solve_port(libs, kind), jax_results[kind]
    assert rt.status.is_success and rt.status.name == rj.status.name
    assert rt.iterations == rj.iterations
    assert abs(rt.obj - rj.obj) <= 1e-8 * max(1.0, abs(rj.obj))
    if kind == "sparse":
        ref, tol = jax_sx1.SELFCHECK[50]
        assert abs((rt.obj - ref) / (1 + ref)) <= tol
    elif kind == "dense":
        # min sum 0.5 (x - 1)^2 s.t. sum x = n/2: x_i = 1/2, obj = n/8
        assert abs(rt.obj - 20 / 8.0) < 1e-6


def test_c_problem_struct_fields(libs):
    p = tcapi.CSparseProblem(libs["sparse"])
    assert p.get_prob_sizes() == (50, 49)
    xl, xu = p.get_vars_info()
    assert xl[2] == 1.5 and xu[2] == 10.0
    i, j = p.jac_structure()
    assert i.size == p.nnz_jac
    assert p.get_sparse_blocks_info() == jcapi.CSparseProblem(libs["sparse"]).get_sparse_blocks_info()


def _evaluations(p, x, lam):
    """Every callback of the problem at (x, lam) as numpy arrays."""
    out = [p.get_vars_info(), p.get_cons_info(), p.get_starting_point(), p.eval_f(x),
           p.eval_grad_f(x), p.eval_cons(x)]
    if hasattr(p, "eval_jac_vals"):
        out += [p.jac_structure(), p.hess_structure(), p.eval_jac_vals(x),
                p.eval_hess_vals(x, 0.5, lam)]
    elif hasattr(p, "eval_jac_blocks"):
        out += [p.jac_sparse_structure(), p.eval_jac_blocks(x), p.eval_hess_blocks(x, 0.5, lam)]
    else:
        out.append(p.eval_jac_cons(x))
    flat = []
    for v in out:
        flat.extend(v if isinstance(v, tuple) else [v])
    return [np.asarray(v) for v in flat]


@pytest.mark.parametrize("kind", list(_EXAMPLES))
def test_c_callbacks_match_jax_loader(libs, kind):
    """The port's loader hands the C functions host copies of the solver's
    tensors and returns the same values as ``hiop_tpu``'s."""
    pt = getattr(tcapi, _CLASS[kind])(libs[kind])
    pj = getattr(jcapi, _CLASS[kind])(libs[kind])
    assert not pt.jittable and not pt.takes_dtensor
    n, m = pt.get_prob_sizes()
    assert (n, m) == pj.get_prob_sizes()
    rng = np.random.default_rng(11)
    x = pt.get_starting_point() + 0.1 * rng.standard_normal(n)
    lam = rng.standard_normal(m)
    got = _evaluations(pt, torch.as_tensor(x), torch.as_tensor(lam))
    want = _evaluations(pj, x, lam)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a, b)
