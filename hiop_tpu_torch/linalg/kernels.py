"""Build, load and count the hand-written CUDA kernels.

The sources live in ``hiop_tpu_torch/csrc/``. At first use each ``.cu`` file
is compiled by its own ``nvcc`` process (all started together) for
``sm_90a`` into ``build/kernels/`` beside the package, and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``. The library's name carries a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.

Every C entry point launches on the stream it is given, allocates no
device memory, and returns the first CUDA error of its launches (0 on
success). Each replays its factorization's launch sequence as a CUDA graph,
captured at the first call for a given (kernel, n, dtype, batch) and
pointer buffer (:func:`args_buffer`); the Python wrappers in
:mod:`hiop_tpu_torch.linalg.cholesky` and
:mod:`hiop_tpu_torch.linalg.ldl_blocked` allocate outputs and scratch and
raise on a nonzero return. Each kernel has a single-matrix and a batched
entry point: the batched one factors S matrices of one n, stacked as an
(S, n, n) tensor, in one launch sequence (``gridDim.z = S``).

:data:`stats` counts the launches of each wrapper (a batched launch once,
under its own name, with its S in :attr:`KernelStats.batches`). A run sets
the counts to zero, drives the solver, and reads them to show which kernels
its main path went through. With ``stats.timing`` set, each launch is also
bracketed by CUDA events so that the kernels' device time over a run can be
summed; the same switch turns on the solver's spans
(:mod:`hiop_tpu_torch.utils.trace`).

:attr:`KernelStats.lanes` counts, at the dispatchers of
:mod:`~hiop_tpu_torch.linalg.cholesky` and
:mod:`~hiop_tpu_torch.linalg.ldl_blocked`, which lane served each call:
``kernel`` (the hand-written kernel), ``plain`` (its plain PyTorch version,
a CPU tensor) or ``library`` (``torch.linalg.cholesky_ex``, the Cholesky
under ``exec_policies`` = ``xla``/``seq``/``raja``). It counts on the CPU
too, so a CPU run shows which lane the option selected.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path

from hiop_tpu_torch.utils import trace as _trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("cholesky.cu", "ldl_nopiv.cu")
HEADERS = ("dense_blocked.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: block-column width of the kernels (``NB`` in csrc/dense_blocked.cuh); the
#: wrappers size the diagonal-block scratch with it
NB = 64
#: depth of the delayed trailing update (``OB``) and width of the diagonal
#: block's leaves (``leaf32``); the plain versions block with both
OB = 4 * NB
LEAF = 32


class KernelStats:
    """Launch counts per wrapper, and optional per-launch CUDA events."""

    def __init__(self) -> None:
        self.launches: Counter = Counter()   # name -> launches
        self.sizes: Counter = Counter()      # (name, n, dtype) -> launches
        self.batches: Counter = Counter()    # (name, n, dtype, S) -> batched launches
        self.lanes: Counter = Counter()      # (op, lane) -> calls at the dispatcher
        self.library: Counter = Counter()    # (op, n, dtype) -> library-lane calls
        self.events: list = []               # (name, n, dtype, start, end) when timing

    @property
    def timing(self) -> bool:
        """Per-launch CUDA events, and the solver's spans
        (:data:`hiop_tpu_torch.utils.trace.recorder`): one switch for both."""
        return _trace.recorder.on

    @timing.setter
    def timing(self, on: bool) -> None:
        _trace.recorder.on = bool(on)

    def reset(self) -> None:
        self.launches.clear()
        self.sizes.clear()
        self.batches.clear()
        self.lanes.clear()
        self.library.clear()
        self.events.clear()

    def begin(self):
        if not self.timing:
            return None
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def count(self, name: str, n: int, dtype, start, batch=None) -> None:
        dname = str(dtype).replace("torch.", "")
        self.launches[name] += 1
        self.sizes[(name, n, dname)] += 1
        if batch is not None:
            self.batches[(name, n, dname, batch)] += 1
        if start is not None:
            import torch

            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events.append((name, n, dname, start, end))

    def lane(self, op: str, lane: str, A=None, start=None) -> None:
        """Count one call of ``op`` served by ``lane``; a ``library`` call
        also by size, and under :attr:`timing` its CUDA events go into
        :attr:`events` as ``<op>_library``."""
        self.lanes[(op, lane)] += 1
        if lane != "library":
            return
        dname = str(A.dtype).replace("torch.", "")
        self.library[(op, A.shape[-1], dname)] += 1
        if start is not None:
            import torch

            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events.append((op + "_library", A.shape[-1], dname, start, end))

    def device_ms(self, by_dtype: bool = False) -> dict:
        """Summed kernel milliseconds over the recorded launches, by name,
        or by (name, dtype) (synchronizes)."""
        import torch

        torch.cuda.synchronize()
        out: dict = {}
        for name, _, dname, s, e in self.events:
            key = (name, dname) if by_dtype else name
            out[key] = out.get(key, 0.0) + s.elapsed_time(e)
        return out


stats = KernelStats()

_lock = threading.Lock()
_lib = None
#: (seconds, compiler log) of the build this process did, None if it loaded
#: a library that was already built
last_build = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                           "where the CUDA toolkit is installed")
    return path


def _library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libhiop_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernel library if it is not built yet; returns
    its path. One ``nvcc`` per source, all running at once."""
    global last_build
    lib = _library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, objs, failed = [], [], []
        for obj, p in procs:
            out, _ = p.communicate()
            log.append(out)
            objs.append(str(obj))
            if p.returncode != 0:
                failed.append(obj.name)
        if failed:
            raise RuntimeError("nvcc failed for %s:\n%s" % (failed, "\n".join(log)))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp_lib), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError("linking the kernel library failed:\n" + link.stdout)
        tmp_lib.replace(lib)  # atomic: a concurrent build never sees half a file
    last_build = (time.perf_counter() - t0, "\n".join(log))
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            for dt in ("f64", "f32"):
                fn = getattr(lib, f"hiop_cholesky_{dt}")
                fn.argtypes = [p, p, i, p, p, p, p]
                fn.restype = i
                fn = getattr(lib, f"hiop_ldl_nopiv_{dt}")
                fn.argtypes = [p, p, p, i, p, p, p, p]
                fn.restype = i
                fn = getattr(lib, f"hiop_cholesky_batched_{dt}")
                fn.argtypes = [p, p, i, i, p, p, p, p]
                fn.restype = i
                fn = getattr(lib, f"hiop_ldl_nopiv_batched_{dt}")
                fn.argtypes = [p, p, p, i, i, p, p, p, p]
                fn.restype = i
            lib.hiop_args_bytes.restype = i
            if lib.hiop_args_bytes() > ARGS_BYTES:
                raise RuntimeError("kernel library: Args is larger than ARGS_BYTES")
            _lib = lib
        return _lib


#: bytes of the device buffer that carries one factorization's pointers
#: (``Args`` in csrc/dense_blocked.cuh); a batch of S takes S of them
ARGS_BYTES = 64
_args_buffers: dict = {}


def args_buffer(name: str, A, batch: int = 1):
    """The device buffer of pointers for kernel ``name`` at A's size, dtype,
    device and batch (``A`` is one matrix or the (S, n, n) stack). The
    kernels capture their launch sequence once per buffer as a CUDA graph,
    so the buffer of one (kernel, n, dtype, batch) lives as long as the
    process and is reused by every call."""
    import torch

    key = (name, A.shape[-1], A.dtype, A.device, batch)
    buf = _args_buffers.get(key)
    if buf is None:
        buf = torch.empty((batch * ARGS_BYTES // 8,), dtype=torch.int64, device=A.device)
        _args_buffers[key] = buf
    return buf


def check_input(A, name: str, batched: bool = False) -> None:
    """What both kernels take: a square, contiguous f32/f64 CUDA matrix, or
    for the batched entry points an (S, n, n) stack of them."""
    import torch

    if not A.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {A.dtype} is not float32/float64")
    dims = 3 if batched else 2
    if A.dim() != dims or A.shape[-2] != A.shape[-1]:
        what = "an (S, n, n) stack of square matrices" if batched else "a square matrix"
        raise ValueError(f"{name}: expected {what}, got {tuple(A.shape)}")
    if batched and not 1 <= A.shape[0] <= 65535:
        raise ValueError(f"{name}: the batch must hold 1 to 65535 matrices, got {A.shape[0]}")
    if not A.is_contiguous():
        raise ValueError(f"{name}: the input must be contiguous (row-major)")


def dtype_suffix(dtype) -> str:
    import torch

    return "f64" if dtype == torch.float64 else "f32"


def raise_on_error(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {rc})")
