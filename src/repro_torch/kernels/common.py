"""Shared kernel plumbing: the ``nvcc`` build of ``csrc/*.cu`` and the ctypes
launch seam every hand-written kernel goes through.

Each source file is its own shared library with a plain C interface, built
on first use (or up front by :func:`build`, which starts one ``nvcc`` per
source, all together) into ``build/kernels/`` at the root of the checkout,
named by a hash of the source, the shared headers and the flags.  A build
writes to a temporary name and is moved into place with ``os.replace``, so
concurrent processes never load a half-written library.

Nothing here falls back to the CPU: a missing card, a missing ``nvcc``, a
failed build or a launch that CUDA refuses all raise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = ["ceil_div", "require_cuda", "aligned", "device_sms", "build",
           "library", "library_path", "CudaKernel", "CSRC", "BUILD_DIR",
           "NVCC_FLAGS"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
# -fmad=false: a contracted multiply-add rounds once where numpy rounds twice,
# and the float64 scans must equal numpy bitwise (the sources also spell the
# roundings out with __dmul_rn/__dadd_rn)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def require_cuda(*tensors) -> None:
    """Raise unless a CUDA device is present and every tensor lies on it."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the repro_torch kernels run only on the card; "
            "pin the 'numpy' or 'torch' backend to run on the CPU")
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")


def aligned(t):
    """``t`` contiguous and 16-byte aligned (a copy only where it is not),
    for kernels that read 16-byte rows or build TMA maps over them."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


_SMS: dict[int, int] = {}


def device_sms() -> int:
    """The current CUDA device's SM count, asked once a device: the launch
    shape queries size their grids by it."""
    import torch
    device = torch.cuda.current_device()
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels cannot be built on this machine")
    return path


def library_path(name: str) -> pathlib.Path:
    h = hashlib.blake2b(digest_size=8)
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()}.so"


def build(names=None) -> dict:
    """Build the named sources (default: all of ``csrc/*.cu``) that are not
    built yet, one ``nvcc`` process each, all started together.  Returns
    ``{name: {"seconds": s, "log": compiler output}}`` for those it built."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f".{out.name}.{os.getpid()}."
                            f"{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    done = {}
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return done


_LIBS: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


class CudaKernel:
    """One exported C launcher of a ``csrc`` library.

    Calling it launches on the given stream and raises if the C function
    returns a CUDA error (it returns ``cudaGetLastError()`` right after the
    launch).  ``launches`` counts the successful launches; it is the one
    place the count moves, so a run can show its path went through the
    kernel.  Threads may call one kernel at once (``sharded_coreset`` builds
    bands on a pool): a lock guards the symbol lookup and the count, not the
    launch.
    """

    def __init__(self, library: str, symbol: str, argtypes):
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    def __call__(self, *args) -> None:
        with self._lock:
            if self._fn is None:
                fn = getattr(library(self.library), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            fn = self._fn
        rc = fn(*args)
        if rc != 0:
            msg = _LIBS[self.library].kernel_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        with self._lock:
            self.launches += 1
