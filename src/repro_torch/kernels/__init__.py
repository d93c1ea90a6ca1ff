"""Build and load the port's hand-written CUDA kernels.

Each source under ``repro_torch/csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and bound with
``ctypes``. The build happens at first use (or up front through
``build_all``, which starts one ``nvcc`` per source in parallel) into
``repro_torch/_build/``, named by a digest of the source and the flags so a
changed source is rebuilt. Nothing is compiled at import time.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, ContextManager, Dict, List, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: library name -> CUDA source under csrc/
SOURCES = {"fused_sim": "fused_sim.cu", "scatter_add": "scatter_add.cu",
           "hitfind": "hitfind.cu", "rasterize": "rasterize.cu",
           "noise": "noise.cu"}

#: no --use_fast_math and no --fmad=false (see the sources' headers)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: where the CUDA toolkit puts nvcc when neither CUDA_HOME nor PATH names it
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

#: the watcher of the wrappers' plain versions (``repro_torch.analysis.
#: census``): called with a kernel's name, it returns the context manager
#: the plain version runs in; None when nothing watches
PLAIN_WATCH: Optional[Callable[[str], ContextManager]] = None


def plain_version(name: str) -> ContextManager:
    """The context a wrapper runs its plain version in, on CPU tensors,
    where on the card it would launch kernel ``name`` (and count it in
    ``LAUNCHES``): a null context unless ``PLAIN_WATCH`` is set."""
    watch = PLAIN_WATCH
    return contextlib.nullcontext() if watch is None else watch(name)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", DEFAULT_NVCC]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start one nvcc into a temporary file; returns (process, tmp, dest)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    dest = library_path(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, dest


def _finish_build(name: str, proc, tmp: str, dest: Path) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, dest)  # atomic: a concurrent reader sees old or new
    return out


def build_all(force: bool = False) -> Dict[str, str]:
    """Build every missing library at once, one nvcc per source in
    parallel. Returns {name: compiler output} of the libraries built; waits
    for every compiler before raising the first failure."""
    started = {}
    for name in SOURCES:
        if force or not library_path(name).is_file():
            started[name] = _start_build(name)
    logs, errors = {}, []
    for name, job in started.items():
        try:
            logs[name] = _finish_build(name, *job)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.is_file():
                _finish_build(name, *_start_build(name))
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def declare(lib: ctypes.CDLL, fn: str, argtypes: List) -> None:
    """Set ``argtypes`` and an int ``restype`` (the launch's cudaError_t)."""
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int


def check_tensor(name: str, x: torch.Tensor, dtype: torch.dtype,
                 shape: Tuple[int, ...], device: torch.device) -> None:
    """Raise unless ``x`` is a contiguous ``shape`` ``dtype`` tensor on
    ``device`` (what a kernel's pointer arithmetic assumes)."""
    if x.dtype != dtype or x.device != device \
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {tuple(shape)} {dtype} tensor on "
            f"{device}, got {tuple(x.shape)} {x.dtype} on {x.device}"
            f"{'' if x.is_contiguous() else ' (non-contiguous)'}")


def kernel_device(x: torch.Tensor) -> torch.device:
    """The device a wrapper serves: CUDA launches its kernel, CPU runs the
    plain version; anything else raises."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device


def error_string(err: int) -> str:
    """``cudaGetErrorString``'s text for a cudaError_t (through torch's
    binding of the CUDA runtime, which the card's launch initialised)."""
    return str(torch.cuda.CudaError(err))


def raise_on(err: int, what: str) -> None:
    """Raise when a launch returned a cudaError_t other than 0, with the
    runtime's text (an allocation failure reads "out of memory", which the
    streaming launcher's retry policy classifies as OOM)."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}: "
                           f"{error_string(err)}")
