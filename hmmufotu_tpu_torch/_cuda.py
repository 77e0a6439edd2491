"""Device selection, kernel build and launch bookkeeping.

The Hopper kernels live as CUDA C++ sources under ``csrc/``.  Each
source is compiled by ``nvcc`` into a shared library with a plain C
interface (``extern "C"`` functions taking raw pointers and the CUDA
stream) under the gitignored ``_build/`` directory at first use, and is
loaded with ``ctypes``.  Nothing here runs at import time: the CPU tests
import every module on a host without ``nvcc`` or a card.

Several processes may build at once (``assign --num-processes``): a
lock file in ``_build/`` lets one process build while the others wait,
and each library is compiled under a temporary name and renamed onto
its final path, so a process only ever loads a whole library.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
# every kernel source of the package, by library name
KERNEL_SOURCES = ("viterbi", "place")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # no FMA contraction: the plain PyTorch versions do each
              # multiply and add as separate rounded ops, and the Viterbi
              # comb must match them bit for bit
              "-fmad=false",
              # per-kernel registers, shared memory and spills in the
              # build log
              "-Xptxas=-v"]

_build_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def resolve_device(device) -> torch.device:
    """torch.device for an entry point's ``device=`` argument.

    CUDA is the default everywhere; without a card it raises instead of
    quietly running on the host.  The CPU runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but no CUDA GPU is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        # parity rule 3: f32 products that stand in for the reference's
        # Precision.HIGHEST einsums (seed p-dist counts, P(t)) must stay
        # full f32 — TF32 keeps ~3 decimal digits and would round
        # mismatch counts above 2^11
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class LaunchCounter:
    """Plain integer count of kernel launches (thread-safe: the assign
    stream launches the Viterbi kernel from a worker thread)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def add(self, k: int = 1):
        with self._lock:
            self.n += k

    def reset(self):
        with self._lock:
            self.n = 0


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = _lib_path(name)
    src = os.path.join(CSRC, f"{name}.cu")
    return (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src))


def _nvcc_cmd(name: str, out: str) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out,
            os.path.join(CSRC, f"{name}.cu")]


def build_all(names=KERNEL_SOURCES) -> str:
    """Compile every stale kernel source, one nvcc process per source,
    all started together.  Returns the compilers' output.

    The build holds an exclusive lock on ``_build/.lock`` across
    processes; a process that waited for it finds the libraries another
    built fresh and builds nothing."""
    with _build_lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)     # released on close
            todo = [n for n in names if _stale(n)]
            tmp = {n: f"{_lib_path(n)}.{os.getpid()}.tmp" for n in todo}
            procs = [(n, subprocess.Popen(
                _nvcc_cmd(n, tmp[n]), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)) for n in todo]
            errors, logs = [], []
            for n, p in procs:
                out, _ = p.communicate()
                logs.append(f"csrc/{n}.cu:\n{out}")
                if p.returncode != 0:
                    errors.append(f"nvcc failed for csrc/{n}.cu:\n{out}")
                else:
                    os.replace(tmp[n], _lib_path(n))
            for path in tmp.values():
                if os.path.exists(path):
                    os.remove(path)
        if errors:
            raise RuntimeError("\n".join(errors))
        return "\n".join(logs)


def load_library(name: str) -> ctypes.CDLL:
    """The compiled library of csrc/<name>.cu, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _build_lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_lib_path(name))
        return _libs[name]


def launch(what: str, fn, on: torch.Tensor, *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` of a kernel whose tensors
    lie on the card of ``on``: under that card's device guard, so the
    launcher's device queries and its launch go to that card, and on that
    card's current stream, the one torch queues its own ops on these
    tensors to.  Raises on a non-zero cudaError_t."""
    dev = on.device
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def require(t: torch.Tensor, dtype, ndim: int, name: str) -> None:
    """Validate a tensor handed to a kernel launcher."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
