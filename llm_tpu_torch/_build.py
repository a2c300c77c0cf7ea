"""Build the CUDA kernels of `csrc/` at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -o build/kernels/lib<name>.so csrc/<name>.cu

into `build/kernels/` at the root of the checkout (listed in .gitignore).
A library is rebuilt when its source, or a header of `csrc/` that the
source includes (`#include "<header>"`), is newer.
Nothing builds at import: the CPU paths never need `nvcc`. Every C entry
point returns `cudaGetLastError()`; `check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}  # nvcc wall time per library built


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _so_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = _so_path(name)
    if not so.exists():
        return True
    cu = CSRC / f"{name}.cu"
    srcs = [cu] + [CSRC / line.split('"')[1]
                   for line in cu.read_text().splitlines()
                   if line.startswith('#include "')]
    return so.stat().st_mtime < max(s.stat().st_mtime for s in srcs)


def _start(name: str) -> tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def build(names: Iterable[str]) -> dict[str, float]:
    """Compile the stale libraries among `names`, one nvcc each, all started
    together. Returns nvcc seconds per library built."""
    t0 = time.monotonic()
    procs = {n: _start(n) for n in names if _stale(n)}
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
        os.replace(tmp, _so_path(name))
        BUILD_SECONDS[name] = time.monotonic() - t0
    return {n: BUILD_SECONDS[n] for n in procs}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built if needed, with each function's
    argtypes set from `signatures` (name -> list of ctypes types) and an
    int return (the cudaError_t)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_so_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err}")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None -> NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


class Launch:
    """A kernel launch whose arguments are ready (a wrapper has checked
    them and allocated the outputs): each call enqueues it on the current
    stream, checks the launch, counts it with `count()` and returns `out`.
    `keep` holds the tensors behind the pointers in `args`."""

    def __init__(self, fn, args: tuple, device, what: str, count, out,
                 keep: tuple = ()):
        self.fn, self.args, self.device = fn, args, device
        self.what, self.count, self.out, self.keep = what, count, out, keep

    def __call__(self):
        check(self.fn(*self.args, stream_ptr(self.device)), self.what)
        self.count()
        return self.out
