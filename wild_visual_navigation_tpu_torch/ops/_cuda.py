"""Build and load the port's CUDA kernels (csrc/*.cu).

All sources compile in one `nvcc` call into one shared library with a
plain C interface, loaded with ctypes. The library's file name carries a
hash of the sources and flags, so a stale build is never loaded. The
build happens at first use, never at import: the CPU tests import every
module and a CPU tensor never reaches this file.

Every C entry point returns `cudaGetLastError()` after its launch;
`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types (every pointer, the stream included, is c_void_p)
SIGNATURES = {
    "wvn_flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "wvn_pixelwise_score": [_P] * 11 + [_I, _I, _I, _I, _I, _F, _P],
    "wvn_pixelwise_hidden_width": [],
    "wvn_slic_step": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
}

_lib = None
build_seconds: float | None = None  # wall time of this process's nvcc call, if it made one


def _nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cands:
        path = Path(root) / "bin" / "nvcc"
        if root and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's kernels build from csrc/ at first use")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into csrc/_build/ unless the hashed library
    exists; returns its path and prints the build time on its own line."""
    global build_seconds
    lib_path = BUILD_DIR / f"libwvn_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees the old name or the whole file
    print(f"[wvn_torch] built {lib_path.name} from {len(_sources())} sources in {build_seconds:.2f} s", flush=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.wvn_error_string.argtypes = [ctypes.c_int]
        lib.wvn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = library().wvn_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: expected 16-byte aligned tensors")
