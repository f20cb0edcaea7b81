"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source compiles to an object in its own `nvcc` process, all started
together; one more `nvcc` call links the objects into one shared library
with a plain C interface, loaded with ctypes. The library's file name
carries a hash of the sources and flags, so a stale build is never
loaded. The
build happens at first use, never at import: the CPU tests import every
module and a CPU tensor never reaches this file.

Every C entry point returns `cudaGetLastError()` after its launch;
`check` raises on anything but 0. ptxas reports each kernel's registers,
shared memory and spills while compiling (`-Xptxas -v`); the build keeps
that report beside the library (`resource_report`). The build directory
is csrc/_build/ unless `set_build_dir` names another before the library
is loaded (feature_extractor/aot_engine.py::enable_persistent_cache): a
process that finds the hashed library there runs no nvcc.
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
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
COMPILE_FLAGS = ("-Xptxas", "-v")  # per-kernel registers, shared memory and spills, kept in the build's report

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types (every pointer, the stream included, is c_void_p)
SIGNATURES = {
    # q, k, v, o, host int64[12] of (B, H, S) strides, B, H, S, D, dtype, scale, block_q, block_k, stream
    "wvn_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # D, dtype, block_q, block_k
    "wvn_flash_attention_smem_bytes": [_I, _I, _I, _I],
    # hw, zsts, starts, runs, coef, w1t, b1, gt, v, consts, trav, reco, B, Hp, H, W, K1, R, D, stream
    "wvn_pixelwise_score": [_P] * 12 + [_I] * 6 + [_F, _P],
    "wvn_pixelwise_hidden_width": [],
    "wvn_pixelwise_score_smem_bytes": [_I],
    # feats, centers, ids, new_centers, partials, mask, rowsums, rowmask, tickets, B, H, W, K, ws, win2, stream
    "wvn_slic_step": [_P] * 9 + [_I, _I, _I, _I, _F, _F, _P],
    "wvn_slic_step_smem_bytes": [_I, _I, _I],
    # hulls, hull_valid, out, B, E, H, W, stream
    "wvn_fill_hulls": [_P, _P, _P, _I, _I, _I, _I, _P],
    # points, valid, hulls, hull_valid, out, B, N, E, H, W, stream
    "wvn_hull_fill": [_P] * 5 + [_I] * 5 + [_P],
}

_lib = None
_lib_lock = threading.Lock()  # one build and one binding, whichever thread launches first
_count_lock = threading.Lock()  # the wrappers' `launches` counters
_recording = threading.local()  # `launches`: a capturing thread's record (recording_launches)
build_seconds: float | None = None  # wall time of this process's nvcc call, if it made one
builds = 0  # nvcc builds this process ran (a steady run makes none after its first launch)


def set_build_dir(path) -> Path:
    """Build into and load from `path` from now on. Raises once the
    library is loaded: this process keeps the one it has."""
    global BUILD_DIR
    with _lib_lock:
        if _lib is not None:
            raise RuntimeError(f"the kernel library is already loaded from {BUILD_DIR}; set the build directory "
                               "before the first launch")
        BUILD_DIR = Path(path).resolve()
    return BUILD_DIR


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + COMPILE_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel and return their outputs; raise with
    the output of any that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    failed, outs = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build() -> Path:
    """Compile csrc/*.cu into csrc/_build/ unless the hashed library
    exists: one `nvcc -c` per source, all at once, then one link. Returns
    the library's path and prints the build time on its own line."""
    global build_seconds, builds
    lib_path = BUILD_DIR / f"libwvn_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs = [Path(tmp_dir) / f"{src.stem}.o" for src in _sources()]
        outs = _run([[nvcc, *NVCC_FLAGS, *COMPILE_FLAGS, "-c", "-o", str(o), str(src)]
                     for src, o in zip(_sources(), objs)])
        tmp = Path(tmp_dir) / lib_path.name
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        report = "".join(f"== {src.name}\n{out}" for src, out in zip(_sources(), outs))
        lib_path.with_suffix(".ptxas.txt").write_text(report)
        os.replace(tmp, lib_path)  # atomic: a concurrent loader sees the old name or the whole file
    build_seconds = time.perf_counter() - t0
    builds += 1
    print(f"[wvn_torch] built {lib_path.name} from {len(objs)} sources in {build_seconds:.2f} s", flush=True)
    return lib_path


def resource_report() -> str:
    """ptxas's per-kernel report (registers, shared memory, spills) from the
    build of the current library."""
    report = build().with_suffix(".ptxas.txt")
    return report.read_text() if report.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call). Threads that call
    it together wait for one build and one binding."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
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


def count_launch(wrapper, variant: str | None = None) -> None:
    """Add one to `wrapper.launches` (and to `wrapper.variant_launches`
    [variant], for a wrapper that launches several instantiations); the
    camera thread and the learning thread launch kernels at the same time.
    Inside `recording_launches` the thread's launch is recorded instead."""
    recorded = getattr(_recording, "launches", None)
    if recorded is not None:
        recorded[(wrapper, variant)] = recorded.get((wrapper, variant), 0) + 1
    else:
        count_recorded({(wrapper, variant): 1})


@contextlib.contextmanager
def recording_launches():
    """This thread's launches inside the block are recorded, not counted: a
    CUDA graph's capture enqueues them and runs none. Yields the record,
    {(wrapper, variant): launches}, for `count_recorded` at each replay.
    Other threads count as usual."""
    _recording.launches = recorded = {}
    try:
        yield recorded
    finally:
        _recording.launches = None


def count_recorded(recorded: dict) -> None:
    """Count the launches of a `recording_launches` record, {(wrapper,
    variant): launches}: one replay of the captured graph runs each."""
    with _count_lock:
        for (wrapper, variant), n in recorded.items():
            wrapper.launches += n
            if variant is not None:
                wrapper.variant_launches[variant] = wrapper.variant_launches.get(variant, 0) + n


def set_launches(wrapper, n: int) -> None:
    """Set `wrapper.launches` to n; at 0 its count by instantiation starts
    afresh too."""
    with _count_lock:
        wrapper.launches = n
        if n == 0 and hasattr(wrapper, "variant_launches"):
            wrapper.variant_launches = {}


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
