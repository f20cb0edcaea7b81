"""Ahead-of-time compiled inference engine.

Port of wild_visual_navigation_tpu/feature_extractor/aot_engine.py, the
counterpart of the reference's TensorRT engine (build offline, load and
run at deploy time). Where the JAX package compiles `jax.jit(fn).lower()`
at one input shape into an XLA executable, the port exports the program
with `torch.export` at one input shape and compiles it with AOTInductor
(`torch._inductor.aoti_compile_and_package`) into a `.pt2` package: a
shared library of the whole program, its weights and its Triton kernels'
binaries. `save_engine_spec` writes the package beside the engine spec and
`load_engine` loads it with AOTInductor's C++ loader, which compiles
nothing (`aoti_load_package` would probe the host's CPU by compiling test
programs, for a warning). A package that fails to compile or load raises;
nothing runs the exported program in its place.

Kernel K1 stays the operator `wvn::flash_attention` (ops/flash_attention.py)
inside the package: Inductor keeps a custom operator as a call through its
proxy executor, so the compiled program launches the kernel through the
operator's body, counts its launches, and lowers no attention of its own.
This module imports that module first, so the operator is registered
before a package calls it.

AOTInductor compiles and links its C++ wrapper with OpenMP; the build takes
the first of $CXX, g++ and c++ that does (`host_compiler`).

`enable_persistent_cache` is the counterpart of XLA's persistent cache:
the directory where ops/_cuda.py builds and finds the hashed kernel
library, so a warm boot runs no nvcc.
"""

from __future__ import annotations

import functools
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry, register_flop_formula

from ..ops import _cuda
from ..ops import flash_attention as _k1  # noqa: F401  (registers the operator wvn::flash_attention)


def _register_flops() -> None:
    """Flop formulas FlopCounterMode lacks: K1's operator, 4·B·H·S·S_kv·D
    (two products of 2·S·S_kv·D per head), and int8 `_int_mm`, 2·M·N·K."""
    attn = torch.ops.wvn.flash_attention
    if attn not in flop_registry:
        @register_flop_formula(attn)
        def _attn_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
            B, H, S, D = q_shape
            return 4 * B * H * S * k_shape[2] * D

    if torch.ops.aten._int_mm not in flop_registry:
        @register_flop_formula(torch.ops.aten._int_mm)
        def _int_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
            return 2 * a_shape[0] * a_shape[1] * b_shape[1]


_register_flops()


def enable_persistent_cache(path: str) -> Path:
    """Build and find the kernel library in `path` (made if missing). Call
    it before the first kernel launch; it raises once the library is
    loaded."""
    os.makedirs(path, exist_ok=True)
    return _cuda.set_build_dir(path)


@functools.cache
def host_compiler() -> str:
    """The C++ compiler AOTInductor builds packages with: the first of $CXX,
    g++ and c++ that compiles and links a program with -fopenmp, as
    AOTInductor links every package."""
    tried = []
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "omp.cpp")
        with open(src, "w") as f:
            f.write("#include <omp.h>\nint main() { return omp_get_max_threads() > 0 ? 0 : 1; }\n")
        for cand in (os.environ.get("CXX"), "g++", "c++"):
            path = shutil.which(cand) if cand else None
            if path is None or path in tried:
                continue
            tried.append(path)
            res = subprocess.run([path, "-fopenmp", src, "-o", os.path.join(d, "omp")], capture_output=True)
            if res.returncode == 0:
                return path
    raise RuntimeError(f"no C++ compiler links with -fopenmp (tried {tried or 'none found'})")


class _Fn(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor):
        return self.fn(x)


def _count_flops(program: torch.export.ExportedProgram, shape, dtype, device) -> int:
    """Floating-point (and int8) operations of one call of the program,
    counted by FlopCounterMode over a call on fake tensors (shapes only)."""
    module = program.module()
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.zeros(shape, dtype=dtype, device=device)
        counter = FlopCounterMode(display=False)
        with counter:
            module(x)
    return counter.get_total_flops()


class _Package:
    """A compiled package loaded by AOTInductor's C++ loader: call it with
    the input tensor."""

    def __init__(self, path: str, device: torch.device):
        index = device.index if device.type == "cuda" and device.index is not None else -1
        self.loader = torch._C._aoti.AOTIModelPackageLoader(str(path), "model", False, 1, index)
        self._out_spec = pytree.treespec_loads(self.loader.get_call_spec()[1])

    def __call__(self, x: torch.Tensor):
        return pytree.tree_unflatten(self.loader.boxed_run([x]), self._out_spec)


class AOTEngine:
    """A program compiled ahead of time at one input shape; call it like
    the reference's TrtModel. `fn_or_module` takes the input tensor alone
    (its weights are the module's, or closed over by the function).
    `compile_seconds` is the export and the compilation; `package` the
    compiled file, `program` the exported program it was compiled from
    (None for a loaded engine)."""

    def __init__(self, fn_or_module, example_input: torch.Tensor):
        module = fn_or_module if isinstance(fn_or_module, torch.nn.Module) else _Fn(fn_or_module)
        t0 = time.perf_counter()
        with torch.no_grad():
            program = torch.export.export(module, (example_input,))
        self._dir = tempfile.TemporaryDirectory(prefix="wvn_engine_")
        package = os.path.join(self._dir.name, "engine.pt2")
        with torch._inductor.config.patch({"cpp.cxx": (None, host_compiler())}):
            torch._inductor.aoti_compile_and_package(program, package_path=package)
        self.compile_seconds = time.perf_counter() - t0
        self.program = program
        self.input_shape = tuple(example_input.shape)
        self.input_dtype = example_input.dtype
        self.device = example_input.device
        self._flops = _count_flops(program, self.input_shape, self.input_dtype, self.device)
        self.weight_bytes = sum(t.numel() * t.element_size()
                                for t in list(program.state_dict.values()) + list(program.constants.values()))
        self._adopt(package)

    @classmethod
    def from_package(cls, package: str, input_shape, input_dtype: torch.dtype, device, flops: int,
                     weight_bytes: int) -> "AOTEngine":
        """A compiled package loaded again, with the input contract, flops
        and weight bytes its spec recorded."""
        engine = cls.__new__(cls)
        engine.compile_seconds, engine.program = 0.0, None
        engine.input_shape, engine.input_dtype, engine.device = tuple(input_shape), input_dtype, torch.device(device)
        engine._flops, engine.weight_bytes = flops, weight_bytes
        engine._adopt(package)
        return engine

    def _adopt(self, package: str) -> None:
        self.package = package
        self._run = _Package(package, self.device)

    def __call__(self, x: torch.Tensor):
        if tuple(x.shape) != self.input_shape:
            raise ValueError(f"AOTEngine expects {self.input_shape}, got {tuple(x.shape)}")
        return self._run(x)

    def _example(self) -> torch.Tensor:
        return torch.zeros(self.input_shape, dtype=self.input_dtype, device=self.device)

    @property
    def flops(self) -> int:
        """Floating-point (and int8) operations of one call, counted on the
        exported program (FlopCounterMode over a call on fake tensors)."""
        return self._flops

    def memory_analysis(self) -> Optional[dict]:
        """Device bytes of one call on the card: the program's weights and
        the input ("argument_bytes"), the output ("output_bytes"), and the
        allocator's peak above what was allocated before the call
        ("peak_bytes"). None on the CPU."""
        if self.device.type != "cuda":
            return None
        x = self._example()
        torch.cuda.synchronize(self.device)
        base = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        out = self(x)
        torch.cuda.synchronize(self.device)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return {"argument_bytes": self.weight_bytes + x.numel() * x.element_size(),
                "output_bytes": sum(t.numel() * t.element_size() for t in outs),
                "peak_bytes": torch.cuda.max_memory_allocated(self.device) - base}


def program_path(spec_path: str) -> str:
    """Where the compiled package beside an engine spec lives."""
    return f"{spec_path}.pt2"


def save_engine_spec(path: str, params, input_shape: Tuple[int, ...], input_dtype: str, meta: dict,
                     engine: Optional[AOTEngine] = None) -> str:
    """Persist the weights and the input contract (tensors, tuples, strings
    and numbers only, so `torch.load(weights_only=True)` reads them), and,
    when an engine is given, its compiled package beside them with its
    flops, weight bytes and device in the spec."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"params": params, "input_shape": tuple(input_shape), "input_dtype": str(input_dtype), "meta": meta}
    if engine is not None:
        shutil.copyfile(engine.package, program_path(path))
        payload["engine"] = {"flops": int(engine.flops), "weight_bytes": int(engine.weight_bytes),
                             "device": str(engine.device)}
    torch.save(payload, path)
    return path


def load_engine_spec(path: str, map_location=None):
    """(params, input_shape, input_dtype, meta), as the JAX function returns."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    return payload["params"], tuple(payload["input_shape"]), payload["input_dtype"], payload["meta"]


def load_engine(path: str) -> AOTEngine:
    """The engine compiled beside the spec at `path`, loaded and ready to
    call; it compiles nothing."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    info = payload["engine"]
    return AOTEngine.from_package(program_path(path), payload["input_shape"],
                                  getattr(torch, payload["input_dtype"].removeprefix("torch.")), info["device"],
                                  info["flops"], info["weight_bytes"])
