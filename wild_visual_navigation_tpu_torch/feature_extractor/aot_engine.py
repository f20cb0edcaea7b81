"""Ahead-of-time exported inference engine.

Port of wild_visual_navigation_tpu/feature_extractor/aot_engine.py, the
counterpart of the reference's TensorRT engine (build offline, load and
run at deploy time). Where the JAX package compiles `jax.jit(fn).lower()`
at one input shape and keeps its executables in XLA's persistent cache,
the port exports the program with `torch.export` at one input shape and
saves the `ExportedProgram` beside the engine spec; a deploying process
loads it and runs it eagerly, op by op, with no Python model code. Kernel
K1 is the operator `wvn::flash_attention` (ops/flash_attention.py), one
node of the exported graph, which runs the kernel again when loaded: the
loader imports that module first, so the operator is registered.

`enable_persistent_cache` is the counterpart of XLA's persistent cache:
the directory where ops/_cuda.py builds and finds the hashed kernel
library, so a warm boot runs no nvcc.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch
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


class _Fn(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor):
        return self.fn(x)


class AOTEngine:
    """A program exported at one input shape; call it like the reference's
    TrtModel. `fn_or_module` takes the input tensor alone (its weights are
    the module's, or closed over by the function)."""

    def __init__(self, fn_or_module, example_input: torch.Tensor):
        module = fn_or_module if isinstance(fn_or_module, torch.nn.Module) else _Fn(fn_or_module)
        t0 = time.perf_counter()
        with torch.no_grad():
            program = torch.export.export(module, (example_input,))
        self.compile_seconds = time.perf_counter() - t0
        self._adopt(program)

    @classmethod
    def from_program(cls, program: torch.export.ExportedProgram) -> "AOTEngine":
        engine = cls.__new__(cls)
        engine.compile_seconds = 0.0
        engine._adopt(program)
        return engine

    def _adopt(self, program: torch.export.ExportedProgram) -> None:
        self.program = program
        self._module = program.module()
        name = program.graph_signature.user_inputs[0]
        spec = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name == name).meta["val"]
        self.input_shape = tuple(int(n) for n in spec.shape)
        self.input_dtype = spec.dtype
        self.device = spec.device
        self._flops: Optional[int] = None

    def __call__(self, x: torch.Tensor):
        if tuple(x.shape) != self.input_shape:
            raise ValueError(f"AOTEngine expects {self.input_shape}, got {tuple(x.shape)}")
        with torch.no_grad():
            return self._module(x)

    def _example(self) -> torch.Tensor:
        return torch.zeros(self.input_shape, dtype=self.input_dtype, device=self.device)

    @property
    def flops(self) -> int:
        """Floating-point (and int8) operations of one call, counted by
        FlopCounterMode over a call on zeros."""
        if self._flops is None:
            counter = FlopCounterMode(display=False)
            with counter:
                self(self._example())
            self._flops = counter.get_total_flops()
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
        weights = list(self.program.state_dict.values()) + list(self.program.constants.values())
        return {"argument_bytes": sum(t.numel() * t.element_size() for t in weights + [x]),
                "output_bytes": sum(t.numel() * t.element_size() for t in outs),
                "peak_bytes": torch.cuda.max_memory_allocated(self.device) - base}


def program_path(spec_path: str) -> str:
    """Where the ExportedProgram beside an engine spec lives."""
    return f"{spec_path}.pt2"


def save_engine_spec(path: str, params, input_shape: Tuple[int, ...], input_dtype: str, meta: dict,
                     program: Optional[torch.export.ExportedProgram] = None) -> str:
    """Persist the weights and the input contract (tensors, tuples, strings
    and numbers only, so `torch.load(weights_only=True)` reads them), and
    the exported program beside them when one is given."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"params": params, "input_shape": tuple(input_shape), "input_dtype": str(input_dtype),
                "meta": meta}, path)
    if program is not None:
        torch.export.save(program, program_path(path))
    return path


def load_engine_spec(path: str, map_location=None):
    """(params, input_shape, input_dtype, meta), as the JAX function returns."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    return payload["params"], tuple(payload["input_shape"]), payload["input_dtype"], payload["meta"]


def load_engine(path: str) -> AOTEngine:
    """The engine saved beside the spec at `path`, ready to call."""
    return AOTEngine.from_program(torch.export.load(program_path(path)))
