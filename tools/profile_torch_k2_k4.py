#!/usr/bin/env python3
"""Where a launch of K2 (csrc/pixelwise_score.cu) and of K4
(csrc/fill_hulls.cu) spends its time, on the card.

    python3 tools/profile_torch_k2_k4.py        (from the root of the repository)

Builds each kernel's source and copies of it cut after a phase into a
temporary directory, and times each with CUDA events over 20 launches back
to back (medians of 30), so that the per-launch cost of a timed single
launch (about 5 us on an H100) drops out; phases follow by difference:
  * K2 at (1, 384, 28, 28) -> 224^2 and at B=4: the loads into shared
    memory alone; loads, H lerp and MMA (the epilogue skipped at run time);
    the whole kernel;
  * K4 at the reprojection's shape (32 footprints of 64 points, max_hull
    32, 224^2): the march alone (a 1 x 1 image), the fill alone from the
    hulls, the fill alone without its mask stores, and the whole launch.
The copies only add a return, a run-time false condition or drop the
stores; the kernels are otherwise unchanged.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "wild_visual_navigation_tpu_torch/csrc"


def _cut(src: str, marker: str, new: str) -> str:
    assert marker in src, marker
    return src.replace(marker, new, 1)


def variants() -> dict[str, tuple[str, str]]:
    """name -> (source file stem, source text)."""
    k2 = (CSRC / "pixelwise_score.cu").read_text()
    k4 = (CSRC / "fill_hulls.cu").read_text()
    loaded = '  asm volatile("cp.async.wait_all;\\n" ::: "memory");\n  __syncthreads();\n'
    store = "      *reinterpret_cast<uint4*>(mask + p) = make_uint4(w[0], w[1], w[2], w[3]);\n"
    return {
        "K2 whole": ("pixelwise_score", k2),
        "K2 loads only": ("pixelwise_score", _cut(k2, loaded, loaded + "  return;\n")),
        "K2 without the epilogue": ("pixelwise_score", _cut(k2, "    if (x < W) {", "    if (x < W && D < 0.f) {")),
        "K4": ("fill_hulls", k4),
        "K4 without mask stores": ("fill_hulls", _cut(k4, store, "      if (w[0] == 0x12345678u) " + store.lstrip())),
    }


def device_ms(launch, reps: int = 30, back_to_back: int = 20) -> float:
    import torch

    for _ in range(5):
        launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        e0.record()
        for _ in range(back_to_back):
            launch()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / back_to_back)
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_k2_k4: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.ops import _cuda
    from wild_visual_navigation_tpu_torch.ops.pixelwise_fused import fused_precompute
    from wild_visual_navigation_tpu_torch.ops.rasterize import convex_hull
    from wild_visual_navigation_tpu_torch.utils.params import load_head_npz, mlp_state_from_jax

    card = cs.card_line()
    print(card)
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, (name, (stem, text)) in enumerate(variants().items()):
            (Path(tmp) / f"v{i}.cu").write_text(text)
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", f"{tmp}/v{i}.so", f"{tmp}/v{i}.cu"]
            procs[name] = (i, stem, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (i, stem, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{out}")
            lib = ctypes.CDLL(f"{tmp}/v{i}.so")
            for fn in ("wvn_pixelwise_score", "wvn_fill_hulls", "wvn_hull_fill"):
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = _cuda.SIGNATURES[fn]
            libs[name] = lib

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)

    def checked(err):
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    mlp = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 384, "hidden_sizes": [256, 32, 1],
                                                             "reconstruction": True}}, device=dev)
    mlp.load_state_dict(mlp_state_from_jax(load_head_npz(ROOT / "assets/checkpoints/replay_demo_head_torch.npz")[0]))
    for B in (1, 4):
        with torch.no_grad():
            ops = fused_precompute(mlp, torch.randn(B, 384, 28, 28, device=dev, generator=g), 224, 224)
        trav = torch.empty((B, 224, 224), device=dev)
        reco = torch.empty_like(trav)
        ptrs = [x.data_ptr() for x in (ops.hw, ops.zsts, ops.starts, ops.runs, ops.coef, ops.w1t, ops.b1, ops.gt,
                                       ops.v, ops.consts, trav, reco)]
        args = (*ptrs, B, 28, 224, 224, 256, ops.runs.shape[0] - 1, 384.0, stream)
        for name in ("K2 loads only", "K2 without the epilogue", "K2 whole"):
            ms = device_ms(lambda: checked(libs[name].wvn_pixelwise_score(*args)))
            print(f"[k2 phases] B={B}, 224x224 from 28x28, {name}: {ms:.4f} ms per launch (20 back to back) | {card}")

    K224 = np.array([[134.4, 0, 112], [0, 134.4, 112], [0, 0, 1]])
    pts, valid = cs.scene_points(dev, np.random.default_rng(0), 32, K224, 224)
    hulls, hull_valid = convex_hull(pts, valid, max_hull=32)
    masks = torch.empty((32, 224, 224), dtype=torch.bool, device=dev)
    h_out = torch.empty((32, 32, 2), device=dev)
    v_out = torch.empty((32, 32), dtype=torch.bool, device=dev)
    march = (pts.data_ptr(), valid.data_ptr(), h_out.data_ptr(), v_out.data_ptr(), masks.data_ptr(), 32, 64, 32)
    for name in ("K4", "K4 without mask stores"):
        lib = libs[name]
        cases = {"march alone (1x1 image)": lambda: checked(lib.wvn_hull_fill(*march, 1, 1, stream)),
                 "fill alone from hulls": lambda: checked(lib.wvn_fill_hulls(
                     hulls.data_ptr(), hull_valid.data_ptr(), masks.data_ptr(), 32, 32, 224, 224, stream)),
                 "hull and fill": lambda: checked(lib.wvn_hull_fill(*march, 224, 224, stream))}
        for case, launch in cases.items():
            if name != "K4" and case.startswith("march"):
                continue
            print(f"[k4 phases] {name}, 32 footprints x 64 points, 224x224, {case}: {device_ms(launch):.4f} ms per "
                  f"launch (20 back to back) | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
