#!/usr/bin/env python3
"""K1 (csrc/flash_attention.cuh and its units) as compiled, on the machine with the card.

    python3 tools/profile_torch_k1.py [--parent DIR [--host]]   (from the root of the repository)

Builds the kernel library and prints, for every instantiation of K1's
bodies (bf16 at each head dim and tile, fp32 at each head dim), ptxas's
registers, shared memory and spills.

With --parent DIR (a checkout of an earlier commit, e.g. unpacked with
`git archive`): compiles its csrc/flash_attention.cu and this tree's
flash_attention.cu to cubins, and compares the SASS of the earlier bf16
kernel with this tree's (D, BQ, BK) = (64, 64, 64) instantiation,
instruction by instruction (addresses and branch targets left out): the
main path's K1 launch is the same code when they are identical.

With --host as well: times on the host clock, for the parent and this tree
in turns (parent, this, this, parent), each in a process of its own, the
DINO frame B=1 (ViT-S/8 at 224, SLIC 100, per pixel: 12 K1 calls; median
of 30 frames, each ending in a synchronize) and K1's wrapper alone (mean
host time per call of 500 calls queued at (1, 1, 64, 64), where the
kernel takes less than the host, so the loop measures the host).

Each variant's checks against the plain version and its times are
chip_smoke.py's [switches] phase and tests/test_torch_port_gpu.py's.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def resources(report: str) -> list[str]:
    """ptxas's line for each K1 body in the build's report."""
    lines, key, spills = [], None, ""
    for line in report.splitlines():
        if "Function properties for" in line:
            m = re.search(r"flash_fwd_(bf16|f32)_kernelILi(\d+)E(?:Li(\d+)ELi(\d+)E)?", line)
            key = (f"bf16 D={m.group(2)} BQ={m.group(3)} BK={m.group(4)}" if m.group(1) == "bf16"
                   else f"fp32 D={m.group(2)}") if m else None
        elif key and "spill" in line:
            spills = line.strip()
        elif key and "Used" in line:
            lines.append(f"{key}: {line.split(':', 1)[1].strip()}; {spills}")
            key = None
    return sorted(lines)


def sass_of(src: Path, kernel: str, out_dir: Path) -> list[str]:
    """The normalised SASS of the kernel functions whose name contains
    `kernel`, compiled alone from `src`."""
    from wild_visual_navigation_tpu_torch.ops import _cuda

    cubin = out_dir / (src.stem + ".cubin")
    subprocess.run([_cuda._nvcc(), "-cubin", *_cuda.NVCC_FLAGS[:4], "-o", str(cubin), str(src)], check=True,
                   capture_output=True, text=True, timeout=900)
    dump = subprocess.run([str(Path(_cuda._nvcc()).parent / "cuobjdump"), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    out, take = [], False
    for line in dump.splitlines():
        if "Function : " in line:
            take = kernel in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s*(.*?)\s*;", line)
        if take and m:
            out.append(re.sub(r"0x[0-9a-f]+", "#", m.group(1)))
    return out


def host_times(root: str) -> dict:
    """The frame's and K1's wrapper's host times with the package of the
    checkout at `root` (see the module's docstring)."""
    sys.path.insert(0, str(Path(root).resolve()))
    import time

    import numpy as np
    import torch

    from wild_visual_navigation_tpu_torch.feature_extractor.dino import DinoInterface
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.ops.flash_attention import flash_attention
    from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_frame_fn
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig, confidence_init

    dev = torch.device("cuda")
    dino = DinoInterface(backbone="dino", input_size=224, backbone_type="vit_small", patch_size=8, device=dev, seed=0)
    mlp = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 384, "hidden_sizes": [256, 32, 1],
                                                             "reconstruction": True}}, device=dev).eval()
    frame = build_fused_frame_fn(dino.vit, mlp, ConfidenceConfig(), 224, num_segments=100)
    cg = confidence_init(dev)
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.random((1, 3, 64, 64), dtype=np.float32)).to(dev) for _ in range(35)]
    frame_ms = []
    with torch.no_grad():
        for i, img in enumerate(imgs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(cg, img)
            torch.cuda.synchronize()
            if i >= 5:
                frame_ms.append((time.perf_counter() - t0) * 1e3)
        q = torch.randn(1, 1, 64, 64, device=dev).bfloat16()
        for _ in range(100):
            flash_attention(q, q, q, 0.125)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            flash_attention(q, q, q, 0.125)
        call_us = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    return {"frame_ms": float(np.median(frame_ms)), "k1_call_us": call_us}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit, for the SASS comparison")
    ap.add_argument("--host", action="store_true", help="with --parent: host times of the frame and of K1's wrapper")
    ap.add_argument("--host-child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.host_child:
        print(json.dumps(host_times(args.host_child)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_k1: no CUDA device", file=sys.stderr)
        return 2
    from wild_visual_navigation_tpu_torch.ops import _cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _cuda.library()
    for line in resources(_cuda.resource_report()):
        print(f"[resources] {line}")
    if args.parent:
        with tempfile.TemporaryDirectory() as tmp:
            old = sass_of(Path(args.parent) / "wild_visual_navigation_tpu_torch/csrc/flash_attention.cu",
                          "flash_fwd_bf16_kernel", Path(tmp))
            new = sass_of(_cuda.CSRC / "flash_attention.cu", "flash_fwd_bf16_kernelILi64ELi64ELi64E", Path(tmp))
        differ = sum(a != b for a, b in zip(old, new)) + abs(len(old) - len(new))
        print(f"[sass] bf16 body at (64, 64, 64) against the parent's: {len(new)} instructions against "
              f"{len(old)}, {differ} differing; identical: {old == new}")
        if old != new or not old:
            return 1
    if args.parent and args.host:
        times = {}
        for name, root in [("parent", args.parent), ("this", ROOT), ("this", ROOT), ("parent", args.parent)]:
            out = subprocess.run([sys.executable, __file__, "--host-child", str(root)], check=True,
                                 capture_output=True, text=True, timeout=600).stdout
            times.setdefault(name, []).append(json.loads(out.strip().splitlines()[-1]))
        for name, runs in times.items():
            print(f"[host] {name}: the DINO frame B=1 (ViT-S/8 at 224, SLIC 100) "
                  f"{[round(r['frame_ms'], 3) for r in runs]} ms (median of 30 each); K1's wrapper "
                  f"{[round(r['k1_call_us'], 2) for r in runs]} us per call | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
