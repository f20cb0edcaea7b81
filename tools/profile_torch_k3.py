#!/usr/bin/env python3
"""Where one launch of K3 (csrc/slic_step.cu) spends its time, on the card.

    python3 tools/profile_torch_k3.py        (from the root of the repository)

Builds the kernel and three copies of its source into a temporary
directory:
  * cut after the assignment (ids only, no sums), and before the CTA's
    rows are added up (no cluster barrier, no update), to time each phase
    by difference against the whole step (CUDA events over 20
    back-to-back launches, medians of 30);
  * one with %globaltimer stamps (thread 0 of each CTA; atomicMin of the
    start, atomicMax of the rest: the last CTA to get there) where the
    centres are ready, the candidates listed, warp 0's candidates scanned,
    its ids written and its part summed, all warps done, the rows sent to
    their owners, the cluster barrier passed, the owned sums done and the
    end (after the global level that joins the image's clusters), with the SMs image 0's CTAs
    ran on (%smid) and CTA 0's SM clock (%clock64 over %globaltimer).
At B=1 and B=4 on 224 x 224 images with K=100 and at B=1 on 448 x 448, on
uniform noise with grid-initialised centres (the first Lloyd step) and on
a smooth texture with the centres of the fourth
step, each on the layout ops/slic_fused.py::step_layout gives it on this
card. The copies only add a return, a cut or the stamps; the kernel itself
is unchanged.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "wild_visual_navigation_tpu_torch/csrc/slic_step.cu"
STAMPS = ["centres ready", "candidates listed", "warp 0: candidates scanned", "warp 0: ids written",
          "warp 0: part summed", "all warps done", "rows sent to their owners", "cluster barrier passed",
          "owned sums done", "end", "last CTA starts"]
SHAPES = ((1, 224, 224, 100), (4, 224, 224, 100), (1, 448, 448, 100))


def stamp(i: int, op: str = "atomicMax") -> str:
    return (f"  if (threadIdx.x == 0) {{ unsigned long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
            f"\"=l\"(t_)); {op}(&wvn_stamps[{i}], t_); }}\n")


CLOCK = ("  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) {{ unsigned long long c_, t_; "
         "asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(c_)); asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
         "\"=l\"(t_)); wvn_clk[{0}] = c_; wvn_clk[{0} + 1] = t_; }}\n")
SMID = ("  if (threadIdx.x == 0 && blockIdx.y == 0) { unsigned s_; asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s_)); "
        "atomicOr(&wvn_sms[(s_ >> 5) & 7], 1u << (s_ & 31)); }\n")


def variants(src: str) -> dict[str, str]:
    def cut(text: str, *edits: tuple[str, str]) -> str:
        for marker, insert in edits:
            assert marker in text, marker
            text = text.replace(marker, insert + marker, 1)
        return text

    timed = src.replace("namespace {\n", "__device__ unsigned long long wvn_stamps[16];\n__device__ unsigned "
                        "wvn_sms[8];\n__device__ unsigned long long wvn_clk[4];\nnamespace {\n", 1)
    marks = [("  const int b = blockIdx.y;\n", True, stamp(0, "atomicMin") + stamp(11) + SMID + CLOCK.format(0)),
             ("  // 2. each tile's candidates", False, stamp(1)),
             ("  if (working) {\n", False, stamp(2)),
             ("#pragma unroll\n    for (int i = 0; i < kPx; ++i) {\n      if (valid[i] && id[i] < 0) {", False, stamp(3)),
             ("    // 4. the part's sums", False, stamp(4)),
             ("  // 5. the CTA's rows", False, stamp(5)),
             ("  for (int k = tid; k < K; k += blockDim.x) {\n    float s[kRow];\n", False, stamp(6)),
             ("  cluster_arrive();\n", False, stamp(7)),
             ("  cluster_wait();  // every peer's rows are in this CTA's inbox, and no peer writes to it again\n", True,
              stamp(8)),
             ("  // 7. the last CTA of each rank", False, stamp(9)),
             ("  if (tid == 0) *ticket = 0u;\n", True, stamp(10) + CLOCK.format(2))]
    for marker, after, text in marks:
        assert marker in timed, marker
        timed = timed.replace(marker, marker + text if after else text + marker, 1)
    timed += ('\nextern "C" int wvn_stamps_reset() { unsigned long long v[16] = {~0ull}; '
              "unsigned s[8] = {0, 0, 0, 0, 0, 0, 0, 0}; cudaError_t e = cudaMemcpyToSymbol(wvn_stamps, v, sizeof(v)); "
              "return e != cudaSuccess ? e : cudaMemcpyToSymbol(wvn_sms, s, sizeof(s)); }\n"
              'extern "C" int wvn_stamps_read(unsigned long long* out, unsigned* sms) { '
              "cudaError_t e = cudaMemcpyFromSymbol(out, wvn_stamps, 16 * sizeof(unsigned long long)); "
              "e = e != cudaSuccess ? e : cudaMemcpyFromSymbol(sms, wvn_sms, 8 * sizeof(unsigned)); "
              "return e != cudaSuccess ? e : cudaMemcpyFromSymbol(out + 12, wvn_clk, 4 * sizeof(unsigned long long)); }\n")
    end = ("  // 5. the CTA's rows", "  return;\n")
    return {"whole step": src, "without the update": cut(src, end),
            "assignment only": cut(src, ("    // 4. the part's sums", "#if 0\n"), ("  }\n\n  // 5. the CTA's rows", "#endif\n"),
                                   end),
            "stamped": timed}


def image(kind: str, B: int, H: int, W: int, g):
    """(B, 3, H, W) in [0, 1]: uniform noise, or a smooth texture of 8-pixel
    blocks averaged twice with their 4 neighbours (as portbench/traffic.py
    textures the benchmark's ground)."""
    import torch

    if kind == "noise":
        return torch.rand(B, 3, H, W, device=g.device, generator=g)
    t = torch.rand(B, 3, H // 8 + 1, W // 8 + 1, device=g.device, generator=g)
    t = t.repeat_interleave(8, 2).repeat_interleave(8, 3)[:, :, :H, :W]
    for _ in range(2):
        t = 0.25 * (t.roll(1, 2) + t.roll(-1, 2) + t.roll(1, 3) + t.roll(-1, 3))
    return t


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_k3: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from wild_visual_navigation_tpu_torch.ops import _cuda
    from wild_visual_navigation_tpu_torch.ops.slic import _init_index, pixel_features, rgb_to_lab, slic_geometry
    from wild_visual_navigation_tpu_torch.ops.slic_fused import SlicScratch, cluster_slots, slic_step, step_layout

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, (name, text) in enumerate(variants(SRC.read_text()).items()):
            (Path(tmp) / f"v{i}.cu").write_text(text)
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", f"{tmp}/v{i}.so", f"{tmp}/v{i}.cu"]
            procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (i, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{out}")
            lib = ctypes.CDLL(f"{tmp}/v{i}.so")
            lib.wvn_slic_step.argtypes = _cuda.SIGNATURES["wvn_slic_step"]
            libs[name] = lib

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for (B, H, W, K), kind in [(shape, kind) for shape in SHAPES for kind in ("noise", "smooth")]:
        ws, win2 = slic_geometry(K, 10.0, H, W)
        f = pixel_features(rgb_to_lab(image(kind, B, H, W, g)), ws)
        c = f[:, :, _init_index(K, H, W).to(dev)].transpose(1, 2).contiguous()
        if kind == "smooth":  # the centres of the frame's fourth step
            for _ in range(3):
                c = slic_step(f, c, W, ws, win2)[1].clone()
        sc = SlicScratch.allocate(B, H, W, K, dev)
        lay = step_layout(H, W, K, cluster_slots(dev))
        args = (f.data_ptr(), c.data_ptr(), sc.ids.data_ptr(), sc.centers[1].data_ptr(), sc.partials.data_ptr(),
                sc.tickets.data_ptr(), B, H, W, K, lay.clusters, lay.cluster_size, lay.tiles, lay.parts, ws, win2,
                stream)
        tag = (f"B={B} {H}x{W} K={K} {kind} ({lay.clusters} x {lay.cluster_size} CTAs of {lay.tiles} tiles x "
               f"{lay.parts} warps, {lay.variant})")
        for name, lib in libs.items():
            if name == "stamped":
                rows, sms, mhz = [], 0, []
                for rep in range(8):
                    lib.wvn_stamps_reset()
                    if lib.wvn_slic_step(*args) != 0:
                        raise RuntimeError(f"launch of {name} failed")
                    torch.cuda.synchronize()
                    v, s = (ctypes.c_ulonglong * 16)(), (ctypes.c_uint * 8)()
                    lib.wvn_stamps_read(v, s)
                    sms = sum(bin(x).count("1") for x in s)
                    mhz.append(1e3 * (v[14] - v[12]) / max(v[15] - v[13], 1))
                    if rep >= 3:
                        rows.append([(v[i + 1] - v[0]) / 1e3 if v[i + 1] else float("nan") for i in range(len(STAMPS))])
                med = [statistics.median(col) for col in zip(*rows)]
                print(f"[k3 timeline] {tag}, us after the first CTA starts (median of 5): " +
                      "; ".join(f"{s} {t:.2f}" for s, t in zip(STAMPS, med)) +
                      f"; image 0's {lay.clusters * lay.cluster_size} CTAs on {sms} SMs; SM clock "
                      f"{statistics.median(mhz):.0f} MHz | {card}")
                continue
            for _ in range(5):
                lib.wvn_slic_step(*args)
            torch.cuda.synchronize()
            times = []
            for _ in range(30):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(1_000_000)
                e0.record()
                for _ in range(20):
                    lib.wvn_slic_step(*args)
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1) / 20)
            print(f"[k3 phases] {tag}, {name}: {statistics.median(times):.4f} ms per launch (20 back to back) | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
