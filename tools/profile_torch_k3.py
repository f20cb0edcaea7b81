#!/usr/bin/env python3
"""Where one launch of K3 (csrc/slic_step.cu) spends its time, on the card.

    python3 tools/profile_torch_k3.py        (from the root of the repository)

Builds the kernel and three copies of its source into a temporary
directory:
  * cut after the assignment (ids only), and before the centre update, to
    time each phase by difference against the whole step (CUDA events
    over 20 back-to-back launches, medians of 30);
  * one with %globaltimer stamps (thread 0 of each block; atomicMin of the
    start, atomicMax of the rest) at the end of the per-tile work, at the
    start and end of the last tile row's reduction, and at the start and
    end of the image's final reduction.
Each at B=1 and B=4 on 224 x 224 images with K=100 grid-initialised
centres, as the first Lloyd step of the frame sees them. The copies only
add a return or the stamps; the kernel itself is unchanged.
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
STAMPS = ["per-tile work done (last block)", "last row reduction starts", "last row reduction done",
          "final reduction starts", "final reduction done"]


def stamp(i: int, op: str = "atomicMax") -> str:
    return (f"  if (threadIdx.x == 0) {{ unsigned long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
            f"\"=l\"(t_)); {op}(&wvn_stamps[{i}], t_); }}\n")


def variants(src: str) -> dict[str, str]:
    def cut(marker: str) -> str:
        assert marker in src, marker
        return src.replace(marker, "  return;\n" + marker, 1)

    timed = src.replace("namespace {\n", "__device__ unsigned long long wvn_stamps[8];\nnamespace {\n", 1)
    marks = [("  const int b = blockIdx.y;\n", True, stamp(0, "atomicMin")),
             ("  // 7. the last block of each tile row", False, stamp(1)),
             ("  const size_t row0 = ", False, stamp(2)),
             ("  // 8. the last tile row", False, stamp(3)),
             ("  for (int i = tid; i < nty * nwords; i += kThreads) rmask[i] = __ldcg(img_rowmask + i);", False,
              stamp(4)),
             ("  for (int i = tid; i <= nty; i += kThreads) img_tickets[i] = 0u;\n", True, stamp(5))]
    for marker, after, text in marks:
        assert marker in timed, marker
        timed = timed.replace(marker, marker + text if after else text + marker, 1)
    timed += ('\nextern "C" int wvn_stamps_reset() { unsigned long long v[8] = {~0ull, 0, 0, 0, 0, 0, 0, 0}; '
              "return cudaMemcpyToSymbol(wvn_stamps, v, sizeof(v)); }\n"
              'extern "C" int wvn_stamps_read(unsigned long long* out) { '
              "return cudaMemcpyFromSymbol(out, wvn_stamps, 8 * sizeof(unsigned long long)); }\n")
    return {"whole step": src, "without the update": cut("  // 7. the last block of each tile row"),
            "assignment only": cut("  // 4. slots for orphans' centres"), "stamped": timed}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_k3: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from wild_visual_navigation_tpu_torch.ops import _cuda
    from wild_visual_navigation_tpu_torch.ops.slic import _init_index, pixel_features, rgb_to_lab, slic_geometry
    from wild_visual_navigation_tpu_torch.ops.slic_fused import SlicScratch

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
    ws, win2 = slic_geometry(100, 10.0, 224, 224)
    stream = torch.cuda.current_stream().cuda_stream
    for B in (1, 4):
        f = pixel_features(rgb_to_lab(torch.rand(B, 3, 224, 224, device=dev, generator=g)), ws)
        c = f[:, :, _init_index(100, 224, 224).to(dev)].transpose(1, 2).contiguous()
        sc = SlicScratch.allocate(B, 224, 224, 100, dev)
        args = (f.data_ptr(), c.data_ptr(), sc.ids.data_ptr(), sc.centers[1].data_ptr(), sc.partials.data_ptr(),
                sc.mask.data_ptr(), sc.rowsums.data_ptr(), sc.rowmask.data_ptr(), sc.tickets.data_ptr(), B, 224, 224,
                100, ws, win2, stream)
        for name, lib in libs.items():
            if name == "stamped":
                rows = []
                for rep in range(8):
                    lib.wvn_stamps_reset()
                    if lib.wvn_slic_step(*args) != 0:
                        raise RuntimeError(f"launch of {name} failed")
                    torch.cuda.synchronize()
                    v = (ctypes.c_ulonglong * 8)()
                    lib.wvn_stamps_read(v)
                    if rep >= 3:
                        rows.append([(v[i + 1] - v[0]) / 1e3 for i in range(len(STAMPS))])
                med = [statistics.median(col) for col in zip(*rows)]
                print(f"[k3 timeline] B={B}, us after the first block starts (median of 5): " +
                      "; ".join(f"{s} {t:.2f}" for s, t in zip(STAMPS, med)) + f" | {card}")
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
            print(f"[k3 phases] B={B}, {name}: {statistics.median(times):.4f} ms per launch (20 back to back) | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
