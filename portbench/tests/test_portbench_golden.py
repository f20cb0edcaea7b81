"""The configuration's pipeline computes, bit for bit, what the harness
computed before its weights, runtime build, plain reference and counts
moved into `portbench/pipelines/`: for two seeds at the CPU sizes of
`data/tiny_dino.json` and `data/tiny_dinov2_4cam.json`, the weights, the
reference's frame (fp32 and the control's low precision), a flush and a
train step on that frame's segments; and, for every configuration and
traffic of BENCHMARK.json's cells and the tiny ones, the model FLOPs and
each kernel's bound. `data/golden.json` holds a SHA-256 of each tensor's
bytes (shape and dtype with them) and each count's exact value, recorded
on the tree before the move with `record` and that tree's functions."""

import hashlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import counts, harness, reference as ref  # noqa: E402
from portbench.traffic import Traffic, intrinsics  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
GOLDEN = DATA / "golden.json"
SEEDS = (7, 2**31 + 101)
TINY = [("tiny_dino", "frames"), ("tiny_dinov2_4cam", "batch")]
COUNTED = [("dino_vits8_224", "frames"), ("dino_vits8_224", "online"), ("dinov2_vitb14_644_4cam", "batch"),
           ("tiny_dino", "frames"), ("tiny_dinov2_4cam", "batch")]


def digest(t: torch.Tensor) -> str:
    t = t.detach().cpu().contiguous()
    h = hashlib.sha256(f"{tuple(t.shape)} {t.dtype}".encode())
    h.update(t.numpy().tobytes())
    return h.hexdigest()


def digest_dict(d: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(d):
        h.update(k.encode() + digest(d[k]).encode())
    return h.hexdigest()


def load(kind: str, name: str) -> dict:
    base = DATA if name.startswith("tiny") else ROOT / "portbench" / kind
    return json.loads((base / f"{name}.json").read_text())


def record(api, cfg: dict, mix: dict, seed: int) -> dict:
    """Digests of what `api` computes for one configuration and seed.
    `api`: make_weights(cfg, seed, device) -> {"backbone", "head", ...};
    frame(cfg, weights, head, mean, std, img, p); num_segments(cfg)."""
    out = {}
    w = api.make_weights(cfg, seed, "cpu")
    for part, sd in w.items():
        out[f"weights.{part}"] = digest_dict(sd)
    H, S = cfg["image_size"], api.num_segments(cfg)
    img = torch.as_tensor(Traffic(mix, H, seed, 8).event(3).images[0])
    g = torch.Generator().manual_seed(seed)
    head = w["head"]
    mean, std = torch.tensor(0.9), torch.tensor(0.3)  # confidence between 0 and 1 on these maps
    for tag, p in (("hi", ref.Prec(False)), ("lo", ref.Prec(True))):
        fr = api.frame(cfg, w, head, mean, std, img, p)
        for k in ("trav", "conf", "seg", "features", "feat_valid"):
            out[f"frame.{tag}.{k}"] = digest(fr[k])
        if tag == "hi":
            seg = fr["seg"]
    B = cfg["estimator"]["reprojection_fanout"]
    s, c = np.sin(np.deg2rad(45)), np.cos(np.deg2rad(45))
    pose = np.tile(np.eye(4), (B, 1, 1))
    pose[:, :3, :3] = [[0.0, -s, c], [-1.0, 0.0, 0.0], [0.0, -c, -s]]
    pose[:, 0, 3] = 0.3 - 0.2 * np.arange(B)
    pose[:, 2, 3] = 1.2
    pose = torch.as_tensor(pose, dtype=torch.float32)
    K = torch.as_tensor(intrinsics(H), dtype=torch.float32).repeat(B, 1, 1)
    fp = torch.cat([torch.rand(64, 2, generator=g) * torch.tensor([1.0, 0.6]) + torch.tensor([1.0, -0.3]),
                    torch.zeros(64, 1)], 1)
    before = torch.where(torch.rand(B, H, H, generator=g) < 0.3, torch.rand(B, H, H, generator=g), torch.inf)
    segs = seg[None].expand(B, H, H).contiguous()
    D = head["layers.0.weight"].shape[1]
    rows = {"features": torch.randn(8, S, D, generator=g), "signal": torch.rand(8, S, generator=g),
            "signal_valid": torch.rand(8, S, generator=g) > 0.5, "feat_valid": torch.rand(8, S, generator=g) > 0.1,
            "valid": torch.ones(8, dtype=torch.bool)}
    adam = {k: (1e-3 * torch.randn(v.shape, generator=g), 1e-6 * torch.rand(v.shape, generator=g), 2.0)
            for k, v in head.items()}
    for tag, p in (("hi", ref.Prec(False)), ("lo", ref.Prec(True))):
        fl = ref.flush(before, K, pose, segs, fp, 0.7, S, H, H, p)
        for k in ("mask", "signal", "signal_valid"):
            out[f"flush.{tag}.{k}"] = digest(fl[k])
        st = ref.train_step(cfg, head, adam, mean, std, rows, p)
        out[f"step.{tag}.loss"] = digest(st["loss"])
        out[f"step.{tag}.grads"] = digest_dict(st["grads"])
        out[f"step.{tag}.change"] = digest_dict(st["change"])
        out[f"step.{tag}.cg"] = digest(torch.stack([st["cg_mean"], st["cg_std"]]))
    return out


def pipeline_counts(cfg: dict, mix: dict) -> dict:
    """The model FLOPs and each launched kernel's bound, as the readers take them."""
    pipe = harness.load_pipeline(cfg)
    out = {"frame_flops": pipe.frame_flops(cfg)}
    for k, shape in pipe.kernel_shapes(cfg, mix).items():
        out[k] = getattr(counts, f"{k}_bound_s")(*shape)
    H = cfg["image_size"]
    out["k4"] = counts.k4_bound_s(cfg["estimator"]["reprojection_fanout"], H, H)
    return out


def pipeline_api(cfg: dict):
    pipe = harness.load_pipeline(cfg)
    return SimpleNamespace(make_weights=pipe.make_weights, frame=pipe.frame, num_segments=pipe.num_segments)


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cfg,mix", TINY)
def test_weights_and_reference_are_bit_identical(golden, cfg, mix, seed):
    c = load("configs", cfg)
    got = record(pipeline_api(c), c, load("traffic", mix), seed)
    want = golden["outputs"][f"{cfg}/{seed}"]
    assert got.keys() == want.keys()
    assert [k for k in want if got[k] != want[k]] == []


@pytest.mark.parametrize("cfg,mix", COUNTED)
def test_counts_and_bounds_are_bit_identical(golden, cfg, mix):
    c = load("configs", cfg)
    got = pipeline_counts(c, load("traffic", mix))
    want = golden["counts"][f"{cfg}/{mix}"]
    # a kernel the configuration's frame does not launch is left out, and the reader of its roofline returns
    # None: K2 scores at every pixel only, K3 makes SLIC segments only
    launched = {"k1", "k4"} | ({"k3"} if c["segmentation"]["type"] == "slic" else set())
    launched |= {"k2"} if c["prediction_per_pixel"] and not c["score_at_patch_res"] else set()
    assert got.keys() == {"frame_flops"} | launched
    assert got == {k: want[k] for k in got}
