"""The Jackal's STEGO model on the port's normal path (DINO ViT-B/8, the
STEGO code head, per-image cosine k-means, a SimpleMLP on the 90-d code),
held on the CPU against the benchmark's plain reference
(portbench/pipelines/stego.py, loaded by path; plain PyTorch, no JAX).

The runtime is the one the benchmark builds (the pipeline's
`build_runtime`) from stego_vitb8_224's configuration at full widths, at
128 px (256 patches for the 20 clusters) and with the ViT in float32: the
cluster labels are a discontinuous function of the codes, and bf16 rounding
of the ViT flips labels that k-means then carries, so the exact comparison
of segments is made in float32 (the bf16 path is measured on the card). At
this size k-means has not converged by its fifth step on the frame used
(the reference's own labels after 5 and 10 steps differ), so a program cut
to half its steps fails the segment check.

The card's test (marked `gpu`, skipped elsewhere) holds the graphed STEGO
backbone stage to the eager one, bit for bit.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_stego_config.py -q
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import reference as ref
from portbench.traffic import Traffic
from wild_visual_navigation_tpu_torch.feature_extractor.feature_extractor import FeatureExtractor
from wild_visual_navigation_tpu_torch.runtime import WVNRuntime, fused
from wild_visual_navigation_tpu_torch.utils import timers

ROOT = Path(__file__).resolve().parent.parent
SIZE = 128
WEIGHT_SEED, TRAFFIC_SEED, EVENT = 3, 2**31 + 7, 8

# Tolerances, port (float32 ViT) against the float32 reference:
SEG_DIFF = 0.0  # labels: the same codes to ~1e-6 on a frame with no near tie, so the same clusters
FEAT_REL = 1e-4  # pooled codes: float32 sums over 768 channels and the patches in another order
TRAV_GAP = 0.01  # K2's plain version rounds the head's hidden layer in bf16 (0.003-0.005 seen)
CONF_GAP = 1e-3  # the mean confidence gap, from the same bf16 rounding of the reconstruction


def _load_pipeline():
    spec = importlib.util.spec_from_file_location("stego_pipeline_under_test",
                                                  ROOT / "portbench" / "pipelines" / "stego.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


STEGO = _load_pipeline()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(size=SIZE, dtype="float32") -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / "stego_vitb8_224.json").read_text())
    return {**cfg, "image_size": size, "dtype": dtype,
            "estimator": {**cfg["estimator"], "buffer_capacity": 16, "reprojection_fanout": 8}}


@pytest.fixture(scope="module")
def jackal():
    """(configuration, weights, runtime, the frame, the reference's frame)."""
    cfg = _cfg()
    mix = json.loads((ROOT / "portbench" / "traffic" / "online.json").read_text())
    weights = STEGO.make_weights(cfg, WEIGHT_SEED, "cpu")
    rt = STEGO.build_runtime(cfg, mix, weights, "cpu")
    img = torch.as_tensor(Traffic(mix, SIZE, TRAFFIC_SEED, EVENT + 2).event(EVENT).images[0])
    head, cg = rt.inference_head
    want = STEGO.frame(cfg, weights, head.state_dict(), cg.mean, cg.std, img, ref.Prec(False))
    return cfg, weights, rt, img, want


def _gaps(fr, want) -> dict:
    both = fr.feat_valid & want["feat_valid"]
    a, b = fr.features[both].float(), want["features"][both]
    return {"seg_diff": float((fr.segments.long() != want["seg"].long()).float().mean()),
            "feat_rel": float((a - b).norm() / b.norm()),
            "trav_gap": float((fr.traversability - want["trav"]).abs().max()),
            "conf_gap": float((fr.confidence - want["conf"]).abs().mean())}


def test_stego_head_params_reach_the_stego_head(jackal):
    cfg, weights, rt, _, _ = jackal
    stego = rt.feature_extractor._extractor
    got = stego.head.state_dict()
    assert set(got) == set(weights["stego_head"])
    assert all(torch.equal(got[k], v) for k, v in weights["stego_head"].items())
    other = STEGO.make_weights(cfg, WEIGHT_SEED + 1, "cpu")["stego_head"]
    tok = torch.randn(1, 16, 768, generator=torch.Generator().manual_seed(0))
    again = type(stego.head)(device="cpu")
    again.load_state_dict(other)
    with torch.no_grad():
        assert not torch.allclose(stego.head(tok)["code"], again(tok)["code"])


def test_stego_head_params_need_the_stego_features():
    with pytest.raises(ValueError, match="stego_head_params needs feature_type"):
        WVNRuntime(stego_head_params={"cluster1.weight": torch.zeros(90, 768)}, device="cpu")


@pytest.mark.parametrize("quant", ["int8", "int8_static"])
def test_the_facade_refuses_a_quantised_stego_backbone(quant):
    with pytest.raises(ValueError, match="no quantised backbone"):
        FeatureExtractor(segmentation_type="stego", feature_type="stego", input_size=32, quant=quant, device="cpu")


def test_fused_stego_frame_agrees_with_the_plain_reference(jackal):
    _, _, rt, img, want = jackal
    head, cg = rt.inference_head
    gaps = _gaps(rt._fused_frame(cg, img[None], head), want)
    assert gaps["seg_diff"] <= SEG_DIFF and gaps["feat_rel"] <= FEAT_REL, gaps
    assert gaps["trav_gap"] <= TRAV_GAP and gaps["conf_gap"] <= CONF_GAP, gaps
    assert int(want["seg"].max()) < 20 and want["features"].shape == (20, 90)


def test_half_the_kmeans_steps_fails_the_segment_check(jackal, monkeypatch):
    cfg, weights, rt, img, want = jackal
    # not converged at this size: the reference's own labels move between the fifth and tenth step
    p = ref.Prec(False)
    tok = STEGO.dino.vit_patch_tokens(weights["backbone"], cfg["model"],
                                      ref.normalize(ref.resize_square(ref.to_unit(img), SIZE))[None], p)[0]
    code = STEGO.code_head(weights["stego_head"], tok, p)
    init = STEGO.kmeans_init((SIZE // 8) ** 2, 20)
    assert bool((STEGO.cosine_kmeans(code, init, 5, p) != STEGO.cosine_kmeans(code, init, 10, p)).any())

    cut = fused.cosine_kmeans
    monkeypatch.setattr(fused, "cosine_kmeans", lambda c, idx, iterations=10: cut(c, idx, iterations // 2))
    head, cg = rt.inference_head
    gaps = _gaps(rt._fused_frame(cg, img[None], head), want)
    assert gaps["seg_diff"] > SEG_DIFF and gaps["feat_rel"] > FEAT_REL, gaps
    assert gaps["trav_gap"] <= TRAV_GAP  # the maps do not depend on the clusters


def test_stego_frame_records_its_spans_and_counters(jackal):
    _, _, rt, img, _ = jackal
    mix = json.loads((ROOT / "portbench" / "traffic" / "online.json").read_text())
    tr = Traffic(mix, SIZE, TRAFFIC_SEED, 4)
    timers.reset()
    timers.set_tracing(True)
    try:
        for i in range(2):
            ev = tr.event(i)
            res = rt.image_callback(ev.images[0], 1000.0 + i, "cam0", tr.K, tr.size, tr.size, ev.pose_base,
                                    tr.cam_in_base[0])
            assert res is not None
        snap = timers.snapshot()
    finally:
        timers.set_tracing(False)
        timers.reset()
    recs = snap["spans"]
    by_id = {r.span_id: r for r in recs}
    for d in [r for r in recs if r.name == "frame.dispatch"]:
        inside = [r.name for r in recs if r.request == d.request and by_id.get(r.parent) is d]
        assert inside == ["frame.backbone", "frame.segment", "frame.head"]
    assert sum(r.name == "frame.dispatch" for r in recs) == 2
    c = snap["counters"]
    assert c["frame.segment.kmeans.images"] == 2 and c["frame.segment.kmeans.steps"] == 2 * fused.KMEANS_ITERATIONS
    assert c["frame.graph.eager.cpu"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_graphed_stego_stage_equals_the_eager_one(dtype):
    """ViT-B/8 and the STEGO head at 224 on the card, B = 1, in bf16 (the
    port's default) and in float32: the key's first call captures, later
    distinct frames replay, each result bit-identical to the eager stage
    and unchanged by the replays after it, replays counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from wild_visual_navigation_tpu_torch.feature_extractor.stego import StegoInterface
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig, confidence_init

    cuda = torch.device("cuda")
    si = StegoInterface(input_size=224, device=cuda, seed=0, dtype=dtype)
    mlp = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 90, "hidden_sizes": [256, 32, 1],
                                                             "reconstruction": True}},
                    device=cuda, generator=torch.Generator().manual_seed(1)).eval().requires_grad_(False)
    fb = fused.build_fused_stego_frame_fn(si, mlp, ConfidenceConfig(), 224).frames_batch
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.integers(0, 256, (1, 3, 480, 640), dtype=np.uint8)).to(cuda) for _ in range(4)]
    cg = confidence_init(cuda)
    timers.reset()
    first = fb(cg, imgs[0])
    assert timers.snapshot()["counters"]["frame.graph.captures"] == 1
    results = [(first, [t.clone() for t in first])]
    for img in imgs[1:]:
        got = fb(cg, img)
        results.append((got, [t.clone() for t in got]))
        assert all(torch.equal(a, b) for a, b in zip(got, fb.eager(cg, img)))
        assert not torch.equal(got.traversability, first.traversability)
    # the replays hand out copies of their codes: each result, the first after three replays, stands as it came
    assert all(torch.equal(a, b) for got, kept in results for a, b in zip(got, kept))
    c = timers.snapshot()["counters"]
    assert c["frame.graph.replays"] == 3 and c["frame.segment.kmeans.images"] == 7
    assert not [k for k in c if k.startswith("frame.graph.eager.")]
    timers.reset()
