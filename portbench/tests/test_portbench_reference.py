"""The plain reference agrees with the port's plain path at a tiny size on
the CPU (the test imports the port; the reference itself does not)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, reference as ref  # noqa: E402
from wild_visual_navigation_tpu_torch.models.vit import make_vit  # noqa: E402
from wild_visual_navigation_tpu_torch.ops import segment_ops  # noqa: E402
from wild_visual_navigation_tpu_torch.ops.projection import Camera  # noqa: E402
from wild_visual_navigation_tpu_torch.ops.rasterize import project_and_render  # noqa: E402
from wild_visual_navigation_tpu_torch.ops.slic import _slic_whole  # noqa: E402

HI = ref.Prec(False)
DATA = Path(__file__).resolve().parent / "data"
DINO = harness.load_pipeline({"pipeline": "dino"})


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(name):
    return json.loads((DATA / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["tiny_dino", "tiny_dinov2_4cam"])
def test_vit_matches_the_port(name):
    cfg = tiny(name)
    sd = DINO.make_weights(cfg, 11, "cpu")["backbone"]
    m = cfg["model"]
    vit = make_vit(m["family"], m["backbone"], m["patch_size"], attention_impl="xla", dtype=torch.float32,
                   device="cpu", state_dict=sd)
    size = cfg["image_size"]
    x = ref.normalize(torch.rand(1, 3, size, size, generator=torch.Generator().manual_seed(3)))
    with torch.no_grad():
        want = vit(x)["patch_tokens"]
        got = DINO.vit_patch_tokens(sd, m, x, HI)
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())


def test_slic_matches_the_port():
    img = torch.rand(3, 32, 32, generator=torch.Generator().manual_seed(5))
    assert torch.equal(ref.slic(img, 16, 10.0, 10, HI), _slic_whole(img, 16, 10.0, 10))


def test_pooling_and_scoring_match_the_port():
    from wild_visual_navigation_tpu_torch.models.simple_mlp import SimpleMLP
    from wild_visual_navigation_tpu_torch.ops.pixelwise import pixelwise_score
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig, confidence_init

    g = torch.Generator().manual_seed(7)
    feat = torch.randn(24, 4, 4, generator=g)
    seg = torch.randint(0, 16, (32, 32), generator=g, dtype=torch.int32)
    got, gc = ref.pool_upsampled(feat, seg, 16, HI)
    want, wc = segment_ops.segment_mean_pool_upsampled(feat, seg, 16, 32, 32)
    assert torch.allclose(got, want, atol=1e-5) and torch.equal(gc, wc)
    mlp = SimpleMLP(24, (16, 8, 1), reconstruction=True, generator=g)
    cg = confidence_init()._replace(mean=torch.tensor(0.3), std=torch.tensor(0.2))
    with torch.no_grad():
        t, c = pixelwise_score(mlp, feat[None], 32, 32, ConfidenceConfig(1.0), cg, method="reference")
        dense = ref.upsample(feat, 32, 32, HI)
        rt, rc = ref.score_rows(mlp.state_dict(), dense.reshape(24, -1).T, cg.mean, cg.std, 1.0, HI)
    assert torch.allclose(rt.reshape(32, 32), t[0], atol=1e-5) and torch.allclose(rc.reshape(32, 32), c[0], atol=1e-5)


def test_flush_matches_the_port():
    g = np.random.RandomState(2)
    B, H = 4, 32
    K = torch.tensor([[0.6 * H, 0, H / 2], [0, 0.6 * H, H / 2], [0, 0, 1.0]]).repeat(B, 1, 1)
    s, c = np.sin(np.deg2rad(45)), np.cos(np.deg2rad(45))
    pose = np.tile(np.eye(4), (B, 1, 1))
    pose[:, :3, :3] = [[0.0, -s, c], [-1.0, 0.0, 0.0], [0.0, -c, -s]]
    pose[:, 0, 3] = 0.3 - 0.4 * np.arange(B)
    pose[:, 2, 3] = 1.2
    pose = torch.as_tensor(pose, dtype=torch.float32)
    fp = torch.as_tensor(np.concatenate([g.rand(64, 2) * [1.0, 0.6] + [1.0, -0.3], np.zeros((64, 1))], 1),
                         dtype=torch.float32)
    inside, _, _ = project_and_render(Camera(K=K, height=H, width=H), pose, fp[None].expand(B, -1, 3))
    pts, front = ref.project(K, pose, fp[None].expand(B, -1, 3), HI)
    mine = ref.fill_hulls(*ref.convex_hull(pts, front), H, H)
    assert inside.any() and torch.equal(mine, inside)
    before = torch.full((B, H, H), torch.inf)
    seg = torch.randint(0, 16, (B, H, H), generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    out = ref.flush(before, K, pose, seg, fp, 0.7, 16, H, H, HI)
    sig, sv = segment_ops.segment_masked_mean(out["mask"], torch.isfinite(out["mask"]), seg, 16)
    assert torch.allclose(out["signal"], sig, atol=1e-6) and torch.equal(out["signal_valid"], sv)


def test_train_step_matches_the_port():
    from wild_visual_navigation_tpu_torch.models.simple_mlp import SimpleMLP
    from wild_visual_navigation_tpu_torch.traversability.estimator import make_adam
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig, confidence_init
    from wild_visual_navigation_tpu_torch.utils.data import batch_from_arrays
    from wild_visual_navigation_tpu_torch.utils.loss import TraversabilityLossConfig, traversability_loss

    cfg = tiny("tiny_dino")
    g = torch.Generator().manual_seed(9)
    mlp = SimpleMLP(384, (256, 32, 1), reconstruction=True, generator=g)
    rows = {"features": torch.randn(8, 16, 384, generator=g), "signal": torch.rand(8, 16, generator=g),
            "signal_valid": torch.rand(8, 16, generator=g) > 0.5, "feat_valid": torch.rand(8, 16, generator=g) > 0.1,
            "valid": torch.ones(8, dtype=torch.bool)}
    before = {k: v.detach().clone() for k, v in mlp.state_dict().items()}
    adam = {k: (torch.zeros_like(v), torch.zeros_like(v), 0.0) for k, v in before.items()}
    cg = confidence_init()
    want = ref.train_step(cfg, before, adam, cg.mean, cg.std, rows, HI)
    opt = make_adam(mlp.parameters(), cfg["estimator"]["lr"])
    batch = batch_from_arrays(rows["features"], rows["signal"], rows["signal_valid"],
                              rows["feat_valid"] & rows["valid"][:, None])
    lc = TraversabilityLossConfig(w_trav=0.03, w_reco=0.5, confidence=ConfidenceConfig(1.0))
    loss, _, _ = traversability_loss(lc, batch, mlp(batch.x), cg)
    loss.backward()
    opt.step()
    assert float(loss.detach()) == pytest.approx(float(want["loss"]), rel=1e-6)
    for k, v in mlp.state_dict().items():
        assert torch.allclose(v - before[k], want["change"][k], atol=1e-9, rtol=1e-4)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 1.0 + 3 * 2**-11, -2.5, 0.0])
    assert ref.tf32(x).tolist() == [1.0, 1.0, 1.0 + 2**-10, 1.0 + 2 * 2**-10, -2.5, 0.0]
