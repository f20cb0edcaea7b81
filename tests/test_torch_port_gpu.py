"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc; they skip elsewhere. This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py -q
"""

import numpy as np
import pytest
import torch

import wild_visual_navigation_tpu_torch as port

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1, 6, 785, 64), (2, 3, 200, 64), (1, 1, 7, 64)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_flash_attention_matches_plain(cuda, shape, dtype, atol):
    from wild_visual_navigation_tpu_torch.ops.flash_attention import flash_attention, xla_attention

    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, device=cuda, generator=g).to(dtype) for _ in range(3))
    n = flash_attention.launches
    out = flash_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1 and out.dtype == dtype
    torch.testing.assert_close(out.float(), xla_attention(q, k, v, 0.125).float(), atol=atol, rtol=0)


def test_flash_attention_refuses_other_head_dims(cuda):
    from wild_visual_navigation_tpu_torch.ops.flash_attention import flash_attention

    q = torch.zeros(1, 1, 16, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim 64"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("hw,K", [((224, 224), 100), ((61, 97), 12)])
def test_slic_step_matches_plain(cuda, hw, K):
    from wild_visual_navigation_tpu_torch.ops.slic import _init_index, pixel_features, rgb_to_lab, slic_geometry
    from wild_visual_navigation_tpu_torch.ops.slic_fused import slic_step, slic_step_plain

    H, W = hw
    g = torch.Generator(device=cuda).manual_seed(1)
    ws, win2 = slic_geometry(K, 10.0, H, W)
    feats = pixel_features(rgb_to_lab(torch.rand(2, 3, H, W, device=cuda, generator=g)), ws)
    centers = feats[:, :, _init_index(K, H, W).to(cuda)].transpose(1, 2)
    centers = (centers + 0.5 * torch.randn(centers.shape, device=cuda, generator=g)).contiguous()
    ids, partials = slic_step(feats, centers, W, ws, win2)
    want_ids, want_partials = slic_step_plain(feats, centers, W, ws, win2)
    assert torch.equal(ids, want_ids)  # identical single-step ids
    torch.testing.assert_close(partials, want_partials, atol=1e-3, rtol=1e-5)


def test_pixelwise_score_matches_plain(cuda):
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.ops.pixelwise_fused import fused_precompute, score_pixels, score_pixels_plain

    mlp = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 384, "hidden_sizes": [256, 32, 1],
                                                             "reconstruction": True}},
                    device=cuda, generator=torch.Generator().manual_seed(0))
    feat = torch.randn(2, 384, 28, 28, device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
    for out in [(224, 224), (23, 37)]:
        ops = fused_precompute(mlp, feat, *out)
        trav, reco = score_pixels(ops, 384)
        want_t, want_r = score_pixels_plain(ops, 384)
        torch.testing.assert_close(trav, want_t, atol=2e-3, rtol=0)
        torch.testing.assert_close(reco, want_r, atol=1e-4, rtol=1e-3)


def test_frame_launches_each_kernel(cuda):
    from wild_visual_navigation_tpu_torch.feature_extractor.dino import DinoInterface
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_frame_fn
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig, confidence_init

    dino = DinoInterface(input_size=224, device=cuda, seed=0)
    mlp = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 384, "hidden_sizes": [256, 32, 1],
                                                             "reconstruction": True}},
                    device=cuda, generator=torch.Generator().manual_seed(1))
    frame = build_fused_frame_fn(dino.vit, mlp, ConfidenceConfig(), 224)
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 3, 480, 640), dtype=np.uint8)).to(cuda)
    port.reset_launch_counts()
    res = frame(confidence_init(cuda), img)
    torch.cuda.synchronize()
    assert port.launch_counts() == {"flash_attention": 12, "pixelwise_score": 1, "slic_step": 11}
    assert res.traversability.shape == (224, 224) and bool(torch.isfinite(res.traversability).all())
    assert int(res.segments.min()) >= 0 and int(res.segments.max()) < 100
