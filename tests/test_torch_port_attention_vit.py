"""Parity of the torch port's attention, ViT and DINO interface against
the JAX package, on the CPU, with JAX-initialised weights carried across
by utils/params.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu.feature_extractor.dino import DinoInterface as JDino
from wild_visual_navigation_tpu.models import vit as jvit
from wild_visual_navigation_tpu.ops.flash_attention import flash_attention as jflash
from wild_visual_navigation_tpu.ops.flash_attention import xla_attention as jxla
from wild_visual_navigation_tpu_torch.feature_extractor.dino import DinoInterface as TDino
from wild_visual_navigation_tpu_torch.models import vit as tvit
from wild_visual_navigation_tpu_torch.ops.flash_attention import flash_attention, xla_attention
from wild_visual_navigation_tpu_torch.utils.params import vit_state_from_jax


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((2, 3, 200, 64)).astype(np.float32) for _ in range(3)]  # ragged S = 200


def test_plain_attention_matches_xla_attention(qkv):
    q, k, v = qkv
    want = np.asarray(jxla(q, k, v, sm_scale=64**-0.5))
    got = xla_attention(*map(torch.from_numpy, qkv), 64**-0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)  # fp32: summation order only
    # the kernel's wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(flash_attention(*map(torch.from_numpy, qkv), 64**-0.5).numpy(), got.numpy())


def test_plain_attention_matches_pallas_flash(qkv):
    want = np.asarray(jflash(*qkv, sm_scale=64**-0.5, interpret=True))
    got = flash_attention(*map(torch.from_numpy, qkv), 64**-0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)  # the reference test's tolerance


def test_plain_attention_bf16_matches_xla_attention(qkv):
    q, k, v = (a[:1, :2] for a in qkv)
    want = np.asarray(jxla(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), sm_scale=0.125), np.float32)
    got = xla_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), 0.125)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)  # bf16 output rounding


def test_flash_attention_rejects_other_devices():
    q = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)


SMALL = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, pos_grid_size=4)


@pytest.fixture(scope="module", params=[
    dict(layerscale_init=None, num_register_tokens=0),
    dict(layerscale_init=1e-5, num_register_tokens=4),
], ids=["dino", "layerscale-registers"])
def small_vit_case(request):
    """JAX params and outputs of a 2-block, width-64, 4-head fp32 ViT on
    the native 32 px grid and on a 48x40 input that interpolates the
    position table."""
    variant = request.param
    jv = jvit.VisionTransformer(jvit.ViTConfig(**SMALL, **variant), attention_impl="xla", dtype=jnp.float32)
    params = jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))
    apply = jax.jit(jv.apply)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal(shape).astype(np.float32) for shape in [(2, 3, 32, 32), (1, 3, 48, 40)]]
    return variant, _np(params), [(x, _np(apply(params, x))) for x in xs]


@pytest.mark.parametrize("impl", ["flash", "eager"])
def test_small_vit_matches_jax_fp32(small_vit_case, impl):
    """Against JAX attention_impl="xla" at fp32: atol 1e-4."""
    variant, params, cases = small_vit_case
    tv = tvit.VisionTransformer(tvit.ViTConfig(**SMALL, **variant), attention_impl=impl, dtype=torch.float32)
    tv.load_state_dict(vit_state_from_jax(params))
    for x, want in cases:
        with torch.no_grad():
            got = tv(torch.from_numpy(x))
        assert got["grid"] == tuple(want["grid"])
        np.testing.assert_allclose(got["patch_tokens"].numpy(), want["patch_tokens"], atol=1e-4)
        np.testing.assert_allclose(got["cls_token"].numpy(), want["cls_token"], atol=1e-4)


def test_small_vit_bf16_close_to_jax():
    """The default bf16 compute with fp32 LayerNorms: the two frameworks
    round bf16 at different places, so hold the features to a bf16
    tolerance (mean abs error 2e-2 of unit-scale features)."""
    cfg = dict(**SMALL, layerscale_init=None)
    jv = jvit.VisionTransformer(jvit.ViTConfig(**cfg), attention_impl="xla")
    params = jv.init(jax.random.PRNGKey(2), jnp.zeros((1, 3, 32, 32)))
    tv = tvit.VisionTransformer(tvit.ViTConfig(**cfg), attention_impl="flash")
    tv.load_state_dict(vit_state_from_jax(_np(params)))
    assert tv.blocks[0].attn.qkv.weight.dtype == torch.bfloat16 and tv.norm.weight.dtype == torch.float32
    x = np.random.default_rng(3).standard_normal((2, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jvit.dense_features(jv, params, x))
    with torch.no_grad():
        got = tvit.dense_features(tv, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(np.mean(np.abs(got.numpy() - want))) < 2e-2


def test_bicubic_pos_matrix_matches_jax():
    for g, o in [(28, 28), (28, 56), (4, 6), (37, 16)]:
        np.testing.assert_array_equal(tvit._torch_bicubic_matrix(g, o), jvit._torch_bicubic_matrix(g, o))


def test_dino_interface_matches_jax():
    """DINO ViT-S/8 at full width and depth, fp32, on a small input:
    resize + crop + normalise, backbone and the bilinear upsample."""
    jd = JDino(jax.random.PRNGKey(0), input_size=32, attention_impl="xla", dtype=jnp.float32)
    td = TDino(input_size=32, dtype=torch.float32, device="cpu", params=vit_state_from_jax(_np(jd.params)))
    assert td.feature_dim == 384 and td.vit_patch_size == 8
    rng = np.random.default_rng(4)
    for shape in [(1, 3, 40, 48), (1, 3, 32, 40)]:  # raw frame -> (H, H); network-size frame -> (H, W)
        x = rng.random(shape, dtype=np.float32)
        want = np.asarray(jd.inference(x))
        got = td.inference(torch.from_numpy(x))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_seeded_dino_is_deterministic():
    a = TDino(input_size=32, device="cpu", seed=3)
    b = TDino(input_size=32, device="cpu", seed=3)
    c = TDino(input_size=32, device="cpu", seed=4)
    sa, sb, sc = a.vit.state_dict(), b.vit.state_dict(), c.vit.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["blocks.0.attn.qkv.weight"], sc["blocks.0.attn.qkv.weight"])
    w = sa["blocks.0.mlp.fc1.weight"].float()
    assert abs(float(w.std()) * 384**0.5 - 1.0) < 0.05  # LeCun-normal scale
