"""The torch port's int8 W8A8 backbone (models/quant.py, the quant hooks of
models/vit.py, DinoInterface(quant=), the facade's calibrate and
WVNRuntime.calibrate_backbone) against the JAX package, on the CPU.

Where the math is integer it is held bit for bit: the int8 values and
scales of quantize_symmetric and the int32 accumulators. The fp32
dequantised outputs equal JAX's eager (op-by-op) results bit for bit; XLA's
jitted program contracts acc·(sx·sw) + b into one fused multiply-add, so
against it they are held within 4 fp32 ulps of |acc·(sx·sw)| + |b|.

A whole int8 ViT cannot be held that tightly to JAX's: a difference of one
fp32 ulp anywhere (a LayerNorm, a softmax, that multiply-add) moves a value
across an int8 rounding boundary now and then, a flip moves the next
layer's inputs by a fraction of a quantum, which flips a few percent of its
roundings, and over 12 blocks the two ViTs differ by about as much as
either differs from the fp32 ViT. Measured on this CPU (DINO ViT-S/8, 32
px, weights carried over by vit_state_from_jax): JAX's own jitted and eager
int8 ViTs differ by a relative mean of 0.01-0.02
(test_jax_int8_vit_jitted_and_eager_differ_by_flips); the port and JAX by
0.017-0.023. The ViTs are therefore held to a relative mean error of
VIT_REL against JAX's, and to JAX's own bands against the fp32 ViT
(tests/test_models.py: dynamic rel < 0.05 and cos > 0.995, static rel <
0.06 and cos > 0.99)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu import cfg as jcfg
from wild_visual_navigation_tpu.feature_extractor.dino import DinoInterface as JDino
from wild_visual_navigation_tpu.feature_extractor.feature_extractor import FeatureExtractor as JFacade
from wild_visual_navigation_tpu.models import quant as jquant
from wild_visual_navigation_tpu.models import vit as jvit
from wild_visual_navigation_tpu.ops.flash_attention import xla_attention as jxla
from wild_visual_navigation_tpu_torch.cfg import experiment as tcfg_exp
from wild_visual_navigation_tpu_torch.cfg import node_params as tcfg_node
from wild_visual_navigation_tpu_torch.feature_extractor.feature_extractor import FeatureExtractor
from wild_visual_navigation_tpu_torch.models import quant as tquant
from wild_visual_navigation_tpu_torch.models import vit as tvit
from wild_visual_navigation_tpu_torch.runtime import WVNRuntime
from wild_visual_navigation_tpu_torch.utils.params import vit_state_from_jax

SIZE = 32
VIT_REL = 0.04  # mean |port - JAX| / std(JAX) of the int8 ViTs' patch tokens (measured 0.017-0.023)
VIT_MAX = 0.25  # max |port - JAX| on features of std 1 (measured 0.09-0.15)
AMAX_REL = 0.5  # a calibrated abs-max against JAX's, past the first block (measured up to 0.31)
AMAX_FIRST_REL = 1e-6  # the first block's four: inputs that agree to an fp32 ulp (measured 3.4e-7)
LAYERS = [("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine's cores;
    torch's own pool of a thread per core on top of them oversubscribes the
    cores, and small ops then wait tens of times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ulp_bound(acc, s, b):
    """4 fp32 ulps of |acc·s| + |b| per element."""
    return 4 * np.spacing((np.abs(acc.astype(np.float64) * s) + np.abs(b)).astype(np.float32))


# ------------------------------------------------------------------ quant.py


@pytest.mark.parametrize("case", ["per-tensor-fp32", "per-tensor-bf16", "per-channel"])
def test_quantize_symmetric_matches_jax_bit_for_bit(case):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((785, 384)) * 3).astype(np.float32)
    x[5, 7] = 0.5 * np.abs(x).max()  # ties and exact halves land where they land on both sides
    axis = 0 if case == "per-channel" else None
    jx = jnp.asarray(x, jnp.bfloat16) if case == "per-tensor-bf16" else jnp.asarray(x)
    tx = torch.from_numpy(x).bfloat16() if case == "per-tensor-bf16" else torch.from_numpy(x)
    jq, js = jquant.quantize_symmetric(jx, axis=axis)
    tq, ts = tquant.quantize_symmetric(tx, dim=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().reshape(np.shape(js)), np.asarray(js))
    # all-zero input: the scale floors at 1e-12 and every value is 0
    zq, zs = tquant.quantize_symmetric(torch.zeros(4, 8))
    assert float(zs) == np.float32(1e-12) and not bool(zq.any())


@pytest.mark.parametrize("shape", [(785, 384, 1152), (17, 1536, 384), (5, 24, 8), (3, 13, 7)],
                         ids=["vit-s-qkv", "fc2-17-rows", "tiny", "ragged"])
def test_int8_accumulators_are_exact(shape):
    """int_mm (torch._int_mm, zero-padded to more than 16 rows and to
    multiples of 8) gives the exact int32 product."""
    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    a = rng.integers(-127, 128, (M, K), dtype=np.int8)
    b = rng.integers(-127, 128, (K, N), dtype=np.int8)
    got = tquant.int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    want = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fn", ["int8_dense", "int8_dense_static", "_int8_matmul_bias"])
def test_int8_dense_matches_jax(fn):
    """Bit for bit against JAX's eager functions; within 4 ulps of
    |acc·(sx·sw)| + |b| against the jitted ones (XLA's fused multiply-add)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 785, 384)) * 3).astype(np.float32)
    k = (rng.standard_normal((384, 1152)) * 0.05).astype(np.float32)
    b = rng.standard_normal((1152,)).astype(np.float32)
    sx = np.float32(np.abs(x).max() * 0.8 / 127)  # a calibrated scale that clips the largest values
    xq, _ = jquant.quantize_symmetric(jnp.asarray(x))
    args = {"int8_dense": (x, k, b), "int8_dense_static": (x, k, b, sx),
            "_int8_matmul_bias": (np.asarray(xq), np.float32(np.abs(x).max() / 127), k, b)}[fn]
    targs = [torch.from_numpy(np.array(a)) if np.ndim(a) else torch.tensor(a) for a in args]
    got = getattr(tquant, fn)(*targs).numpy()
    eager = np.asarray(getattr(jquant, fn)(*map(jnp.asarray, args)))
    jitted = np.asarray(jax.jit(getattr(jquant, fn))(*map(jnp.asarray, args)))
    assert got.shape == (2, 785, 1152) and got.dtype == np.float32
    np.testing.assert_array_equal(got, eager)
    # the accumulators and scales behind each output, for the ulp bound
    x_in = np.asarray(xq) if fn == "_int8_matmul_bias" else x
    s_x = args[1] if fn == "_int8_matmul_bias" else (sx if fn == "int8_dense_static" else np.abs(x).max() / 127)
    q = x_in if fn == "_int8_matmul_bias" else np.clip(np.round(x / np.float32(s_x)), -127, 127)
    wq, sw = jquant.quantize_symmetric(jnp.asarray(k), axis=0)
    acc = q.reshape(-1, 384).astype(np.int64) @ np.asarray(wq).astype(np.int64)
    bound = _ulp_bound(acc, np.float32(s_x) * np.asarray(sw), b).reshape(got.shape)
    assert np.all(np.abs(got - jitted) <= bound)


def test_attention_scores_int8_matches_jax():
    """(2, 6, 257, 64): within 1e-5 of JAX's (measured 1.5e-7; the
    softmax's exponentials differ in their last bits), and within JAX's own
    band against fp32 attention (relative L2 < 0.05)."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 6, 257, 64)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax.jit(jquant.attention_scores_int8, static_argnums=3)(q, k, v, 0.125))
    got = tquant.attention_scores_int8(*map(torch.from_numpy, (q, k, v)), 0.125)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 6, 257, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    ref = np.asarray(jxla(q, k, v, sm_scale=0.125))
    assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) < 0.05


# ------------------------------------------------------------------ the ViTs


@pytest.fixture(scope="module")
def jax_vit_s8():
    """JAX-initialised DINO ViT-S/8 params (fp32 leaves), calibration
    batches and a test batch, seeded numpy."""
    jv = jvit.make_vit("dino", "vit_small", 8, attention_impl="xla", dtype=jnp.float32)
    params = _np(jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, SIZE, SIZE))))
    rng = np.random.default_rng(0)
    imgs = [rng.standard_normal((2, 3, SIZE, SIZE)).astype(np.float32) for _ in range(3)]
    f32 = np.asarray(jax.jit(jv.apply)(params, imgs[2])["patch_tokens"])
    return params, imgs[:2], imgs[2], f32


def _jax_quant_vit(params, quant, dtype, cal):
    jv = jvit.make_vit("dino", "vit_small", 8, attention_impl="xla", dtype=dtype, quant=quant)
    v = params
    if quant == "int8_static":
        v = {"params": params["params"], "quant_cal": jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, SIZE, SIZE)))[
            "quant_cal"]}
        v = _np(jvit.calibrate_int8_static(jv, v, cal))
    return jv, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", ["int8", "int8_static"])
def test_quant_vit_matches_jax(jax_vit_s8, quant, dtype):
    """The port's int8 ViT-S/8 against JAX's on the same weights and
    calibration batches (the port calibrates itself): relative mean error
    under VIT_REL, max under VIT_MAX, finite."""
    params, cal, img, _ = jax_vit_s8
    jv, v = _jax_quant_vit(params, quant, getattr(jnp, dtype), cal)
    want = np.asarray(jax.jit(jv.apply)(v, img)["patch_tokens"]).astype(np.float32)
    tv = tvit.make_vit("dino", "vit_small", 8, dtype=getattr(torch, dtype), quant=quant, device="cpu",
                       state_dict=vit_state_from_jax(params))
    assert sum(isinstance(m, tvit.QuantLinear) for m in tv.modules()) == 48
    if quant == "int8_static":
        tvit.calibrate_int8_static(tv, [torch.from_numpy(x) for x in cal])
    with torch.no_grad():
        got = tv(torch.from_numpy(img))["patch_tokens"]
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    d = np.abs(got.numpy() - want)
    assert d.mean() / want.std() < VIT_REL and d.max() < VIT_MAX


def test_jax_int8_vit_jitted_and_eager_differ_by_flips(jax_vit_s8):
    """The reference against itself: JAX's int8 ViT-S/8 jitted (XLA fuses
    multiply-adds) and run op by op differ far beyond fp32 rounding, by int8
    flips, by about as much as the port differs from either."""
    params, _, img, _ = jax_vit_s8
    jv = jvit.make_vit("dino", "vit_small", 8, attention_impl="xla", dtype=jnp.float32, quant="int8")
    jitted = np.asarray(jax.jit(jv.apply)(params, img)["patch_tokens"])
    eager = np.asarray(jv.apply(params, img)["patch_tokens"])
    rel = np.abs(jitted - eager).mean() / eager.std()
    assert 1e-3 < rel < VIT_REL


@pytest.mark.parametrize("quant,rel_max,cos_min", [("int8", 0.05, 0.995), ("int8_static", 0.06, 0.99)])
def test_quant_vit_within_jax_bands_of_fp32(jax_vit_s8, quant, rel_max, cos_min):
    """Against the port's fp32 ViT on the same weights, within JAX's own
    bands (tests/test_models.py; there with layerscale set to 1, which DINO
    ViT-S/8 does not have)."""
    params, cal, img, f32_jax = jax_vit_s8
    sd = vit_state_from_jax(params)
    t32 = tvit.make_vit("dino", "vit_small", 8, dtype=torch.float32, device="cpu", state_dict=sd)
    t8 = tvit.make_vit("dino", "vit_small", 8, dtype=torch.float32, quant=quant, device="cpu", state_dict=sd)
    tvit.calibrate_int8_static(t8, [torch.from_numpy(x) for x in cal])  # a no-op for the dynamic ViT
    with torch.no_grad():
        f32 = t32(torch.from_numpy(img))["patch_tokens"].numpy()
        f8 = t8(torch.from_numpy(img))["patch_tokens"].numpy()
    np.testing.assert_allclose(f32, f32_jax, atol=1e-4)  # the fp32 ViT is JAX's
    rel = np.abs(f8 - f32).mean() / f32.std()
    cos = (f8 * f32).sum(-1) / (np.linalg.norm(f8, axis=-1) * np.linalg.norm(f32, axis=-1))
    assert rel < rel_max and cos.min() > cos_min


def test_quant_vit_bands_with_layerscale():
    """JAX's band test's own setting: DINOv2 ViT-S/14 with layerscale set
    to 1 (at 56 px here, seeded port weights): dynamic rel < 0.05, cos >
    0.995; static rel < 0.06, cos > 0.99."""
    backbone, ps = "dinov2", 14
    g = torch.Generator().manual_seed(5)
    t32 = tvit.make_vit(backbone, "vit_small", ps, dtype=torch.float32, device="cpu", generator=g)
    for blk in t32.blocks:
        blk.ls1.gamma.data.fill_(1.0)
        blk.ls2.gamma.data.fill_(1.0)
    sd = t32.state_dict()
    rng = np.random.default_rng(6)
    cal = [torch.from_numpy(rng.random((2, 3, 56, 56), dtype=np.float32)) for _ in range(2)]
    img = torch.from_numpy(rng.random((2, 3, 56, 56), dtype=np.float32))
    with torch.no_grad():
        f32 = t32(img)["patch_tokens"].numpy()
    for quant, rel_max, cos_min in (("int8", 0.05, 0.995), ("int8_static", 0.06, 0.99)):
        t8 = tvit.make_vit(backbone, "vit_small", ps, dtype=torch.float32, quant=quant, device="cpu", state_dict=sd)
        tvit.calibrate_int8_static(t8, cal)
        with torch.no_grad():
            f8 = t8(img)["patch_tokens"].numpy()
        rel = np.abs(f8 - f32).mean() / f32.std()
        cos = (f8 * f32).sum(-1) / (np.linalg.norm(f8, axis=-1) * np.linalg.norm(f32, axis=-1))
        assert rel < rel_max and cos.min() > cos_min, (quant, rel, cos.min())


def test_static_calibration_records_48_scales_like_jax(jax_vit_s8):
    """Calibration fills 48 non-zero amax buffers: the first block's equal
    JAX's quant_cal within AMAX_FIRST_REL, the rest within AMAX_REL (their
    inputs differ by the int8 flips the module docstring describes). JAX's
    quant_cal carried by vit_state_from_jax lands in the buffers exactly;
    params without one load with zero amax, as JAX seeds them."""
    params, cal, img, _ = jax_vit_s8
    _, v = _jax_quant_vit(params, "int8_static", jnp.float32, cal)
    tv = tvit.make_vit("dino", "vit_small", 8, dtype=torch.float32, quant="int8_static", device="cpu",
                       state_dict=vit_state_from_jax(params))
    assert all(float(m.amax) == 0.0 for m in tv.modules() if isinstance(m, tvit.StaticQuantLinear))
    tvit.calibrate_int8_static(tv, [torch.from_numpy(x) for x in cal])
    assert not any(m.calibrating for m in tv.modules() if isinstance(m, tvit.StaticQuantLinear))
    rels = []
    for i in range(12):
        for mod, layer in LAYERS:
            got = float(tv.blocks[i].get_submodule(f"{mod}.{layer}").amax)
            want = float(v["quant_cal"][f"block_{i}"][mod][layer]["amax"])
            assert got > 0
            rels.append(abs(got - want) / want)
    assert len(rels) == 48 and max(rels[:4]) < AMAX_FIRST_REL and max(rels) < AMAX_REL
    carried = vit_state_from_jax(v)
    assert sum(k.endswith(".amax") for k in carried) == 48
    tc = tvit.make_vit("dino", "vit_small", 8, dtype=torch.float32, quant="int8_static", device="cpu",
                       state_dict=carried)
    for i in range(12):
        for mod, layer in LAYERS:
            m = tc.blocks[i].get_submodule(f"{mod}.{layer}")
            assert float(m.amax) == float(v["quant_cal"][f"block_{i}"][mod][layer]["amax"])
            assert float(m.x_scale) == float(np.maximum(np.float32(m.amax) / np.float32(127.0), np.float32(1e-12)))


def test_quant_vit_keeps_the_fp_parameter_names_and_refreshes_on_load():
    """The quantised ViTs' parameters are the fp ViT's (names and shapes;
    fp32 in the int8 layers, so fp checkpoints load as they are), the
    quantised weights are buffers outside the state dict, and a
    load_state_dict after construction quantises the new weights."""
    cfg = tvit.ViTConfig(patch_size=8, embed_dim=64, depth=2, num_heads=4, pos_grid_size=4)
    fp = tvit.VisionTransformer(cfg, dtype=torch.bfloat16, device="cpu", generator=torch.Generator().manual_seed(0))
    st = tvit.VisionTransformer(cfg, dtype=torch.bfloat16, device="cpu", quant="int8_static",
                                generator=torch.Generator().manual_seed(1))
    fp_shapes = {k: tuple(v.shape) for k, v in fp.named_parameters()}
    assert {k: tuple(v.shape) for k, v in st.named_parameters()} == fp_shapes
    assert set(st.state_dict()) == set(fp.state_dict()) | {f"blocks.{i}.{m}.{n}.amax" for i in range(2)
                                                           for m, n in LAYERS}
    qkv = st.blocks[0].attn.qkv
    assert qkv.weight.dtype == torch.float32 and qkv.weight_q.dtype == torch.int8
    before = qkv.weight_q.clone()
    st.load_state_dict(fp.state_dict())  # an fp (bf16) checkpoint: amax seeded with zeros
    assert not torch.equal(qkv.weight_q, before)
    wq, sw = tquant.quantize_symmetric(fp.blocks[0].attn.qkv.weight.float().t(), dim=0)
    assert torch.equal(qkv.weight_q.t(), wq) and torch.equal(qkv.weight_scale, sw) and qkv.weight_q.is_contiguous()
    assert float(qkv.amax) == 0.0 and float(qkv.x_scale) == np.float32(1e-12)
    with pytest.raises(ValueError, match="quant must be one of"):
        tvit.VisionTransformer(cfg, device="cpu", quant="int4")


def test_xla_int8_attention_impl_matches_jax(jax_vit_s8):
    """attention_impl="xla_int8" on the fp32 ViT: both attention products
    in int8, as JAX's, held like the int8 ViTs."""
    params, _, img, _ = jax_vit_s8
    jv = jvit.make_vit("dino", "vit_small", 8, attention_impl="xla_int8", dtype=jnp.float32)
    want = np.asarray(jax.jit(jv.apply)(params, img)["patch_tokens"])
    tv = tvit.make_vit("dino", "vit_small", 8, attention_impl="xla_int8", dtype=torch.float32, device="cpu",
                       state_dict=vit_state_from_jax(params))
    with torch.no_grad():
        got = tv(torch.from_numpy(img))["patch_tokens"].numpy()
    d = np.abs(got - want)
    assert d.mean() / want.std() < VIT_REL and d.max() < VIT_MAX


def test_shard_heads_refuses_a_quantised_vit(tmp_path):
    """shard_heads_ takes a quantised ViT (ROADMAP.md item 28b): on each
    of tp = 2 ranks, qkv and fc1 keep their rows of the unmeshed int8
    weights and scales, and proj and fc2 their columns of the unmeshed int8
    weights with the full weight's scales (not the slice's own maxima),
    also after a refresh; the biases of proj and fc2 stay whole. (A group
    of one process stands in for the tp group: the cut is local.)"""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    cfg = tvit.ViTConfig(patch_size=8, embed_dim=64, depth=1, num_heads=4, pos_grid_size=4)
    for quant in ("int8", "int8_static"):
        full = tvit.VisionTransformer(cfg, device="cpu", quant=quant, generator=torch.Generator().manual_seed(0))
        spec = {f"blocks.0.{n}.weight": Shard(0) for n in ("attn.qkv", "mlp.fc1")}
        spec.update({f"blocks.0.{n}.weight": Shard(1) for n in ("attn.proj", "mlp.fc2")}, other=Replicate())
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg_{quant}", world_size=1, rank=0)
        try:
            for rank in range(2):
                vit = tvit.VisionTransformer(cfg, device="cpu", quant=quant, state_dict=full.state_dict())
                tvit.shard_heads_(vit, dist.group.WORLD, rank, 2, spec)
                attn, mlp, fa, fm = vit.blocks[0].attn, vit.blocks[0].mlp, full.blocks[0].attn, full.blocks[0].mlp
                assert attn.num_heads == 2 and attn.proj.tp_group is dist.group.WORLD and attn.qkv.tp_group is None
                heads = [(j * 4 + rank * 2 + h) * 16 + d for j in range(3) for h in range(2) for d in range(16)]
                cols = slice(rank * 32, (rank + 1) * 32)
                hidden = slice(rank * 128, (rank + 1) * 128)
                for _ in range(2):  # as cut, and after a refresh
                    assert torch.equal(attn.qkv.weight_q, fa.qkv.weight_q[heads])
                    assert torch.equal(attn.qkv.weight_scale, fa.qkv.weight_scale[:, heads])
                    assert torch.equal(attn.proj.weight_q, fa.proj.weight_q[:, cols])
                    assert torch.equal(attn.proj.weight_scale, fa.proj.weight_scale)
                    assert torch.equal(mlp.fc1.weight_q, fm.fc1.weight_q[hidden])
                    assert torch.equal(mlp.fc2.weight_q, fm.fc2.weight_q[:, hidden])
                    assert torch.equal(mlp.fc2.weight_scale, fm.fc2.weight_scale)
                    assert torch.equal(mlp.fc2.bias, fm.fc2.bias)
                    for lin in (attn.qkv, attn.proj, mlp.fc1, mlp.fc2):
                        lin.refresh_()
                # the slice's own maxima are other scales
                own = tquant.quantize_symmetric(mlp.fc2.weight.float().t(), dim=0)[1]
                assert not torch.equal(own, fm.fc2.weight_scale)
        finally:
            dist.destroy_process_group()


# ------------------------------------------------------------------ facade and runtime


def _toy_image(h=32, w=32, seed=0):
    """A seeded image with a bright square, as the JAX facade test paints one."""
    img = np.random.default_rng(seed).random((1, 3, h, w), dtype=np.float32)
    img[:, :, : h // 2, : w // 2] = 0.9
    return img


def test_facade_dino_int8_static_calibrated():
    """The JAX facade test's scenario: one calibrate() pass, then dense
    features that track the bf16 twin on the same weights (cos > 0.97, as
    there) and JAX's int8_static facade (relative mean error under
    VIT_REL); the bf16 facade's calibrate() does nothing and says False."""
    kw = dict(segmentation_type="grid", feature_type="dino", input_size=SIZE, cell_size=16)
    j8 = JFacade(key=jax.random.PRNGKey(0), attention_impl="xla", quant="int8_static", **kw)
    sd = vit_state_from_jax(_np(j8._extractor.params["params"]))
    f8 = FeatureExtractor(device="cpu", backbone_params=sd, quant="int8_static", **kw)
    fb = FeatureExtractor(device="cpu", backbone_params=sd, **kw)
    assert isinstance(f8._extractor.vit.blocks[0].attn.qkv, tvit.StaticQuantLinear)
    img = _toy_image()
    assert fb.calibrate([img]) is False
    assert f8.calibrate([img]) is True and j8.calibrate([img]) is True
    got = f8.compute_features(torch.from_numpy(img)).reshape(384, -1).T.numpy()
    twin = fb.compute_features(torch.from_numpy(img)).reshape(384, -1).T.numpy()
    want = np.asarray(j8.compute_features(img)).reshape(384, -1).T
    cos = (got * twin).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(twin, axis=-1) + 1e-9)
    assert np.isfinite(got).all() and cos.min() > 0.97
    assert np.abs(got - want).mean() / want.std() < VIT_REL


def _runtime(dino_quant, backbone_params=None):
    fe = tcfg_node.FeatureExtractorNodeParams(
        network_input_image_height=32, network_input_image_width=32, segmentation_type="grid", feature_type="dino",
        dino_backbone="vit_small", dino_patch_size=8, dino_quant=dino_quant, image_callback_rate=1000.0,
        grid_cell_size=8, camera_topics={"front": {"use_for_training": True}})
    ln = tcfg_node.LearningNodeParams(min_samples_for_training=2, image_graph_dist_thr=0.05,
                                      supervision_callback_rate=1000.0)
    exp = tcfg_exp.ExperimentParams()
    exp.model.simple_mlp_cfg.hidden_sizes = [32, 1]
    return WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=8, reprojection_fanout=4,
                      device="cpu", backbone_params=backbone_params)


def test_runtime_int8_static_product_path():
    """JAX tests/test_runtime.py's product-path scenario on the port, with
    the JAX runtime's backbone weights carried over: calibrate_backbone
    records 48 non-zero scales (the first, qkv's of block 0, as JAX's bf16
    DinoInterface records it on the same frames, within AMAX_FIRST_REL;
    every one within AMAX_REL), the fused frame sees them in place, the frame and
    learning path run with finite maps in [0, 1]; a bf16 runtime's
    calibrate_backbone does nothing and says False."""
    jfe = jcfg.FeatureExtractorNodeParams()
    assert jfe.dino_quant is None and tcfg_node.FeatureExtractorNodeParams().dino_quant is None
    jd = JDino(jax.random.PRNGKey(0), input_size=32, attention_impl="xla", quant="int8_static")
    rt = _runtime("int8_static", vit_state_from_jax(_np(jd.params["params"])))
    vit = rt.feature_extractor._extractor.vit
    rng = np.random.RandomState(0)
    cal = [rng.rand(1, 3, 32, 32).astype(np.float32) for _ in range(2)]
    assert rt.calibrate_backbone(cal) is True and jd.calibrate(cal) is True
    amax = [m.amax for m in vit.modules() if isinstance(m, tvit.StaticQuantLinear)]
    assert len(amax) == 48 and all(float(a) > 0 for a in amax)
    for i in range(12):
        for mod, layer in LAYERS:
            want = float(jd.params["quant_cal"][f"block_{i}"][mod][layer]["amax"])
            rel = abs(float(vit.blocks[i].get_submodule(f"{mod}.{layer}").amax) - want) / want
            assert rel < (AMAX_FIRST_REL if (i, layer) == (0, "qkv") else AMAX_REL)

    img = rng.rand(3, 40, 40).astype(np.float32)
    K = np.array([[30.0, 0, 20], [0, 30, 20], [0, 0, 1]])
    Tc = np.eye(4)
    Tc[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]])
    Tc[2, 3] = 2.0
    res = rt.image_callback(img, 0.0, "front", K, 40, 40, np.eye(4), Tc)
    assert res is not None and tuple(res.traversability.shape) == (32, 32)
    t = res.traversability.numpy()
    assert np.isfinite(t).all() and t.min() >= 0 and t.max() <= 1
    for i in range(1, 5):
        T = np.eye(4)
        T[0, 3] = i * 0.3
        rt.image_callback(img + 0.01 * i, float(i), "front", K, 40, 40, T, Tc)
        pT = np.eye(4)
        pT[0, 3] = i * 0.3 + 0.5
        rt.robot_state_callback(float(i) + 0.5, pT, np.array([1.0, 0, 0, 0, 0, 0]), np.array([1.0, 0, 0, 0, 0, 0]))
    for _ in range(8):
        st = rt.learning_step()
    assert st.step > 0, "training never ran on the quantised backbone"
    assert _runtime(None).calibrate_backbone(cal) is False
