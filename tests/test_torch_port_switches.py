"""The JAX package's implementation switches in the torch port, against the
JAX package on the CPU: K1's whole contract (head dims up to 256, the block
arguments) and the bf16-score attention, every `attention_impl` name and
`ln_dtype` of the ViT (with the int8 backbones and on a mesh), the scorer's
`method` / `return_dense`, the two resize forms, and `slic_batch(impl=)` /
`adjacency_list(impl=)`.

Inputs are seeded numpy; JAX's Pallas kernels run in interpret mode. Each
test states its tolerance and why."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from wild_visual_navigation_tpu.models import get_model as jget_model
from wild_visual_navigation_tpu.models import vit as jvit
from wild_visual_navigation_tpu.ops import resize as jresize
from wild_visual_navigation_tpu.ops import segment_ops as jseg
from wild_visual_navigation_tpu.ops import slic as jslic
from wild_visual_navigation_tpu.ops.flash_attention import flash_attention as jflash
from wild_visual_navigation_tpu.ops.flash_attention import xla_attention as jxla
from wild_visual_navigation_tpu.ops.flash_attention import xla_attention_bf16 as jxla_bf16
from wild_visual_navigation_tpu.ops.pixelwise import pixelwise_score as jscore
from wild_visual_navigation_tpu.utils import confidence_generator as jcg
from wild_visual_navigation_tpu_torch.models import vit as tvit
from wild_visual_navigation_tpu_torch.models.registry import get_model
from wild_visual_navigation_tpu_torch.ops import resize as tresize
from wild_visual_navigation_tpu_torch.ops import segment_ops as tseg
from wild_visual_navigation_tpu_torch.ops import slic as tslic
from wild_visual_navigation_tpu_torch.ops.flash_attention import (
    TILES,
    flash_attention,
    variant_name,
    xla_attention,
    xla_attention_bf16,
)
from wild_visual_navigation_tpu_torch.ops.pixelwise import pixelwise_score
from wild_visual_navigation_tpu_torch.utils import confidence_generator as tcg
from wild_visual_navigation_tpu_torch.utils.params import mlp_state_from_jax, vit_state_from_jax


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine's cores;
    torch's own pool of a thread per core on top of them oversubscribes
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ------------------------------------------------------------------ K1


K1_CASES = [(D, tile) for D in (32, 80, 128, 256) for tile in TILES[{80: 128}.get(D, D)]]


@pytest.mark.parametrize("D,tile", K1_CASES, ids=[f"d{D}-{t[0]}x{t[1]}" for D, t in K1_CASES])
def test_flash_attention_head_dims_and_tiles_match_jax(D, tile):
    """The port's flash_attention (its plain version on the CPU) at each
    head dim against JAX's Pallas kernel in interpret mode with each block_q
    / block_k the card takes (fp32, S = 200, ragged for every tile: atol
    2e-5, the online softmax's rounding against the plain softmax) and
    against JAX's xla_attention (atol 1e-5, summation order). The fp32 body
    has its own tile, so the tile goes to the bf16 call, which is the plain
    version bit for bit: tiles change only the card's order of sums."""
    rng = np.random.default_rng(D)
    q, k, v = (rng.standard_normal((1, 2, 200, D)).astype(np.float32) for _ in range(3))
    scale = D**-0.5
    got = flash_attention(*_t(q, k, v), scale)
    assert got.shape == (1, 2, 200, D) and got.dtype == torch.float32
    want = np.asarray(jflash(q, k, v, sm_scale=scale, block_q=tile[0], block_k=tile[1], interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jxla(q, k, v, sm_scale=scale)), atol=1e-5)
    qb, kb, vb = (x.bfloat16() for x in _t(q, k, v))
    torch.testing.assert_close(flash_attention(qb, kb, vb, scale, *tile), xla_attention(qb, kb, vb, scale), atol=0,
                               rtol=0)
    padded = " (D=80)" if D == 80 else ""  # a zero-padded head dim counts under its own key
    assert variant_name(D, torch.bfloat16, *tile) == f"bf16 d{ {80: 128}.get(D, D)} {tile[0]}x{tile[1]}{padded}"


@pytest.mark.parametrize("case", ["d320", "bq1152", "bk384", "fp32-block", "d256-bk128"])
def test_flash_attention_refuses_what_k1_does_not_hold(case):
    """Head dims above 256 and tiles the card cannot hold raise on every
    device, naming the allowed tiles, and are never replaced by another tile."""
    x = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    call, match = {
        "d320": (lambda: flash_attention(*[torch.zeros(1, 1, 8, 320)] * 3), "head dim must be in"),
        "bq1152": (lambda: flash_attention(x, x, x, 1.0, 1152, 0), r"\(64, 64\), \(128, 64\)"),
        "bk384": (lambda: flash_attention(x, x, x, 1.0, 0, 384), "is not one the card holds"),
        "fp32-block": (lambda: flash_attention(*[x.float()] * 3, 1.0, 128, 64), "fp32 kernel has its own tile"),
        "d256-bk128": (lambda: flash_attention(*[torch.zeros(1, 1, 8, 256, dtype=torch.bfloat16)] * 3, 1.0, 64, 128),
                       r"it takes \[\(64, 64\), \(128, 64\)\]"),
    }[case]
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_xla_attention_bf16_matches_jax(dtype):
    """The bf16-score plain form against JAX's, which takes the same
    rounding steps: its scores equal JAX's bit for bit; the output differs
    from JAX's op-by-op result by at most one bf16 unit at bf16 output, on
    at most 0.1 % of the elements (the fp32 sums and the division round
    in another order before the last rounding), and within 2**-8 of the
    largest |output| at fp32 output; from JAX's jitted result (which XLA
    fuses) within 2**-7 of it."""
    rng = np.random.default_rng(7)
    q, k, v = (jnp.asarray(rng.standard_normal((2, 3, 57, 64)), getattr(jnp, dtype)) for _ in range(3))
    want = np.asarray(jxla_bf16(q, k, v, sm_scale=0.125)).astype(np.float32)
    jitted = np.asarray(jax.jit(jxla_bf16, static_argnames="sm_scale")(q, k, v, sm_scale=0.125)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype)) for a in (q, k, v))
    got = xla_attention_bf16(tq, tk, tv, 0.125)
    assert got.dtype == getattr(torch, dtype)
    scores = np.asarray(jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(torch.einsum("bhqd,bhkd->bhqk", tq.float(), tk.float()).bfloat16().float().numpy(),
                                  scores)
    got = got.float().numpy()
    if dtype == "bfloat16":
        unit = np.spacing(np.abs(want)) * 2.0**16
        assert np.all(np.abs(got - want) <= unit) and np.mean(got != want) <= 1e-3
    else:
        np.testing.assert_allclose(got, want, atol=2.0**-8 * np.abs(want).max())
    np.testing.assert_allclose(got, jitted, atol=2.0**-7 * np.abs(want).max())


# ------------------------------------------------------------------ the ViT

# DINOv2 ViT-S/14, cut to 2 blocks, with the layer scales at 1 on both sides: at DINOv2's 1e-5 each block adds about
# 1e-5 to the tokens, so a zeroed attention or a wrong LayerNorm cast would pass any tolerance (trained DINOv2
# gammas are of order 0.1 to 1)
S14 = dict(patch_size=14, embed_dim=384, depth=2, num_heads=6, layerscale_init=1.0)


def _vits(jax_impl, torch_impl, dtype, size, batch, ln_dtype="float32", quant=None, seed=0):
    """JAX's and the port's 2-block ViT-S/14 on the same weights (JAX's
    init, bridged by utils/params.py) and one seeded input."""
    jv = jvit.VisionTransformer(jvit.ViTConfig(**S14), attention_impl=jax_impl, dtype=getattr(jnp, dtype),
                                ln_dtype=getattr(jnp, ln_dtype), quant=quant)
    params = _np(jv.init(jax.random.PRNGKey(seed), jnp.zeros((1, 3, 28, 28))))
    tv = tvit.VisionTransformer(tvit.ViTConfig(**S14), attention_impl=torch_impl, dtype=getattr(torch, dtype),
                                state_dict=vit_state_from_jax(params), quant=quant, ln_dtype=getattr(torch, ln_dtype))
    x = np.random.default_rng(seed + 1).standard_normal((batch, 3, size, size)).astype(np.float32)
    return jv, params, tv, x


def _tokens(tv, x):
    with torch.no_grad():
        return tv(torch.from_numpy(x))["patch_tokens"].float().numpy()


def _zero_attention(tv):
    """The control of the ViT tests: every block's attention branch scaled
    to zero, which the tokens must show at the stated tolerance."""
    for block in tv.blocks:
        block.ls1.gamma.data.zero_()
    return tv


# (port name, JAX name, dtype, size, batch, atol): 56 px is 17 tokens, where "auto" takes "xla_bf16"; 322 px at
# B = 8 is 530 tokens and B·H = 48, where it takes "flash" (JAX: "flash_interpret", Pallas on the CPU). fp32 ViTs
# (max abs error): the plain forms agree to summation order (2e-5; 4e-6 seen); "xla_bf16" rounds scores to bf16 on
# both sides, where a q·k summed in another order can land one bf16 unit away (1e-3; 2.5e-4 seen). K1's tiles are
# bf16 tiles (the fp32 body has its own), so "flash:<bq>:<bk>" runs a bf16 ViT (mean abs error 1e-2; 4.2e-3 seen).
VIT_IMPLS = [
    ("flash", "flash_interpret", "float32", 56, 2, 2e-5),
    ("flash:128:64", "flash_interpret", "bfloat16", 56, 2, 1e-2),
    ("flash:64:128", "flash_interpret", "bfloat16", 56, 2, 1e-2),
    ("flash:128:128", "flash_interpret", "bfloat16", 56, 2, 1e-2),
    ("flash_interpret", "flash_interpret", "float32", 56, 2, 2e-5),
    ("xla", "xla", "float32", 56, 2, 2e-5),
    ("eager", "xla", "float32", 56, 2, 2e-5),
    ("xla_bf16", "xla_bf16", "float32", 56, 2, 1e-3),
    ("auto", "auto", "float32", 56, 2, 1e-3),
    ("auto", "flash_interpret", "float32", 322, 8, 2e-5),
]


@pytest.mark.parametrize("impl,jax_impl,dtype,size,batch,atol", VIT_IMPLS,
                         ids=[f"{c[0]}-{c[3]}px" for c in VIT_IMPLS])
def test_vit_attention_impls_match_jax(impl, jax_impl, dtype, size, batch, atol, capfd):
    """Every attention_impl name the reference's Attention takes builds the
    port's ViT and matches JAX's (2-block ViT-S/14, layer scales 1); "auto"
    logs its resolution on stderr as the reference does. Controls: with
    the attention zeroed the tokens miss JAX's by over 10 times the
    tolerance, and in fp32 the other plain form ("xla" for a case that
    runs "xla_bf16", else "xla_bf16") misses it by more than the tolerance."""
    jv, params, tv, x = _vits(jax_impl, impl, dtype, size, batch)
    want = np.asarray(jax.jit(jv.apply)(params, x)["patch_tokens"]).astype(np.float32)
    tvit._AUTO_RESOLVED_LOGGED.clear()
    got = _tokens(tv, x)

    def err(tokens):
        e = np.abs(tokens - want)
        return e.max() if dtype == "float32" else e.mean()

    assert err(got) < atol
    N = (size // 14) ** 2 + 1
    resolved = impl if impl != "auto" else ("flash" if batch * 6 >= 48 and N >= 512 else "xla_bf16")
    if impl == "auto":
        assert f"[vit] attention auto(B={batch}, heads=6, S={N}) -> {resolved}" in capfd.readouterr().err
    if dtype == "float32":
        other = tvit.VisionTransformer(tvit.ViTConfig(**S14), attention_impl="xla" if resolved == "xla_bf16" else
                                       "xla_bf16", dtype=torch.float32, state_dict=tv.state_dict())
        assert err(_tokens(other, x)) > atol
    assert err(_tokens(_zero_attention(tv), x)) > 10 * atol


def test_vit_auto_takes_the_reference_rule():
    """The rule on both sides of each threshold: B·H >= 48 and N >= 512."""
    assert [tvit.resolve_auto(*s) for s in ((8, 6, 512), (8, 6, 511), (7, 6, 4096), (1, 48, 600))] == [
        "flash", "xla_bf16", "xla_bf16", "flash"]


def test_vit_refuses_names_and_tiles_the_reference_or_k1_does_not_take():
    """A name outside the reference's vocabulary raises as before; a TPU
    tile such as flash:1152:1152 raises when the ViT is built, naming K1's
    tiles; a malformed flash name raises."""
    cfg = tvit.ViTConfig(**S14)
    for impl, match in (("sdpa", "attention_impl must be one of"), ("flash:1152:1152", "it takes"),
                        ("flash:128", "expected 'flash:<block_q>:<block_k>'")):
        with pytest.raises(ValueError, match=match):
            tvit.VisionTransformer(cfg, attention_impl=impl, device="meta")
    tvit.VisionTransformer(cfg, attention_impl="flash:128:64", device="meta")  # bf16 by default: a tile K1 holds


def test_layernorm_output_type_is_flax_semantics():
    """flax's LayerNorm(dtype=bf16) computes its statistics and affine in
    fp32 and casts the result (flax 0.12 normalization._normalize); the
    port's Block computes nn.LayerNorm in fp32 and casts. On the same
    input and affine the two agree to one bf16 unit everywhere and bit for
    bit on all but a few elements (flax's one-pass variance rounds in the
    last fp32 bits)."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4, 50, 384)) * 3 + 1).astype(np.float32)
    scale, bias = rng.standard_normal(384).astype(np.float32), rng.standard_normal(384).astype(np.float32)
    ln = fnn.LayerNorm(epsilon=1e-6, dtype=jnp.bfloat16)
    for xin in (jnp.asarray(x), jnp.asarray(x, jnp.bfloat16)):
        want = ln.apply({"params": {"scale": scale, "bias": bias}}, xin)
        assert want.dtype == jnp.bfloat16
        tln = torch.nn.LayerNorm(384, eps=1e-6)
        tln.weight.data, tln.bias.data = torch.from_numpy(scale), torch.from_numpy(bias)
        with torch.no_grad():
            got = tln(torch.from_numpy(np.asarray(xin, np.float32))).to(torch.bfloat16).float().numpy()
        want = np.asarray(want, np.float32)
        ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0**16  # one bf16 unit
        assert np.all(np.abs(got - want) <= ulp) and np.mean(got == want) > 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_ln_dtype_bf16_matches_jax(dtype):
    """ln_dtype=bf16 (the reference bench's backbone) against JAX's, layer
    scales 1: in an fp32 ViT the bf16 LayerNorm outputs feed fp32 layers,
    and the two agree to a mean abs error of 4e-4 and a max of 3e-3 (both
    round the same fp32 LayerNorm to bf16, and a one-unit flip moves the
    rest; 1.3e-4 and 1.5e-3 seen), while the fp32-LayerNorm ViT misses
    JAX's by more than both; in a bf16 ViT to a mean abs error of 1e-2
    (3.9e-3 seen). With the attention zeroed the tokens miss by over 10
    times the tolerance. The final norm stays fp32, as the reference's (its
    models/vit.py builds it with dtype=float32 whatever ln_dtype is)."""
    jv, params, tv, x = _vits("xla", "flash", dtype, 56, 2, ln_dtype="bfloat16")
    want = np.asarray(jax.jit(jv.apply)(params, x)["patch_tokens"]).astype(np.float32)
    with torch.no_grad():
        got = tv(torch.from_numpy(x))["patch_tokens"]
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want)
    if dtype == "float32":
        assert err.mean() < 4e-4 and err.max() < 3e-3
    else:
        assert err.mean() < 1e-2
    # bf16 LayerNorm outputs change what an fp32 ViT computes, and nothing a bf16 ViT computes (its layers cast
    # their input to bf16 anyway)
    _, _, tv32, _ = _vits("xla", "flash", dtype, 56, 2)
    with torch.no_grad():
        got32 = tv32(torch.from_numpy(x))["patch_tokens"]
    assert torch.equal(got32, got) == (dtype == "bfloat16")
    if dtype == "float32":
        err32 = np.abs(got32.numpy() - want)
        assert err32.mean() > 4e-4 and err32.max() > 3e-3
    assert np.abs(_tokens(_zero_attention(tv), x) - want).mean() > 10 * (4e-4 if dtype == "float32" else 1e-2)


VIT_REL, VIT_MAX = 0.04, 0.25  # tests/test_torch_port_quant.py's int8 limits against JAX


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_ln_dtype_bf16_with_int8_static_matches_jax(dtype):
    """ln_dtype=bf16 with int8_static, calibrated on the same batches
    (layer scales 1): the abs-max the qkv and fc1 layers of block 0 record
    (over bf16 LayerNorm outputs) equals JAX's bit for bit, where the
    fp32-LayerNorm ViT's does not; the rest within the int8 flips of
    tests/test_torch_port_quant.py (0.5 relative); the tokens at that
    file's int8 limits (0.002 and 0.013 relative seen), which the tokens
    with the attention zeroed miss."""
    jv, params, tv, x = _vits("xla", "flash", dtype, 56, 2, ln_dtype="bfloat16", quant="int8_static")
    rng = np.random.default_rng(21)
    cal = [rng.standard_normal((2, 3, 56, 56)).astype(np.float32) for _ in range(2)]
    v = {"params": params["params"], "quant_cal": _np(jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 28, 28))))[
        "quant_cal"]}
    v = _np(jvit.calibrate_int8_static(jv, v, cal))
    tvit.calibrate_int8_static(tv, [torch.from_numpy(c) for c in cal])
    _, _, tv32, _ = _vits("xla", "flash", dtype, 56, 2, quant="int8_static")
    tvit.calibrate_int8_static(tv32, [torch.from_numpy(c) for c in cal])
    for i in range(2):
        for mod, layer in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
            got = float(tv.blocks[i].get_submodule(f"{mod}.{layer}").amax)
            want = float(v["quant_cal"][f"block_{i}"][mod][layer]["amax"])
            if i == 0 and layer in ("qkv", "fc1"):
                assert got == want, (i, layer, got, want)
                assert float(tv32.blocks[i].get_submodule(f"{mod}.{layer}").amax) != want
            assert abs(got - want) / want < 0.5
    want = np.asarray(jax.jit(jv.apply)(v, x)["patch_tokens"]).astype(np.float32)
    d = np.abs(_tokens(tv, x) - want)
    assert d.mean() / want.std() < VIT_REL and d.max() < VIT_MAX
    assert np.abs(_tokens(_zero_attention(tv), x) - want).mean() / want.std() > VIT_REL


def test_params_bridge_needs_nothing_for_ln_dtype():
    """ln_dtype changes no parameter: a bf16-LayerNorm ViT's state dict has
    the fp32 ViT's names, shapes and types, and JAX's params bridge as they
    are."""
    jv, params, tv, _ = _vits("xla", "flash", "bfloat16", 56, 1, ln_dtype="bfloat16")
    ref = tvit.VisionTransformer(tvit.ViTConfig(**S14), state_dict=vit_state_from_jax(params))
    a, b = tv.state_dict(), ref.state_dict()
    assert a.keys() == b.keys() and all(a[n].dtype == b[n].dtype and torch.equal(a[n], b[n]) for n in a)


def test_vit_auto_resolves_on_the_global_shape_on_a_mesh():
    """Under dp 2 x tp 2 each rank holds 4 of the 8 frames and 3 of the 6
    heads (B·H = 12 locally), but "auto" resolves on the global (8, 6),
    B·H = 48 at 530 tokens: "flash", as the reference resolves inside jit.
    Each dp rank's features equal the unmeshed "flash" ViT's rows (1e-5:
    tp's fp32 sums in another order) and not the "xla_bf16" ones."""
    from _torch_switches_ranks import MESH_VIT, auto_mesh_rank

    from wild_visual_navigation_tpu_torch.parallel.launch import run_ranks

    g = torch.Generator().manual_seed(3)
    vit = tvit.VisionTransformer(tvit.ViTConfig(**MESH_VIT), attention_impl="flash", dtype=torch.float32,
                                 generator=g)
    state = {k: v.clone() for k, v in vit.state_dict().items()}
    imgs = np.random.default_rng(4).standard_normal((8, 3, 184, 184)).astype(np.float32)  # 23 x 23 + 1 tokens
    out = run_ranks(auto_mesh_rank, 4, args=(state, imgs), timeout=300)
    with torch.no_grad():
        flash = vit(torch.from_numpy(imgs))["patch_tokens"].numpy()
        bf16 = tvit.VisionTransformer(tvit.ViTConfig(**MESH_VIT), attention_impl="xla_bf16", dtype=torch.float32,
                                      state_dict=state)(torch.from_numpy(imgs))["patch_tokens"].numpy()
    assert np.abs(flash - bf16).max() > 1e-3  # the two choices are told apart
    for r in out:
        assert r["heads"] == 3 and r["resolved"] == [(8, 6, 530)]
        rows = slice(4 * r["dp"], 4 * r["dp"] + 4)
        np.testing.assert_allclose(r["feats"], flash[rows], atol=1e-5)


# ------------------------------------------------------------------ the scorer and the resize forms

HEAD = {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 32, "hidden_sizes": [64, 32, 1], "reconstruction": True}}


@pytest.fixture(scope="module")
def head():
    jm = jget_model(HEAD)
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32))))
    tm = get_model(HEAD)
    tm.load_state_dict(mlp_state_from_jax(params))
    feat = np.random.default_rng(1).standard_normal((2, 32, 8, 8)).astype(np.float32)
    jst = jcg.confidence_init()._replace(mean=jnp.float32(0.5), std=jnp.float32(0.2))
    tst = tcg.confidence_init()._replace(mean=torch.tensor(0.5), std=torch.tensor(0.2))
    return jm, params, tm, feat, jst, tst


@pytest.mark.parametrize("method", ["restructured", "reference", "gram", "fused"])
@pytest.mark.parametrize("dense", [False, True])
def test_pixelwise_methods_and_dense_match_jax(head, method, dense):
    """Each method, with and without the dense map, against JAX's same
    call (fused with return_dense takes "gram" on both sides): trav and
    conf within 2e-3 (bf16 rows round at other points), the dense map bit
    for bit where it is bf16 and to 1e-6 in fp32 ("reference")."""
    jm, params, tm, feat, jst, tst = head
    jout = jscore(params, feat, 23, 37, jcg.ConfidenceConfig(), jst, mlp=jm, return_dense=dense, method=method)
    tout = pixelwise_score(tm, torch.from_numpy(feat), 23, 37, tcg.ConfidenceConfig(), tst, method=method,
                           return_dense=dense)
    assert len(tout) == len(jout) == (3 if dense else 2)
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), atol=2e-3)
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), atol=2e-3)
    if dense:
        want = np.asarray(jout[2]).astype(np.float32)
        assert tout[2].shape == (2, 32, 23, 37) and str(tout[2].dtype)[6:] == str(jout[2].dtype)
        np.testing.assert_allclose(tout[2].float().numpy(), want, atol=1e-6 if method == "reference" else 0)


def test_pixelwise_optimized_false_is_the_reference_order(head):
    jm, params, tm, feat, jst, tst = head
    jt, jc = jscore(params, feat, 16, 16, jcg.ConfidenceConfig(), jst, optimized=False, mlp=jm)
    tt, tc = pixelwise_score(tm, torch.from_numpy(feat), 16, 16, tcg.ConfidenceConfig(), tst, optimized=False)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    with pytest.raises(ValueError, match="unknown method"):
        pixelwise_score(tm, torch.from_numpy(feat), 16, 16, tcg.ConfidenceConfig(), tst, method="ladder")


@pytest.mark.parametrize("dtype,precision", [("bfloat16", None), ("float32", None), ("float32", "highest"),
                                             ("float32", jax.lax.Precision.HIGHEST)])
def test_interpolate_bilinear_mxu_nhwc_matches_jax(dtype, precision):
    """Channels-last upsample in x.dtype, each product rounded to it: bit
    for bit in bf16 (two taps per output, summed in fp32 once), 1e-6 in
    fp32. `precision` takes the reference's names and its own values."""
    x = np.random.default_rng(5).standard_normal((2, 7, 9, 5)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jresize.interpolate_bilinear_mxu_nhwc(
        jx, 23, 31, precision=jax.lax.Precision.HIGHEST if precision else None)).astype(np.float32)
    got = tresize.interpolate_bilinear_mxu_nhwc(torch.from_numpy(x).to(getattr(torch, dtype)), 23, 31,
                                                precision=precision)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 23, 31, 5)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0 if dtype == "bfloat16" else 1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_interpolate_bilinear_mxu_precise_matches_jax(dtype):
    """The fp32 "highest" form, from bf16 or fp32 input: fp32 out, 1e-6."""
    x = np.random.default_rng(6).standard_normal((2, 1, 8, 8)).astype(np.float32)
    want = np.asarray(jresize.interpolate_bilinear_mxu_precise(jnp.asarray(x, getattr(jnp, dtype)), 40, 24))
    got = tresize.interpolate_bilinear_mxu_precise(torch.from_numpy(x).to(getattr(torch, dtype)), 40, 24)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    with pytest.raises(ValueError, match="precision must be one of"):
        tresize.interpolate_bilinear_mxu_nhwc(torch.from_numpy(x).permute(0, 2, 3, 1), 4, 4, precision="exact")


# ------------------------------------------------------------------ segmentation


@pytest.fixture(scope="module")
def slic_images():
    rng = np.random.default_rng(8)
    base = rng.random((2, 3, 8, 8)).astype(np.float32)
    return np.repeat(np.repeat(base, 6, axis=2), 6, axis=3) + 0.03 * rng.random((2, 3, 48, 48)).astype(np.float32)


@pytest.mark.parametrize("impl,jax_impl,agree", [("xla", "xla", 0.99), ("pallas-interpret", "pallas-interpret", 0.99),
                                                 ("pallas", "pallas-interpret", 0.99), ("auto", "auto", 0.9)])
def test_slic_batch_impls_match_jax(slic_images, impl, jax_impl, agree):
    """Each impl against JAX's (K = 16, 10 iterations on blocky 48 px
    images). The same loops agree at 0.99 or more (sums in other orders move
    a boundary pixel now and then); "auto" is "pallas" on the port and
    "xla" in the reference, two loops the reference itself holds at 92 %."""
    want = np.asarray(jslic.slic_batch(jnp.asarray(slic_images), 16, 10.0, 10, impl=jax_impl))
    got = tslic.slic_batch(torch.from_numpy(slic_images), 16, 10.0, 10, impl=impl)
    assert got.dtype == torch.int32 and got.shape == (2, 48, 48)
    assert float(np.mean(got.numpy() == want)) >= agree


def test_slic_batch_auto_is_pallas_and_refuses_other_names(slic_images):
    imgs = torch.from_numpy(slic_images)
    assert torch.equal(tslic.slic_batch(imgs, 16, impl="auto"), tslic.slic_batch(imgs, 16, impl="pallas"))
    with pytest.raises(ValueError, match="impl must be one of"):
        tslic.slic_batch(imgs, 16, impl="mosaic")


@pytest.mark.parametrize("impl,S", [("auto", 40), ("matrix", 40), ("hash", 40), ("auto", 300), ("hash", 300)])
def test_adjacency_list_impls_match_jax(impl, S):
    """Each impl returns JAX's exact layout for the same impl: edges and
    validity equal, truncation included (max_edges below the edge count)."""
    rng = np.random.default_rng(S)
    seg = np.repeat(np.repeat(rng.integers(0, S, (12, 12)), 4, 0), 4, 1).astype(np.int32)
    for max_edges in (64, 1024):
        want_e, want_v = jseg.adjacency_list(jnp.asarray(seg), S, max_edges=max_edges, impl=impl)
        got_e, got_v = tseg.adjacency_list(torch.from_numpy(seg), S, max_edges=max_edges, impl=impl)
        np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_adjacency_list_matrix_refuses_above_256_segments_like_jax():
    seg = np.zeros((8, 8), np.int32)
    with pytest.raises(ValueError, match="gated to <= 256 segments"):
        jseg.adjacency_list(jnp.asarray(seg), 300, impl="matrix")
    with pytest.raises(ValueError, match="gated to <= 256 segments"):
        tseg.adjacency_list(torch.from_numpy(seg), 300, impl="matrix")
    with pytest.raises(ValueError, match="impl must be one of"):
        tseg.adjacency_list(torch.from_numpy(seg), 30, impl="sort")
