"""The torch port's STEGO path against the JAX package, on the CPU: the
STEGO head and its params bridge, cosine k-means, the patch-resolution
adjacency and centres of an upsampled label map, the mean-field CRF,
StegoInterface, the facade's stego modes, the fused STEGO frame and
WVNRuntime in stego x stego.

Weights: DINO ViT-B/8 and the STEGO head at their full widths, drawn once
per module with numpy into the flax layout (as the JAX tests' _STEGO_CACHE
builds them once) and bridged into the port. Both backbones run in fp32 on
32-px inputs (16 patch tokens), k-means with 4 clusters.

k-means' initial indices: JAX draws them with jax.random.choice, which a
torch generator cannot reproduce, so every test draws them with JAX and
hands the same indices to the port.

Tolerances: head outputs, codes and pooled features 1e-4 (fp32 sums over
768 channels in another order); k-means labels, segments, edges and
validity flags exactly; centres 1e-4 px; the maps 2e-3 (K2's plain version
rounds its hidden layer in bf16 where JAX's kernel does, in another
order); CRF log-probabilities 1e-4; runtime losses rtol 1e-4."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu import cfg as jcfg
from wild_visual_navigation_tpu.feature_extractor import feature_extractor as jfe_mod
from wild_visual_navigation_tpu.feature_extractor.stego import StegoInterface as JStego
from wild_visual_navigation_tpu.models import get_model as jget_model
from wild_visual_navigation_tpu.models import stego_head as jhead_mod
from wild_visual_navigation_tpu.models.vit import make_vit as jmake_vit
from wild_visual_navigation_tpu.ops import crf as jcrf
from wild_visual_navigation_tpu.ops import segment_ops as jseg
from wild_visual_navigation_tpu.runtime import WVNRuntime as JRuntime
from wild_visual_navigation_tpu.runtime import run_replay as jrun_replay
from wild_visual_navigation_tpu.runtime.fused import build_fused_stego_frame_fn as jbuild
from wild_visual_navigation_tpu.utils import confidence_generator as jcg
from wild_visual_navigation_tpu_torch.cfg import experiment as tcfg_exp
from wild_visual_navigation_tpu_torch.cfg import node_params as tcfg_node
from wild_visual_navigation_tpu_torch.feature_extractor import feature_extractor as tfe_mod
from wild_visual_navigation_tpu_torch.feature_extractor.stego import StegoInterface
from wild_visual_navigation_tpu_torch.models import stego_head as thead_mod
from wild_visual_navigation_tpu_torch.models.registry import get_model
from wild_visual_navigation_tpu_torch.ops import crf as tcrf
from wild_visual_navigation_tpu_torch.ops import pixelwise_fused as tfused
from wild_visual_navigation_tpu_torch.ops import segment_ops as tseg
from wild_visual_navigation_tpu_torch.runtime import WVNRuntime, run_replay, synthetic_sequence
from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_stego_frame_fn as tbuild
from wild_visual_navigation_tpu_torch.utils import confidence_generator as tcg
from wild_visual_navigation_tpu_torch.utils.params import (
    mlp_state_from_jax,
    stego_head_state_from_jax,
    train_state_from_jax,
    vit_state_from_jax,
)

SIZE, S = 32, 4
N = (SIZE // 8) ** 2
ATOL = 1e-4
MAP_ATOL = 2e-3
LOSS_RTOL = 1e-4


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


def _fill(shapes, rng):
    """numpy weights in the flax layout of `shapes`: fan-in-scaled kernels,
    small random biases, LayerNorm scales near 1, 0.02-scaled tokens."""

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        x = rng.standard_normal(s.shape, dtype=np.float32)
        if name == "kernel":
            return x / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if name == "scale":
            return 1.0 + np.float32(0.1) * x
        if name == "cluster_probe":
            return x
        return np.float32(0.02) * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def weights():
    """ViT-B/8 and STEGO head params (flax layout, numpy) and the port's
    state dict of the ViT, built once."""
    rng = np.random.default_rng(0)
    vit = jmake_vit("dino", "vit_base", 8, attention_impl="xla", dtype=jnp.float32)
    bp = _fill(jax.eval_shape(vit.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, SIZE, SIZE))), rng)
    head = jhead_mod.StegoHead(in_dim=768, code_dim=90, n_classes=27)
    hp = _fill(jax.eval_shape(head.init, jax.random.PRNGKey(0), jnp.zeros((1, N, 768))), rng)
    return bp, hp, vit_state_from_jax(bp)


def _jstego(weights, **kw):
    bp, hp, _ = weights
    return JStego(key=jax.random.PRNGKey(0), input_size=SIZE, n_image_clusters=S, attention_impl="xla",
                  dtype=jnp.float32, backbone_params=bp, head_params=hp, **kw)


def _tstego(weights, **kw):
    _, hp, vit_sd = weights
    return StegoInterface(input_size=SIZE, n_image_clusters=S, dtype=torch.float32, device="cpu",
                          backbone_params=vit_sd, head_params=stego_head_state_from_jax(hp), **kw)


@pytest.fixture(scope="module")
def stegos(weights):
    return _jstego(weights), _tstego(weights)


def _jax_init_idx(key, n_points=N, n_clusters=S):
    """The initial indices JAX's cosine_kmeans draws from `key`."""
    return torch.from_numpy(np.array(jax.random.choice(key, n_points, shape=(n_clusters,),
                                                       replace=n_clusters > n_points)))


def _image(seed, shape=(1, 3, SIZE, SIZE)):
    """A blocky random image: regions for k-means and the CRF to find."""
    rng = np.random.default_rng(seed)
    b, c, h, w = shape
    img = rng.random((b, c, -(-h // 8), -(-w // 8)), dtype=np.float32).repeat(8, 2).repeat(8, 3)[:, :, :h, :w]
    return np.clip(img + 0.03 * rng.standard_normal(img.shape).astype(np.float32), 0, 1)


def _close(got, want, atol=ATOL, rtol=0.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _equal(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))


# ------------------------------------------------------------------ head


@pytest.mark.parametrize("dims", [(768, 90, 27), (32, 12, 5)], ids=["vit-b", "small"])
def test_head_matches_jax(weights, dims):
    in_dim, code_dim, n_classes = dims
    feats = np.random.default_rng(1).standard_normal((2, N, in_dim)).astype(np.float32)
    jh = jhead_mod.StegoHead(in_dim=in_dim, code_dim=code_dim, n_classes=n_classes)
    hp = weights[1] if in_dim == 768 else _fill(jax.eval_shape(jh.init, jax.random.PRNGKey(1), feats),
                                                 np.random.default_rng(1))
    th = thead_mod.StegoHead(in_dim, code_dim, n_classes)
    th.load_state_dict(stego_head_state_from_jax(hp))
    want = jh.apply(hp, jnp.asarray(feats))
    with torch.no_grad():
        got = th(torch.from_numpy(feats))
    for name in ("code", "cluster_logits", "linear_logits"):
        assert got[name].shape == want[name].shape
        _close(got[name], want[name], atol=ATOL, rtol=1e-5)


# --------------------------------------------------------------- k-means


def _separated_codes(seed, n, d=12, k=4):
    rng = np.random.default_rng(seed)
    dirs = rng.standard_normal((k, d))
    return (dirs[rng.integers(0, k, n)] + 0.05 * rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("n,s", [(64, 4), (3, 5)], ids=["separated", "more-clusters-than-points"])
def test_cosine_kmeans_matches_jax(n, s):
    codes = np.stack([_separated_codes(seed, n) for seed in (2, 3)])
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    idx = torch.stack([_jax_init_idx(k, n, s) for k in keys])
    got_l, got_c = thead_mod.cosine_kmeans(torch.from_numpy(codes), idx)  # batched over the two images
    assert got_l.dtype == torch.int32 and got_l.shape == (2, n) and got_c.shape == (2, s, 12)
    for b in range(2):
        want_l, want_c = jhead_mod.cosine_kmeans(jnp.asarray(codes[b]), keys[b], n_clusters=s)
        _equal(got_l[b], want_l)
        _close(got_c[b], want_c, atol=1e-5)


def test_kmeans_init_indices_are_distinct_unless_too_few_points():
    g = torch.Generator().manual_seed(0)
    idx = thead_mod.kmeans_init_indices(g, 3137, 20)
    assert idx.shape == (20,) and len(set(idx.tolist())) == 20 and int(idx.max()) < 3137
    assert torch.equal(idx, thead_mod.kmeans_init_indices(torch.Generator().manual_seed(0), 3137, 20))
    few = thead_mod.kmeans_init_indices(g, 3, 20)
    assert few.shape == (20,) and int(few.min()) >= 0 and int(few.max()) < 3


# ------------------------------------------------------- segment geometry


@pytest.mark.parametrize("hp,wp,h,w", [(4, 4, 32, 32), (5, 7, 37, 50), (4, 6, 32, 48)],
                         ids=["divisible", "not-divisible", "rectangle"])
def test_upsampled_adjacency_and_centers_matches_jax(hp, wp, h, w):
    seg_p = np.random.default_rng(hp * wp).integers(0, 6, (hp, wp)).astype(np.int32)
    got = tseg.upsampled_adjacency_and_centers(torch.from_numpy(seg_p), 6, h, w, max_edges=64)
    want = jseg.upsampled_adjacency_and_centers(jnp.asarray(seg_p), 6, h, w, max_edges=64)
    for g, wt, exact in zip(got, want, (True, True, False, True)):
        _equal(g, wt) if exact else _close(g, wt)
    # and what adjacency_list + segment_centers give on the upsampled map itself
    seg = torch.from_numpy(seg_p)[(torch.arange(h) * hp) // h][:, (torch.arange(w) * wp) // w]
    edges, valid = tseg.adjacency_list(seg, 6, max_edges=64)
    centers, cvalid = tseg.segment_centers(seg, 6)
    assert torch.equal(got[0], edges) and torch.equal(got[1], valid) and torch.equal(got[3], cvalid)
    _close(got[2], centers.numpy())
    with pytest.raises(ValueError, match="out >= patch grid"):
        tseg.upsampled_adjacency_and_centers(torch.from_numpy(seg_p), 6, hp - 1, w)


# -------------------------------------------------------------------- CRF


def test_meanfield_crf_matches_jax():
    rng = np.random.default_rng(4)
    logits = (2.0 * rng.standard_normal((3, 16, 20))).astype(np.float32)
    image = rng.random((3, 16, 20), dtype=np.float32)
    got = tcrf.meanfield_crf(torch.from_numpy(logits), torch.from_numpy(image))
    _close(got, jcrf.meanfield_crf(jnp.asarray(logits), jnp.asarray(image)), atol=ATOL, rtol=1e-5)


def test_crf_refine_labels_matches_jax():
    """Two colour regions with salt-and-pepper label noise, as the JAX
    package's own CRF test: the same refined labels, and the noise cleaned."""
    H = W = 32
    img = np.zeros((3, H, W), np.float32)
    img[:, :, : W // 2] = np.array([0.9, 0.1, 0.1])[:, None, None]
    img[:, :, W // 2 :] = np.array([0.1, 0.1, 0.9])[:, None, None]
    true = np.concatenate([np.zeros((H, W // 2)), np.ones((H, W // 2))], axis=1).astype(np.int32)
    noisy = np.where(np.random.RandomState(0).rand(H, W) < 0.15, 1 - true, true).astype(np.int32)
    got = tcrf.crf_refine_labels(torch.from_numpy(noisy), torch.from_numpy(img), 2)
    assert got.dtype == torch.int32
    _equal(got, jcrf.crf_refine_labels(jnp.asarray(noisy), jnp.asarray(img), num_classes=2))
    assert float((got.numpy() != true).mean()) < 0.3 * float((noisy != true).mean())


# ----------------------------------------------------------- the interface


@pytest.mark.parametrize("crf", [False, True], ids=["plain", "crf"])
def test_stego_interface_matches_jax(weights, stegos, crf):
    """B=2 at network size without the CRF (maps at the full (H, W)); a raw
    24x40 frame with it (square (24, 24) maps, the CRF on the resized guide)."""
    jsi, tsi = stegos if not crf else (_jstego(weights, run_crf=True), _tstego(weights, run_crf=True))
    img = _image(5, (2, 3, SIZE, SIZE)) if not crf else _image(6, (1, 3, 24, 40))
    B = img.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    code_j, cluster_j = jsi.inference(jnp.asarray(img))
    code_t, cluster_t = tsi.inference(torch.from_numpy(img), init_idx=torch.stack([_jax_init_idx(k) for k in keys]))
    h = img.shape[2]
    assert code_t.shape == (B, 90, h, h if crf else SIZE) and cluster_t.dtype == torch.int32
    _close(code_t, code_j, atol=ATOL, rtol=1e-4)
    _equal(cluster_t, cluster_j)
    _equal(tsi.linear_segments, jsi.linear_segments)
    assert tsi.features is code_t and tsi.cluster_segments is cluster_t


# --------------------------------------------------------------- facade


@pytest.fixture(scope="module")
def facades(weights):
    bp, hp, vit_sd = weights
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfe_mod, "StegoInterface", functools.partial(JStego, dtype=jnp.float32))
        out = {}
        for st in ("stego", "grid"):
            kw = dict(segmentation_type=st, feature_type="stego", input_size=SIZE, n_image_clusters=S, cell_size=8,
                      max_edges=64)
            jf = jfe_mod.FeatureExtractor(key=jax.random.PRNGKey(0), backbone_params=bp, head_params=hp,
                                          attention_impl="xla", **kw)
            tf = tfe_mod.FeatureExtractor(seed=0, device="cpu", dtype=torch.float32,
                                          backbone_params=vit_sd, head_params=stego_head_state_from_jax(hp), **kw)
            # JAX's facade draws k-means' indices from split(PRNGKey(0), 1) on every call
            jidx = _jax_init_idx(jax.random.split(jax.random.PRNGKey(0), 1)[0])[None]
            tf._extractor.kmeans_init = lambda batch, n_points, idx=jidx: idx
            out[st] = (jf, tf)
    return out


@pytest.mark.parametrize("st", ["stego", "grid"])
def test_facade_stego_extract_matches_jax(facades, st):
    jf, tf = facades[st]
    img = _image(7)
    want = jf.extract(jnp.asarray(img), return_dense_features=True)
    got = tf.extract(torch.from_numpy(img), return_dense_features=True)
    _equal(got.segments, want.segments)
    _close(got.dense_features, want.dense_features, atol=ATOL, rtol=1e-4)
    _close(got.features, want.features, atol=ATOL, rtol=1e-4)
    for name in ("edges", "edge_valid", "center_valid"):
        _equal(getattr(got, name), getattr(want, name))
    _close(got.centers, want.centers)
    assert tf.num_segments(SIZE, SIZE) == jf.num_segments(SIZE, SIZE) == got.features.shape[0]
    assert tf.feature_dim == jf.feature_dim == 90


def test_facade_stego_reuses_the_segmenting_features(facades):
    """stego x stego: compute_features hands back what segmenting computed
    (one backbone run per extract), as the JAX facade does."""
    _, tf = facades["stego"]
    img = torch.from_numpy(_image(8))
    tf.compute_segments(img)
    feats = tf._extractor.features
    again = tf.compute_features(torch.from_numpy(_image(9)))
    assert again.data_ptr() == feats.data_ptr() and torch.equal(again, feats[0])


def test_stego_segments_need_stego_features():
    with pytest.raises(ValueError, match="needs feature_type"):
        tfe_mod.FeatureExtractor(segmentation_type="stego", feature_type="dino", device="cpu", input_size=SIZE)


# ---------------------------------------------------------- fused frame


@pytest.fixture(scope="module")
def head_pair():
    cfg = {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 90, "hidden_sizes": [64, 32, 1],
                                                   "reconstruction": True}}
    jm = jget_model(cfg)
    mparams = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(1), jnp.zeros((1, 90))), np.random.default_rng(2))
    tm = get_model(cfg)
    tm.load_state_dict(mlp_state_from_jax(mparams))
    return jm, mparams, tm


@pytest.mark.parametrize("pp,width", [(True, SIZE), (False, SIZE), (False, 48)],
                         ids=["per-pixel", "per-segment", "rectangle"])
def test_fused_stego_frame_matches_jax(stegos, head_pair, pp, width):
    """JAX's fused STEGO frame (its K2 in interpret mode) against the port's
    (K2's plain version); frames_batch at B=2 against two single frames."""
    jsi, tsi = stegos
    jm, mparams, tm = head_pair
    kw = dict(max_edges=64, prediction_per_pixel=pp, input_width=width)
    jframe = jbuild(jsi, jm, jcg.ConfidenceConfig(std_factor=0.5), SIZE, **kw)
    n = (SIZE // 8) * (width // 8)
    tframe = tbuild(tsi, tm, tcg.ConfidenceConfig(std_factor=0.5), SIZE, **kw,
                    init_idx=_jax_init_idx(jax.random.PRNGKey(0), n))
    img = _image(10, (1, 3, 40, 56))
    # confidence statistics at the scale of this head's reconstruction error
    code = tsi.head(tsi.vit(torch.from_numpy(_image(11)))["patch_tokens"])["code"]
    _, reco = tfused.pixelwise_score_fused(tm, code.reshape(1, SIZE // 8, SIZE // 8, 90).permute(0, 3, 1, 2),
                                           SIZE, SIZE)
    m, s = float(reco.mean()), float(reco.std())
    jst = jcg.confidence_init()._replace(mean=jnp.float32(m), std=jnp.float32(s))
    tst = tcg.confidence_init()._replace(mean=torch.tensor(m), std=torch.tensor(s))

    want = jframe((jsi.backbone_params, jsi.head_params), mparams, jst, jnp.asarray(img))
    got = tframe(tst, torch.from_numpy(img))
    assert got.traversability.shape == (SIZE, width) and got.segments.dtype == torch.int32
    _equal(got.segments, want.segments)
    for name in ("traversability", "confidence"):
        _close(getattr(got, name), getattr(want, name), atol=MAP_ATOL)
    _close(got.features, want.features, atol=ATOL, rtol=1e-4)
    for name in ("feat_valid", "edges", "edge_valid"):
        _equal(getattr(got, name), getattr(want, name))
    _close(got.centers, want.centers)
    if pp and width == SIZE:
        imgs = np.concatenate([img, _image(12, (1, 3, 40, 56))])
        batch = tframe.frames_batch(tst, torch.from_numpy(imgs))
        for b in range(2):
            single = tframe(tst, torch.from_numpy(imgs[b : b + 1]))
            _equal(batch.segments[b], single.segments.numpy())
            _close(batch.traversability[b], single.traversability.numpy(), atol=1e-5)


def test_fused_stego_frame_checks_its_config(stegos, head_pair):
    tsi = stegos[1]
    with pytest.raises(ValueError, match="patch-aligned"):
        tbuild(tsi, head_pair[2], tcg.ConfidenceConfig(), SIZE, input_width=44)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, item 22"):  # no graph head to pass yet
        get_model({"name": "SimpleGCN"})


def test_fused_stego_frame_draws_its_indices_once(stegos, head_pair):
    """Without init_idx the frame draws k-means' indices from a generator
    seeded 0 when it is built: two frames built alike segment as one built
    with those indices, and every call of one frame starts from them."""
    tsi = stegos[1]
    img = torch.from_numpy(_image(13))
    a = tbuild(tsi, head_pair[2], tcg.ConfidenceConfig(), SIZE)
    b = tbuild(tsi, head_pair[2], tcg.ConfidenceConfig(), SIZE,
               init_idx=thead_mod.kmeans_init_indices(torch.Generator().manual_seed(0), N, S))
    st = tcg.confidence_init()
    assert torch.equal(a(st, img).segments, b(st, img).segments)
    assert torch.equal(a(st, img).segments, a(st, img).segments)


# --------------------------------------------------------------- runtime


def _params(mod_node, mod_exp, pp):
    fe = mod_node.FeatureExtractorNodeParams(
        network_input_image_height=SIZE, network_input_image_width=SIZE, segmentation_type="stego",
        feature_type="stego", prediction_per_pixel=pp, image_callback_rate=1e9)
    ln = mod_node.LearningNodeParams(
        network_input_image_height=SIZE, network_input_image_width=SIZE, image_graph_dist_thr=0.05,
        supervision_graph_dist_thr=0.02, min_samples_for_training=2, supervision_callback_rate=1e9,
        robot_width=0.5, robot_length=0.5)
    exp = mod_exp.ExperimentParams()
    exp.model.simple_mlp_cfg.hidden_sizes = [64, 32, 1]
    return fe, ln, exp


def _record_losses(rt):
    out, step = [], rt.learning_step

    def recorded():
        st = step()
        out.append(st.loss_total)
        return st

    rt.learning_step = recorded
    return out


@pytest.mark.parametrize("fused,pp", [(True, True), (False, False)], ids=["fused-per-pixel", "composed-per-segment"])
def test_runtime_stego_matches_jax(weights, fused, pp):
    """A synthetic mission through run_replay on the JAX runtime and on the
    port's, stego x stego with the runtime's 20 clusters (more than the 16
    tokens: k-means' initial draw repeats points), carrying JAX's backbone, code head, traversability
    head and Adam state across; both estimators sample from np.random seeded
    42. Mirrors the JAX package's test_runtime_with_stego_features."""
    bp, hp, vit_sd = weights
    fe, ln, exp = _params(jcfg, jcfg, pp)
    with pytest.MonkeyPatch.context() as mp:
        # the JAX facade passes attention_impl and head_params itself (None): set them over its call
        mp.setattr(jfe_mod, "StegoInterface",
                   lambda **kw: JStego(**{**kw, "dtype": jnp.float32, "attention_impl": "xla", "head_params": hp}))
        jrt = JRuntime(fe_params=fe, ln_params=ln, exp_params=exp, key=jax.random.PRNGKey(0), buffer_capacity=16,
                       reprojection_fanout=4, use_fused=fused, backbone_params=bp)
    fe, ln, exp = _params(tcfg_node, tcfg_exp, pp)
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=16, reprojection_fanout=4,
                    use_fused=fused, device="cpu", backbone_dtype=torch.float32, backbone_params=vit_sd)
    tsi = rt.feature_extractor._extractor
    tsi.head.load_state_dict(stego_head_state_from_jax(hp))
    est = jrt.estimator
    rt.adopt_train_state(**train_state_from_jax(*_np((est.params, est._opt_state, est.confidence_state)), est.step))
    assert (rt._fused_frame is not None) == fused == (jrt._fused_frame is not None)
    if fused:  # JAX seeds the fused frame's k-means with PRNGKey(0)
        rt._fused_frame = tbuild(tsi, rt.estimator.model, rt.estimator._cg_cfg, SIZE, max_edges=1024,
                                 prediction_per_pixel=pp, init_idx=_jax_init_idx(jax.random.PRNGKey(0), N, 20))
    else:  # the facade's StegoInterface, split(PRNGKey(0), 1)
        jidx = _jax_init_idx(jax.random.split(jax.random.PRNGKey(0), 1)[0], N, 20)[None]
        tsi.kmeans_init = lambda batch, n_points: jidx

    seq = synthetic_sequence(duration=1.6, frame_rate=5.0, state_rate=5.0, image_size=SIZE, seed=0)
    jl, tl = _record_losses(jrt), _record_losses(rt)
    np.random.seed(42)
    jrep = jrun_replay(jrt, seq)
    trep = run_replay(rt, seq)
    for field in ("frames_processed", "frames_gated", "supervision_updates", "train_steps", "valid_nodes"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.frames_processed >= 6 and trep.train_steps >= 1 and rt.estimator.step == jrt.estimator.step
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=1e-7)
    trav, conf = trep.last_result.to_numpy()
    _close(trav, jrep.last_result.traversability, atol=MAP_ATOL)
    _close(conf, jrep.last_result.confidence, atol=MAP_ATOL)
    tb, jb = rt.estimator.buffer, jrt.estimator.buffer
    for name in ("valid", "seg", "feat_valid", "signal_valid"):
        _equal(getattr(tb, name), getattr(jb, name))
    _close(tb.features, jb.features, atol=ATOL, rtol=1e-4)


def _port_runtime(weights, pp=False, width=SIZE, **kw):
    fe, ln, exp = _params(tcfg_node, tcfg_exp, pp)
    fe = dataclasses.replace(fe, network_input_image_width=width, camera_topics={"cam0": {}, "cam1": {}})
    ln = dataclasses.replace(ln, network_input_image_width=width)
    return WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=8, reprojection_fanout=4,
                      device="cpu", backbone_dtype=torch.float32, backbone_params=weights[2], **kw)


def test_stego_batch_callback_matches_single_callbacks(weights):
    """image_batch_callback at B=2 through the STEGO frame's frames_batch
    against two image_callbacks on a twin runtime: the same maps, mission
    nodes and buffer rows (the JAX package's
    test_image_batch_callback_matches_sequential_other_backbones[stego])."""
    rt_b, rt_s = _port_runtime(weights, pp=True), _port_runtime(weights, pp=True)
    rt_s.adopt_train_state(rt_b.estimator.params, None, rt_b.estimator.confidence_state, 0)
    frames = synthetic_sequence(duration=0.8, frame_rate=5.0, state_rate=5.0, image_size=SIZE, seed=6).frames[:2]
    imgs = np.stack([f.image for f in frames])
    Ks = np.stack([f.K for f in frames])
    pb = np.stack([f.pose_base_in_world for f in frames])
    pb[1, 0, 3] += 1.0  # past the distance gate
    pc = np.stack([f.pose_cam_in_base for f in frames])
    stamps = [f.stamp for f in frames]
    batch = rt_b.image_batch_callback(imgs, stamps, ["cam0", "cam1"], Ks, SIZE, SIZE, pb, pc)
    singles = [rt_s.image_callback(imgs[i], stamps[i], f"cam{i}", Ks[i], SIZE, SIZE, pb[i], pc[i]) for i in range(2)]
    for b, s in zip(batch, singles):
        for x, y in zip(b.to_numpy(), s.to_numpy()):
            np.testing.assert_allclose(x, y, atol=1e-4)
    nb, ns = rt_b.estimator.get_mission_nodes(), rt_s.estimator.get_mission_nodes()
    assert [(n.timestamp, n.buffer_slot) for n in nb] == [(n.timestamp, n.buffer_slot) for n in ns] and len(nb) == 2
    for name in ("features", "feat_valid", "seg", "valid"):
        torch.testing.assert_close(getattr(rt_b.estimator.buffer, name), getattr(rt_s.estimator.buffer, name),
                                   atol=1e-4, rtol=0)


def test_rectangular_stego_config(weights):
    """A patch-aligned W != H stego config runs fused with rectangular maps;
    a misaligned one warns and falls back to the composed path, which serves
    the full (H, W) (the JAX package's test_rectangular_stego_config)."""
    K = np.array([[10.0, 0, 20], [0, 10.0, 16], [0, 0, 1]])
    rt = _port_runtime(weights, width=48)
    assert rt._fused_frame is not None
    img = np.random.RandomState(0).rand(3, SIZE, 48).astype(np.float32)
    res = rt.image_callback(img, 1.0, "cam0", K, SIZE, 48, np.eye(4), np.eye(4))
    assert res.traversability.shape == (SIZE, 48) and bool(torch.isfinite(res.traversability).all())
    with pytest.warns(UserWarning, match="patch-aligned"):
        rt2 = _port_runtime(weights, width=44)
    assert rt2._fused_frame is None
    img2 = np.random.RandomState(1).rand(3, SIZE, 44).astype(np.float32)
    res2 = rt2.image_callback(img2, 1.0, "cam0", K, SIZE, 44, np.eye(4), np.eye(4))
    assert res2.traversability.shape == (SIZE, 44) and bool(torch.isfinite(res2.traversability).all())
