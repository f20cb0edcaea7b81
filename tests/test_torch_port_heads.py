"""The torch port's anomaly head (models/linear_rnvp.py) and graph head
(models/simple_gcn.py) against the JAX package, on the CPU, and the paths
that carry them: the params bridge, estimator sessions in anomaly mode
and with the graph head, the fused DINO frame with either head and the
fused STEGO frame with the graph head, WVNRuntime in anomaly mode over
the demo mission, and FeatureExtractorNode's anomaly scoring.

Inputs are seeded numpy arrays fed to both packages; the port's heads
hold the JAX heads' weights through utils/params.py. Tolerances are
stated beside each test."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu import cfg as jcfg
from wild_visual_navigation_tpu.feature_extractor import feature_extractor as jfe_mod
from wild_visual_navigation_tpu.feature_extractor.dino import DinoInterface as JDino
from wild_visual_navigation_tpu.models import get_model as jget_model
from wild_visual_navigation_tpu.models import init_model as jinit_model
from wild_visual_navigation_tpu.models import vit as jvit
from wild_visual_navigation_tpu.models.simple_gcn import gcn_aggregate as jgcn_aggregate
from wild_visual_navigation_tpu.ops import segment_ops as jseg
from wild_visual_navigation_tpu.ops.resize import imagenet_normalize
from wild_visual_navigation_tpu.runtime import WVNRuntime as JRuntime
from wild_visual_navigation_tpu.runtime import run_replay as jrun_replay
from wild_visual_navigation_tpu.runtime.fused import build_fused_frame_fn as jbuild
from wild_visual_navigation_tpu.traversability import MissionNode as JMissionNode
from wild_visual_navigation_tpu.traversability import SupervisionNode as JSupervisionNode
from wild_visual_navigation_tpu.traversability import TraversabilityEstimator as JEstimator
from wild_visual_navigation_tpu.utils import confidence_generator as jcg
from wild_visual_navigation_tpu_torch.cfg import experiment as texp
from wild_visual_navigation_tpu_torch.cfg import node_params as tnode
from wild_visual_navigation_tpu_torch.models import vit as tvit
from wild_visual_navigation_tpu_torch.models.registry import apply_model, get_model, model_needs_edges
from wild_visual_navigation_tpu_torch.models.simple_gcn import batch_graph, gcn_aggregate
from wild_visual_navigation_tpu_torch.ops import segment_ops as tseg
from wild_visual_navigation_tpu_torch.runtime import WVNRuntime, run_replay
from wild_visual_navigation_tpu_torch.runtime import fused as tfused
from wild_visual_navigation_tpu_torch.runtime.replay import Sequence, load_sequence
from wild_visual_navigation_tpu_torch.traversability.estimator import TraversabilityEstimator
from wild_visual_navigation_tpu_torch.traversability.nodes import MissionNode, SupervisionNode
from wild_visual_navigation_tpu_torch.utils import confidence_generator as tcg
from wild_visual_navigation_tpu_torch.utils.params import (
    head_state_from_jax,
    linear_rnvp_state_from_jax,
    simple_gcn_state_from_jax,
    train_state_from_jax,
    vit_state_from_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOW_RTOL = FLOW_ATOL = 1e-5  # z, log_det, logprob and the inverse flow
GCN_ATOL = 1e-5


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


def _close(got, want, atol, rtol=0.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _head_pair(cfg, seed=0):
    """A JAX head, its params, and the port's head holding them."""
    jm = jget_model(cfg)
    D = cfg[next(k for k in cfg if k.endswith("_cfg"))]["input_size"]
    params = _np(jinit_model(jm, jax.random.PRNGKey(seed), D))
    tm = get_model(cfg)
    tm.load_state_dict(head_state_from_jax(params))
    return jm, params, tm.eval()


def _rnvp_cfg(D=384, mask="odds", perm=True, single=False, top=(200,), flows=2):
    return {"name": "LinearRnvp", "linear_rnvp_cfg": {"input_size": D, "coupling_topology": list(top), "flow_n": flows,
                                                      "mask_type": mask, "use_permutation": perm,
                                                      "single_function": single}}


def _gcn_cfg(D=16, hidden=(32, 16, 1), reco=True):
    return {"name": "SimpleGCN", "simple_gcn_cfg": {"input_size": D, "hidden_sizes": list(hidden),
                                                    "reconstruction": reco}}


# ------------------------------------------------------------------ LinearRnvp


@pytest.mark.parametrize("mask,perm,single", [("odds", True, False), ("half", True, False), ("odds", False, False),
                                              ("half", False, True), ("odds", True, True)],
                         ids=["odds-perm", "half-perm", "odds-flip", "half-flip-single", "odds-perm-single"])
def test_linear_rnvp_matches_jax(mask, perm, single):
    """Forward (z, log_det, logprob) and the inverse flow at input 384,
    topology [200]; rtol 1e-5 / atol 1e-5."""
    jm, params, tm = _head_pair(_rnvp_cfg(mask=mask, perm=perm, single=single))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 384)).astype(np.float32)
    want = jm.apply(params, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert set(got) == set(want) == {"z", "log_det", "logprob"}
    for k in got:
        _close(got[k], want[k], FLOW_ATOL, FLOW_RTOL)
    u = rng.standard_normal((16, 384)).astype(np.float32)
    want_u, want_ld = jm.apply(params, u, method=lambda m, v: m._flow_backward(v))
    with torch.no_grad():
        got_u, got_ld = tm._flow_backward(torch.from_numpy(u))
        back, _ = tm._flow_backward(got["z"])
    _close(got_u, want_u, FLOW_ATOL, FLOW_RTOL)
    _close(got_ld, want_ld, FLOW_ATOL, FLOW_RTOL)
    _close(back, x, 1e-4)  # the inverse undoes the forward


def test_linear_rnvp_permutations_and_sample():
    """The permutations are the JAX package's numpy draws; `sample` is the
    inverse flow of a draw from the torch generator (the accepted
    divergence: JAX draws with jax.random.normal)."""
    jm, params, tm = _head_pair(_rnvp_cfg(D=24, top=(16, 12), flows=3))
    rng = np.random.RandomState(0)
    for i in range(3):
        perm = rng.permutation(24)
        assert torch.equal(tm.perms[i], torch.from_numpy(perm))
        assert torch.equal(tm.inv_perms[i], torch.from_numpy(np.argsort(perm)))
    assert not any("perm" in k or "mask" in k for k in tm.state_dict())
    z, lp = tm.sample(torch.Generator().manual_seed(3), samples=5, return_logdet=True)
    u = torch.randn((5, 24), generator=torch.Generator().manual_seed(3))
    want_z, want_d = jm.apply(params, u.numpy(), method=lambda m, v: m._flow_backward(v))
    _close(z, want_z, FLOW_ATOL, FLOW_RTOL)
    _close(lp, np.sum(-0.5 * u.numpy() ** 2 - 0.5 * np.log(2 * np.pi), -1) + np.asarray(want_d), 1e-4)
    # the first topology width appears twice in each conditioner net
    assert [lin.out_features for lin in tm.layers[0].s_net.layers] == [16, 16, 12, 24]


# ------------------------------------------------------------------ SimpleGCN


def _graph(rng, S=12, E=20, n_invalid=5):
    edges = rng.integers(0, S, (2, E)).astype(np.int32)
    valid = np.ones(E, bool)
    valid[rng.choice(E, n_invalid, replace=False)] = False
    edges[:, ~valid] = rng.integers(0, 3 * S, (2, n_invalid))  # garbage behind invalid slots
    return edges, valid


@pytest.mark.parametrize("n_edges", [20, 0], ids=["edges", "no-edges"])
def test_gcn_aggregate_and_head_match_jax(n_edges):
    """With invalid edges (garbage ids behind them) and with none: atol 1e-5.
    Without edges the graph head equals itself scored row by row."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((12, 16)).astype(np.float32)
    edges, valid = _graph(rng, E=n_edges, n_invalid=min(5, n_edges))
    _close(gcn_aggregate(torch.from_numpy(x), torch.from_numpy(edges), torch.from_numpy(valid)),
           jgcn_aggregate(jnp.asarray(x), jnp.asarray(edges), jnp.asarray(valid)), GCN_ATOL)
    jm, params, tm = _head_pair(_gcn_cfg())
    assert model_needs_edges(tm)
    with torch.no_grad():
        got = apply_model(tm, torch.from_numpy(x), torch.from_numpy(edges), torch.from_numpy(valid))
        alone = apply_model(tm, torch.from_numpy(x))
    _close(got, jm.apply(params, x, edges, valid), GCN_ATOL)
    assert got.shape == (12, 1 + 16) and bool(((got[:, 0] >= 0) & (got[:, 0] <= 1)).all())
    if n_edges == 0:
        with torch.no_grad():
            rows = torch.stack([apply_model(tm, torch.from_numpy(x[i : i + 1]))[0] for i in range(12)])
        _close(got, alone, 0.0)
        _close(alone, rows, 1e-6)


@pytest.mark.parametrize("S,max_edges", [(9, 32), (300, 64), (300, 4096)],
                         ids=["counts", "unique-truncated", "unique-padded"])
def test_batched_adjacency_equals_jax_image_by_image(S, max_edges):
    """adjacency_list on a (B, H, W) batch (a co-occurrence count for S <=
    256, one torch.unique over (image, key) rows above) equals the JAX
    function image by image, ids outside [0, S) and an image with no edges
    included."""
    rng = np.random.default_rng(3)
    segs = rng.integers(-1, S + 2, (4, 12, 16)).astype(np.int32)
    segs[1] = 0  # a node with no edges
    edges, valid = tseg.adjacency_list(torch.from_numpy(segs), S, max_edges=max_edges)
    assert edges.shape == (4, 2, max_edges) and valid.shape == (4, max_edges)
    for b in range(4):
        je, jv = jseg.adjacency_list(jnp.asarray(segs[b]), S, max_edges=max_edges)
        np.testing.assert_array_equal(edges[b].numpy(), np.asarray(je))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(jv))
    assert not bool(valid[1].any()) and bool(valid[0].any())


def test_batched_graph_equals_graphs_one_by_one():
    """The batch as one graph (batch_graph) scores as the graphs one by one."""
    rng = np.random.default_rng(3)
    S = 9
    segs = rng.integers(0, S, (4, 3, 4)).repeat(4, 1).repeat(4, 2).astype(np.int32)
    segs[1] = 0  # a node with no edges
    edges, valid = tseg.adjacency_list(torch.from_numpy(segs), S, max_edges=32)
    _, _, tm = _head_pair(_gcn_cfg())
    x = torch.from_numpy(rng.standard_normal((4 * S, 16)).astype(np.float32))
    with torch.no_grad():
        whole = tm(x, *batch_graph(edges, valid, S))
        each = torch.cat([tm(x[b * S : (b + 1) * S], edges[b], valid[b]) for b in range(4)])
    _close(whole, each, 1e-6)


def test_head_bridges():
    """simple_gcn_state_from_jax is the Dense_i bridge; linear_rnvp's names
    every conditioner layer; head_state_from_jax picks by layout."""
    _, params, tm = _head_pair(_gcn_cfg())
    assert set(simple_gcn_state_from_jax(params)) == set(tm.state_dict())
    _, params, tm = _head_pair(_rnvp_cfg(D=8, top=(6,)))
    sd = linear_rnvp_state_from_jax(params)
    assert set(sd) == set(tm.state_dict()) and "layers.1.t_net.layers.2.weight" in sd
    assert sd["layers.0.s_net.layers.0.weight"].shape == (6, 8)


# ------------------------------------------------------------ estimator sessions
# D=16, S=9, 48x64, capacity 16, fan-out 8, cameras looking down along x
# (the learning tests' mission).

EST_ARGS = dict(lr=1e-3, max_distance=3.0, image_distance_thr=0.1, supervision_distance_thr=0.05,
                min_samples_for_training=2, batch_size=4, buffer_capacity=16, num_segments=9, feature_dim=16,
                image_height=48, image_width=64, reprojection_fanout=8)
SEG = np.arange(9, dtype=np.int32).reshape(3, 3).repeat(16, 0).repeat(22, 1)[:48, :64]
K_CAM = np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]])
SESSION_ATOL, SESSION_RTOL = 1e-5, 1e-4  # losses and params after 10 Adam steps


def _pose(x=0.0):
    T = np.eye(4)
    T[0, 3] = x
    return T


def _cam(x):
    T = np.eye(4)
    T[:3, :3] = [[1, 0, 0], [0, -1, 0], [0, 0, -1]]
    T[:3, 3] = [x, 0, 2.0]
    return T


def _feed(est, jax_side):
    MN, SN = (JMissionNode, JSupervisionNode) if jax_side else (MissionNode, SupervisionNode)
    rng = np.random.default_rng(0)
    for i, x in enumerate(np.linspace(0, 1.0, 5)):
        node = MN(timestamp=float(i), pose_base_in_world=_pose(x), pose_cam_in_base=np.linalg.inv(_pose(x)) @ _cam(x))
        est.add_mission_node(node, rng.standard_normal((9, 16)).astype(np.float32), np.ones(9, bool), SEG, K_CAM)
    for i, x in enumerate(np.linspace(0, 1.0, 6)):
        est.add_supervision_node(SN(timestamp=i + 0.5, pose_base_in_world=_pose(x), width=0.4, length=0.4, height=0.3,
                                    twist_in_base=np.array([1.0, 0, 0]), desired_twist_in_base=np.array([1.0, 0, 0]),
                                    traversability=0.9 - 0.1 * i, traversability_var=1.0, is_untraversable=False))


@pytest.mark.parametrize("kind", ["anomaly", "graph"])
def test_estimator_session_matches_jax(kind):
    """10 Adam steps in anomaly mode (LinearRnvp) or with the graph head
    (SimpleGCN), the JAX head and confidence state carried over, batches
    from the same seed: losses and the final params, Adam moments and
    confidence state to atol 1e-5 / rtol 1e-4 (the flow's log-likelihood
    sums 16 dims of terms of order 10)."""
    cfg = _rnvp_cfg(D=16, top=(16,)) if kind == "anomaly" else _gcn_cfg()
    kw = dict(model_cfg=cfg, anomaly_detection=kind == "anomaly", **EST_ARGS)
    jest = JEstimator(**kw, seed=5)
    test = TraversabilityEstimator(**kw, seed=5, device="cpu")
    test.adopt_train_state(**train_state_from_jax(*_np((jest.params, jest._opt_state, jest.confidence_state)), 0))
    _feed(jest, True)
    _feed(test, False)
    assert test.get_num_valid_nodes() == jest.get_num_valid_nodes() >= 3
    np.random.seed(5)
    j_losses = [jest.train()["loss_total"] for _ in range(10)]
    t_losses = [test.train()["loss_total"] for _ in range(10)]
    assert all(v != -1 for v in t_losses)
    _close(t_losses, j_losses, SESSION_ATOL, SESSION_RTOL)
    want = train_state_from_jax(*_np((jest.params, jest._opt_state, jest.confidence_state)), jest.step)
    for name, p in test.model.named_parameters():
        _close(p, want["params"][name], SESSION_ATOL, SESSION_RTOL)
        st = test.optimizer.state[p]
        _close(st["exp_avg"], want["adam"]["exp_avg"][name], SESSION_ATOL, SESSION_RTOL)
        _close(st["exp_avg_sq"], want["adam"]["exp_avg_sq"][name], SESSION_ATOL, SESSION_RTOL)
    for name in tcg.ConfidenceState._fields:
        _close(getattr(test.confidence_state, name), getattr(want["cg_state"], name), SESSION_ATOL, SESSION_RTOL)
    assert test.step == jest.step == 10


# --------------------------------------------------------------- fused frame
# A small ViT (2 blocks, width 64) with the same JAX-initialised weights on
# both sides, frames from the demo mission, as the frame parity tests use.


SIZE, S = 64, 20
VIT = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, pos_grid_size=8, layerscale_init=None)
MAP_ATOL = 2e-3  # trav and conf, as the frame parity tests hold them


@pytest.fixture(scope="module")
def vit_pair():
    jv = jvit.VisionTransformer(jvit.ViTConfig(**VIT), attention_impl="xla", dtype=jnp.float32)
    vparams = _np(jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, SIZE, SIZE))))
    tv = tvit.VisionTransformer(tvit.ViTConfig(**VIT), dtype=torch.float32)
    tv.load_state_dict(vit_state_from_jax(vparams))
    frames = np.load(os.path.join(ROOT, "assets/sequences/demo_mission.npz"))["frame_images"][:2]
    feat = np.asarray(jvit.dense_features(jv, vparams, imagenet_normalize(frames[:1])))
    return jv, vparams, tv, frames, feat


def _cg_pair(scores):
    """Both packages' confidence states at the scale of `scores`."""
    m, s = float(np.mean(scores)), float(np.std(scores))
    return (jcg.confidence_init()._replace(mean=jnp.float32(m), std=jnp.float32(s)),
            tcg.confidence_init()._replace(mean=torch.tensor(m), std=torch.tensor(s)))


@pytest.mark.parametrize("kind,kw", [
    ("anomaly", {}),
    ("anomaly", dict(prediction_per_pixel=False)),
    ("anomaly", dict(segmentation_type="grid", cell_size=16)),
    ("graph", {}),
    ("graph", dict(segmentation_type="grid", cell_size=16)),
], ids=["anomaly-slic-per-pixel", "anomaly-per-segment", "anomaly-grid", "graph-slic", "graph-grid"])
def test_fused_frame_with_anomaly_and_graph_heads(vit_pair, monkeypatch, kind, kw):
    """The fused DINO frame scoring with a LinearRnvp (anomaly: no K2, the
    chunked per-pixel path or per segment, confidence 1) or a SimpleGCN
    (per segment over the frame adjacency, in either prediction mode):
    maps within 2e-3 of JAX's, segments agreeing in 0.99 of pixels."""
    jv, vparams, tv, frames, feat = vit_pair
    jm, mparams, tm = _head_pair(_rnvp_cfg(D=64, top=(64,)) if kind == "anomaly" else _gcn_cfg(D=64))
    cfg = dict(num_segments=S, max_edges=256, anomaly=kind == "anomaly", **kw)
    jframe = jbuild(jv, jm, jcg.ConfidenceConfig(std_factor=0.5), SIZE, **cfg)
    tframe = tfused.build_fused_frame_fn(tv, tm, tcg.ConfidenceConfig(std_factor=0.5), SIZE, **cfg)
    # confidence statistics at the scale of what the head scores: pixels or pooled segments
    pooled = np.asarray(jframe(vparams, mparams, jcg.confidence_init(), frames[:1]).features)
    rows = feat[0].reshape(64, -1).T if kw.get("prediction_per_pixel", True) and kind == "anomaly" else pooled
    if kind == "anomaly":
        out = jm.apply(mparams, rows)
        scores = -(np.asarray(out["logprob"]).sum(-1) + np.asarray(out["log_det"]))
    else:
        out = np.asarray(jm.apply(mparams, rows, np.zeros((2, 0), np.int32), np.zeros(0, bool)))
        scores = np.mean((out[:, 1:] - rows) ** 2, -1)
    jst, tst = _cg_pair(scores)

    def no_k2(*a, **k):
        raise AssertionError("K2's scorer was called for an anomaly or graph head")

    monkeypatch.setattr(tfused, "pixelwise_score", no_k2)
    want = jframe(vparams, mparams, jst, frames[:1])
    got = tframe(tst, torch.from_numpy(frames[:1]))
    assert np.mean(got.segments.numpy() == np.asarray(want.segments)) >= 0.99
    _close(got.traversability, want.traversability, MAP_ATOL)
    _close(got.confidence, want.confidence, MAP_ATOL)
    if kind == "anomaly":
        assert bool((got.confidence == 1).all())
    else:  # per segment: one score per segment id
        t, sg = got.traversability.numpy(), got.segments.numpy()
        assert all(np.ptp(t[sg == i]) == 0 for i in np.unique(sg))
    assert float(got.traversability.std()) > 0


# ------------------------------------------------------------------- runtime


RT_SIZE = 32


def _rt_params(mod_node, mod_exp):
    fe = mod_node.FeatureExtractorNodeParams(
        network_input_image_height=RT_SIZE, network_input_image_width=RT_SIZE, segmentation_type="grid",
        feature_type="dino", dino_patch_size=8, grid_cell_size=8, prediction_per_pixel=True, image_callback_rate=1e9)
    ln = mod_node.LearningNodeParams(
        network_input_image_height=RT_SIZE, network_input_image_width=RT_SIZE, image_graph_dist_thr=0.05,
        supervision_graph_dist_thr=0.02, min_samples_for_training=3, supervision_callback_rate=1e9)
    exp = mod_exp.ExperimentParams()
    exp.model.name = "LinearRnvp"
    return fe, ln, exp


def test_anomaly_runtime_replays_the_demo_mission_as_jax():
    """WVNRuntime(anomaly_detection=True) over the first 3 s of the demo
    mission, DINO ViT-S/8 at 32 px in fp32 and the default LinearRnvp
    (input 384, topology [200], 2 flows), the JAX runtime's backbone,
    head and confidence state carried over: the same frames, flushes,
    steps and valid nodes, losses within 1e-4 relative, the last map
    within 2e-3, confidence 1."""
    seq = load_sequence(os.path.join(ROOT, "assets/sequences/demo_mission.npz"))
    seq = Sequence([f for f in seq.frames if f.stamp < 3.0], [s for s in seq.states if s.stamp < 3.0])
    fe, ln, exp = _rt_params(jcfg, jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfe_mod, "DinoInterface", functools.partial(JDino, dtype=jnp.float32, attention_impl="xla"))
        jrt = JRuntime(fe_params=fe, ln_params=ln, exp_params=exp, key=jax.random.PRNGKey(0), anomaly_detection=True,
                       buffer_capacity=16, reprojection_fanout=8)
    fe, ln, exp = _rt_params(tnode, texp)
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, anomaly_detection=True, buffer_capacity=16,
                    reprojection_fanout=8, device="cpu", backbone_dtype=torch.float32,
                    backbone_params=vit_state_from_jax(_np(jrt.feature_extractor._extractor.params)))
    assert rt._fused_frame is not None and jrt._fused_frame is not None
    est = jrt.estimator
    rt.adopt_train_state(**train_state_from_jax(*_np((est.params, est._opt_state, est.confidence_state)), 0))
    losses = {"jax": [], "port": []}
    for name, r in (("jax", jrt), ("port", rt)):
        step = r.learning_step

        def recorded(step=step, out=losses[name]):
            st = step()
            out.append(st.loss_total)
            return st

        r.learning_step = recorded
    np.random.seed(42)
    jrep = jrun_replay(jrt, seq)
    trep = run_replay(rt, seq)
    for field in ("frames_processed", "supervision_updates", "train_steps", "valid_nodes"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.train_steps >= 3 and trep.valid_nodes >= 4
    _close(losses["port"], losses["jax"], 1e-6, 1e-4)
    trav, conf = trep.last_result.to_numpy()
    _close(trav, jrep.last_result.traversability, MAP_ATOL)
    _close(conf, jrep.last_result.confidence, 0.0)
    assert (conf == 1).all()
    np.testing.assert_array_equal(rt.estimator.buffer.signal_valid.numpy(), np.asarray(est.buffer.signal_valid))


def test_composed_branch_scores_anomaly_and_graph_heads():
    """The runtime's composed branch (sift features on a grid, no fused
    frame): anomaly scoring per pixel (no confidence map) and per segment
    (confidence 1), and a graph head per segment over the frame adjacency,
    each equal to the head applied by hand."""
    fe = tnode.FeatureExtractorNodeParams(network_input_image_height=RT_SIZE, network_input_image_width=RT_SIZE,
                                          segmentation_type="grid", feature_type="sift", grid_cell_size=8,
                                          image_callback_rate=1e9)
    img = np.random.default_rng(6).random((3, RT_SIZE, RT_SIZE)).astype(np.float32)
    args = (img, 0.0, "front", np.array([[30.0, 0, 16], [0, 30, 16], [0, 0, 1]]), RT_SIZE, RT_SIZE, np.eye(4),
            np.eye(4))
    for name, pp in (("LinearRnvp", True), ("LinearRnvp", False), ("SimpleGCN", True)):
        exp = texp.ExperimentParams()
        exp.model.name = name
        exp.model.simple_gcn_cfg.hidden_sizes = [16, 8, 1]
        exp.model.linear_rnvp_cfg.coupling_topology = [32]
        rt = WVNRuntime(fe_params=fe, exp_params=exp, anomaly_detection=name == "LinearRnvp", buffer_capacity=8,
                        device="cpu")
        res = rt.image_callback(*args, prediction_per_pixel=pp)
        ex = rt.feature_extractor.extract(torch.from_numpy(img)[None], return_dense_features=True)
        head, cg = rt.inference_head
        with torch.no_grad():
            if name == "SimpleGCN":
                out = head(ex.features, ex.edges, ex.edge_valid)
                want = out[:, 0][ex.segments.long()]
                assert res.confidence is not None
            else:
                x = ex.dense_features.reshape(384, -1).T if pp else ex.features
                out = head(x)
                nll = -(out["logprob"].sum(-1) + out["log_det"])
                want = tcg.confidence_inference(rt.estimator._cg_cfg, cg, nll)
                want = want.reshape(RT_SIZE, RT_SIZE) if pp else want[ex.segments.long()]
                assert (res.confidence is None) if pp else bool((res.confidence == 1).all())
        _close(res.traversability, want, 1e-6)


def test_feature_node_scores_anomaly_as_the_jax_node():
    """FeatureExtractorNode with a LinearRnvp head (sift features on a grid,
    per segment and per pixel): the JAX node's weights and confidence state,
    maps within 1e-3. The flow's negative log-likelihood is about 354 here
    with a spread of 0.34 over the pixels, so the two fp32 units (6e-5) by
    which the packages' sums differ move the calibrated map by up to 5e-4.
    The node still refuses SimpleGCN."""
    from wild_visual_navigation_tpu.runtime import nodes as jnodes
    from wild_visual_navigation_tpu_torch.runtime import nodes as tnodes

    img = np.random.default_rng(7).random((3, RT_SIZE, RT_SIZE)).astype(np.float32)
    K = np.array([[30.0, 0, 16], [0, 30, 16], [0, 0, 1]])
    for pp in (False, True):
        maps = {}
        for name, node_mod, cfg_mod in (("jax", jnodes, jcfg), ("port", tnodes, (tnode, texp))):
            nm, em = (cfg_mod, cfg_mod) if name == "jax" else cfg_mod
            fe = nm.FeatureExtractorNodeParams(network_input_image_height=RT_SIZE, network_input_image_width=RT_SIZE,
                                               segmentation_type="grid", feature_type="sift", grid_cell_size=8,
                                               prediction_per_pixel=pp, image_callback_rate=1e9)
            exp = em.ExperimentParams()
            exp.model.name = "LinearRnvp"
            exp.model.linear_rnvp_cfg.coupling_topology = [32]
            kw = dict(key=jax.random.PRNGKey(0)) if name == "jax" else dict(device="cpu")
            node = node_mod.FeatureExtractorNode(params=fe, exp_params=exp, hot_swap_folder="unused", **kw)
            if name == "jax":
                jparams = _np(node.model_params)
                ex = node.feature_extractor.extract(jnp.asarray(img)[None], return_dense_features=pp)
                x = np.asarray(ex.dense_features).reshape(384, -1).T if pp else np.asarray(ex.features)
                out = node.model.apply(jparams, x)
                nll = -(np.asarray(out["logprob"]).sum(-1) + np.asarray(out["log_det"]))
                m, sd = float(nll.mean()), float(nll.std())
                node.cg_state = node.cg_state._replace(mean=jnp.float32(m), std=jnp.float32(sd))
            else:
                node.model.load_state_dict(head_state_from_jax(jparams))
                node.cg_state = node.cg_state._replace(mean=torch.tensor(m), std=torch.tensor(sd))
            maps[name] = [np.asarray(m) for m in node.image_callback(img, 0.0, "front", K, RT_SIZE, RT_SIZE)]
        for got, want in zip(maps["port"], maps["jax"]):
            _close(got, want, 1e-3)
        assert (maps["port"][1] == 1).all() and np.ptp(maps["port"][0]) > 0
    exp = texp.ExperimentParams()
    exp.model.name = "SimpleGCN"
    with pytest.raises(ValueError, match="SimpleGCN"):
        tnodes.FeatureExtractorNode(params=tnode.FeatureExtractorNodeParams(feature_type="sift"), exp_params=exp,
                                    hot_swap_folder="unused", device="cpu")
