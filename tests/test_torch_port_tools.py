"""The torch port's offline tools (wild_visual_navigation_tpu_torch/tools/)
against the repository's root tools/ that drive the JAX package, on the
CPU: the vectorised parameter search, dataset generation, the ablation
sweep's run_one, real-data evaluation's splits and trainers with the
reference-graph loader, and the soak with its gates.

Inputs are made with numpy from fixed seeds. Tolerances, each stated
beside its test:
  * population_fit's trial 0 against the port's OfflineTrainer: scores within
    rtol 1e-4 / atol 1e-5 (the same algebra, Adam written out on stacked
    tensors); every trial against JAX's population fed the same initial
    weights within rtol 2e-3 / atol 2e-4 (the JAX test's own tolerance);
  * generate_dataset's records against the JAX tool's loop (fp32 backbones
    carrying JAX's weights): segments, edges, validity and labels exactly,
    features 1e-4 and centres 1e-3 (the facade tests'), flow 1e-3 px (the
    optical-flow tests');
  * the ablation sweep's run_one (grid x sift, no backbone): the same nodes
    and steps, the exported signals to rtol 1e-5 / atol 1e-6 (the learning
    tests' estimator state: masked means over many pixels in another
    order), their validity exactly;
  * real_data_eval's splits exactly; train_offline / train_online from the
    JAX side's initial weights: losses rtol 1e-4, scores atol 1e-5."""

import argparse
import glob
import json
import os
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools import ablation_sweep as jsweep  # noqa: E402
from tools import generate_dataset as jgen  # noqa: E402
from tools import param_search as jsearch  # noqa: E402
from tools import real_data_eval as jreal  # noqa: E402
from wild_visual_navigation_tpu.feature_extractor import feature_extractor as jfe_mod  # noqa: E402
from wild_visual_navigation_tpu.feature_extractor.dino import DinoInterface as JDino  # noqa: E402
from wild_visual_navigation_tpu.feature_extractor.stego import StegoInterface as JStego  # noqa: E402
from wild_visual_navigation_tpu.models import get_model as jget_model  # noqa: E402
from wild_visual_navigation_tpu.models import init_model as jinit_model  # noqa: E402
from wild_visual_navigation_tpu.models import stego_head as jhead_mod  # noqa: E402
from wild_visual_navigation_tpu.models.vit import make_vit as jmake_vit  # noqa: E402
from wild_visual_navigation_tpu.offline import OfflineTrainer as JTrainer  # noqa: E402
from wild_visual_navigation_tpu.offline import OfflineTrainerConfig as JConfig  # noqa: E402
from wild_visual_navigation_tpu.offline import reference_graph as jrg  # noqa: E402
from wild_visual_navigation_tpu.ops.optical_flow import track_points as jtrack_points  # noqa: E402
from wild_visual_navigation_tpu.traversability import TraversabilityEstimator as JEstimator  # noqa: E402
from wild_visual_navigation_tpu_torch.offline import reference_graph as trg  # noqa: E402
from wild_visual_navigation_tpu_torch.offline.trainer import OfflineTrainer, OfflineTrainerConfig  # noqa: E402
from wild_visual_navigation_tpu_torch.tools import (  # noqa: E402
    ablation_sweep,
    generate_dataset,
    param_search,
    real_data_eval,
    soak,
)
from wild_visual_navigation_tpu_torch.utils.params import (  # noqa: E402
    mlp_state_from_jax,
    stego_head_state_from_jax,
    train_state_from_jax,
    vit_state_from_jax,
)

TRIAL0_RTOL, TRIAL0_ATOL = 1e-4, 1e-5
POP_RTOL, POP_ATOL = 2e-3, 2e-4
FEAT_ATOL, CENTER_ATOL, FLOW_ATOL = 1e-4, 1e-3, 1e-3
SIGNAL_RTOL, SIGNAL_ATOL = 1e-5, 1e-6  # the learning tests' estimator-state tolerance
LOSS_RTOL, SCORE_ATOL = 1e-4, 1e-5


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


# ---------------------------------------------------------------- param_search
def test_sampler_synth_data_and_population_metrics_match_jax():
    for pin in (True, False):
        for got, want in zip(param_search.sample_space(9, 5, pin), jsearch.sample_space(9, 5, pin)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(param_search.make_synth(12, 3, 5, seed=2), jsearch.make_synth(12, 3, 5, seed=2)):
        for f in ("features", "signal", "signal_valid", "sample_valid"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    _, val = param_search.make_synth(12, 3, 5, seed=2)
    scores = np.random.RandomState(0).rand(4, val.signal.size).astype(np.float32)
    assert param_search.evaluate_population(scores, val) == jsearch.evaluate_population(scores, val)


@pytest.mark.parametrize("anomaly_balanced", [True, False])
def test_population_trial0_is_the_offline_trainer(anomaly_balanced):
    """Trial 0 (the production defaults, seed) trains as OfflineTrainer(seed)
    does: the same head, batches and Adam algebra."""
    train, val = param_search.make_synth(n_nodes=24, n_seg=4, dim=12, seed=3)
    lr, wt, wr = param_search.sample_space(5, seed=42)
    scores, losses, params = param_search.population_fit(train, val, lr, wt, wr, epochs=8, batch_size=4, seed=42,
                                                         anomaly_balanced=anomaly_balanced, device="cpu")
    cfg = OfflineTrainerConfig(epochs=8, batch_size=4, seed=42)
    cfg.model_cfg["simple_mlp_cfg"]["input_size"] = 12
    cfg.loss_cfg = type(cfg.loss_cfg)(anomaly_balanced=anomaly_balanced)
    trainer = OfflineTrainer(cfg, device="cpu")
    trainer.fit(train)
    np.testing.assert_allclose(scores[0], trainer.predict(val.features), rtol=TRIAL0_RTOL, atol=TRIAL0_ATOL)
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(params[name][0].numpy(), p.detach().numpy(), rtol=TRIAL0_RTOL, atol=TRIAL0_ATOL)
    assert scores.shape == (5, val.signal.size) and losses.shape == (5,) and np.isfinite(losses).all()
    aurocs = [m["val_auroc"] for m in param_search.evaluate_population(scores, val)]
    assert max(aurocs) >= aurocs[0]


def test_population_matches_jax_from_the_same_weights():
    """Every trial against JAX's population_fit, the port fed the heads JAX
    draws from PRNGKey(seed + i)."""
    train, val = param_search.make_synth(n_nodes=24, n_seg=4, dim=12, seed=3)
    lr, wt, wr = param_search.sample_space(6, seed=42)
    want, jlosses, _ = jsearch.population_fit(train, val, lr, wt, wr, epochs=8, batch_size=4, seed=42)
    model = jget_model({"name": "SimpleMLP",
                        "simple_mlp_cfg": {"input_size": 12, "hidden_sizes": [256, 32, 1], "reconstruction": True}})
    keys = jnp.stack([jax.random.PRNGKey(42 + i) for i in range(6)])
    init = mlp_state_from_jax(_np(jax.vmap(lambda k: jinit_model(model, k, 12))(keys)))
    got, losses, _ = param_search.population_fit(train, val, lr, wt, wr, epochs=8, batch_size=4, seed=42,
                                                 device="cpu", init_params=init)
    np.testing.assert_allclose(got, want, rtol=POP_RTOL, atol=POP_ATOL)
    np.testing.assert_allclose(losses, jlosses, rtol=POP_RTOL, atol=POP_ATOL)
    assert param_search.evaluate_population(got, val)[0]["val_auroc"] == pytest.approx(
        jsearch.evaluate_population(want, val)[0]["val_auroc"], abs=2e-3)


def test_param_search_cli_on_the_cpu(tmp_path):
    out = tmp_path / "search"
    assert param_search.main(["--data", "synth", "--trials", "4", "--epochs", "2", "--out", str(out),
                              "--device", "cpu"]) == 0
    summary = json.load(open(out / "search_summary.json"))
    assert summary["trials"] == 4 and summary["default"]["is_default"] and summary["device"] == "cpu"
    assert (out / "search_results.csv").exists() and (out / "search_results.md").exists()
    with pytest.raises(SystemExit, match="reference graph assets not found"):
        param_search.main(["--data", "real", "--device", "cpu", "--out", str(out)])


# ---------------------------------------------------------------- generate_dataset
GEN_SIZE, GEN_SLIC = 64, 16


def _fill(shapes, rng):
    """numpy weights in the flax layout of `shapes` (fan-in-scaled kernels,
    LayerNorm scales near 1, small biases and tokens)."""

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


def _frames(n=3, size=GEN_SIZE, seed=0):
    """A blocky texture shifted 2 px per frame, as a moving camera sees it."""
    rng = np.random.default_rng(seed)
    tex = rng.random((3, size // 4, size // 4), dtype=np.float32).repeat(4, 1).repeat(4, 2)
    tex = np.clip(tex + 0.03 * rng.standard_normal(tex.shape).astype(np.float32), 0, 1)
    return [np.ascontiguousarray(np.roll(tex, 2 * i, axis=(1, 2))) for i in range(n)]


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """The port's generate() and the JAX tool's loop on the same frames, the
    port's fp32 backbones carrying JAX's weights."""
    rng = np.random.default_rng(0)
    N = (GEN_SIZE // 8) ** 2
    vit_b8 = jmake_vit("dino", "vit_base", 8, attention_impl="xla", dtype=jnp.float32)
    bp = _fill(jax.eval_shape(vit_b8.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, GEN_SIZE, GEN_SIZE))), rng)
    head = jhead_mod.StegoHead(in_dim=768, code_dim=90, n_classes=27)
    hp = _fill(jax.eval_shape(head.init, jax.random.PRNGKey(0), jnp.zeros((1, N, 768))), rng)
    vit_s14 = jmake_vit("dinov2", "vit_small", 14, attention_impl="xla", dtype=jnp.float32)
    sp = _fill(jax.eval_shape(vit_s14.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, GEN_SIZE, GEN_SIZE))), rng)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfe_mod, "DinoInterface", lambda **kw: JDino(**{**kw, "dtype": jnp.float32,
                                                                   "attention_impl": "xla"}))
        jfe = jfe_mod.FeatureExtractor(key=jax.random.PRNGKey(0), segmentation_type="slic", feature_type="dinov2",
                                       input_size=GEN_SIZE, slic_num_components=GEN_SLIC, backbone_params=sp)
    jst = JStego(key=jax.random.PRNGKey(1), input_size=GEN_SIZE, run_clustering=False, attention_impl="xla",
                 dtype=jnp.float32, backbone_params=bp, head_params=hp)
    fe, st = generate_dataset.build_extractors(
        "dinov2", "slic", GEN_SIZE, GEN_SLIC, "stego", device="cpu", dtype=torch.float32,
        backbone_params=vit_state_from_jax(sp), stego_backbone_params=vit_state_from_jax(bp),
        stego_head_params=stego_head_state_from_jax(hp))
    images = _frames()
    names = [f"frame_{i}.png" for i in range(len(images))]
    out = tmp_path_factory.mktemp("datasets")
    meta = generate_dataset.generate(images, names, fe, st, str(out), "seeded", percentage=0.67, every_n_test=2)

    want = []  # the JAX tool's loop (tools/generate_dataset.py main), on the same images
    exs = []
    for img in images:
        ex = jfe.extract(jnp.asarray(img)[None])
        jst.inference(jnp.asarray(img)[None])
        exs.append((ex, jgen.majority_labels(ex.segments, jst.linear_segments[0], ex.features.shape[0])))
    for i, (ex, label) in enumerate(exs):
        if i + 1 < len(images):
            nxt, good = jtrack_points(jnp.asarray(images[i]), jnp.asarray(images[i + 1]), ex.centers)
        else:
            nxt, good = jnp.zeros_like(ex.centers), jnp.zeros((ex.features.shape[0],), bool)
        want.append(dict(feat=ex.features, seg=ex.segments, edges=ex.edges, edge_valid=ex.edge_valid,
                         centers=ex.centers, center_valid=ex.center_valid, label=label, flow_next=nxt,
                         flow_good=good))
    return out / "seeded", meta, names, [_np(w) for w in want]


def test_generated_records_match_the_jax_tool(generated):
    base, meta, names, want = generated
    files = sorted(glob.glob(str(base / "graph_*.npz")))
    assert [os.path.basename(f) for f in files] == ["graph_0000.npz", "graph_0001.npz", "graph_0002.npz"]
    for f, name, w in zip(files, names, want):
        got = np.load(f)
        assert set(got.files) == {"source", "feat", "seg", "edges", "edge_valid", "centers", "center_valid", "label",
                                  "flow_next", "flow_good"}
        assert str(got["source"]) == name
        for key in ("seg", "edges", "edge_valid", "center_valid", "label", "flow_good"):
            assert got[key].dtype == np.asarray(w[key]).dtype or key in ("seg", "edges", "label"), key
            np.testing.assert_array_equal(got[key], w[key], err_msg=key)
        assert got["feat"].shape == (GEN_SLIC, 384) and got["label"].dtype == np.int32
        np.testing.assert_allclose(got["feat"], w["feat"], atol=FEAT_ATOL)
        np.testing.assert_allclose(got["centers"], w["centers"], atol=CENTER_ATOL)
        np.testing.assert_allclose(got["flow_next"], w["flow_next"], atol=FLOW_ATOL)
    assert (np.load(files[0])["label"] >= 0).any()


def test_generated_splits_and_meta(generated):
    base, meta, _, _ = generated
    assert meta == {"name": "seeded", "images": 3, "size": GEN_SIZE, "seg": "slic", "feature": "dinov2",
                    "labels": "stego", "feature_dim": 384, "splits": {"train": 2, "val": 1, "test": 2}}
    assert json.load(open(base / "meta.json")) == meta
    assert open(base / "seeded_train.txt").read().split() == ["graph_0000.npz", "graph_0001.npz"]
    assert open(base / "seeded_val.txt").read().split() == ["graph_0002.npz"]
    assert open(base / "seeded_test.txt").read().split() == ["graph_0000.npz", "graph_0002.npz"]


def test_majority_labels_match_jax():
    rng = np.random.default_rng(4)
    seg = rng.integers(0, 7, (12, 10)).astype(np.int32)
    seg[seg == 3] = 4  # segment 3 is empty: -1
    linear = rng.integers(0, 27, (12, 10)).astype(np.int32)
    got = generate_dataset.majority_labels(torch.from_numpy(seg), torch.from_numpy(linear), 8)
    want = np.asarray(jgen.majority_labels(jnp.asarray(seg), jnp.asarray(linear), 8))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[3] == -1 and got[7] == -1


# ---------------------------------------------------------------- ablation_sweep
def test_ablation_run_one_matches_jax(tmp_path):
    """grid x sift at 64 px (no backbone weights): the replay exports the
    same nodes with the same signals, after the same number of steps."""
    kw = dict(size=64, duration=5.0, epochs=3, kfold=2)
    np.random.seed(42)  # the JAX estimator samples from the global stream
    want = jsweep.run_one("grid", "sift", argparse.Namespace(**kw, out=str(tmp_path / "jax")))
    got = ablation_sweep.run_one("grid", "sift", argparse.Namespace(**kw, out=str(tmp_path / "torch"),
                                                                    device="cpu"))
    assert got["nodes_exported"] == want["nodes_exported"] >= 4
    assert got["online_train_steps"] == want["online_train_steps"] > 0
    assert got["feature_dim"] == want["feature_dim"] == 384 and got["folds_valid"].endswith("/2")
    assert set(ablation_sweep.ROW_KEYS) == set(want)
    jf = sorted(glob.glob(str(tmp_path / "jax/exports/grid_sift/*.npz")))
    tf = sorted(glob.glob(str(tmp_path / "torch/exports/grid_sift/*.npz")))
    assert [os.path.basename(f) for f in tf] == [os.path.basename(f) for f in jf]
    for a, b in zip(tf, jf):
        ga, gb = np.load(a), np.load(b)
        np.testing.assert_array_equal(ga["signal_valid"], gb["signal_valid"])
        np.testing.assert_allclose(ga["signal"], gb["signal"], rtol=SIGNAL_RTOL, atol=SIGNAL_ATOL)
        np.testing.assert_array_equal(ga["segments"], gb["segments"])


def test_ablation_sweep_keeps_going_past_a_failing_combo(tmp_path):
    args = ablation_sweep.parse_args(["--combos", "grid:nope", "--out", str(tmp_path), "--device", "cpu"])
    rows = ablation_sweep.sweep(args)
    assert len(rows) == 1 and "error" in rows[0]
    assert (tmp_path / "ablation_results.csv").exists() and (tmp_path / "ablation_results.md").exists()


# ---------------------------------------------------------------- real_data_eval
def _synthetic_graph(S=100, D=90, seed=0):
    """A stand-in for the recorded graph's shapes: 100 segments x 90-d, 16
    footprint positives (y == y_valid), centres on a 448-px image."""
    rng = np.random.RandomState(seed)
    y_valid = np.zeros(S, bool)
    y_valid[rng.choice(S, 16, replace=False)] = True
    x = (rng.randn(S, D) + 0.8 * y_valid[:, None] * rng.randn(D)).astype(np.float32)
    return types.SimpleNamespace(x=x, y=y_valid.astype(np.float32), y_valid=y_valid,
                                 centers=(rng.rand(S, 2) * 448).astype(np.float32),
                                 trav_pred=rng.rand(S).astype(np.float32))


def test_real_data_splits_match_jax():
    g = _synthetic_graph()
    labels = g.y > 0.5
    for seed in (0, 3):
        for a, b in zip(real_data_eval.stratified_split(labels, 0.3, seed), jreal.stratified_split(labels, 0.3, seed)):
            np.testing.assert_array_equal(a, b)
        for (ta, va), (tb, vb) in zip(real_data_eval.stratified_kfold(labels, 5, seed),
                                      jreal.stratified_kfold(labels, 5, seed)):
            np.testing.assert_array_equal(ta, tb)
            np.testing.assert_array_equal(va, vb)
    for rev in (False, True):
        for a, b in zip(real_data_eval.spatial_split(g.centers, rev), jreal.spatial_split(g.centers, rev)):
            np.testing.assert_array_equal(a, b)
    assert real_data_eval.eval_row("m", g.trav_pred, labels, {"k": 1}) == jreal.eval_row("m", g.trav_pred, labels,
                                                                                          {"k": 1})


def test_train_offline_matches_jax():
    g = _synthetic_graph()
    tr, va = real_data_eval.stratified_split(g.y > 0.5, 0.3, 0)
    cfg = JConfig(epochs=6, seed=0)
    cfg.model_cfg["simple_mlp_cfg"]["input_size"] = 90
    jt = JTrainer(cfg)
    state = train_state_from_jax(*_np((jt.params, jt.opt_state, jt.cg_state)), jt.step)
    jtrainer, jscore = jreal.train_offline(g.x[tr], g.y[tr], g.y_valid[tr], epochs=6, seed=0)
    trainer, score = real_data_eval.train_offline(g.x[tr], g.y[tr], g.y_valid[tr], epochs=6, seed=0, device="cpu",
                                                  train_state=state)
    np.testing.assert_allclose([h["train_loss"] for h in trainer.history],
                               [h["train_loss"] for h in jtrainer.history], rtol=LOSS_RTOL)
    np.testing.assert_allclose(score(g.x[va]), jscore(g.x[va]), atol=SCORE_ATOL)


def test_train_online_matches_jax():
    g = _synthetic_graph()
    tr = real_data_eval.stratified_split(g.y > 0.5, 0.3, 0)[0]
    x, y, yv = g.x[tr], g.y[tr], g.y_valid[tr]
    per = len(tr) // 10
    mlp = {"input_size": 90, "hidden_sizes": [256, 32, 1], "reconstruction": True}
    jest0 = JEstimator(model_cfg={"name": "SimpleMLP", "simple_mlp_cfg": mlp},
                       buffer_capacity=10, num_segments=per, feature_dim=90, image_height=8, image_width=8,
                       min_samples_for_training=5, batch_size=8, seed=0)
    state = train_state_from_jax(*_np((jest0.params, jest0._opt_state, jest0.confidence_state)), 0)
    np.random.seed(0)  # the JAX estimator samples from the global stream; the port's from RandomState(seed)
    jest, jscore, jlosses = jreal.train_online(x, y, yv, steps=40, seed=0)
    est, score, losses = real_data_eval.train_online(x, y, yv, steps=40, seed=0, device="cpu", train_state=state)
    assert est.step == jest.step == 40 and len(losses) == len(jlosses) == 40
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(score(g.x), jscore(g.x), atol=SCORE_ATOL)


def _write_graph_fixture(root: Path, S=6, D=90, seed=0):
    """A tiny graph.pt in the recorded fixture's format: a pickled pyg
    Data whose _store holds the _mapping of tensors, written through a
    stand-in torch_geometric class (the loaders register their own stubs to
    read it), and the fixture's other files."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    names = ["torch_geometric", "torch_geometric.data", "torch_geometric.data.data", "torch_geometric.data.storage"]
    mods = {n: types.ModuleType(n) for n in names}
    Data = type("Data", (), {"__module__": "torch_geometric.data.data"})
    mods["torch_geometric.data.data"].Data = Data
    saved = {n: sys.modules.get(n) for n in names}
    want = dict(x=rng.randn(S, D).astype(np.float32), edge_index=rng.randint(0, S, (2, 8)).astype(np.int64),
                y=(rng.rand(S) < 0.5).astype(np.float32))
    want["y_valid"] = want["y"] > 0.5
    try:
        sys.modules.update(mods)
        g = Data()
        g.__dict__["_store"] = {"_mapping": {k: torch.from_numpy(np.asarray(v)) for k, v in want.items()}}
        root.mkdir(parents=True)
        torch.save(g, root / "graph.pt")
    finally:
        for n in names:
            if saved[n] is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = saved[n]
    for name, arr in (("center", rng.rand(S, 2) * 448), ("trav_pred", rng.rand(S)), ("reco_pred", rng.randn(S, D))):
        torch.save(torch.from_numpy(arr.astype(np.float32)), root / f"{name}.pt")
        want[name] = arr.astype(np.float32)
    img = (rng.rand(16, 16, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(root / "img.png")
    want["img"] = img.astype(np.float32) / 255.0
    return want


def test_reference_graph_loader_reads_the_fixture_as_jax_does(tmp_path):
    root = tmp_path / "graph"
    assert not trg.available(str(root))
    want = _write_graph_fixture(root)
    assert trg.available(str(root)) and jrg.available(str(root))
    got, jgot = trg.load_reference_graph(str(root)), jrg.load_reference_graph(str(root))
    for f in ("x", "edge_index", "y", "y_valid", "trav_pred", "reco_pred", "img"):
        np.testing.assert_array_equal(getattr(got, f), getattr(jgot, f), err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), want[f], err_msg=f)
    np.testing.assert_array_equal(got.centers, want["center"])
    assert got.num_segments == 6 and got.feature_dim == 90
    np.testing.assert_array_equal(trg.reference_confidence(got.reco_pred, got.x),
                                  jrg.reference_confidence(got.reco_pred, got.x))
    assert "torch_geometric" not in sys.modules
    assert Path(trg.REFERENCE_GRAPH_DIR).relative_to(ROOT) == Path("assets/graph")


# ---------------------------------------------------------------- soak
@pytest.fixture(scope="module")
def soaked():
    """64 frames at 64 px on 2 cameras (dinov2 x slic 64, per-pixel scoring),
    windows of 16 frames, the first of them warmup."""
    args = soak.build_parser().parse_args(["--frames", "64", "--size", "64", "--window", "16", "--warmup_windows", "1",
                                           "--pool", "6", "--device", "cpu"])
    return soak.run_soak(args)


def test_soak_on_the_cpu_passes_every_gate(soaked):
    r = soaked
    gates = {k: v for k, v in r.items() if k.startswith("ok_")}
    assert set(gates) == {"ok_no_rebuild", "ok_launches_steady", "ok_graph_semantics", "ok_host_bounded",
                          "ok_device_bounded", "ok_rate_stable"}
    assert all(gates.values()) and r["ok"], gates
    assert r["frames_done"] == 64 and len(r["windows"]) == 4 and r["frames_gated"] == 0
    assert r["train_steps"] > 10 and r["supervision_updates"] > 20
    assert r["launches_per_frame"] == {"flash_attention": 0.0, "pixelwise_score": 0.0, "slic_step": 0.0,
                                       "fill_hulls": 0.0}  # CPU tensors take the plain versions
    assert r["device"] == "cpu" and r["device_growth_mb"] == 0.0


def test_soak_graph_semantics_hold(soaked):
    g = soaked["graph_semantics"]
    assert all(v for k, v in g.items() if k.startswith("ok_"))
    assert g["export_files"] > 0 and g["graph_nodes"] >= g["export_files"]


# ---------------------------------------------------------------- the card by default
@pytest.mark.parametrize("tool,argv", [
    (param_search, ["--data", "synth"]),
    (generate_dataset, ["--images", "."]),
    (ablation_sweep, ["--combos", "grid:sift"]),
    (real_data_eval, []),
    (soak, ["--frames", "10"]),
])
def test_every_tool_runs_on_the_card_unless_asked(tool, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv + ["--out", str(tmp_path / "out.json")])
