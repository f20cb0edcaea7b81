"""The torch port's offline stack (offline/: metrics, dataset, loggers,
trainer), its trace exporter and device memory statistics
(utils/timers.py::profile_trace, utils/device_monitor.py) and the
estimator's whole-object pickle, on the CPU, against the JAX package where
it has the same function.

Inputs are made with numpy from fixed seeds. Tolerances: metrics, datasets
and batches exactly (copies of numpy code); the offline trainer started
from the JAX trainer's weights on the same export and batches: per-epoch
train_loss within rtol 1e-4, validation scores within atol 1e-5, val_auroc
equal to 3 decimals (fp32 Adam in another summation order); a trainer
reloaded from its checkpoint scores identically; a pickled estimator's
continued losses equal an unpickled twin's exactly (the same CPU ops in
the same order)."""

import csv
import dataclasses
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu.offline import GraphTravDataset as JDataset
from wild_visual_navigation_tpu.offline import OfflineTrainer as JTrainer
from wild_visual_navigation_tpu.offline import OfflineTrainerConfig as JConfig
from wild_visual_navigation_tpu.offline import get_logger as jget_logger
from wild_visual_navigation_tpu.offline import metrics as jmetrics
from wild_visual_navigation_tpu_torch.offline import GraphTravDataset, OfflineTrainer, OfflineTrainerConfig, get_logger
from wild_visual_navigation_tpu_torch.offline import metrics as tmetrics
from wild_visual_navigation_tpu_torch.traversability.estimator import TraversabilityEstimator
from wild_visual_navigation_tpu_torch.traversability.nodes import MissionNode, SupervisionNode
from wild_visual_navigation_tpu_torch.utils import timers
from wild_visual_navigation_tpu_torch.utils.device_monitor import device_memory_stats
from wild_visual_navigation_tpu_torch.utils.params import train_state_from_jax
from wild_visual_navigation_tpu_torch.utils.timers import profile_trace

LOSS_RTOL = 1e-4  # per-epoch train_loss, the port's trainer against JAX's from the same weights
SCORE_ATOL = 1e-5  # validation scores after training, the same comparison


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


def _make_export(folder, n=20, S=16, D=8, seed=0, feat_valid=False):
    """A synthetic mission export: separable grass / rock features, every
    signal valid (the JAX offline tests' export); with feat_valid, a fifth
    of the signals unset and two padded segment rows per node."""
    rng = np.random.RandomState(seed)
    grass = rng.randn(D)
    rock = rng.randn(D) * 2
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        is_grass = rng.rand(S) < 0.5
        feats = np.where(is_grass[:, None], grass, rock) + rng.randn(S, D) * 0.1
        rec = dict(features=feats.astype(np.float32), signal=np.where(is_grass, 0.9, 0.1).astype(np.float32),
                   signal_valid=np.ones(S, bool), segments=np.zeros((4, 4), np.int32))
        if feat_valid:
            rec["signal_valid"] = rng.rand(S) < 0.8
            rec["feat_valid"] = np.arange(S) < S - 2
        np.savez_compressed(os.path.join(folder, f"graph_{i:02d}.npz"), **rec)
    return folder


def _mlp_cfg(D=8, hidden=(16, 1)):
    return {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": D, "hidden_sizes": list(hidden),
                                                    "reconstruction": True}}


# ---------------------------------------------------------------- metrics
@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
def test_metrics_match_jax(seed, ties):
    rng = np.random.RandomState(seed)
    scores = rng.rand(60).astype(np.float32)
    if ties:
        scores = np.round(scores * 5) / 5  # repeated thresholds
    labels = rng.rand(60) < 0.4
    for name in ("roc_curve",):
        for got, want in zip(getattr(tmetrics, name)(scores, labels), getattr(jmetrics, name)(scores, labels)):
            np.testing.assert_array_equal(got, want)
    assert tmetrics.auroc(scores, labels) == jmetrics.auroc(scores, labels)
    t = tmetrics.optimal_threshold(scores, labels)
    assert t == jmetrics.optimal_threshold(scores, labels)
    assert tmetrics.accuracy(scores, labels, t) == jmetrics.accuracy(scores, labels, t)


def test_metrics_on_a_perfect_ranking():
    scores = np.array([0.9, 0.8, 0.3, 0.2])
    labels = np.array([True, True, False, False])
    assert tmetrics.auroc(scores, labels) == 1.0
    assert tmetrics.accuracy(scores, labels, 0.5) == 1.0
    assert 0.3 < tmetrics.optimal_threshold(scores, labels) <= 0.8


# ---------------------------------------------------------------- dataset
def _same_dataset(got, want):
    for f in ("features", "signal", "signal_valid", "sample_valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("feat_valid", [False, True])
@pytest.mark.parametrize("shuffle_seed", [None, 3])
def test_dataset_splits_match_jax(tmp_path, feat_valid, shuffle_seed):
    export = _make_export(str(tmp_path / "export"), feat_valid=feat_valid)
    for mode in ("train", "val"):
        got = GraphTravDataset.from_folder(export, mode, shuffle_seed=shuffle_seed)
        want = JDataset.from_folder(export, mode, shuffle_seed=shuffle_seed)
        _same_dataset(got, want)
        assert len(got) == len(want) == (16 if mode == "train" else 4)
    assert bool(got.sample_valid.all()) != feat_valid


def test_dataset_subset_shuffle_and_batches_match_jax(tmp_path):
    export = _make_export(str(tmp_path / "export"))
    got = GraphTravDataset.from_folder(export, "train", percentage=1.0)
    want = JDataset.from_folder(export, "train", percentage=1.0)
    idx = np.array([3, 0, 7, 11])
    _same_dataset(got.subset(idx), want.subset(idx))
    shuf, jshuf = got.shuffled_labels(seed=1), want.shuffled_labels(seed=1)
    _same_dataset(shuf, jshuf)
    assert np.isclose(shuf.signal.mean(), got.signal.mean()) and not np.array_equal(shuf.signal, got.signal)
    for shuffle in (True, False):
        rt, rj = np.random.RandomState(5), np.random.RandomState(5)
        bt, bj = list(got.batches(3, rt, shuffle)), list(want.batches(3, rj, shuffle))
        assert len(bt) == len(bj) == 6
        for a, b in zip(bt, bj):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    with pytest.raises(FileNotFoundError):
        GraphTravDataset.from_folder(str(tmp_path / "empty"))


# ---------------------------------------------------------------- loggers
def test_loggers_match_jax(tmp_path):
    rows = [({"epoch": 0, "train_loss": 0.5}, 1), ({"epoch": 1, "train_loss": 0.25, "val_auroc": 0.9}, 2)]
    for mod, sub in ((get_logger, "torch"), (jget_logger, "jax")):
        lg = mod("csv", str(tmp_path / sub))
        for r, step in rows:
            lg.log_metrics(r, step=step)
        lg.finalize()
    assert open(tmp_path / "torch" / "metrics.csv").read() == open(tmp_path / "jax" / "metrics.csv").read()
    for name in ("neptune", "wandb"):
        assert type(get_logger(name, str(tmp_path / name))).__name__ == "CSVLogger"
    with pytest.raises(ValueError):
        get_logger("nope", str(tmp_path))
    lg = get_logger("tensorboard", str(tmp_path / "tb"))
    lg.log_metrics({"loss": 1.0, "note": "text"}, step=0)
    lg.finalize()
    assert os.listdir(tmp_path / "tb")


# ---------------------------------------------------------------- trainer
@pytest.fixture(scope="module")
def export(tmp_path_factory):
    return _make_export(str(tmp_path_factory.mktemp("export")), feat_valid=True)


def _jax_and_port(cfg_kw, loss_kw=None):
    jcfg, tcfg = JConfig(**cfg_kw), OfflineTrainerConfig(**cfg_kw)
    if loss_kw:
        jcfg.loss_cfg = dataclasses.replace(jcfg.loss_cfg, **loss_kw)
        tcfg.loss_cfg = dataclasses.replace(tcfg.loss_cfg, **loss_kw)
    jt = JTrainer(jcfg)
    tt = OfflineTrainer(tcfg, device="cpu",
                        train_state=train_state_from_jax(*_np((jt.params, jt.opt_state, jt.cg_state)), jt.step))
    return jt, tt


@pytest.mark.parametrize("loss_kw", [None, {"w_reco": 0.0, "anomaly_balanced": False}])
def test_offline_trainer_matches_jax_from_the_same_weights(export, loss_kw):
    train = GraphTravDataset.from_folder(export, "train")
    val = GraphTravDataset.from_folder(export, "val")
    jt, tt = _jax_and_port(dict(model_cfg=_mlp_cfg(), epochs=12, batch_size=4), loss_kw)
    jres, tres = jt.fit(train, val), tt.fit(train, val)
    assert len(tt.history) == len(jt.history) == 12 and tt.step == jt.step == 48
    for a, b in zip(tt.history, jt.history):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=LOSS_RTOL)
        assert round(a["val_auroc"], 3) == round(b["val_auroc"], 3)
    want = np.asarray(jt._predict(jt.params, val.features))
    np.testing.assert_allclose(tt.predict(val.features), want, atol=SCORE_ATOL)
    assert round(tres["val_auroc"], 3) == round(jres["val_auroc"], 3)
    np.testing.assert_allclose(tt.threshold, jt.threshold, atol=SCORE_ATOL)


def test_offline_trainer_learns(tmp_path):
    """The port's twin of the JAX offline test of the same name, from the
    same initial head (JAX's, seed 42). On this toy export the result
    depends on the head's draw in both packages (40 epochs reach a val AUROC
    of 0.019 from JAX's seed 1 and 0.765 from the port's own seed 42), so the
    twin holds the JAX test's claim from the JAX test's start."""
    export = _make_export(str(tmp_path / "export"))
    train = GraphTravDataset.from_folder(export, mode="train")
    val = GraphTravDataset.from_folder(export, mode="val")
    cfg = OfflineTrainerConfig(model_cfg=_mlp_cfg(), epochs=40, batch_size=4, output_folder=str(tmp_path / "out"))
    jt = JTrainer(JConfig(model_cfg=_mlp_cfg()))
    trainer = OfflineTrainer(cfg, device="cpu",
                             train_state=train_state_from_jax(*_np((jt.params, jt.opt_state, jt.cg_state)), 0))
    result = trainer.fit(train, val, logger=get_logger("csv", str(tmp_path / "logs")))
    assert result["val_auroc"] > 0.95
    assert result["best_checkpoint"] is not None and os.path.exists(result["best_checkpoint"])
    with open(tmp_path / "logs" / "metrics.csv") as f:
        assert len(list(csv.DictReader(f))) == 40
    payload = torch.load(result["best_checkpoint"], weights_only=True)
    assert {"params", "cg_state", "opt_state", "step", "loss", "threshold"} <= set(payload)


def test_shuffled_labels_control(tmp_path):
    """The port's twin of the JAX test: a model trained on shuffled labels
    must not beat the one trained on real labels."""
    export = _make_export(str(tmp_path / "export"))
    train = GraphTravDataset.from_folder(export, mode="train")
    val = GraphTravDataset.from_folder(export, mode="val")
    cfg = OfflineTrainerConfig(model_cfg=_mlp_cfg(), epochs=30)
    cfg.loss_cfg = dataclasses.replace(cfg.loss_cfg, w_reco=0.0, anomaly_balanced=False)
    real = OfflineTrainer(cfg, device="cpu").fit(train, val)
    control = OfflineTrainer(cfg, device="cpu").fit(train.shuffled_labels(seed=1), val)
    assert real["val_auroc"] > 0.9
    assert real["val_auroc"] > control["val_auroc"] + 0.2


def test_save_then_load_scores_identically(export, tmp_path):
    train = GraphTravDataset.from_folder(export, "train")
    val = GraphTravDataset.from_folder(export, "val")
    cfg = OfflineTrainerConfig(model_cfg=_mlp_cfg(), epochs=5, batch_size=4)
    a = OfflineTrainer(cfg, device="cpu")
    a.fit(train, val)
    path = a.save(str(tmp_path), "last.ckpt")
    b = OfflineTrainer(cfg, device="cpu")
    assert not np.array_equal(b.predict(val.features), a.predict(val.features))
    info = b.load(path)
    assert info["step"] == a.step == b.step and info["threshold"] == a.threshold
    np.testing.assert_array_equal(b.predict(val.features), a.predict(val.features))
    assert b.evaluate(val) == a.evaluate(val)
    # and both keep training the same way: Adam's moments and the confidence state came along
    a.fit(train)
    b.fit(train)
    np.testing.assert_array_equal(b.predict(val.features), a.predict(val.features))


def test_offline_trainer_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OfflineTrainer(OfflineTrainerConfig(model_cfg=_mlp_cfg()))


# ---------------------------------------------------------------- pickle
ESTIMATOR_ARGS = dict(
    model_cfg=_mlp_cfg(16, (32, 1)), lr=1e-3, max_distance=3.0, image_distance_thr=0.1,
    supervision_distance_thr=0.05, min_samples_for_training=2, batch_size=4, buffer_capacity=16, num_segments=9,
    feature_dim=16, image_height=48, image_width=64, reprojection_fanout=8, supervision_flush_every=3,
)
SEG = np.arange(9, dtype=np.int32).reshape(3, 3).repeat(16, 0).repeat(22, 1)[:48, :64]
K_CAM = np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]])


def _pose(x):
    T = np.eye(4)
    T[0, 3] = x
    return T


def _feed(est, xs, t0=0.0, seed=0):
    """Mission nodes at xs seen by a downward camera, then supervision
    along them (the footprints queue; flushes every third)."""
    rng = np.random.default_rng(seed)
    cam = np.eye(4)
    cam[:3, :3] = [[1, 0, 0], [0, -1, 0], [0, 0, -1]]
    cam[2, 3] = 2.0
    for i, x in enumerate(xs):
        est.add_mission_node(MissionNode(timestamp=t0 + i, pose_base_in_world=_pose(x), pose_cam_in_base=cam),
                             rng.standard_normal((9, 16)).astype(np.float32), np.ones(9, bool), SEG, K_CAM)
    for i, x in enumerate(xs):
        est.add_supervision_node(SupervisionNode(
            timestamp=t0 + i + 0.5, pose_base_in_world=_pose(x), width=0.4, length=0.4, height=0.3,
            twist_in_base=np.array([1.0, 0, 0]), desired_twist_in_base=np.array([1.0, 0, 0]),
            traversability=0.9 - 0.05 * i, traversability_var=1.0, is_untraversable=False))


def test_estimator_pickle_continues_identically(tmp_path):
    """A session pickled half-way, with footprints still queued, continues
    as its unpickled twin: the same losses, buffer, confidence state and
    sampled batches (the port's twin of the JAX whole-pickle test)."""
    a = TraversabilityEstimator(**ESTIMATOR_ARGS, seed=3, device="cpu")
    b = TraversabilityEstimator(**ESTIMATOR_ARGS, seed=3, device="cpu")
    for est in (a, b):
        _feed(est, np.linspace(0, 0.8, 5))
        for _ in range(4):
            est.train()
        _feed(est, np.linspace(0.9, 1.4, 4), t0=10.0, seed=1)  # leaves footprints in the queue
    assert a._pending_footprints
    path = a.save_pickle(str(tmp_path / "est" / "estimator.pkl"))
    a2 = TraversabilityEstimator.load_pickle(path, device="cpu")
    assert a2.step == b.step == 4 and a2._device == torch.device("cpu")
    assert a2.get_num_valid_nodes() == b.get_num_valid_nodes()
    for x, y in zip(a2.buffer, b.buffer):
        assert torch.equal(x, y)
    la = [a2.train()["loss_total"] for _ in range(6)]
    lb = [b.train()["loss_total"] for _ in range(6)]
    assert la == lb and all(v > 0 for v in la)
    for x, y in zip(a2.confidence_state, b.confidence_state):
        assert torch.equal(x, y)
    for (n, p), (_, q) in zip(a2.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p, q), n
    # the loaded estimator still takes supervision and pickles again
    _feed(a2, [1.5], t0=20.0, seed=2)
    again = TraversabilityEstimator.load_pickle(a2.save_pickle(str(tmp_path / "again.pkl")))
    assert again.step == a2.step and again._device == torch.device("cpu")


# ---------------------------------------------------------------- trace exporter and device memory
def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """Every thread's work, the program's spans on for the block only."""
    go, done = threading.Event(), threading.Event()

    def learner():  # started before the block, as the runtime's learning thread is
        go.wait(5.0)
        timers.new_request()
        with timers.span("estimator.train_step"):
            torch.ones(64).sum()
        done.set()

    th = threading.Thread(target=learner)
    th.start()
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
        go.set()
        assert done.wait(5.0)
    th.join(5.0)
    assert prof is not None and not th.is_alive()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "wvn.estimator.train_step" and e.get("tid") == th.native_id for e in events)
    timers.new_request()
    assert timers.span("a") is timers.span("b")  # off again after the block
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not os.path.exists(tmp_path / "off")


def test_device_monitor():
    """A CPU device reads zeros, as the JAX package's backends without
    memory statistics do."""
    assert device_memory_stats("cpu") == {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0,
                                          "peak_bytes_reserved": 0}
