"""Parity of the port's online learning loop against the JAX package, on
the CPU: Kalman filter, supervision generator, confidence updates, data
containers, losses and their gradients, the mission buffer, and whole
estimator sessions (mission intake -> supervision reprojection -> train
steps), including a JAX mission carried into the port half-way.

Inputs are made with numpy from fixed seeds and fed to both packages.
Tolerances: confidence, loss and gradient values to 1e-6 absolute or
1e-5 relative; estimator state after 30 Adam steps to rtol 1e-5 /
atol 1e-6; masks, validity flags, counts and sampled slots exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu.cfg import experiment as jexp
from wild_visual_navigation_tpu.models import get_model as jget_model
from wild_visual_navigation_tpu.supervision import SupervisionGenerator as JSupervisionGenerator
from wild_visual_navigation_tpu.traversability import MissionNode as JMissionNode
from wild_visual_navigation_tpu.traversability import SupervisionNode as JSupervisionNode
from wild_visual_navigation_tpu.traversability import TraversabilityEstimator as JEstimator
from wild_visual_navigation_tpu.traversability import mission_buffer as jbuf
from wild_visual_navigation_tpu.utils import confidence_generator as jcg
from wild_visual_navigation_tpu.utils import data as jdata
from wild_visual_navigation_tpu.utils import kalman_filter as jkf
from wild_visual_navigation_tpu.utils import loss as jloss
from wild_visual_navigation_tpu_torch.cfg import experiment as texp
from wild_visual_navigation_tpu_torch.models.registry import get_model
from wild_visual_navigation_tpu_torch.supervision.supervision_generator import SupervisionGenerator
from wild_visual_navigation_tpu_torch.traversability import mission_buffer as tbuf
from wild_visual_navigation_tpu_torch.traversability.estimator import TraversabilityEstimator
from wild_visual_navigation_tpu_torch.traversability.graphs import DistanceWindowGraph, MaxElementsGraph
from wild_visual_navigation_tpu_torch.traversability.nodes import BaseNode, MissionNode, SupervisionNode
from wild_visual_navigation_tpu_torch.utils import confidence_generator as tcg
from wild_visual_navigation_tpu_torch.utils import data as tdata
from wild_visual_navigation_tpu_torch.utils import kalman_filter as tkf
from wild_visual_navigation_tpu_torch.utils import loss as tloss
from wild_visual_navigation_tpu_torch.utils.operation_modes import WVNMode
from wild_visual_navigation_tpu_torch.utils.params import confidence_state_from_jax, mlp_state_from_jax, train_state_from_jax

ATOL, RTOL = 1e-6, 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _close_state(got: tcg.ConfidenceState, want: jcg.ConfidenceState):
    for name in tcg.ConfidenceState._fields:
        _close(getattr(got, name), getattr(want, name))


# ------------------------------------------------------- kalman / supervision


@pytest.mark.parametrize("rejection", ["none", "hard", "huber"])
def test_kf_scan_matches_jax(rejection):
    meas = np.random.default_rng(0).standard_normal((20, 2)).astype(np.float32) * 3.0
    tp = tkf.KalmanFilterParams.make(2, proc_cov=0.1, meas_cov=2.0, outlier_rejection=rejection, outlier_delta=0.8)
    jp = jkf.KalmanFilterParams.make(2, proc_cov=0.1, meas_cov=2.0, outlier_rejection=rejection, outlier_delta=0.8)
    state, xs = tkf.kf_scan(tp, tkf.kf_init(2), _t(meas))
    jstate, jxs = jkf.kf_scan(jp, jkf.kf_init(2), meas)
    _close(xs, jxs)
    _close(state.P, jstate.P)


def test_supervision_generator_velocity_tracking_matches_jax():
    kw = dict(kf_process_cov=0.1, kf_meas_cov=10.0, kf_outlier_rejection="huber", kf_outlier_rejection_delta=0.5,
              sigmoid_slope=30, sigmoid_cutoff=0.2, untraversable_thr=0.05)
    sg, jsg = SupervisionGenerator(**kw), JSupervisionGenerator(**kw)
    rng = np.random.default_rng(1)
    for i in range(40):
        cur = rng.standard_normal(6) * (0.1 if i < 20 else 1.5)
        des = np.r_[1.0, np.zeros(5)]
        got = sg.update_velocity_tracking(cur, des, max_velocity=0.8, velocities=["vx", "vy"])
        want = jsg.update_velocity_tracking(cur, des, max_velocity=0.8, velocities=["vx", "vy"])
        assert got[2] == want[2]
        _close(got[:2], want[:2])
    assert sg.traversability < 0.3


def test_supervision_generator_pose_prediction_matches_jax():
    kw = dict(sigmoid_slope=10, sigmoid_cutoff=0.2, untraversable_thr=0.05, time_horizon=1.0, graph_max_length=5.0)
    sg, jsg = SupervisionGenerator(**kw), JSupervisionGenerator(**kw)
    rng = np.random.default_rng(2)
    for i in range(12):
        pose = np.eye(4)
        pose[:2, 3] = [0.1 * i, 0.02 * rng.standard_normal()]
        des = np.r_[1.0, 0.1 * rng.standard_normal(5)]
        got = sg.update_pose_prediction(0.1 * i, pose, des, des, velocities=["vx", "vy", "wz"])
        want = jsg.update_pose_prediction(0.1 * i, pose, des, des, velocities=["vx", "vy", "wz"])
        assert got[2] == want[2]
        _close(got[:2], want[:2], atol=1e-5)


def test_copied_graphs_and_nodes_behave_as_jax():
    from wild_visual_navigation_tpu.traversability import graphs as jgraphs
    from wild_visual_navigation_tpu.traversability import nodes as jnodes

    def pose(x, y=0.0):
        T = np.eye(4)
        T[:2, 3] = [x, y]
        return T

    for graph, jgraph in [(MaxElementsGraph(edge_distance=0.5, max_elements=3),
                           jgraphs.MaxElementsGraph(edge_distance=0.5, max_elements=3)),
                          (DistanceWindowGraph(max_distance=1.0), jgraphs.DistanceWindowGraph(max_distance=1.0))]:
        for i in range(8):
            graph.add_node(BaseNode(timestamp=float(i), pose_base_in_world=pose(0.3 * i, 0.05 * i)))
            jgraph.add_node(jnodes.BaseNode(timestamp=float(i), pose_base_in_world=pose(0.3 * i, 0.05 * i)))
        got = [n.timestamp for n in graph.get_nodes()]
        assert got == [n.timestamp for n in jgraph.get_nodes()] and 1 < len(got) < 8
    a = SupervisionNode(timestamp=0.0, pose_base_in_world=pose(0), width=0.4, length=0.6, height=0.3)
    b = SupervisionNode(timestamp=1.0, pose_base_in_world=pose(1.0, 0.2), width=0.4, length=0.6, height=0.3)
    ja = jnodes.SupervisionNode(timestamp=0.0, pose_base_in_world=pose(0), width=0.4, length=0.6, height=0.3)
    jb = jnodes.SupervisionNode(timestamp=1.0, pose_base_in_world=pose(1.0, 0.2), width=0.4, length=0.6, height=0.3)
    np.testing.assert_array_equal(b.make_footprint_with_node(a), jb.make_footprint_with_node(ja))


def test_experiment_config_copy_matches_jax():
    t, j = texp.ExperimentParams(), jexp.ExperimentParams()
    assert t.model.to_dict() == j.model.to_dict()
    assert t.loss_cfg().__dict__.keys() == j.loss_cfg().__dict__.keys()
    assert (t.loss_cfg().confidence.std_factor, t.optimizer.lr) == (0.5, 1e-3)
    for k in ("w_trav", "w_reco", "w_temp", "anomaly_balanced", "trav_cross_entropy"):
        assert getattr(t.loss_cfg(), k) == getattr(j.loss_cfg(), k)


# ----------------------------------------------------------- confidence


@pytest.mark.parametrize("method", ["latest_measurement", "running_mean", "kalman_filter", "moving_average"])
def test_confidence_update_matches_jax(method):
    """Ten updates, one of them without positives (the skip)."""
    rng = np.random.default_rng(3)
    tcfg, jcfg = tcg.ConfidenceConfig(std_factor=0.5, method=method), jcg.ConfidenceConfig(std_factor=0.5, method=method)
    ts, js = tcg.confidence_init(), jcg.confidence_init()
    for step in range(10):
        x = rng.gamma(2.0, 0.5, 40).astype(np.float32)
        pos = rng.uniform(size=40) < (0.0 if step == 4 else 0.4)
        ts, tconf = tcg.confidence_update(tcfg, ts, _t(x), _t(pos))
        js, jconf = jcg.confidence_update(jcfg, js, x, pos)
        _close(tconf, jconf)
        _close_state(ts, js)
    assert int(ts.window_ptr) == int(js.window_ptr)
    reset = tcg.confidence_reset(ts)
    _close_state(reset, jcg.confidence_init())


# ------------------------------------------------------- data and losses


def _mlp_pair(D=16, hidden=(32, 1), seed=0):
    cfg = {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": D, "hidden_sizes": list(hidden), "reconstruction": True}}
    jm = jget_model(cfg)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, D))))
    tm = get_model(cfg)
    tm.load_state_dict(mlp_state_from_jax(params))
    return tm, jm, params


def _batch(rng, N=36, D=16):
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = rng.uniform(size=N).astype(np.float32)
    yv = rng.uniform(size=N) < 0.4
    sv = rng.uniform(size=N) < 0.9
    return x, y, yv, sv


def test_batch_containers_match_jax():
    rng = np.random.default_rng(4)
    x, y, yv, sv = _batch(rng, 3 * 9)
    nodes = [tdata.NodeData(_t(x[i * 9:(i + 1) * 9]), _t(y[i * 9:(i + 1) * 9]), _t(yv[i * 9:(i + 1) * 9]),
                            _t(sv[i * 9:(i + 1) * 9])) for i in range(3)]
    b = tdata.batch_from_nodes(nodes)
    jb = jdata.batch_from_arrays(x.reshape(3, 9, -1), y.reshape(3, 9), yv.reshape(3, 9), sv.reshape(3, 9))
    tb = tdata.batch_from_arrays(_t(x.reshape(3, 9, -1)), _t(y.reshape(3, 9)), _t(yv.reshape(3, 9)), _t(sv.reshape(3, 9)))
    for got in (b, tb):
        for name in ("x", "y", "y_valid", "sample_valid"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(jb, name)))
    assert int(b.num_samples) == int(jb.num_samples)


@pytest.mark.parametrize("cross_entropy,balanced", [(False, True), (True, True), (False, False)])
def test_traversability_loss_and_gradient_match_jax(cross_entropy, balanced):
    tm, jm, params = _mlp_pair()
    rng = np.random.default_rng(5)
    x, y, yv, sv = _batch(rng)
    conf = dict(std_factor=0.5, method="running_mean")
    kw = dict(trav_cross_entropy=cross_entropy, anomaly_balanced=balanced)
    tcfg = tloss.TraversabilityLossConfig(confidence=tcg.ConfidenceConfig(**conf), **kw)
    jcfg = jloss.TraversabilityLossConfig(confidence=jcg.ConfidenceConfig(**conf), **kw)
    jbatch = jdata.TravBatch(x, y, yv, sv)
    tbatch = tdata.TravBatch(_t(x), _t(y), _t(yv), _t(sv))
    jstate = jcg.confidence_init()._replace(running_n=jnp.float32(20.0), running_sum=jnp.float32(15.0),
                                            running_sum2=jnp.float32(14.0))
    tstate = confidence_state_from_jax(jstate)

    def jf(p):
        loss, aux, cg2 = jloss.traversability_loss(jcfg, jbatch, jm.apply(p, x), jstate)
        return loss, (aux, cg2)

    (jl, (jaux, jcg2)), jgrad = jax.value_and_grad(jf, has_aux=True)(params)
    tl, taux, tcg2 = tloss.traversability_loss(tcfg, tbatch, tm(tbatch.x), tstate)
    tl.backward()
    _close(tl, jl)
    for k in jaux:
        _close(taux[k], jaux[k])
    _close_state(tcg2, jcg2)
    want = mlp_state_from_jax(jgrad)
    for name, p in tm.named_parameters():
        _close(p.grad, want[name])
    # without the update the statistics stay and the confidence is inferred
    _, aux2, same = tloss.traversability_loss(tcfg, tbatch, tm(tbatch.x), tstate, update_generator=False)
    _, jaux2, _ = jloss.traversability_loss(jcfg, jbatch, jm.apply(params, x), jstate, update_generator=False)
    _close(aux2["confidence"], jaux2["confidence"])
    assert same is tstate


def test_anomaly_loss_and_reconstruction_confidence_match_jax():
    rng = np.random.default_rng(6)
    res = {"logprob": rng.standard_normal((30, 8)).astype(np.float32), "log_det": rng.standard_normal(30).astype(np.float32)}
    sv = rng.uniform(size=30) < 0.8
    tl, taux, ts = tloss.anomaly_loss(tloss.AnomalyLossConfig(), {k: _t(v) for k, v in res.items()}, _t(sv),
                                      tcg.confidence_init())
    jl, jaux, js = jloss.anomaly_loss(jloss.AnomalyLossConfig(), res, sv, jcg.confidence_init())
    _close(tl, jl)
    _close(taux["confidence"], jaux["confidence"])
    _close_state(ts, js)
    f, r = rng.standard_normal((2, 10, 16)).astype(np.float32)
    _close(tloss.reconstruction_confidence(tcg.ConfidenceConfig(), tcg.confidence_init(), _t(f), _t(r)),
           jloss.reconstruction_confidence(jcg.ConfidenceConfig(), jcg.confidence_init(), f, r))


# ---------------------------------------------------------- mission buffer


def test_mission_buffer_inserts_match_jax():
    rng = np.random.default_rng(7)
    N, S, D, H, W = 6, 9, 16, 12, 10
    tb, jb = tbuf.buffer_init(N, S, D, H, W), jbuf.buffer_init(N, S, D, H, W)
    feats = rng.standard_normal((3, S, D)).astype(np.float32)
    fv = rng.uniform(size=(3, S)) < 0.7
    seg = rng.integers(0, S, (3, H, W)).astype(np.int32)
    K = rng.standard_normal((3, 3, 3)).astype(np.float32)
    P = rng.standard_normal((3, 4, 4))
    tb = tbuf.buffer_insert(tb, 2, feats[0], fv[0], seg[0], K[0], P[0])
    jb = jbuf.buffer_insert(jb, jnp.asarray(2), feats[0], fv[0], seg[0], K[0], P[0])
    slots = np.array([4, N, 0])  # the middle row is padding: dropped
    tb = tbuf.buffer_insert_batch_impl(tb, slots, feats, fv, seg, K, P)
    jb = jbuf.buffer_insert_batch_impl(jb, jnp.asarray(slots), feats, fv, seg, K, P)
    for name in tbuf.MissionBuffer._fields:
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    with pytest.raises(IndexError):
        tbuf.buffer_insert_batch_impl(tb, np.array([N + 1]), feats[:1], fv[:1], seg[:1], K[:1], P[:1])


# --------------------------------------------------------------- sessions
# The JAX package's estimator session (tests/test_traversability_estimator.py):
# D=16, S=9, 48x64, capacity 16, fan-out 8, cameras looking down along x.

ESTIMATOR_ARGS = dict(
    model_cfg={"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 16, "hidden_sizes": [32, 1], "reconstruction": True}},
    lr=1e-3, max_distance=3.0, image_distance_thr=0.1, supervision_distance_thr=0.05, min_samples_for_training=2,
    batch_size=4, buffer_capacity=16, num_segments=9, feature_dim=16, image_height=48, image_width=64,
    reprojection_fanout=8,
)
SEED = 11


def _pose(x=0.0, y=0.0):
    T = np.eye(4)
    T[:2, 3] = [x, y]
    return T


def _downward_cam_pose(x):
    T = np.eye(4)
    T[:3, :3] = [[1, 0, 0], [0, -1, 0], [0, 0, -1]]
    T[:3, 3] = [x, 0, 2.0]
    return T


SEG = np.arange(9, dtype=np.int32).reshape(3, 3).repeat(16, 0).repeat(22, 1)[:48, :64]
K_CAM = np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]])


def _feed(est, jax_side: bool, mission_xs, states, seed=0):
    """The same mission nodes and supervision nodes into either package."""
    MN, SN = (JMissionNode, JSupervisionNode) if jax_side else (MissionNode, SupervisionNode)
    rng = np.random.default_rng(seed)
    for i, x in enumerate(mission_xs):
        feats = rng.standard_normal((9, 16)).astype(np.float32)
        node = MN(timestamp=float(i), pose_base_in_world=_pose(x),
                  pose_cam_in_base=np.linalg.inv(_pose(x)) @ _downward_cam_pose(x))
        est.add_mission_node(node, feats, np.ones(9, bool), SEG, K_CAM)
    for t, x, trav in states:
        est.add_supervision_node(SN(timestamp=t, pose_base_in_world=_pose(x), width=0.4, length=0.4, height=0.3,
                                    twist_in_base=np.array([1.0, 0, 0]), desired_twist_in_base=np.array([1.0, 0, 0]),
                                    traversability=trav, traversability_var=1.0, is_untraversable=False))


MISSION_XS = np.linspace(0, 1.0, 5)
STATES = [(i + 0.5, float(x), 0.9 - 0.1 * i) for i, x in enumerate(np.linspace(0, 1.0, 6))]


def _record_samples(est, out: list):
    sample = est._sample_indices

    def recorded(batch_size=None):
        idx = sample(batch_size)
        out.append(None if idx is None else np.asarray(idx).tolist())
        return idx

    est._sample_indices = recorded


def _session_pair():
    """Both estimators after the same mission, the port holding JAX's
    initial params."""
    jest = JEstimator(**ESTIMATOR_ARGS, seed=SEED)
    test = TraversabilityEstimator(**ESTIMATOR_ARGS, seed=SEED, device="cpu")
    test.adopt_train_state(mlp_state_from_jax(jax.tree_util.tree_map(np.asarray, jest.params)), None,
                           confidence_state_from_jax(jax.tree_util.tree_map(np.asarray, jest.confidence_state)), 0)
    _feed(jest, True, MISSION_XS, STATES)
    _feed(test, False, MISSION_XS, STATES)
    return jest, test


def _assert_same_training_state(test, jest):
    jparams = mlp_state_from_jax(jax.tree_util.tree_map(np.asarray, jest.params))
    adam = jax.tree_util.tree_map(np.asarray, jest._opt_state[0])
    mu, nu = mlp_state_from_jax(adam.mu), mlp_state_from_jax(adam.nu)
    for name, p in test.model.named_parameters():
        _close(p, jparams[name])
        st = test.optimizer.state[p]
        _close(st["exp_avg"], mu[name])
        _close(st["exp_avg_sq"], nu[name])
        assert int(st["step"]) == int(adam.count)
    _close_state(test.confidence_state, jest.confidence_state)
    assert test.step == jest.step


def _train(est, n):
    return [est.train().get("loss_total", -1) for _ in range(n)]


def test_estimator_session_matches_jax():
    jest, test = _session_pair()
    jb, tb = jest.buffer, test.buffer
    np.testing.assert_array_equal(tb.supervision_mask.numpy(), np.asarray(jb.supervision_mask))
    np.testing.assert_array_equal(tb.signal_valid.numpy(), np.asarray(jb.signal_valid))
    _close(tb.signal, jb.signal, atol=1e-6, rtol=0)
    assert test.get_num_valid_nodes() == jest.get_num_valid_nodes() >= 3
    assert [n.buffer_slot for n in test.get_mission_nodes()] == [n.buffer_slot for n in jest.get_mission_nodes()]

    t_idx, j_idx = [], []
    _record_samples(test, t_idx)
    _record_samples(jest, j_idx)
    np.random.seed(SEED)
    j_losses = _train(jest, 30)
    t_losses = _train(test, 30)
    assert t_idx == j_idx and len(t_idx) == 30
    _close(t_losses, j_losses)
    assert t_losses[-1] < t_losses[0] and test.step == 30
    _assert_same_training_state(test, jest)


def test_mission_carried_from_jax_continues_the_same():
    """JAX trains 10 steps; its state moves into the port's estimator
    through train_state_from_jax; both then train 10 more."""
    jest, test = _session_pair()
    np.random.seed(SEED)
    _train(jest, 10)
    state = jax.tree_util.tree_map(np.asarray, (jest.params, jest._opt_state, jest.confidence_state))
    test.adopt_train_state(**train_state_from_jax(*state, jest.step))
    _assert_same_training_state(test, jest)
    np.random.seed(SEED + 1)
    test._rng = np.random.RandomState(SEED + 1)
    j_losses = _train(jest, 10)
    t_losses = _train(test, 10)
    _close(t_losses, j_losses)
    _assert_same_training_state(test, jest)
    assert test.step == 20


def test_sampling_seed_separate_from_head_seed():
    """A JAX session whose head comes from PRNGKey(0) and whose batches come
    from the global np.random seeded 7 after construction replays in the
    port: the head carried over, sampling_seed 7, the port's own head seed
    left at another value. Both draw the same batches and the same losses."""
    jest = JEstimator(**ESTIMATOR_ARGS, seed=0)
    test = TraversabilityEstimator(**ESTIMATOR_ARGS, seed=SEED, sampling_seed=7, device="cpu")
    test.adopt_train_state(mlp_state_from_jax(jax.tree_util.tree_map(np.asarray, jest.params)), None,
                           confidence_state_from_jax(jax.tree_util.tree_map(np.asarray, jest.confidence_state)), 0)
    _feed(jest, True, MISSION_XS, STATES)
    _feed(test, False, MISSION_XS, STATES)
    t_idx, j_idx = [], []
    _record_samples(test, t_idx)
    _record_samples(jest, j_idx)
    np.random.seed(7)
    j_losses = _train(jest, 30)
    t_losses = _train(test, 30)
    assert t_idx == j_idx and len(t_idx) == 30
    _close(t_losses, j_losses)
    _assert_same_training_state(test, jest)
    # without sampling_seed the batches come from the head's seed, and differ
    other, o_idx = TraversabilityEstimator(**ESTIMATOR_ARGS, seed=SEED, device="cpu"), []
    _feed(other, False, MISSION_XS, STATES)
    _record_samples(other, o_idx)
    _train(other, 5)
    assert o_idx != j_idx[:5]


# -------------------------------------------------- the port on its own


def _port_estimator(**kw):
    return TraversabilityEstimator(**{**ESTIMATOR_ARGS, **kw}, device="cpu")


def test_pessimistic_fusion():
    """A second, lower-traversability pass lowers the fused signals."""
    est = _port_estimator()
    _feed(est, False, [0.0], [])

    def supervise(t, x, trav):
        _feed(est, False, [], [(t, x, trav)])

    supervise(0.0, -0.1, 0.9)
    supervise(0.1, 0.1, 0.9)
    sig1, sv1 = est.buffer.signal.clone(), est.buffer.signal_valid.clone()
    assert sv1.any()
    supervise(0.2, -0.05, 0.3)
    supervise(0.3, 0.05, 0.3)
    overlap = sv1 & est.buffer.signal_valid
    assert overlap.any()
    assert (est.buffer.signal[overlap] <= sig1[overlap] + 1e-6).all()
    assert (est.buffer.signal[overlap] < 0.5).any()


def test_checkpoint_round_trip_and_hot_swap(tmp_path):
    est = _port_estimator(seed=2)
    _feed(est, False, np.linspace(0, 0.6, 4), [(i + 0.5, float(x), 0.8) for i, x in enumerate(np.linspace(0, 0.6, 5))])
    for _ in range(5):
        est.train()
    hot = est.state_dict_for_hot_swap()
    path = est.save_checkpoint(str(tmp_path))
    est.train()  # the hot-swap snapshot is not aliased by later steps
    assert not all(torch.equal(v, est.params[k]) for k, v in hot["params"].items())

    est2 = _port_estimator(seed=3)
    est2.load_checkpoint(path)
    assert est2.step == 5 and est2.loss == pytest.approx(float(torch.load(path)["loss"]))
    for k, v in hot["params"].items():
        assert torch.equal(est2.params[k], v)
    for p, p2 in zip(est.model.parameters(), est2.model.parameters()):
        assert est2.optimizer.state[p2]["step"] == 5
    for k, v in hot["confidence_generator"].items():
        assert torch.equal(getattr(est2.confidence_state, k), v)

    est.save_graph(str(tmp_path / "graph"))
    files = sorted((tmp_path / "graph").glob("graph_*.npz"))
    assert len(files) == est.get_num_valid_nodes() and np.load(files[0])["features"].shape == (9, 16)
    est.reset()
    assert est.step == 0 and est.loss == float("inf") and est.get_num_valid_nodes() == 0
    assert not est.optimizer.state and not bool(est.buffer.valid.any())


def test_extract_labels_mode(tmp_path):
    est = _port_estimator(mode=WVNMode.EXTRACT_LABELS, extraction_store_folder=str(tmp_path))
    _feed(est, False, np.linspace(0, 0.6, 4), [(i + 0.5, float(x), 0.8) for i, x in enumerate(np.linspace(0, 0.6, 5))])
    masks = os.listdir(tmp_path / "supervision_mask")
    assert len(masks) >= 3
    m = np.load(tmp_path / "supervision_mask" / masks[0])
    assert m.dtype == bool and m.shape == (48, 64)


def test_pause_flags_and_unported_heads():
    est = _port_estimator()
    est.pause_learning = True
    assert est.train() == {}
    est.pause_mission_graph = True
    _feed(est, False, [0.0], [])
    assert est.get_mission_nodes() == []
    # the graph head and anomaly mode are ported (ROADMAP.md item 22)
    gcn = _port_estimator(model_cfg={"name": "SimpleGCN", "simple_gcn_cfg": {"input_size": 16,
                                                                            "hidden_sizes": [8, 1]}})
    assert type(gcn.model).__name__ == "SimpleGCN"
    rnvp = _port_estimator(model_cfg={"name": "LinearRnvp", "linear_rnvp_cfg": {"input_size": 16,
                                                                               "coupling_topology": [8]}},
                           anomaly_detection=True)
    assert type(rnvp.model).__name__ == "LinearRnvp" and isinstance(rnvp._loss_cfg, tloss.AnomalyLossConfig)
