"""The torch port's two-process topology (runtime/nodes.py) and its
copied transport modules (msgs, transport, converters, native_ipc),
against the JAX package on the CPU: the wire format byte for byte, a
JAX-packed ImageFeatures payload into the port's LearningNode, the socket
transport, the hot-swap file, and the FeatureExtractorNode ->
LearningNode loop with a hot swap (dino / grid at 48 px)."""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu.runtime import converters as jconv
from wild_visual_navigation_tpu.runtime import msgs as jmsgs
from wild_visual_navigation_tpu_torch.cfg.experiment import ExperimentParams
from wild_visual_navigation_tpu_torch.cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
from wild_visual_navigation_tpu_torch.runtime import converters as tconv
from wild_visual_navigation_tpu_torch.runtime import msgs as tmsgs
from wild_visual_navigation_tpu_torch.runtime import nodes as tnodes
from wild_visual_navigation_tpu_torch.runtime.transport import LocalTopic, SocketPublisher, SocketSubscriber


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine's cores;
    torch's own pool of a thread per core on top of them oversubscribes the
    cores, and small ops then wait tens of times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZE = 48


def _features_fields(seed=0, h=16, w=20, s=9, d=32):
    rng = np.random.RandomState(seed)
    return dict(stamp=12.5, camera="front", segments=rng.randint(0, s, (h, w)).astype(np.int32),
                features=rng.randn(s, d).astype(np.float32), feat_valid=rng.rand(s) > 0.3,
                K_scaled=(np.eye(3) * 2).astype(np.float32), pose_base_in_world=np.eye(4) + 0.1,
                pose_cam_in_base=np.eye(4) - 0.1)


def test_wire_format_is_byte_identical_to_jax():
    for seed in range(3):
        f = _features_fields(seed)
        assert tmsgs.ImageFeatures(**f).pack() == jmsgs.ImageFeatures(**f).pack()
        out = tmsgs.ImageFeatures.unpack(jmsgs.ImageFeatures(**f).pack())
        for k, v in f.items():
            np.testing.assert_array_equal(getattr(out, k), v)
    st = dict(mode=2, mission_graph_num_valid_node=7, step=100, loss_total=0.5, loss_trav=0.1, loss_reco=0.4,
              pause_learning=True)
    assert tmsgs.SystemStateMsg(**st).pack() == jmsgs.SystemStateMsg(**st).pack()
    assert tmsgs.SystemStateMsg.unpack(jmsgs.SystemStateMsg(**st).pack()) == tmsgs.SystemStateMsg(**st)


def test_converters_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        q = rng.standard_normal(4)
        pose7 = np.concatenate([rng.standard_normal(3), q / np.linalg.norm(q)])
        np.testing.assert_array_equal(tconv.pose7_to_se3(pose7), jconv.pose7_to_se3(pose7))
        T = jconv.pose7_to_se3(pose7)
        np.testing.assert_array_equal(tconv.se3_to_pose7(T), jconv.se3_to_pose7(T))
        lin, ang = rng.standard_normal(3), rng.standard_normal(3)
        for a, b in zip(tconv.odometry_to_state(pose7[:3], pose7[3:], lin, ang),
                        jconv.odometry_to_state(pose7[:3], pose7[3:], lin, ang)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tconv._so3_log_np(T[:3, :3]), jconv._so3_log_np(T[:3, :3]))
    info = {"K": list(np.arange(9.0)), "height": 480, "width": 640}
    assert [np.asarray(x).tolist() for x in tconv.camera_info_to_K(info)] == \
        [np.asarray(x).tolist() for x in jconv.camera_info_to_K(info)]
    state = {"stamp": 1.0, "pose": np.arange(7.0), "twist": np.arange(6.0), "joint_position": np.zeros(12)}
    a, b = tconv.anymal_state_to_robot_state(state), jconv.anymal_state_to_robot_state(state)
    np.testing.assert_array_equal(a["vector_state"], b["vector_state"])
    assert a["states"].keys() == b["states"].keys()
    odo = {"stamp": 2.0, "position": [1, 0, 0], "orientation": [0, 0, 0.6, 0.8], "linear": [0.5, 0, 0],
           "angular": [0, 0, 0.1]}
    cmd = {"linear": [1.0, 0, 0], "angular": [0, 0, 0]}
    a, b = tconv.jackal_state_to_robot_state(odo, cmd), jconv.jackal_state_to_robot_state(odo, cmd)
    for k in ("pose", "pose_se3", "twist", "desired_twist"):
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(tconv.policy_debug_info_to_twist([0.3, -0.1, 0.2, 9.9])["desired_twist"],
                                  jconv.policy_debug_info_to_twist([0.3, -0.1, 0.2, 9.9])["desired_twist"])
    with pytest.raises(ValueError):
        tconv.policy_debug_info_to_twist([1.0, 2.0])


def test_socket_transport_round_trip(tmp_path):
    path = str(tmp_path / "topic.sock")
    pub = SocketPublisher(path)
    sub = SocketSubscriber(path)
    time.sleep(0.15)  # accept
    payloads = [tmsgs.ImageFeatures(**_features_fields(i)).pack() for i in range(3)] + [b"x" * 100_000]
    for p in payloads:
        pub.publish(p)
    got, deadline = [], time.time() + 5.0
    while len(got) < len(payloads) and time.time() < deadline:
        m = sub.poll()
        if m is None:
            time.sleep(0.01)
        else:
            got.append(m)
    assert got == payloads
    sub.close()
    pub.close()
    assert not os.path.exists(path)


def _head_state(seed=0):
    from wild_visual_navigation_tpu_torch.models.registry import get_model

    m = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 8, "hidden_sizes": [4, 1],
                                                           "reconstruction": True}},
                  generator=torch.Generator().manual_seed(seed))
    return m.state_dict()


def test_hot_swap_file_round_trip(tmp_path):
    params = _head_state()
    cg = {"mean": torch.tensor(0.5), "var": torch.tensor(0.25), "std": torch.tensor(0.5)}
    path = tnodes.write_hot_swap_state(str(tmp_path), params, cg, step=5)
    assert os.path.basename(path) == tnodes.HOT_SWAP_FILENAME != ".tmp_state_dict.msgpack"
    p2, cg2, step = tnodes.read_hot_swap_state(str(tmp_path))
    assert step == 5 and set(p2) == set(params) and set(cg2) == set(cg)
    for k, v in params.items():
        assert torch.equal(p2[k], v)
    assert tnodes.read_hot_swap_state(str(tmp_path / "empty")) is None
    assert os.listdir(tmp_path) == [tnodes.HOT_SWAP_FILENAME]  # no temporary file left behind


def test_hot_swap_file_is_replaced_atomically(tmp_path, monkeypatch):
    """A write that dies half-way leaves the previous file whole: readers
    see the old payload or the new one, never a torn one."""
    cg = {"mean": torch.tensor(0.0), "var": torch.tensor(1.0), "std": torch.tensor(1.0)}
    tnodes.write_hot_swap_state(str(tmp_path), _head_state(0), cg, step=1)
    real_save = torch.save

    def torn_save(obj, f):
        real_save(obj, f)
        with open(f, "r+b") as fh:
            fh.truncate(10)
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn_save)
    with pytest.raises(OSError, match="disk full"):
        tnodes.write_hot_swap_state(str(tmp_path), _head_state(1), cg, step=2)
    monkeypatch.setattr(torch, "save", real_save)
    params, _, step = tnodes.read_hot_swap_state(str(tmp_path))
    assert step == 1 and all(torch.equal(params[k], v) for k, v in _head_state(0).items())
    tnodes.write_hot_swap_state(str(tmp_path), _head_state(1), cg, step=2)
    assert tnodes.read_hot_swap_state(str(tmp_path))[2] == 2


def _small_params():
    fe = FeatureExtractorNodeParams(
        network_input_image_height=SIZE, network_input_image_width=SIZE, segmentation_type="grid",
        feature_type="dino", grid_cell_size=16, prediction_per_pixel=True, image_callback_rate=1000.0,
    )
    ln = LearningNodeParams(
        network_input_image_height=SIZE, network_input_image_width=SIZE, image_graph_dist_thr=0.05,
        supervision_graph_dist_thr=0.02, min_samples_for_training=3, supervision_callback_rate=1000.0,
        robot_width=0.5, robot_length=0.5, learning_thread_rate=10.0, load_save_checkpoint_rate=5.0,
    )
    exp = ExperimentParams()
    exp.model.simple_mlp_cfg.hidden_sizes = [16, 1]
    return fe, ln, exp


@pytest.fixture(scope="module")
def backbone():
    from wild_visual_navigation_tpu_torch.models.vit import make_vit

    return make_vit("dino", "vit_small", 8, dtype=torch.float32, device="cpu",
                    generator=torch.Generator().manual_seed(0)).state_dict()


CAM_K = np.array([[30.0, 0, 24], [0, 30.0, 24], [0, 0, 1]])


def _cam_in_base():
    T = np.eye(4)
    T[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]])
    T[:3, 3] = [0, 0, 2.0]
    return T


def test_learning_node_ingests_a_jax_packed_payload(tmp_path):
    """ImageFeatures packed by the JAX package (its msgs, as its
    FeatureExtractorNode publishes them) go into the port's LearningNode."""
    fe, ln, exp = _small_params()
    node = tnodes.LearningNode(fe_params=fe, ln_params=ln, exp_params=exp, hot_swap_folder=str(tmp_path), device="cpu")
    est = node.runtime.estimator
    rng = np.random.RandomState(0)
    seg = (np.arange(SIZE * SIZE) // SIZE // 16 * 3 + np.arange(SIZE * SIZE) % SIZE // 16).reshape(SIZE, SIZE)
    sent = []
    for i in range(3):
        pose = np.eye(4)
        pose[0, 3] = 0.2 * i
        msg = jmsgs.ImageFeatures(stamp=float(i), camera="front", segments=seg.astype(np.int32),
                                  features=rng.randn(9, 384).astype(np.float32), feat_valid=np.ones(9, bool),
                                  K_scaled=CAM_K.astype(np.float32), pose_base_in_world=pose,
                                  pose_cam_in_base=_cam_in_base())
        sent.append(msg)
        assert node.imagefeat_callback(msg.pack())
    nodes = est.get_mission_nodes()
    assert [n.timestamp for n in nodes] == [0.0, 1.0, 2.0]
    for n, msg in zip(nodes, sent):
        np.testing.assert_array_equal(est.buffer.features[n.buffer_slot].numpy(), msg.features)
        np.testing.assert_array_equal(est.buffer.seg[n.buffer_slot].numpy(), msg.segments)
        np.testing.assert_array_equal(est.buffer.K[n.buffer_slot].numpy(), msg.K_scaled)
        np.testing.assert_allclose(n.pose_cam_in_world, msg.pose_base_in_world @ msg.pose_cam_in_base)


def test_two_node_pipeline_with_hot_swap(tmp_path, backbone):
    """FeatureExtractorNode publishes ImageFeatures to LearningNode; the
    learner trains and writes the hot-swap file; the extractor reloads it
    and then scores with the learner's weights."""
    fe_p, ln_p, exp = _small_params()
    folder = str(tmp_path)
    topic = LocalTopic()
    states = []
    fe_node = tnodes.FeatureExtractorNode(params=fe_p, exp_params=exp, hot_swap_folder=folder,
                                          publish_features=topic.publish, backbone_params=backbone, device="cpu",
                                          backbone_dtype=torch.float32)
    ln_node = tnodes.LearningNode(fe_params=fe_p, ln_params=ln_p, exp_params=exp, hot_swap_folder=folder,
                                  publish_system_state=states.append, seed=1, device="cpu")
    rng = np.random.RandomState(0)
    img = None
    for i in range(30):
        stamp = i * 0.1
        pose = np.eye(4)
        pose[0, 3] = i * 0.08
        img = rng.rand(3, SIZE, SIZE).astype(np.float32)
        trav, conf = fe_node.image_callback(img, stamp, "front", CAM_K, SIZE, SIZE, pose, _cam_in_base())
        assert trav.shape == conf.shape == (SIZE, SIZE) and np.isfinite(trav).all()
        while (payload := topic.poll()) is not None:
            ln_node.imagefeat_callback(payload)
        ln_node.robot_state_callback(stamp + 0.01, pose, np.array([1.0, 0, 0, 0, 0, 0]),
                                     np.array([1.0, 0, 0, 0, 0, 0]))
        ln_node.learning_step()

    est = ln_node.runtime.estimator
    assert est.step > 5 and est.get_num_valid_nodes() >= 3
    assert os.path.exists(os.path.join(folder, tnodes.HOT_SWAP_FILENAME))
    assert not os.path.exists(os.path.join(folder, ".tmp_state_dict.msgpack"))  # the JAX node's file
    last = tmsgs.SystemStateMsg.unpack(states[-1])
    assert len(states) == 30 and last.step == est.step and last.mission_graph_num_valid_node >= 3

    assert fe_node.maybe_reload_weights()
    assert fe_node._loaded_step > 0 and fe_node._loaded_step % 2 == 0
    assert not fe_node.maybe_reload_weights()  # no new write: a no-op
    ln_node.shutdown(str(tmp_path / "ckpt"))
    assert fe_node.maybe_reload_weights() and fe_node._loaded_step == est.step
    for k, v in est.params.items():
        assert torch.equal(fe_node.model.state_dict()[k], v)
    assert os.path.exists(tmp_path / "ckpt" / "last_checkpoint.ckpt")

    # a stale hot-swap file is removed when a learner starts
    tnodes.LearningNode(fe_params=fe_p, ln_params=ln_p, exp_params=exp, hot_swap_folder=folder, device="cpu")
    assert not os.path.exists(os.path.join(folder, tnodes.HOT_SWAP_FILENAME))


def test_feature_node_scores_as_the_jax_node(backbone):
    """Per-pixel scoring of the FeatureExtractorNode: plain torch matmuls on
    the dense features, equal to the JAX node's jitted MLP on the same
    features and weights."""
    from wild_visual_navigation_tpu.models import get_model as jget_model
    from wild_visual_navigation_tpu_torch.utils.params import mlp_state_from_jax

    fe_p, _, exp = _small_params()
    node = tnodes.FeatureExtractorNode(params=fe_p, exp_params=exp, hot_swap_folder="unused",
                                       backbone_params=backbone, device="cpu", backbone_dtype=torch.float32)
    cfg = {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 384, "hidden_sizes": [16, 1], "reconstruction": True}}
    jp = jax.tree_util.tree_map(np.asarray, jget_model(cfg).init(jax.random.PRNGKey(3), jnp.zeros((1, 384))))
    node.model.load_state_dict(mlp_state_from_jax(jp))
    x = np.random.default_rng(0).standard_normal((50, 384)).astype(np.float32)
    with torch.no_grad():
        trav, _ = node._score(torch.from_numpy(x))
    want = np.asarray(jget_model(cfg).apply(jp, x))[:, 0]
    np.testing.assert_allclose(trav.numpy(), want, atol=1e-5)


def test_native_ipc_copy_drives_the_repository_library():
    """The port's native_ipc finds native/ at the repository root, as the
    JAX package's does (the pure-python fallbacks serve where no toolchain
    builds it)."""
    from wild_visual_navigation_tpu.runtime import native_ipc as jipc
    from wild_visual_navigation_tpu_torch.runtime import native_ipc as tipc

    assert tipc._NATIVE_DIR == jipc._NATIVE_DIR and os.path.isdir(tipc._NATIVE_DIR)
    img = np.random.default_rng(0).integers(0, 256, (6, 5, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tipc.image_to_chw(img), jipc.image_to_chw(img))
