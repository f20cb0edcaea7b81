"""The torch port's grid map (ops/gridmap.py), smart carrot
(scripts/smart_carrot.py) and the runtime's grid map, carrot and closed
loop against the JAX package, on the CPU.

The grid's values are held bitwise where both sides round in the same
order: the scatter adds into the running sums in index order, the SDF
takes only mins and adds, and the recentred origin is the JAX package's
multiply-add rounded once. A ray landing on a cell edge could still fall
into the neighbour cell where XLA contracts a product and a sum that torch
rounds twice; the projection tests count such cells (none in these scenes)
and hold every other cell exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu import cfg as jcfg
from wild_visual_navigation_tpu.ops import gridmap as jg
from wild_visual_navigation_tpu.runtime import WVNRuntime as JRuntime
from wild_visual_navigation_tpu.runtime import run_replay as jrun_replay
from wild_visual_navigation_tpu.runtime import synthetic_sequence as jsynthetic_sequence
from wild_visual_navigation_tpu.runtime.replay import SimWorld as JSimWorld
from wild_visual_navigation_tpu.runtime.replay import run_closed_loop as jrun_closed_loop
from wild_visual_navigation_tpu.scripts import CarrotConfig as JCarrotConfig
from wild_visual_navigation_tpu.scripts import select_carrot as jselect_carrot
from wild_visual_navigation_tpu_torch.cfg import experiment as tcfg_exp
from wild_visual_navigation_tpu_torch.cfg import node_params as tcfg_node
from wild_visual_navigation_tpu_torch.ops import gridmap as tg
from wild_visual_navigation_tpu_torch.runtime import WVNRuntime, run_replay, synthetic_sequence
from wild_visual_navigation_tpu_torch.runtime.replay import SimWorld, run_closed_loop
from wild_visual_navigation_tpu_torch.scripts import CarrotConfig, select_carrot
from wild_visual_navigation_tpu_torch.utils.params import train_state_from_jax

EDGE_CELLS = 2  # cells allowed to differ from JAX's through a ray on a cell edge (none seen)
MAP_ATOL = 1e-4  # trav / conf maps of the runtimes, fp32 sift features and heads


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


def _cameras():
    """A camera looking straight down from 2 m (the JAX tests' scene) and
    one looking ahead, tilted down by 40 degrees, from 1.5 m."""
    down = np.array([[1, 0, 0, 0.3], [0, -1, 0, -0.2], [0, 0, -1, 2.0], [0, 0, 0, 1]], np.float64)
    a = np.deg2rad(40.0)
    z = np.array([np.cos(a), 0.0, -np.sin(a)])
    x = np.array([0.0, -1.0, 0.0])
    ahead = np.eye(4)
    ahead[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
    ahead[:3, 3] = [0.4, 0.7, 1.5]
    return {"down": down, "ahead": ahead}


def _pair(G=64, res=0.15, center=(1.0, 0.5), seed=0):
    """The same non-empty grid on both sides."""
    rng = np.random.default_rng(seed)
    vs = rng.random((G, G)).astype(np.float32) * (rng.random((G, G)) < 0.3)
    ws = (vs > 0) * rng.uniform(0.5, 2.0, (G, G)).astype(np.float32)
    j = jg.gridmap_init(G, res, center_xy=center)._replace(value_sum=jnp.asarray(vs), weight=jnp.asarray(ws))
    t = tg.gridmap_init(G, res, center_xy=center)._replace(value_sum=torch.from_numpy(vs), weight=torch.from_numpy(ws))
    return j, t


def _same_grid(t, j, edge_cells=0):
    """Origins bitwise; sums bitwise except at most `edge_cells` cells."""
    np.testing.assert_array_equal(t.origin_xy, np.asarray(j.origin_xy))
    assert t.origin_xy.dtype == np.float32 and t.resolution == j.resolution
    for name in ("value_sum", "weight"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert int((a != b).sum()) <= edge_cells, (name, int((a != b).sum()))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.traversability.numpy(), np.asarray(j.traversability))


def test_gridmap_init_matches_jax():
    for size, res, c in [(64, 0.1, (0.0, 0.0)), (128, 0.15, (2.5, -1.25)), (33, 0.25, (-3.0, 7.0))]:
        _same_grid(tg.gridmap_init(size, res, center_xy=c), jg.gridmap_init(size, res, center_xy=c))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("with_conf", [True, False], ids=["confidence", "unit-weight"])
def test_project_traversability_to_grid_matches_jax(with_conf, stride):
    """Two fusions in turn (the second into the first's sums) from a
    downward and a tilted camera; rays beyond 8 m, behind the camera or off
    the grid are dropped."""
    rng = np.random.default_rng(1)
    H, W = 48, 64
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    j, t = _pair()
    for cam in _cameras().values():
        trav = rng.random((H, W)).astype(np.float32)
        conf = rng.random((H, W)).astype(np.float32)
        j = jg.project_traversability_to_grid(j, jnp.asarray(trav), jnp.asarray(K), jnp.asarray(cam, jnp.float32),
                                              confidence=jnp.asarray(conf) if with_conf else None, stride=stride)
        t = tg.project_traversability_to_grid(t, torch.from_numpy(trav), torch.from_numpy(K), cam,
                                              confidence=torch.from_numpy(conf) if with_conf else None, stride=stride)
        _same_grid(t, j, EDGE_CELLS)
    assert int(t.valid.sum()) > 400


@pytest.mark.parametrize("center", [(1.6, 0.5), (-0.7, 0.5), (1.0, 2.2), (1.0, -0.9), (0.3, -1.4), (40.0, -30.0)],
                         ids=["+x", "-x", "+y", "-y", "diagonal", "clears-all"])
def test_gridmap_recenter_matches_jax(center):
    """A whole-cell shift each way (content moves against the origin),
    cells shifted in cleared; a jump beyond the grid clears it all."""
    j, t = _pair()
    for _ in range(2):  # the second call from the first's origin
        j = jg.gridmap_recenter(j, jnp.asarray(center, jnp.float32))
        t = tg.gridmap_recenter(t, center)
        _same_grid(t, j)
    if center == (40.0, -30.0):
        assert not bool(t.valid.any())
    else:
        assert bool(t.valid.any())


def test_gridmap_recenter_origin_drift_matches_jax():
    """Three hundred recentrings on random centres: the host's origin equals
    the JAX package's bit for bit at every step."""
    rng = np.random.default_rng(2)
    j, t = _pair(G=128)
    for _ in range(300):
        c = rng.normal(0, 3, 2).astype(np.float32)
        j = jg.gridmap_recenter(j, jnp.asarray(c))
        t = tg.gridmap_recenter(t, c)
        np.testing.assert_array_equal(t.origin_xy, np.asarray(j.origin_xy))
    _same_grid(t, j)


def _fused_grid():
    j, t = _pair(G=48, res=0.1, center=(1.5, 0.0), seed=3)
    rng = np.random.default_rng(3)
    K = np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]], np.float32)
    cam = _cameras()["ahead"]
    trav = (rng.random((48, 64)) > 0.4).astype(np.float32)
    j = jg.project_traversability_to_grid(j, jnp.asarray(trav), jnp.asarray(K), jnp.asarray(cam, jnp.float32),
                                          stride=1)
    t = tg.project_traversability_to_grid(t, torch.from_numpy(trav), torch.from_numpy(K), cam, stride=1)
    _same_grid(t, j)
    return j, t


def test_traversability_sdf_matches_jax_bitwise():
    """On JAX's fused grid and on a random one: mins and adds only, so equal bit for bit."""
    j, t = _fused_grid()
    sj = np.asarray(jg.traversability_sdf(j.traversability, j.valid, resolution=0.1))
    st = tg.traversability_sdf(torch.from_numpy(np.array(j.traversability)),
                               torch.from_numpy(np.array(j.valid)), resolution=0.1).numpy()
    np.testing.assert_array_equal(st, sj)
    assert (st > 0).any() and (st < 0).any()
    rng = np.random.default_rng(4)
    trav = rng.random((37, 29)).astype(np.float32)
    valid = rng.random((37, 29)) > 0.2
    for it in (1, 5, 64):
        np.testing.assert_array_equal(
            tg.traversability_sdf(torch.from_numpy(trav), torch.from_numpy(valid), 0.4, 0.25, it).numpy(),
            np.asarray(jg.traversability_sdf(jnp.asarray(trav), jnp.asarray(valid), 0.4, 0.25, it)))


@pytest.mark.parametrize("yaw", [0.0, 0.8, -2.5])
def test_select_carrot_matches_jax(yaw):
    """The same cell and the same score map on the same SDF."""
    j, t = _fused_grid()
    sdf = np.asarray(jg.traversability_sdf(j.traversability, j.valid, resolution=0.1))
    valid = np.asarray(j.valid)
    for cfg in (CarrotConfig(), CarrotConfig(invalid_dilation=1, min_distance_cells=2)):
        jcfg_ = JCarrotConfig(**vars(cfg))
        cell_t, score_t = select_carrot(sdf, yaw=yaw, valid=valid, cfg=cfg)
        cell_j, score_j = jselect_carrot(sdf, yaw=yaw, valid=valid, cfg=jcfg_)
        assert cell_t == cell_j
        np.testing.assert_array_equal(score_t, score_j)


# ------------------------------------------------------------------- runtime


def _params(mod_node, mod_exp):
    """The JAX package's own runtime grid-map test: sift x grid at 48 px, a
    [16, 1] head, buffer 32, fan-out 8, grid 32 x 0.25."""
    fe = mod_node.FeatureExtractorNodeParams(
        network_input_image_height=48, network_input_image_width=48, segmentation_type="grid", feature_type="sift",
        prediction_per_pixel=False, image_callback_rate=1000.0, grid_cell_size=16)
    ln = mod_node.LearningNodeParams(
        network_input_image_height=48, network_input_image_width=48, image_graph_dist_thr=0.05,
        supervision_graph_dist_thr=0.02, min_samples_for_training=3, supervision_callback_rate=1000.0,
        robot_width=0.5, robot_length=0.5)
    exp = mod_exp.ExperimentParams()
    exp.model.simple_mlp_cfg.hidden_sizes = [16, 1]
    return fe, ln, exp


def _runtimes(G=32, res=0.25):
    fe, ln, exp = _params(jcfg, jcfg)
    jrt = JRuntime(fe_params=fe, ln_params=ln, exp_params=exp, key=jax.random.PRNGKey(0), buffer_capacity=32,
                   reprojection_fanout=8, gridmap_size=G, gridmap_resolution=res)
    fe, ln, exp = _params(tcfg_node, tcfg_exp)
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=32, reprojection_fanout=8,
                    gridmap_size=G, gridmap_resolution=res, device="cpu")
    est = jrt.estimator
    rt.adopt_train_state(**train_state_from_jax(*_np((est.params, est._opt_state, est.confidence_state)), est.step))
    return jrt, rt


def _close_grid(t, j):
    """The runtimes' grids: the same origin and cells, sums within the maps' tolerance."""
    np.testing.assert_array_equal(t.origin_xy, np.asarray(j.origin_xy))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_allclose(t.weight.numpy(), np.asarray(j.weight), rtol=1e-5, atol=MAP_ATOL)
    np.testing.assert_allclose(t.traversability.numpy(), np.asarray(j.traversability), atol=MAP_ATOL)


def test_runtime_gridmap_and_carrot_match_jax():
    """The replay of the JAX package's runtime grid-map test through both
    runtimes: the grid maps, then the carrot (its SDF from the device in one
    copy), then a recentring and a second carrot."""
    jrt, rt = _runtimes()
    assert rt.gridmap.weight.device.type == "cpu" and rt.gridmap.value_sum.shape == (32, 32)
    np.random.seed(42)
    jrep = jrun_replay(jrt, jsynthetic_sequence(duration=4.0, frame_rate=5.0, state_rate=5.0, image_size=48, seed=0))
    trep = run_replay(rt, synthetic_sequence(duration=4.0, frame_rate=5.0, state_rate=5.0, image_size=48, seed=0))
    for field in ("frames_processed", "supervision_updates", "train_steps", "valid_nodes"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.train_steps > 0 and int(rt.gridmap.valid.sum()) > 20
    _close_grid(rt.gridmap, jrt.gridmap)
    for yaw in (0.0, 0.6):
        goal_t, score_t = rt.get_carrot(yaw=yaw)
        goal_j, score_j = jrt.get_carrot(yaw=yaw)
        assert (goal_t is None) == (goal_j is None)
        if goal_t is not None:
            np.testing.assert_allclose(goal_t, goal_j, atol=1e-6)
            assert abs(goal_t[0] - 4.0) < 5.0  # the JAX test's bound: ahead of a robot that ended near x = 4
        finite = np.isfinite(score_j)
        np.testing.assert_array_equal(np.isfinite(score_t), finite)
        np.testing.assert_allclose(score_t[finite], score_j[finite], atol=1e-4)
    assert goal_t is not None


def test_runtime_without_a_grid_map_has_no_carrot():
    fe, ln, exp = _params(tcfg_node, tcfg_exp)
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=8, device="cpu")
    assert rt.gridmap is None and rt.get_carrot() == (None, None)


def test_run_closed_loop_chooses_carrots_as_jax():
    """run_closed_loop in the sim world with the grid map: carrots chosen
    every second tick steer the robot; the path and the goals agree with
    the JAX runtime's."""
    jrt, rt = _runtimes(G=64, res=0.15)
    np.random.seed(42)
    jpath, jgoals = jrun_closed_loop(jrt, JSimWorld(image_size=48, seed=0, obstacle_xy=(2.0, 0.5)), duration=2.4,
                                     rate=5.0)
    tpath, tgoals = run_closed_loop(rt, SimWorld(image_size=48, seed=0, obstacle_xy=(2.0, 0.5)), duration=2.4,
                                    rate=5.0)
    assert len(tgoals) == len(jgoals) > 0 and any(g is not None for g in tgoals)
    for a, b in zip(tgoals, jgoals):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(tpath, jpath, atol=1e-6)
    assert np.isfinite(tpath).all() and len(tpath) >= 12


def test_obstacle_scenario_on_the_cpu():
    """The JAX package's closed-loop obstacle scenario (its own test is
    marked slow there) on the port, with that test's configuration and
    checks: the robot crosses the obstacle, trains more than 100 steps on
    low-traversability supervision, the rebuilt grid map reads the obstacle
    worse than clean ground by 0.15, the carrot stays out of it, and the
    closed loop then drives on."""
    from wild_visual_navigation_tpu_torch.runtime.obstacle_scenario import build_runtime, run_obstacle_scenario

    rt = build_runtime("cpu")
    out = run_obstacle_scenario(rt)
    assert all(out["checks"].values()), out
    assert out["loop_goals"] > 0 and out["carrot"] is not None
