"""The torch port's parallel layer (parallel/, the meshed WVNRuntime and
estimator, the DistributedTrainer and its dryrun) against the JAX package
and the port's unmeshed paths, on the CPU.

The ranks are spawned processes joined into a Gloo process group through a
file (parallel/launch.py::run_ranks), one torch thread each; their bodies
are in tests/_torch_parallel_ranks.py. One spawn of 4 ranks on a
("dp", "tp") = (2, 2) mesh serves the train-step, tp-ViT, meshed-runtime
and pickle tests, one spawn of 2 ranks the trainer and runtime-hook tests.
The JAX side runs here, on the seeded numpy inputs and weights the ranks
get. Tolerances are stated beside each test."""

import functools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

import _torch_parallel_ranks as ranks
from wild_visual_navigation_tpu import cfg as jcfg
from wild_visual_navigation_tpu.feature_extractor import feature_extractor as jfe_mod
from wild_visual_navigation_tpu.feature_extractor.dino import DinoInterface as JDino
from wild_visual_navigation_tpu.models import get_model as jget_model
from wild_visual_navigation_tpu.models import vit as jvit
from wild_visual_navigation_tpu.parallel import mlp_param_spec as jmlp_spec
from wild_visual_navigation_tpu.parallel import vit_param_spec as jvit_spec
from wild_visual_navigation_tpu.runtime import WVNRuntime as JRuntime
from wild_visual_navigation_tpu.utils import TravBatch as JTravBatch
from wild_visual_navigation_tpu.utils import TraversabilityLossConfig as JLossConfig
from wild_visual_navigation_tpu.utils import confidence_init as jconfidence_init
from wild_visual_navigation_tpu.utils import traversability_loss as jtraversability_loss
from wild_visual_navigation_tpu_torch.models import vit as tvit
from wild_visual_navigation_tpu_torch.models.registry import get_model
from wild_visual_navigation_tpu_torch.parallel import create_mesh, mlp_param_spec, vit_param_spec
from wild_visual_navigation_tpu_torch.parallel.launch import run_ranks
from wild_visual_navigation_tpu_torch.runtime import WVNRuntime
from wild_visual_navigation_tpu_torch.runtime.mesh_scenario import run_mesh_scenario, scenario_inputs, scenario_params
from wild_visual_navigation_tpu_torch.utils.params import mlp_state_from_jax, train_state_from_jax, vit_state_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_RTOL, STEP_ATOL = 1e-5, 1e-5  # one step: loss, params after one Adam step (JAX's own test's)
VIT_ATOL = 1e-5  # the tp ViT's dense features
STATE_ATOL = 1e-5  # meshed against unmeshed: pooled features, signals, losses, params
# meshed against unmeshed maps: K2 scores in bf16 (as the reference's kernel), so the tp ViT's ~1e-6
# feature differences (summation order) move the per-pixel maps by up to ~5e-4; the frame parity
# tests' limit for K2 maps
MAP_ATOL = 2e-3
TRAINER_RTOL, TRAINER_ATOL = 2e-5, 2e-6  # JAX's trainer test's
VIT_CFG = dict(patch_size=8, embed_dim=384, depth=2, num_heads=6, pos_grid_size=4, layerscale_init=None)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(specs) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): s
            for path, s in jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]}


# JAX's placement of a flax kernel / bias -> the port's of the torch weight / bias
_TRANSPOSED = {("kernel", P(None, "tp")): Shard(0), ("kernel", P("tp", None)): Shard(1), ("bias", P("tp")): Shard(0)}


def _as_port(leaf: str, spec) -> object:
    return _TRANSPOSED.get((leaf, spec), Replicate())


# ------------------------------------------------------------------- specs
@pytest.mark.parametrize("D,hidden", [(16, [32, 1]), (384, [256, 32, 1])], ids=["16-32-1", "384-256-32-1"])
def test_mlp_param_spec_is_jax_transposed(D, hidden):
    """The [256, 32, 1] head on 384-d features: its last layer is 385 wide,
    which tp = 2 does not divide, so it stays replicated on both sides."""
    cfg = {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": D, "hidden_sizes": hidden, "reconstruction": True}}
    jspec = _flat(jmlp_spec(jax.eval_shape(jget_model(cfg).init, jax.random.PRNGKey(0), jnp.zeros((1, D))), tp=2))
    spec = mlp_param_spec(get_model(cfg), tp=2)
    want = {}
    for path, s in jspec.items():
        _, layer, leaf = path.split("/")
        want[f"layers.{layer.split('_')[1]}.{'weight' if leaf == 'kernel' else 'bias'}"] = _as_port(leaf, s)
    assert spec == want
    assert spec["layers.0.weight"] == Shard(0) and spec["layers.1.weight"] == Shard(1)
    if len(hidden) == 3:
        assert spec["layers.2.weight"] == Replicate() and spec["layers.2.bias"] == Replicate()


def test_vit_param_spec_is_jax_transposed():
    """ViT-S/8: qkv and fc1 column-split, proj and fc2 row-split, the rest
    replicated. At tp = 4, 6 heads do not split: the port replicates
    attention (it shards by head), where JAX's contiguous cut splits it."""
    cfg = jvit.VIT_CONFIGS["dino_vit_small_8"]
    shapes = jax.eval_shape(jvit.VisionTransformer(cfg, attention_impl="xla").init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3, 224, 224)))
    tv = tvit.VisionTransformer(tvit.VIT_CONFIGS["dino_vit_small_8"], dtype=torch.float32, device="meta")
    for tp in (2, 4):
        jspec = _flat(jvit_spec(shapes, tp=tp))
        spec = vit_param_spec(tv, tp=tp)
        want = {name: Replicate() for name in spec}
        for path, s in jspec.items():
            parts = path.split("/")
            if len(parts) == 5 and parts[2] in ("attn", "mlp"):
                leaf = "weight" if parts[4] == "kernel" else "bias"
                name = f"blocks.{parts[1].split('_')[1]}.{parts[2]}.{parts[3]}.{leaf}"
                if not (tp == 4 and parts[3] in ("qkv", "proj")):
                    want[name] = _as_port(parts[4], s)
                elif s != P():
                    assert spec[name] == Replicate()  # the documented divergence
            else:
                assert s == P(), path
        assert spec == want
    assert sum(isinstance(s, Shard) for s in vit_param_spec(tv, 2).values()) == 12 * 6


def test_create_mesh_shapes_and_refusals(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        mesh = create_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("dp", "tp") and tuple(mesh.mesh.shape) == (1, 1)
        assert tuple(create_mesh(1, tp=1, device="cpu").mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="world size 1"):
            create_mesh(8, dp=4, tp=2, device="cpu")  # JAX's 8 virtual devices are 8 ranks here
        with pytest.raises(AssertionError, match=r"dp\(2\) \* tp\(1\) != n\(1\)"):
            create_mesh(dp=2, tp=1, device="cpu")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the (2, 2) mesh
def _jax_mesh_runtime():
    """The JAX runtime of tests/_mesh_runtime_check.py, unmeshed, in fp32."""
    fe = jcfg.FeatureExtractorNodeParams(
        network_input_image_height=32, network_input_image_width=32, segmentation_type="grid", feature_type="dino",
        dino_backbone="vit_small", dino_patch_size=8, image_callback_rate=1000.0,
        camera_topics={f"cam{i}": {"use_for_training": True} for i in range(4)})
    fe.grid_cell_size = 8
    ln = jcfg.LearningNodeParams(min_samples_for_training=2, image_graph_dist_thr=0.01,
                                 supervision_graph_dist_thr=0.01, supervision_callback_rate=1000.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfe_mod, "DinoInterface", functools.partial(JDino, dtype=jnp.float32, attention_impl="xla"))
        return JRuntime(fe_params=fe, ln_params=ln, key=jax.random.PRNGKey(0), buffer_capacity=16,
                        reprojection_fanout=4)


def _jax_scenario(rt) -> dict:
    """tests/_mesh_runtime_check.py's loop on the JAX runtime."""
    imgs, Ks, Tc = scenario_inputs()
    np.random.seed(42)  # the JAX estimator samples from the global RNG
    trav = []
    for step in range(3):
        poses = np.tile(np.eye(4), (4, 1, 1))
        poses[:, 0, 3] = step * 0.5 + np.arange(4) * 0.1
        res = rt.image_batch_callback(imgs + step * 0.01, stamps=[step + 0.1 * i for i in range(4)],
                                      cameras=[f"cam{i}" for i in range(4)], Ks=Ks, orig_h=40, orig_w=40,
                                      poses_base_in_world=poses, poses_cam_in_base=np.tile(Tc, (4, 1, 1)))
        trav.append(np.stack([np.asarray(r.traversability) for r in res]))
        pT = np.eye(4)
        pT[0, 3] = step * 0.5 + 0.2
        rt.robot_state_callback(step + 0.5, pT, np.array([1.0, 0, 0, 0, 0, 0]), np.array([1.0, 0, 0, 0, 0, 0]))
    return {"trav": trav, "losses": [rt.learning_step().loss_total for _ in range(5)]}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """JAX's references, the port's unmeshed runtime, and the 4 ranks'
    results, all from the same numpy inputs and JAX weights."""
    rng = np.random.default_rng(0)
    D, B, S = 16, 8, 4
    jm = jget_model(ranks.MLP_CFG)
    mlp_params = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, D))))
    x = rng.standard_normal((B * S, D)).astype(np.float32)
    y = rng.uniform(size=B * S).astype(np.float32)
    yv = rng.uniform(size=B * S) < 0.5
    sv = rng.uniform(size=B * S) < 0.9

    jv = jvit.VisionTransformer(jvit.ViTConfig(**VIT_CFG), attention_impl="xla", dtype=jnp.float32)
    vit_params = _np(jv.init(jax.random.PRNGKey(1), jnp.zeros((1, 3, 32, 32))))
    vit_x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)

    jrt = _jax_mesh_runtime()
    backbone = vit_state_from_jax(_np(jrt.feature_extractor._extractor.params))
    est = jrt.estimator
    train_state = train_state_from_jax(*_np((est.params, est._opt_state, est.confidence_state)), est.step)
    inputs = {"mlp_state": mlp_state_from_jax(mlp_params), "x": x, "y": y, "yv": yv, "sv": sv,
              "vit_cfg": VIT_CFG, "vit_state": vit_state_from_jax(vit_params), "vit_x": vit_x,
              "backbone": backbone, "train_state": train_state}
    path = str(tmp_path_factory.mktemp("mesh") / "inputs.pt")
    torch.save(inputs, path)
    out = run_ranks(ranks.mesh_rank, 4, args=(path,), timeout=300)

    fe, ln = scenario_params()
    rt = WVNRuntime(fe_params=fe, ln_params=ln, buffer_capacity=16, reprojection_fanout=4, device="cpu",
                    backbone_dtype=torch.float32, backbone_params=backbone, sampling_seed=42)
    rt.adopt_train_state(**train_state)
    single = run_mesh_scenario(rt)
    single.update(buffer_features=rt.estimator.buffer.features.numpy(), signal=rt.estimator.buffer.signal.numpy())
    return {"ranks": out, "single": single, "moving_average": ranks.moving_average_runtime(None, inputs), "jax": _jax_scenario(jrt), "mlp_params": mlp_params, "jm": jm,
            "batch": (x, y, yv, sv), "vit": np.asarray(jvit.dense_features(jv, vit_params, vit_x)), "vit_x": vit_x}


def _jax_step(jm, params, batch):
    """JAX's unsharded step, as tests/test_parallel.py holds the sharded one to it."""
    x, y, yv, sv = batch
    tx = optax.adam(1e-3)

    def loss_fn(p):
        loss, aux, cg2 = jtraversability_loss(JLossConfig(), JTravBatch(x=x, y=y, y_valid=yv, sample_valid=sv),
                                              jm.apply(p, x), jconfidence_init())
        return loss

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params))
    return float(loss), mlp_state_from_jax(_np(optax.apply_updates(params, updates)))


@pytest.mark.parametrize("case", ["step", "step_starved"])
def test_multichip_train_step_matches_jax(mesh_run, case):
    """dp 2 x tp 2 make_multichip_train_step against JAX's unsharded step:
    loss rtol 1e-5, params after one Adam step atol 1e-5. "step_starved":
    every row of dp rank 1 masked, so the ranks' valid counts differ and
    only global reductions give JAX's numbers."""
    x, y, yv, sv = mesh_run["batch"]
    if case == "step_starved":
        sv = sv.copy()
        sv[len(sv) // 2:] = False
    want_loss, want = _jax_step(mesh_run["jm"], mesh_run["mlp_params"], (x, y, yv, sv))
    for r in mesh_run["ranks"]:
        got = r[case]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=STEP_RTOL)
        for name, w in want.items():
            np.testing.assert_allclose(got["params"][name], w.numpy(), atol=STEP_ATOL, err_msg=name)
    assert [r["shape"] for r in mesh_run["ranks"]] == [{"dp": 2, "tp": 2}] * 4
    assert [(r["dp_rank"], r["tp_rank"]) for r in mesh_run["ranks"]] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_multichip_inference_splits_frames_over_dp(mesh_run):
    """make_multichip_inference on 5 frames over dp 2: each rank runs 3
    (one zero frame of padding on the second), and every rank gets all 5
    outputs of a tuple, a boolean one included, exactly."""
    x = np.tile(mesh_run["vit_x"], (3, 1, 1, 1))[:5]
    for r in mesh_run["ranks"]:
        sums, positive, seen = r["infer"]
        assert seen == [3]
        np.testing.assert_array_equal(sums, torch.from_numpy(x).sum((1, 2, 3)).numpy())
        np.testing.assert_array_equal(positive, x[:, 0] > 0)


def test_tp_vit_matches_jax(mesh_run):
    """The tp = 2 ViT (ViT-S/8 widths, 2 blocks, fp32, 32 px) on each rank's
    3 heads against JAX's unsharded dense_features: atol 1e-5."""
    for r in mesh_run["ranks"]:
        assert r["vit_local_heads"] == 3
        np.testing.assert_allclose(r["vit"], mesh_run["vit"], atol=VIT_ATOL)


def test_meshed_runtime_matches_unmeshed(mesh_run):
    """WVNRuntime(mesh=(2, 2)) against the port's unmeshed runtime on
    tests/_mesh_runtime_check.py's scenario at 32 px in fp32, both holding
    the JAX runtime's weights: pooled features, supervision signals,
    losses and params atol 1e-5; maps MAP_ATOL (K2's bf16); every rank the
    same checksum. The unmeshed runtime is itself held to JAX's runtime:
    maps MAP_ATOL, losses rtol 1e-4 (the runtime parity tests' limits)."""
    single, jx = mesh_run["single"], mesh_run["jax"]
    assert len({r["runtime"]["checksum"] for r in mesh_run["ranks"]}) == 1
    for r in mesh_run["ranks"]:
        got = r["runtime"]
        np.testing.assert_allclose(r["buffer_features"], single["buffer_features"], atol=STATE_ATOL)
        np.testing.assert_allclose(r["signal"], single["signal"], atol=STATE_ATOL)
        for a, b in zip(got["trav"] + got["conf"], single["trav"] + single["conf"]):
            np.testing.assert_allclose(a, b, atol=MAP_ATOL)
        np.testing.assert_allclose(got["losses"], single["losses"], atol=STATE_ATOL)
        for k, v in single["params"].items():
            np.testing.assert_allclose(got["params"][k], v, atol=STATE_ATOL, err_msg=k)
    assert single["losses"][-1] >= 0, "training never ran"
    for a, b in zip(single["trav"], jx["trav"]):
        np.testing.assert_allclose(a, b, atol=MAP_ATOL)
    np.testing.assert_allclose(single["losses"], jx["losses"], rtol=1e-4)


def test_meshed_moving_average_with_a_padded_batch(mesh_run):
    """dp 4 over batches of 7 nodes with moving_average confidence: each
    batch is padded to 8, and the padding must stay out of the confidence's
    minimum and maximum over the rows. Losses, params and maps against the
    unmeshed runtime, as in test_meshed_runtime_matches_unmeshed."""
    single = mesh_run["moving_average"]
    assert single["losses"][-1] >= 0, "training never ran"
    for r in mesh_run["ranks"]:
        got = r["moving_average"]
        for a, b in zip(got["trav"] + got["conf"], single["trav"] + single["conf"]):
            np.testing.assert_allclose(a, b, atol=MAP_ATOL)
        np.testing.assert_allclose(got["losses"], single["losses"], atol=STATE_ATOL)
        for k, v in single["params"].items():
            np.testing.assert_allclose(got["params"][k], v, atol=STATE_ATOL, err_msg=k)


def test_pickled_meshed_estimator_loads_unmeshed(mesh_run):
    """__getstate__ drops the mesh (it holds process groups): the pickle of
    a meshed estimator loads unmeshed here and trains on its own."""
    est = pickle.loads(mesh_run["ranks"][0]["pickle"])
    assert est._mesh is None and est._dp == 1 and est._dp_group is None
    np.testing.assert_array_equal(est.buffer.features.numpy(), mesh_run["ranks"][0]["buffer_features"])
    step = est.step
    assert np.isfinite(est.train()["loss_total"]) and est.step == step + 1


# ------------------------------------------------------------- the trainer
CASES = [("SimpleMLP", 1, False), ("SimpleGCN", 1, False), ("SimpleMLP", 2, False), ("SimpleMLP", 1, True)]


@pytest.fixture(scope="module")
def trainer_run():
    out = run_ranks(ranks.trainer_rank, 2, args=(CASES,), timeout=300)
    return {case: [r[case] for r in out] for case in CASES + ["hook"]}


@pytest.mark.parametrize("case", CASES, ids=["mlp", "gcn", "mlp-tp2", "mlp-starved"])
def test_distributed_trainer_matches_twin(trainer_run, case):
    """Two ranks' DistributedTrainer, started from an estimator with 2
    local Adam steps, against a twin estimator stepping on the
    concatenation of both ranks' rows (pinned slots per rank, as JAX's test
    pins them; "starved": rank 1 has no data on step 1): losses and params
    after 3 steps rtol 2e-5, atol 2e-6 (JAX's test's); both ranks the same
    checksum."""
    per_rank = trainer_run[case]
    assert per_rank[0]["checksum"] == per_rank[1]["checksum"]
    for r in per_rank:
        assert r["mesh"] == (("dp", "tp") if case[1] > 1 else ("dp",)) and r["adam_step"] == 5
        for got, want in r["losses"]:
            assert np.isfinite(got)
            np.testing.assert_allclose(got, want, rtol=TRAINER_RTOL, atol=TRAINER_ATOL)
        for k, v in r["twin"].items():
            np.testing.assert_allclose(r["params"][k], v, rtol=TRAINER_RTOL, atol=TRAINER_ATOL, err_msg=k)


def test_runtime_distributed_trainer_hook(trainer_run):
    """attach_distributed_trainer: learning_step runs the collective step
    (4 ticks, 4 steps), hot_swap writes the trained params into the
    estimator and the mailbox, a pause skips the step, and both ranks end
    with the same params."""
    per_rank = trainer_run["hook"]
    assert per_rank[0]["checksum"] == per_rank[1]["checksum"]
    for r in per_rank:
        assert r["steps"] == 4 and r["st_step"] == 4 and np.isfinite(r["loss"])
        assert r["trained"] and r["mailbox_equal"]
        assert r["paused"] == (4, True) and r["resumed"] == 5


# --------------------------------------------------------------- the dryrun
def _dryrun(*args):
    return subprocess.run([sys.executable, "-m", "wild_visual_navigation_tpu_torch.tools.dryrun_multiprocess",
                           "--device", "cpu", *args], cwd=ROOT, capture_output=True, text=True, timeout=600)


def test_dryrun_multiprocess_estimators():
    res = _dryrun("--procs", "2")
    assert res.returncode == 0, f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}"
    assert "replicated state consistent" in res.stdout and res.stdout.count("DISTRIBUTED OK") == 2


@pytest.mark.slow
def test_dryrun_multiprocess_runtime_dp_tp():
    res = _dryrun("--procs", "2", "--runtime", "--tp", "2")
    assert res.returncode == 0, f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}"
    assert "mesh=('dp', 'tp') tp=2" in res.stdout and "replicated state consistent" in res.stdout
