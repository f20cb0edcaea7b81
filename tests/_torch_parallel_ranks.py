"""Rank bodies for tests/test_torch_port_parallel.py.

Each function runs on one rank of a Gloo process group on the CPU
(wild_visual_navigation_tpu_torch/parallel/launch.py::run_ranks spawns
them; this module is imported by name in every rank, so it imports no JAX)
and returns numpy values for the test process to compare with the JAX
package and with the port's unmeshed paths.
"""

import pickle

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from wild_visual_navigation_tpu_torch.cfg.experiment import ExperimentParams
from wild_visual_navigation_tpu_torch.cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
from wild_visual_navigation_tpu_torch.models import vit as tvit
from wild_visual_navigation_tpu_torch.models.registry import get_model
from wild_visual_navigation_tpu_torch.parallel import (
    create_mesh,
    make_multichip_inference,
    make_multichip_train_step,
    mlp_param_spec,
    shard_module,
    vit_param_spec,
)
from wild_visual_navigation_tpu_torch.parallel.distributed import _full, masked_batch
from wild_visual_navigation_tpu_torch.runtime import WVNRuntime, run_replay, synthetic_sequence
from wild_visual_navigation_tpu_torch.runtime.mesh_scenario import params_checksum, run_mesh_scenario, scenario_params
from wild_visual_navigation_tpu_torch.traversability.estimator import make_adam
from wild_visual_navigation_tpu_torch.utils.confidence_generator import confidence_init
from wild_visual_navigation_tpu_torch.utils.data import TravBatch
from wild_visual_navigation_tpu_torch.utils.loss import TraversabilityLossConfig, traversability_loss

MLP_CFG = {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 16, "hidden_sizes": [32, 1], "reconstruction": True}}


def _np_params(model) -> dict:
    """Full parameters (tp shards gathered) as numpy."""
    return {n: _full(p, p.device_mesh.get_group() if isinstance(p, DTensor) else None).numpy()
            for n, p in model.named_parameters()}


def one_step(mesh, inputs: dict, sample_valid: np.ndarray) -> dict:
    """make_multichip_train_step on the dp x tp mesh: one Adam step of the
    [32, 1] head from the JAX weights on this rank's dp rows."""
    model = get_model(MLP_CFG)
    model.load_state_dict(inputs["mlp_state"])
    shard_module(model, mlp_param_spec(model, tp=2), mesh)
    opt = make_adam(model.parameters(), 1e-3)
    cfg = TraversabilityLossConfig()

    def loss_fn(m, batch, cg, group):
        x, y, yv, sv = batch
        loss, aux, cg2 = traversability_loss(cfg, TravBatch(x, y, yv, sv), m(x), cg, group=group)
        return loss, (aux, cg2)

    train_step, place_batch = make_multichip_train_step(mesh, model, opt, loss_fn)
    rows = tuple(torch.from_numpy(a) for a in (inputs["x"], inputs["y"], inputs["yv"], sample_valid))
    loss, _, _ = train_step(confidence_init(), place_batch(rows))
    return {"loss": float(loss), "params": _np_params(model)}


def moving_average_runtime(mesh, inputs: dict) -> dict:
    """The mesh scenario with moving_average confidence and batches of 7
    nodes, which a dp of 4 does not divide."""
    fe, ln = scenario_params()
    exp = ExperimentParams()
    exp.loss.method = "moving_average"
    exp.ablation_data_module.batch_size = 7
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=16, reprojection_fanout=4, mesh=mesh,
                    device="cpu", backbone_dtype=torch.float32, backbone_params=inputs["backbone"], sampling_seed=42)
    rt.adopt_train_state(**inputs["train_state"])
    return run_mesh_scenario(rt)


def mesh_rank(rank: int, world: int, path: str) -> dict:
    """Everything the (2, 2) mesh is held to: the one-step train step with
    every row valid and with dp rank 1's rows fully masked, the tp ViT, and
    the meshed runtime on the mesh scenario (with a pickle of its
    estimator from rank 0); then the moving_average scenario on a (4, 1)
    mesh."""
    inputs = torch.load(path, weights_only=False)
    mesh = create_mesh(dp=2, tp=2, device="cpu")
    out = {"shape": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)), "dp_rank": mesh.get_local_rank("dp"),
           "tp_rank": mesh.get_local_rank("tp")}
    # 5 frames over dp 2: padded to 6, the padding dropped from the gathered outputs
    imgs = torch.from_numpy(inputs["vit_x"]).repeat(3, 1, 1, 1)[:5]
    seen = []
    infer = make_multichip_inference(mesh, lambda x: (seen.append(x.shape[0]) or x.sum((1, 2, 3)), x[:, 0] > 0))
    out["infer"] = [t.numpy() for t in infer(imgs)] + [seen]
    out["step"] = one_step(mesh, inputs, inputs["sv"])
    starved = inputs["sv"].copy()
    starved[len(starved) // 2:] = False  # dp rank 1's rows
    out["step_starved"] = one_step(mesh, inputs, starved)

    vit = tvit.VisionTransformer(tvit.ViTConfig(**inputs["vit_cfg"]), attention_impl="flash", dtype=torch.float32,
                                 state_dict=inputs["vit_state"])
    shard_module(vit, vit_param_spec(vit, tp=2), mesh)
    out["vit_local_heads"] = vit.blocks[0].attn.num_heads
    with torch.no_grad():
        out["vit"] = tvit.dense_features(vit, torch.from_numpy(inputs["vit_x"])).numpy()

    fe, ln = scenario_params()
    rt = WVNRuntime(fe_params=fe, ln_params=ln, buffer_capacity=16, reprojection_fanout=4, mesh=mesh, device="cpu",
                    backbone_dtype=torch.float32, backbone_params=inputs["backbone"], sampling_seed=42)
    rt.adopt_train_state(**inputs["train_state"])
    out["runtime"] = run_mesh_scenario(rt)
    out["buffer_features"] = rt.estimator.buffer.features.numpy()
    out["signal"] = rt.estimator.buffer.signal.numpy()
    if rank == 0:
        out["pickle"] = pickle.dumps(rt.estimator)
    out["moving_average"] = moving_average_runtime(create_mesh(dp=4, tp=1, device="cpu"), inputs)
    return out


# ---------------------------------------------------------------- trainer
def _sift_runtime(size: int, model: str = "SimpleMLP", hidden=(32, 1), capacity: int = 16, seed: int = 3,
                  **ln_kw):
    """The JAX trainer tests' runtime: sift x grid, a replay of a synthetic
    sequence without training."""
    fe = FeatureExtractorNodeParams(network_input_image_height=size, network_input_image_width=size,
                                    segmentation_type="grid", feature_type="sift", prediction_per_pixel=False,
                                    image_callback_rate=1000.0, grid_cell_size=8)
    ln = LearningNodeParams(network_input_image_height=size, network_input_image_width=size,
                            supervision_callback_rate=1000.0, **ln_kw)
    exp = ExperimentParams()
    exp.model.name = model
    if model == "SimpleGCN":
        exp.model.simple_gcn_cfg.hidden_sizes = list(hidden)
    else:
        exp.model.simple_mlp_cfg.hidden_sizes = list(hidden)
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=capacity, reprojection_fanout=8,
                    device="cpu")
    seq = synthetic_sequence(duration=5.0 if size == 48 else 4.0, frame_rate=5.0, state_rate=5.0, image_size=size,
                             seed=seed)
    run_replay(rt, seq, train_every_state=0)
    return rt


def trainer_case(rank: int, world: int, model: str, tp: int, starve: bool) -> dict:
    """DistributedTrainer against a twin estimator in this rank that steps
    on the concatenation of every rank's rows. Every rank replays the same
    sequence; rank r pins its own sampled slots; with `starve`, rank 1 has
    no data on the first step."""
    rt = _sift_runtime(48, model, (32, 16, 1) if model == "SimpleGCN" else (32, 1), image_graph_dist_thr=0.1,
                       supervision_graph_dist_thr=0.05, min_samples_for_training=3)
    est = rt.estimator
    est._resolve_pending_supervision()
    valid = [n.buffer_slot for n in est._mission_graph.get_valid_nodes() if n.buffer_slot >= 0]
    assert len(valid) > 3, "the replay produced too few valid nodes"
    idx = [np.array(np.roll(valid * 8, r)[:8], dtype=np.int32) for r in range(world)]
    # two local steps first: the trainer starts from Adam moments it must carry (and split over tp)
    est._sample_indices = lambda batch_size=None: idx[0]
    for _ in range(2):
        est.train()
    del est._sample_indices
    twin = pickle.loads(pickle.dumps(est))
    calls = []

    def pinned(batch_size=None):
        calls.append(1)
        return None if starve and rank == 1 and len(calls) == 1 else idx[rank]

    est._sample_indices = pinned
    trainer = rt.attach_distributed_trainer(tp=tp)
    losses = []
    for step in range(3):
        res = trainer.step()
        parts = [masked_batch(twin) if starve and r == 1 and step == 0 else twin._batch(idx[r], split=False)
                 for r in range(world)]
        batch = TravBatch(*(None if f[0] is None else torch.cat(f) for f in zip(*parts)))
        loss, _, twin._cg_state = twin.step_on_batch(twin.model, twin.optimizer, twin.confidence_state, batch)
        losses.append((res["loss_total"], float(loss)))
    trainer.sync_to_estimator()
    assert est.step == 5
    return {"losses": losses, "params": {k: v.numpy() for k, v in est.params.items()},
            "twin": {k: v.numpy() for k, v in twin.params.items()}, "checksum": params_checksum(est.params),
            "mesh": tuple(trainer.mesh.mesh_dim_names),
            "adam_step": int(next(iter(est.optimizer.state.values()))["step"])}


def runtime_hook(rank: int, world: int) -> dict:
    """attach_distributed_trainer on a runtime: learning_step joins the
    collective step, hot_swap writes the trained params back into the
    estimator and the mailbox, and a pause binds."""
    rt = _sift_runtime(64, seed=0, capacity=32, image_graph_dist_thr=0.15, supervision_graph_dist_thr=0.05,
                       min_samples_for_training=4, robot_width=0.8, robot_length=0.8, traversability_radius=4.0,
                       load_save_checkpoint_rate=5.0)
    trainer = rt.attach_distributed_trainer()
    before = next(iter(rt.estimator.params.values())).clone()
    for _ in range(4):
        st = rt.learning_step()
    out = {"steps": trainer.step_count, "st_step": st.step, "loss": st.loss_total}
    rt.hot_swap()  # the checkpoint rate (5 of 1000 Hz) swaps every 200 ticks: force one
    after = next(iter(rt.estimator.params.values()))
    head, _ = rt.inference_head
    out["trained"] = not torch.allclose(before, after)
    out["mailbox_equal"] = bool(torch.equal(next(iter(head.state_dict().values())), after))
    rt.pause_learning(True)
    st = rt.learning_step()
    out["paused"] = (trainer.step_count, st.pause_learning)
    rt.pause_learning(False)
    rt.learning_step()
    out["resumed"] = trainer.step_count
    out["checksum"] = params_checksum(rt.estimator.params)
    return out


def trainer_rank(rank: int, world: int, cases: list) -> dict:
    """The trainer cases, then the runtime hook, in one process group."""
    out = {case: trainer_case(rank, world, *case) for case in cases}
    out["hook"] = runtime_hook(rank, world)
    return out

# ----------------------------------------------------------------- the card
def tp_vit_rank(rank: int, world: int, path: str) -> dict:
    """The tp ViT on the card: this rank's heads through K1, its launches
    and the shapes they took."""
    import wild_visual_navigation_tpu_torch as port

    data = torch.load(path, weights_only=False)
    mesh = create_mesh(dp=1, tp=world, device="cuda")
    vit = tvit.VisionTransformer(tvit.ViTConfig(**data["cfg"]), attention_impl="flash", dtype=torch.float32,
                                 device="cuda", state_dict=data["state"])
    shard_module(vit, vit_param_spec(vit, tp=world), mesh)
    shapes, k1 = set(), tvit.flash_attention

    def recording(q, *a, **kw):
        shapes.add(tuple(q.shape))
        return k1(q, *a, **kw)

    tvit.flash_attention = recording
    port.reset_launch_counts()
    with torch.no_grad():
        out = tvit.dense_features(vit, data["x"].cuda())
    torch.cuda.synchronize()
    return {"out": out.cpu().numpy(), "launches": port.launch_counts()["flash_attention"], "shapes": sorted(shapes)}


def nccl_runtime_rank(rank: int, world: int) -> dict:
    """A (1, 1) mesh over NCCL against no mesh, on the mesh scenario at 32 px."""
    import torch.distributed as dist

    fe, ln = scenario_params()
    out = {"backend": str(dist.get_backend())}
    for name, mesh in (("meshed", create_mesh(dp=1, tp=1, device="cuda")), ("plain", None)):
        rt = WVNRuntime(fe_params=fe, ln_params=ln, buffer_capacity=16, reprojection_fanout=4, mesh=mesh,
                        device="cuda")
        out[name] = run_mesh_scenario(rt)
    return out
