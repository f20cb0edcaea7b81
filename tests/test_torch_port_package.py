"""Shape of the torch port as a package: no JAX anywhere in it, every
module importable without JAX, CPU tensors never reaching the CUDA
loader, the converted demo head, and the copied configuration."""

import ast
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wild_visual_navigation_tpu_torch as port
from wild_visual_navigation_tpu_torch.ops import _cuda

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "wild_visual_navigation_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "wild_visual_navigation_tpu", "torchvision"}
HEAD_NPZ = ROOT / "assets/checkpoints/replay_demo_head_torch.npz"
HEAD_CKPT = ROOT / "assets/checkpoints/replay_demo_head.ckpt"


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 20
    new = {"ops/histogram.py", "ops/optical_flow.py", "feature_extractor/sift.py", "models/linear_rnvp.py",
           "models/simple_gcn.py", "visu/visualizer.py", "visu/markers.py", "scripts/overlay_images.py",
           "runtime/demo_golden.py", "models/resnet.py", "models/efficientnet.py",
           "feature_extractor/torchvision_interface.py", "ops/gridmap.py", "scripts/smart_carrot.py",
           "offline/metrics.py", "offline/dataset.py", "offline/loggers.py", "offline/trainer.py",
           "offline/reference_graph.py", "utils/timers.py", "utils/device_monitor.py", "tools/param_search.py",
           "tools/generate_dataset.py", "tools/ablation_sweep.py", "tools/real_data_eval.py", "tools/soak.py",
           "parallel/mesh.py", "parallel/distributed.py", "parallel/launch.py", "runtime/mesh_scenario.py",
           "tools/dryrun_multiprocess.py"}
    assert new <= {str(f.relative_to(PKG)) for f in files if PKG in f.parents}
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN) for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_every_port_module_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for name in {sorted(FORBIDDEN)!r}: sys.modules[name] = None\n"
        "import wild_visual_navigation_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "print(len(mods))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_cpu_tensors_never_touch_the_cuda_loader(monkeypatch):
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.ops.flash_attention import flash_attention
    from wild_visual_navigation_tpu_torch.ops.pixelwise_fused import pixelwise_score_fused
    from wild_visual_navigation_tpu_torch.ops.rasterize import rasterize_points_hull
    from wild_visual_navigation_tpu_torch.ops.slic import slic_batch

    def refuse(*a, **k):
        raise AssertionError("the CUDA loader was reached from CPU tensors")

    monkeypatch.setattr(_cuda, "library", refuse)
    monkeypatch.setattr(_cuda, "build", refuse)
    port.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 70, 64, generator=g)
    assert flash_attention(q, q, q, 0.125).shape == q.shape
    assert slic_batch(torch.rand(1, 3, 32, 32, generator=g), num_components=8, iterations=2).shape == (1, 32, 32)
    mlp = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 16, "hidden_sizes": [16, 32, 1],
                                                             "reconstruction": True}}, generator=g)
    trav, reco = pixelwise_score_fused(mlp, torch.randn(1, 16, 4, 4, generator=g), 20, 20)
    assert trav.shape == reco.shape == (1, 20, 20)
    pts = torch.tensor([[[2.0, 3.0], [12.0, 3.0], [12.0, 9.0], [2.0, 9.0]]])
    assert int(rasterize_points_hull(pts, torch.ones((1, 4), dtype=torch.bool), 16, 20).sum()) == 77
    assert port.launch_counts() == {"flash_attention": 0, "pixelwise_score": 0, "slic_step": 0, "fill_hulls": 0}


def test_kernel_wrappers_refuse_other_devices():
    from wild_visual_navigation_tpu_torch.ops.pixelwise_fused import FusedOperands, score_pixels
    from wild_visual_navigation_tpu_torch.ops.slic_fused import slic_step

    m = torch.empty((1, 5, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        slic_step(m, torch.empty((1, 4, 5), device="meta"), 8, 1.0, 1.0)
    ops = FusedOperands(*(torch.empty(2, device="meta") for _ in FusedOperands._fields))
    with pytest.raises(ValueError, match="unsupported device"):
        score_pixels(ops, 16)
    from wild_visual_navigation_tpu_torch.ops.rasterize_fill import fill_hulls

    with pytest.raises(ValueError, match="unsupported device"):
        fill_hulls(torch.empty((2, 8, 2), device="meta"), torch.empty((2, 8), dtype=torch.bool, device="meta"), 4, 4)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_hull_fill_takes_only_cuda_tensors(device):
    """K4 from points has no plain route of its own: rasterize_points_hull
    sends CPU tensors to convex_hull and the plain fill, and hull_fill
    raises for anything but a CUDA tensor."""
    from wild_visual_navigation_tpu_torch.ops.rasterize_fill import hull_fill

    with pytest.raises(ValueError, match="unsupported device"):
        hull_fill(torch.zeros((2, 8, 2), device=device), torch.ones((2, 8), dtype=torch.bool, device=device), 4, 4)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_hull_masks_takes_only_cuda_tensors(device):
    """The flush's K4 route (masks only) raises for anything but a CUDA
    tensor, as hull_fill does."""
    from wild_visual_navigation_tpu_torch.ops.rasterize_fill import hull_masks

    with pytest.raises(ValueError, match="hull_masks: unsupported device"):
        hull_masks(torch.zeros((2, 8, 2), device=device), torch.ones((2, 8), dtype=torch.bool, device=device), 4, 4)


def test_build_is_keyed_on_the_sources():
    assert _cuda.BUILD_DIR.parent == PKG / "csrc"
    assert {p.name for p in _cuda.CSRC.glob("*.cu")} == {"flash_attention.cu", "pixelwise_score.cu", "slic_step.cu",
                                                        "fill_hulls.cu"}
    assert set(_cuda.SIGNATURES) >= {f"wvn_{n}" for n in ("flash_attention_fwd", "pixelwise_score", "slic_step",
                                                           "fill_hulls")}
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS
    assert len(_cuda._digest()) == 16
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "wild_visual_navigation_tpu_torch/csrc/_build/" in ignored


def test_build_compiles_each_source_in_parallel_then_links(tmp_path, monkeypatch):
    """One `nvcc -c` per source, all started before any is waited for, then
    one link into the hashed library (nvcc replaced by a script that logs
    its arguments and writes its output file)."""
    log = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    f"echo \"$*\" >> {log}\n"
                    "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then touch \"$2\"; fi; shift; done\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "_build")
    lib = _cuda.build()
    assert lib.exists() and lib.parent == tmp_path / "_build" and _cuda._digest() in lib.name
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    assert len(compiles) == len(_cuda._sources()) == 4 and all("sm_90a" in c for c in calls)
    assert len(calls) == 5 and "-shared" in calls[-1]
    assert _cuda.build() == lib and len(log.read_text().splitlines()) == 5  # cached: no second build


def test_converted_head_matches_flax_checkpoint():
    """assets/checkpoints/replay_demo_head_torch.npz holds exactly the
    flax checkpoint's numbers, and the port's head computes what the
    flax head computes from them."""
    from flax import serialization

    from wild_visual_navigation_tpu.models import get_model as jget_model
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.utils.params import (
        confidence_state_from_jax,
        load_head_npz,
        mlp_state_from_jax,
    )

    with open(HEAD_CKPT, "rb") as f:
        payload = pickle.load(f)
    want_params = serialization.msgpack_restore(payload["params"])["params"]
    want_cg = serialization.msgpack_restore(payload["cg_state"])
    params, cg, step = load_head_npz(HEAD_NPZ)
    assert step == payload["step"]
    assert set(params["params"]) == set(want_params)
    for layer, leaves in want_params.items():
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(params["params"][layer][leaf], np.asarray(value))
    assert set(cg) == set(want_cg)
    for field, value in want_cg.items():
        np.testing.assert_array_equal(cg[field], np.asarray(value))

    cfg = {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 384, "hidden_sizes": [256, 32, 1],
                                                   "reconstruction": True}}
    tm = get_model(cfg)
    tm.load_state_dict(mlp_state_from_jax(params))
    x = np.random.default_rng(0).standard_normal((64, 384)).astype(np.float32)
    want = np.asarray(jget_model(cfg).apply({"params": want_params}, x))
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want, atol=1e-5)
    st = confidence_state_from_jax(cg)
    assert float(st.std) == pytest.approx(float(want_cg["std"])) and st.window_ptr.dtype == torch.int32


def test_double_mlp_params_bridge():
    from wild_visual_navigation_tpu.models import get_model as jget_model
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.utils.params import mlp_state_from_jax

    cfg = {"name": "DoubleMLP", "double_mlp_cfg": {"input_size": 24, "hidden_sizes": [16, 8, 1]}}
    jm = jget_model(cfg)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 24))))
    tm = get_model(cfg)
    tm.load_state_dict(mlp_state_from_jax(params))
    x = np.random.default_rng(1).standard_normal((10, 24)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), np.asarray(jm.apply(params, x)), atol=1e-5)


def test_unported_heads_name_their_roadmap_item():
    """Every head of the JAX registry is ported (the graph head and the
    anomaly flow came with ROADMAP.md item 22): each builds at its config
    defaults and an unknown name is refused."""
    from wild_visual_navigation_tpu.models.registry import _MODELS as JMODELS
    from wild_visual_navigation_tpu_torch.models.registry import _MODELS, get_model, model_needs_edges

    assert set(_MODELS) == set(JMODELS)
    for name in ("SimpleGCN", "LinearRnvp"):
        m = get_model({"name": name})
        assert type(m).__name__ == name and model_needs_edges(m) == (name == "SimpleGCN")
    with pytest.raises(ValueError, match="not registered"):
        get_model({"name": "NoSuchHead"})


def test_copied_config_matches_jax_but_for_the_device():
    from wild_visual_navigation_tpu.cfg import node_params as jnp_
    from wild_visual_navigation_tpu.utils.operation_modes import WVNMode as JMode
    from wild_visual_navigation_tpu_torch.cfg import node_params as tnp
    from wild_visual_navigation_tpu_torch.utils.operation_modes import WVNMode as TMode

    for cls in ("LearningNodeParams", "FeatureExtractorNodeParams"):
        j = dataclasses.asdict(getattr(jnp_, cls)())
        t = dataclasses.asdict(getattr(tnp, cls)())
        assert t.pop("device") == "cuda" and j.pop("device") == "tpu"
        assert {k: (v.name if hasattr(v, "name") else v) for k, v in t.items()} == \
               {k: (v.name if hasattr(v, "name") else v) for k, v in j.items()}
    assert [m.name for m in TMode] == [m.name for m in JMode]
    assert TMode.from_string("online") is TMode.ONLINE


def test_quick_start_runs_on_cpu(tmp_path):
    from wild_visual_navigation_tpu_torch import quick_start

    quick_start.main(["--device", "cpu", "--max_frames", "1", "--network_input_image_height", "64",
                      "--network_input_image_width", "64", "--slic_num_components", "16",
                      "--output_folder", str(tmp_path)])
    assert len(list(tmp_path.glob("*_trav.png"))) == 1


def test_quick_start_runs_the_jackal_stego_profile_on_cpu(tmp_path, capsys):
    """The Jackal robot's profile (stego features and segments) through the
    YAML loader, at 32 px: the STEGO frame end to end."""
    from wild_visual_navigation_tpu_torch import quick_start

    argv = ["--config", str(ROOT / "configs/default.yaml"), "--config", str(ROOT / "configs/robots/jackal.yaml"),
            "--device", "cpu", "--max_frames", "1", "--network_input_image_height", "32",
            "--network_input_image_width", "32", "--output_folder", str(tmp_path)]
    args = quick_start.parse_args(argv)
    assert (args.feature_type, args.segmentation_type, args.network_input_image_height) == ("stego", "stego", 32)
    quick_start.main(argv)
    assert len(list(tmp_path.glob("*_trav.png"))) == 1


def test_node_profiles_load_as_in_jax(tmp_path):
    """utils/loading.py (a copy of the JAX package's) builds the same node
    parameters from the same YAML stack, and refuses unknown keys."""
    from wild_visual_navigation_tpu.utils.loading import load_node_params as jload
    from wild_visual_navigation_tpu_torch.utils.loading import load_node_params as tload

    paths = [str(ROOT / "configs/default.yaml"), str(ROOT / "configs/robots/jackal.yaml")]
    fe, ln = tload(*paths)
    for t, j in zip((fe, ln), jload(*paths)):
        t, j = dataclasses.asdict(t), dataclasses.asdict(j)
        assert t.pop("device") == "cuda" and j.pop("device") == "tpu"
        assert {k: (v.name if hasattr(v, "name") else v) for k, v in t.items()} == \
               {k: (v.name if hasattr(v, "name") else v) for k, v in j.items()}
    assert (fe.feature_type, fe.segmentation_type, ln.robot_length) == ("stego", "stego", 0.5)
    bad = tmp_path / "bad.yaml"
    bad.write_text("feature_type: stego\nno_such_param: 1\n")
    with pytest.raises(KeyError, match="unknown node param"):
        tload(str(bad))
