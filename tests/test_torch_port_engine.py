"""The torch port's AOT engine (feature_extractor/aot_engine.py,
tools/export_engine.py) and K1 as the operator `wvn::flash_attention`, on
the CPU, against the JAX package's AOTEngine where both have one.

An engine is exported with torch.export at its fixed input shape, compiled
with AOTInductor into a package saved beside the engine spec, and loaded in
a fresh process, which imports no model code and compiles nothing (no
subprocess, nothing written to Inductor's cache): its output equals the
engine's in the building process bit for bit (the same compiled code).
Against the eager pipeline the compiled program rounds where its fused
kernels round: in fp32 within ENGINE_FP32_ATOL, in bf16 within
ENGINE_JAX_ATOL (the band two frameworks' bf16 ViTs are held to), and with
int8 products within the int8 runtime's limits on the traversability map
(an fp32 ulp flips an int8 rounding now and then, and the flips spread).
Against JAX's engine on the same weights (DINO ViT-S/8 at 32 px, bf16
compute, a SimpleMLP [384, 256, 32, 1] head with reconstruction) the
traversability per patch is held to ENGINE_JAX_ATOL, as
tests/test_torch_port_attention_vit.py's bf16 ViT test allows."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from wild_visual_navigation_tpu.feature_extractor.aot_engine import AOTEngine as JEngine
from wild_visual_navigation_tpu.models import get_model as jget_model
from wild_visual_navigation_tpu.models.vit import dense_features as jdense_features
from wild_visual_navigation_tpu.models.vit import make_vit as jmake_vit
from wild_visual_navigation_tpu_torch.feature_extractor import aot_engine
from wild_visual_navigation_tpu_torch.models.registry import get_model
from wild_visual_navigation_tpu_torch.models import vit as tvit
from wild_visual_navigation_tpu_torch.models.vit import calibrate_int8_static
from wild_visual_navigation_tpu_torch.ops import _cuda
from wild_visual_navigation_tpu_torch.ops.flash_attention import flash_attention, xla_attention
from wild_visual_navigation_tpu_torch.tools.export_engine import (
    EnginePipeline,
    build_pipeline,
    export_pipeline,
    pipeline_flops,
)
from wild_visual_navigation_tpu_torch.utils.params import mlp_state_from_jax, vit_state_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
ENGINE_JAX_ATOL = 6e-3  # sigmoid traversability per patch, bf16 ViTs of two frameworks (measured 1.8e-3 to 2.9e-3)
ENGINE_FP32_ATOL = 1e-5  # the compiled fp32 program against eager: fused kernels' summation order
INT8_TRAV_MEAN, INT8_TRAV_MAX = 2e-2, 2e-1  # an int8 pipeline against another on the same weights (chip_smoke.py's QUANT_CPU_TOL)
FLOPS_RTOL = 0.01
# Loads an engine in a fresh process and runs it on a saved input; prints the refusal, the modules imported,
# the subprocesses started and what Inductor's cache (an empty directory) holds afterwards.
LOADER = textwrap.dedent("""
    import json, os, subprocess, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    spawned = []
    popen = subprocess.Popen.__init__
    subprocess.Popen.__init__ = lambda self, *a, **kw: spawned.append(str(a[:1])[:200]) or popen(self, *a, **kw)
    from wild_visual_navigation_tpu_torch.feature_extractor.aot_engine import load_engine, load_engine_spec
    spec, x_path, out_path = sys.argv[1:4]
    engine = load_engine(spec)
    _, shape, dtype, meta = load_engine_spec(spec)
    out = engine(torch.from_numpy(np.load(x_path)))
    np.save(out_path, out.numpy())
    try:
        engine(torch.zeros(shape[0], 3, shape[2] + 8, shape[3] + 8))
        refused = ""
    except ValueError as e:
        refused = str(e)
    cache = [f for _, _, fs in os.walk(os.environ["TORCHINDUCTOR_CACHE_DIR"]) for f in fs]
    print(json.dumps({"shape": list(shape), "dtype": dtype, "meta": meta, "refused": refused, "spawned": spawned,
                      "inductor_cache": cache, "flops": engine.flops,
                      "modules": sorted(m for m in sys.modules if m.startswith("wild_visual_navigation_tpu"))}))
""")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine's cores;
    torch's own pool of a thread per core on top of them oversubscribes the
    cores, and small ops then wait tens of times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    return {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}


def _load_in_fresh_process(spec: str, x: np.ndarray, tmp_path) -> tuple[np.ndarray, dict]:
    """The engine's output in a fresh process, and what that process saw;
    it must have compiled nothing."""
    np.save(tmp_path / "x.npy", x)
    cache = tmp_path / "inductor_cache"
    cache.mkdir()
    out = subprocess.run([sys.executable, "-c", LOADER, spec, str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
                         capture_output=True, text=True, cwd=ROOT, env={**_env(), "TORCHINDUCTOR_CACHE_DIR": str(cache)},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout.strip().splitlines()[-1])
    assert info["spawned"] == [] and info["inductor_cache"] == [], info
    return np.load(tmp_path / "y.npy"), info


# ------------------------------------------------------------------ the operator


@pytest.mark.parametrize("layout", ["contiguous", "qkv-views"])
def test_flash_attention_fake_matches_the_cpu_call(layout):
    """The operator's fake version (what torch.export traces) gives the
    real CPU call's shape, dtype and strides: contiguous (B, H, S, D). The
    CUDA layout, a (B, H, S, D) view of a (B, S, H, D) buffer, is held on
    the card (tests/test_torch_port_gpu.py)."""
    if layout == "contiguous":
        q, k, v = (torch.randn(2, 3, 40, 64) for _ in range(3))
    else:  # (B, H, S, D) views of a (B, S, 3, H, D) qkv product, as Attention hands them
        q, k, v = torch.randn(2, 40, 3, 3, 64).permute(2, 0, 3, 1, 4).unbind(0)
    real = flash_attention(q, k, v, 0.125)
    np.testing.assert_array_equal(real.numpy(), xla_attention(q, k, v, 0.125).numpy())
    with FakeTensorMode() as mode:
        fake = torch.ops.wvn.flash_attention(*(mode.from_tensor(t) for t in (q, k, v)), 0.125)
    assert (fake.shape, fake.dtype, fake.stride()) == (real.shape, real.dtype, real.stride())
    assert real.is_contiguous()


# ------------------------------------------------------------------ AOTEngine


def _mlp(D=16):
    return get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": D, "hidden_sizes": [32, 1],
                                                              "reconstruction": True}},
                     generator=torch.Generator().manual_seed(0)).eval().requires_grad_(False)


def test_aot_engine_executes_and_checks_shapes():
    """JAX's test: the engine gives the module's output and refuses another
    shape with JAX's message; its flops are the two layers' 2·M·N·K."""
    m = _mlp()
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(1))
    eng = aot_engine.AOTEngine(m, x)
    assert eng.input_shape == (8, 16) and eng.input_dtype == torch.float32 and eng.compile_seconds > 0
    with torch.no_grad():
        assert torch.equal(eng(x), m(x))
    with pytest.raises(ValueError, match=r"AOTEngine expects \(8, 16\), got \(4, 16\)"):
        eng(torch.zeros(4, 16))
    assert eng.flops == 2 * 8 * (16 * 32 + 32 * 17)
    assert eng.memory_analysis() is None  # no card
    fn_eng = aot_engine.AOTEngine(lambda t: m(t)[:, 0], x)  # a function of the input alone
    with torch.no_grad():
        assert torch.equal(fn_eng(x), m(x)[:, 0])


def test_engine_spec_roundtrip(tmp_path):
    """JAX's test: params, input shape and meta survive save and load
    (torch.load with weights_only)."""
    m = _mlp()
    path = str(tmp_path / "engine.spec")
    aot_engine.save_engine_spec(path, m.state_dict(), (8, 16), "torch.float32", {"model": "SimpleMLP"})
    params, shape, dtype, meta = aot_engine.load_engine_spec(path)
    assert shape == (8, 16) and dtype == "torch.float32" and meta["model"] == "SimpleMLP"
    for k, v in m.state_dict().items():
        assert torch.equal(params[k], v)
    assert not os.path.exists(aot_engine.program_path(path))


def test_enable_persistent_cache_moves_the_kernel_build(tmp_path, monkeypatch):
    """The kernel library is built and found in the given directory; once
    it is loaded the directory can no longer change."""
    monkeypatch.setattr(_cuda, "BUILD_DIR", _cuda.BUILD_DIR)
    monkeypatch.setattr(_cuda, "_lib", None)
    cache = tmp_path / "kernels"
    assert aot_engine.enable_persistent_cache(str(cache)) == cache.resolve() and cache.is_dir()
    assert _cuda.BUILD_DIR == cache.resolve()
    monkeypatch.setattr(_cuda, "_lib", object())
    with pytest.raises(RuntimeError, match="already loaded"):
        aot_engine.enable_persistent_cache(str(tmp_path / "other"))


# ------------------------------------------------------------------ the exported pipeline


def test_export_engine_tool_reloads_bit_equal_in_a_fresh_process(tmp_path):
    """`python -m ...tools.export_engine` (DINO ViT-S/8 at 32 px on the CPU)
    writes the spec and the compiled package; a fresh process loads the
    package with no model code and compiles nothing, and its output equals
    the package loaded here bit for bit, and the eager pipeline built from
    the spec's weights within ENGINE_JAX_ATOL (bf16); another shape is
    refused."""
    spec = str(tmp_path / "engines" / "dino_s8_32.spec")
    out = subprocess.run([sys.executable, "-m", "wild_visual_navigation_tpu_torch.tools.export_engine", "--backbone",
                          "dino", "--patch_size", "8", "--size", str(SIZE), "--device", "cpu", "--out", spec],
                         capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    assert "engine spec:" in out.stdout and os.path.exists(aot_engine.program_path(spec))
    x = np.random.default_rng(0).random((1, 3, SIZE, SIZE), dtype=np.float32)
    got, info = _load_in_fresh_process(spec, x, tmp_path)
    assert info["shape"] == [1, 3, SIZE, SIZE] and info["dtype"] == "torch.float32" and info["meta"]["size"] == SIZE
    assert info["refused"] == f"AOTEngine expects (1, 3, {SIZE}, {SIZE}), got (1, 3, {SIZE + 8}, {SIZE + 8})"
    assert not any(".models" in m or ".tools" in m for m in info["modules"]), info["modules"]
    params, *_ = aot_engine.load_engine_spec(spec)
    pipe = build_pipeline("dino", "vit_small", 8, "cpu")
    pipe.vit.load_state_dict(params["vit"])
    pipe.head.load_state_dict(params["head"])
    with torch.no_grad():
        want = pipe(torch.from_numpy(x)).numpy()
    assert got.shape == (1, SIZE // 8, SIZE // 8)
    np.testing.assert_array_equal(got, aot_engine.load_engine(spec)(torch.from_numpy(x)).numpy())
    np.testing.assert_allclose(got, want, atol=ENGINE_JAX_ATOL)


def test_engine_matches_jax_aot_engine(tmp_path):
    """The root tool's pipeline on both sides with JAX's weights: the port's
    engine, saved and reloaded in a fresh process, equals the engine that
    compiled it bit for bit, and its eager pipeline and JAX's AOTEngine
    within ENGINE_JAX_ATOL; its flops, counted on the exported program
    (with K1 as 12 operator nodes), are within 1 % of the analytic count,
    and the reloaded engine reports the same."""
    key = jax.random.PRNGKey(0)
    jvit = jmake_vit("dino", "vit_small", 8)
    vit_params = jvit.init(key, jnp.zeros((1, 3, SIZE, SIZE)))
    jmlp = jget_model({"name": "SimpleMLP",
                       "simple_mlp_cfg": {"input_size": 384, "hidden_sizes": [256, 32, 1], "reconstruction": True}})
    mlp_params = jmlp.init(jax.random.fold_in(key, 1), jnp.zeros((1, 384)))

    def pipeline(params, imgs):
        feat = jdense_features(jvit, params[0], imgs)
        B, D, Hp, Wp = feat.shape
        return jmlp.apply(params[1], feat.transpose(0, 2, 3, 1).reshape(-1, D))[:, 0].reshape(B, Hp, Wp)

    x = np.random.default_rng(1).random((1, 3, SIZE, SIZE), dtype=np.float32)
    want_jax = np.asarray(JEngine(pipeline, (vit_params, mlp_params), jnp.asarray(x))(jnp.asarray(x)))

    pipe = build_pipeline("dino", "vit_small", 8, "cpu")
    pipe.vit.load_state_dict(vit_state_from_jax(jax.tree_util.tree_map(np.asarray, vit_params)))
    pipe.head.load_state_dict(mlp_state_from_jax(jax.tree_util.tree_map(np.asarray, mlp_params)))
    eng = export_pipeline(pipe, SIZE, 1)
    spec = str(tmp_path / "engine.spec")
    aot_engine.save_engine_spec(spec, {"vit": pipe.vit.state_dict(), "head": pipe.head.state_dict()},
                                eng.input_shape, str(eng.input_dtype), {"size": SIZE}, engine=eng)
    got, info = _load_in_fresh_process(spec, x, tmp_path)
    with torch.no_grad():
        eager = pipe(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, eng(torch.from_numpy(x)).numpy())
    np.testing.assert_allclose(got, eager, atol=ENGINE_JAX_ATOL)
    np.testing.assert_allclose(got, want_jax, atol=ENGINE_JAX_ATOL)
    assert abs(eng.flops / pipeline_flops(pipe, SIZE, 1) - 1) < FLOPS_RTOL and info["flops"] == eng.flops
    assert sum(n.target is torch.ops.wvn.flash_attention.default for n in eng.program.graph.nodes) == 12


def test_int8_static_engine_reloads_bit_equal(tmp_path):
    """An int8_static pipeline built and calibrated through the API exports
    with its 48 int8 products as _int_mm nodes and compiles; reloaded in a
    fresh process it equals the engine that compiled it bit for bit, and
    the eager pipeline within the int8 limits (INT8_TRAV_MEAN,
    INT8_TRAV_MAX); its flops are within 1 % of the analytic count (int8
    operations counted as the fp ones)."""
    pipe = build_pipeline("dino", "vit_small", 8, "cpu", quant="int8_static")
    rng = np.random.default_rng(2)
    calibrate_int8_static(pipe.vit, [torch.from_numpy(rng.random((2, 3, SIZE, SIZE), dtype=np.float32))])
    eng = export_pipeline(pipe, SIZE, 1)
    assert sum(n.target is torch.ops.aten._int_mm.default for n in eng.program.graph.nodes) == 48
    spec = str(tmp_path / "engine_int8.spec")
    aot_engine.save_engine_spec(spec, {"vit": pipe.vit.state_dict(), "head": pipe.head.state_dict()},
                                eng.input_shape, str(eng.input_dtype), {"quant": "int8_static"}, engine=eng)
    x = rng.random((1, 3, SIZE, SIZE), dtype=np.float32)
    got, info = _load_in_fresh_process(spec, x, tmp_path)
    with torch.no_grad():
        want = pipe(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, eng(torch.from_numpy(x)).numpy())
    d = np.abs(got - want)
    assert np.isfinite(got).all() and d.mean() < INT8_TRAV_MEAN and d.max() < INT8_TRAV_MAX
    assert info["meta"] == {"quant": "int8_static"}
    assert abs(eng.flops / pipeline_flops(pipe, SIZE, 1) - 1) < FLOPS_RTOL


def test_compiled_fp32_engine_matches_eager_and_refuses_other_shapes(tmp_path):
    """A compiled engine of a depth-1 ViT-S/8 pipeline in fp32 at 32 px:
    within ENGINE_FP32_ATOL of its eager pipeline, in this process and
    reloaded in a fresh one that compiles nothing (the loader's checks);
    another shape refused in both."""
    cfg = tvit.ViTConfig(patch_size=8, embed_dim=384, depth=1, num_heads=6, pos_grid_size=28, layerscale_init=None)
    vit = tvit.VisionTransformer(cfg, dtype=torch.float32, device="cpu", generator=torch.Generator().manual_seed(3))
    pipe = EnginePipeline(vit, _mlp(384)).eval().requires_grad_(False)
    eng = export_pipeline(pipe, SIZE, 1)
    x = np.random.default_rng(4).random((1, 3, SIZE, SIZE), dtype=np.float32)
    with torch.no_grad():
        want = pipe(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(eng(torch.from_numpy(x)).numpy(), want, atol=ENGINE_FP32_ATOL)
    with pytest.raises(ValueError, match=r"AOTEngine expects \(1, 3, 32, 32\), got \(1, 3, 40, 40\)"):
        eng(torch.zeros(1, 3, 40, 40))
    spec = str(tmp_path / "engine_fp32.spec")
    aot_engine.save_engine_spec(spec, {"vit": vit.state_dict()}, eng.input_shape, str(eng.input_dtype), {}, engine=eng)
    got, info = _load_in_fresh_process(spec, x, tmp_path)
    np.testing.assert_allclose(got, want, atol=ENGINE_FP32_ATOL)
    assert info["refused"] == "AOTEngine expects (1, 3, 32, 32), got (1, 3, 40, 40)"
