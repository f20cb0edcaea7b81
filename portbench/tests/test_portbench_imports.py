"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference, the pipelines' references and their counts import nothing of
the port. Top-level module names are compared
whole: the port's name begins with the JAX package's."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

HARNESS = """
import sys, json
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from portbench import harness, system, trace, counts, check, traffic, weights, reference
from portbench.run import cell_spec
cfg = json.load(open({root!r} + "/portbench/tests/data/tiny_dino.json"))
mix = json.load(open({root!r} + "/portbench/tests/data/online.json"))
pipe = harness.load_pipeline(cfg)
rt = pipe.build_runtime(cfg, mix, pipe.make_weights(cfg, 3, "cpu"), "cpu", None)
for name in ("frame_p50_ms.online", "k1_roofline.frames", "mfu.frames"):
    harness.load_metric(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import sys, json
sys.path.insert(0, {root!r})
import portbench.reference
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

PIPELINES = """
import sys, json, pathlib
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from portbench import harness, reference
pb = pathlib.Path({root!r}) / "portbench"
cfgs = [json.loads(p.read_text()) for p in sorted((pb / "configs").glob("*.json"))]
tiny = [json.loads(p.read_text()) for p in sorted((pb / "tests" / "data").glob("tiny_*.json"))]
mix = json.loads((pb / "traffic" / "frames.json").read_text())
ran = []
for path in sorted((pb / "pipelines").glob("*.py")):
    pipe = harness.load_pipeline({{"pipeline": path.stem}})
    for cfg in cfgs + tiny:
        if cfg.get("pipeline", "dino") == path.stem:
            pipe.frame_flops(cfg), pipe.kernel_shapes(cfg, mix), pipe.num_segments(cfg)
    for cfg in tiny:
        if cfg.get("pipeline", "dino") == path.stem:
            w = pipe.make_weights(cfg, 3, "cpu")
            img = torch.randint(0, 256, (3, 40, 48), dtype=torch.uint8, generator=torch.Generator().manual_seed(1))
            pipe.frame(cfg, w, w["head"], torch.tensor(0.9), torch.tensor(0.3), img, reference.Prec(False))
            ran.append(path.stem)
print(json.dumps(sorted(set(ran))))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def printed(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], capture_output=True, text=True,
                         timeout=300, check=True)
    return out.stdout.strip().splitlines()


def top_level(code: str) -> set:
    return set(json.loads(printed(code)[-1]))


def test_harness_and_port_load_no_jax():
    mods = top_level(HARNESS)
    assert "wild_visual_navigation_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "wild_visual_navigation_tpu"}


def test_pipelines_reference_and_counts_import_nothing_of_the_port():
    """Each pipeline module, loaded, its weights, its plain frame on a
    CPU-sized configuration and its counts."""
    *_, ran, mods = printed(PIPELINES)
    assert not set(json.loads(mods)) & {"wild_visual_navigation_tpu_torch", "wild_visual_navigation_tpu", "jax",
                                        "jaxlib", "flax"}
    assert json.loads(ran) == sorted(p.stem for p in (ROOT / "portbench" / "pipelines").glob("*.py"))


def test_reference_imports_nothing_of_the_port():
    mods = top_level(REFERENCE)
    assert not mods & {"wild_visual_navigation_tpu_torch", "wild_visual_navigation_tpu", "jax", "jaxlib", "flax"}
