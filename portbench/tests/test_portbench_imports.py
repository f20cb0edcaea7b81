"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Top-level module names are compared
whole: the port's name begins with the JAX package's."""

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
vit, head = weights.make_weights(cfg, 3, "cpu")
rt = system.build_runtime(cfg, mix, vit, head, "cpu")
for name in ("frame_p50_ms", "k1_roofline.frames", "mfu.frames"):
    harness.load_metric(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import sys, json
sys.path.insert(0, {root!r})
import portbench.reference
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], capture_output=True, text=True,
                         timeout=300, check=True)
    import json

    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_port_load_no_jax():
    mods = top_level(HARNESS)
    assert "wild_visual_navigation_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "wild_visual_navigation_tpu"}


def test_reference_imports_nothing_of_the_port():
    mods = top_level(REFERENCE)
    assert not mods & {"wild_visual_navigation_tpu_torch", "wild_visual_navigation_tpu", "jax", "jaxlib", "flax"}
