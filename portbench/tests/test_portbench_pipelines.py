"""A configuration names its pipeline, `pipelines/<pipeline>.py`, and a new
one joins the benchmark as new files and appended entries only: a copy of
portbench/ with nothing but a pipeline module (the dino pipeline under
another name), a configuration naming it, a traffic mix and its limits
added, and a cell appended to BENCHMARK.json, runs a whole CPU run through
the copy's harness to `correct` true, with the check numbers that the dino
pipeline gives on the same samples. A configuration that names a missing
module, or a module that lacks a function of the interface, fails in
`load_cell`, naming the file."""

import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, trace  # noqa: E402
from portbench.run import load_cell  # noqa: E402
from portbench.tests.test_portbench_trace import Ev  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"

ALIAS = '''"""The dino pipeline under another name."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_pipeline_alias_dino", pathlib.Path(__file__).with_name("dino.py"))
_dino = importlib.util.module_from_spec(_s)
_s.loader.exec_module(_dino)
make_weights, build_runtime, frame = _dino.make_weights, _dino.build_runtime, _dino.frame
num_segments, frame_flops, kernel_shapes = _dino.num_segments, _dino.frame_flops, _dino.kernel_shapes
'''

RUN = """
import json, sys, time
sys.path[:0] = [{copy!r}, {root!r}]
import torch
torch.set_num_threads(1)
from portbench import check, harness, run
assert harness.__file__.startswith({copy!r}), harness.__file__
cell, e2e, per_layer, cfg, mix, limits = run.load_cell("tiny_alias.frames")
dino = harness.load_pipeline({{"pipeline": "dino"}})
compare, seen = check.compare, []

def both(rec, cfg, pipe, weights, traffic, control=False):
    out = compare(rec, cfg, pipe, weights, traffic, control)
    seen.append((pipe.__file__, out[0], compare(rec, cfg, dino, weights, traffic, control)[0]))
    return out

check.compare = both
res, _ = harness.run(cfg, mix, limits, e2e, per_layer, 2**31 + 303, 2.0, False, "cpu", time.perf_counter())
print(json.dumps({{"result": res, "file": seen[0][0], "alias": seen[0][1], "dino": seen[0][2]}}))
"""


def test_a_pipeline_added_as_new_files_runs_correct(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", copy / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny_alias.frames", "config": "tiny_alias", "traffic": "tiny_frames",
                               "chips": 1, "why": "the dino pipeline under another name"})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = copy / "portbench"
    new = {pb / "pipelines" / "alias.py": ALIAS,
           pb / "configs" / "tiny_alias.json": json.dumps(
               {**json.loads((DATA / "tiny_dino.json").read_text()), "name": "tiny_alias", "pipeline": "alias"}),
           pb / "traffic" / "tiny_frames.json": (DATA / "frames.json").read_text(),
           pb / "limits" / "tiny_alias.frames.json": json.dumps(
               {"limits": json.loads((DATA / "limits_tiny.json").read_text())["tiny_dino"]})}
    for path, text in new.items():
        assert not path.exists()
        path.write_text(text)
    out = subprocess.run([sys.executable, "-c", RUN.format(copy=str(copy), root=str(ROOT))], cwd=copy,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"] == str(pb / "pipelines" / "alias.py")
    assert got["result"]["correct"], got["result"]["checks"]
    assert got["alias"] == got["dino"] and set(got["alias"]) >= {"trav_gap", "seg_diff", "feat_rel"}
    assert "setup_s" in got["result"]["metrics"]


def cell_with(root: Path, cfg: dict, modules: dict) -> None:
    pb = root / "portbench"
    for sub in ("configs", "traffic", "limits", "pipelines"):
        (pb / sub).mkdir(parents=True)
    (root / "BENCHMARK.json").write_text(json.dumps(
        {"workloads": [{"name": "c.frames", "config": "c", "traffic": "frames", "chips": 1}], "end_to_end": [],
         "per_layer": []}))
    (pb / "configs" / "c.json").write_text(json.dumps({"name": "c", **cfg}))
    (pb / "traffic" / "frames.json").write_text("{}")
    (pb / "limits" / "c.frames.json").write_text('{"limits": {}}')
    for name, text in modules.items():
        (pb / "pipelines" / f"{name}.py").write_text(text)


@pytest.mark.parametrize("cfg,modules,message", [
    ({"pipeline": "nosuch"}, {}, r"no .*portbench/pipelines/nosuch\.py"),
    ({"pipeline": "partial"}, {"partial": "def make_weights(cfg, seed, device):\n    return {}\n"},
     r"portbench/pipelines/partial\.py lacks build_runtime, frame, num_segments, frame_flops, kernel_shapes"),
    ({}, {"dino": "frame = None\n"}, r"portbench/pipelines/dino\.py lacks make_weights, build_runtime, frame"),
])
def test_a_missing_pipeline_or_function_fails_in_load_cell(tmp_path, cfg, modules, message):
    cell_with(tmp_path, cfg, modules)
    with pytest.raises(SystemExit, match=message):
        load_cell("c.frames", tmp_path)


def test_a_kernel_the_frame_does_not_launch_reads_none():
    """The four-camera grid configuration scores at patch resolution: K1
    has a bound, K2 and K3 none, even where a trace holds their kernels."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "dinov2_vitb14_644_4cam.json").read_text())
    ev = [Ev("portbench.image_batch_callback", "CPU", 1000, 9000, tid=1, user=True)]
    for i, name in enumerate(("flash_fwd_bf16_kernel", "pixelwise_score_kernel", "slic_step_kernel")):
        ev += [Ev("cudaLaunchKernel", "CPU", 1100 + 10 * i, 5, corr=7 + i, tid=1),
               Ev(name, "CUDA", 2000 + 1000 * i, 500, corr=7 + i)]
    ctx = SimpleNamespace(trace=trace.reduce(ev, 0, 10_000), cfg=cfg, mix={"cameras": 4},
                          pipeline=harness.load_pipeline(cfg))
    assert harness.load_metric("k1_roofline.frames").read(ctx) > 0
    assert harness.load_metric("k2_roofline.frames").read(ctx) is None
    assert harness.load_metric("k3_roofline.frames").read(ctx) is None
