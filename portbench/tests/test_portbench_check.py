"""The check that decides `correct`, driven through a whole run on the CPU at
a tiny size: sound runs pass; the control (the program's int8 backbone, the
reference in low precision) and the faults a cell can have fail: a step
that leaves its state unchanged, half of a batch left out, an answer
altered where it is produced, a hot swap that publishes stale parameters. A run on the card of each cell's control is
marked `gpu`."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import faults, harness  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
LIMITS = json.loads((DATA / "limits_tiny.json").read_text())
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_tiny(cfg: str, mix: str, seed: int = 2**31 + 101, control: bool = False) -> dict:
    c = json.loads((DATA / f"{cfg}.json").read_text())
    m = json.loads((DATA / f"{mix}.json").read_text())
    res, _ = harness.run(c, m, LIMITS[cfg], [], [], seed, 2.0, False, "cpu", time.perf_counter(), control=control)
    return res


def failing(res: dict) -> set:
    return {k for k, v in res["checks"].items() if v["value"] is None or v["value"] > v["limit"]}


@pytest.mark.parametrize("cfg,mix", [("tiny_dino", "frames"), ("tiny_dinov2_4cam", "batch")])
def test_sound_run_is_correct(cfg, mix):
    res = run_tiny(cfg, mix)
    assert res["correct"], res["checks"]


def test_control_is_not_correct():
    res = run_tiny("tiny_dino", "frames", control=True)
    assert not res["correct"] and failing(res) & {"trav_gap", "conf_gap", "feat_rel"}
    low = res["control"]["reference_low"]
    assert low["seg_diff"] > LIMITS["tiny_dino"]["seg_diff"] and low["feat_rel"] > LIMITS["tiny_dino"]["feat_rel"]


@pytest.mark.parametrize("fault,cfg,mix,number", [
    ("frozen_step", "tiny_dinov2_4cam", "batch", "step_gap"),
    ("frozen_masks", "tiny_dinov2_4cam", "batch", "mask_diff"),
    ("half_batch", "tiny_dinov2_4cam", "batch", "loss_rel"),
    ("half_batch", "tiny_dinov2_4cam", "batch", "cg_gap"),
    ("half_cameras", "tiny_dinov2_4cam", "batch", "trav_gap"),
    ("altered_answer", "tiny_dino", "frames", "trav_gap"),
    ("stale_swap", "tiny_dinov2_4cam", "batch", "swap_gap"),
    ("stale_swap", "tiny_dino", "frames", "swap_gap"),
])
def test_fault_is_not_correct(fault, cfg, mix, number):
    handles = faults.plant(fault)
    try:
        res = run_tiny(cfg, mix)
    finally:
        faults.unplant(handles)
    assert not res["correct"] and number in failing(res), res["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2147483999",
                          "--seconds", "6", "--control", "1"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert not res["correct"]
