"""The `stego` pipeline (the Jackal's STEGO model): a whole CPU run of its
tiny cell through the harness reads `correct` true and its control false,
and its counts at the published widths are pinned."""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
STEGO = harness.load_pipeline({"pipeline": "stego"})


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_tiny(control: bool = False) -> dict:
    cfg = json.loads((DATA / "tiny_stego_vitb8_224.json").read_text())
    mix = json.loads((DATA / "online.json").read_text())
    limits = json.loads((DATA / "limits_tiny_stego.json").read_text())["limits"]
    res, _ = harness.run(cfg, mix, limits, [], [], 2**31 + 505, 2.0, False, "cpu", time.perf_counter(),
                         control=control)
    return res


def test_tiny_stego_cell_runs_correct():
    res = run_tiny()
    assert res["correct"], res["checks"]
    assert {"trav_gap", "seg_diff", "feat_rel", "step_gap"} <= set(res["checks"])


def test_tiny_stego_control_is_not_correct():
    res = run_tiny(control=True)
    low, limits = res["control"]["reference_low"], res["checks"]
    assert not res["correct"]
    assert low["trav_gap"] > limits["trav_gap"]["limit"] and low["seg_diff"] > limits["seg_diff"]["limit"]


def test_counts_at_the_published_widths():
    cfg = json.loads((ROOT / "portbench" / "configs" / "stego_vitb8_224.json").read_text())
    # ViT-B/8 at 224: per block 2*785*768*2304 + 4*785^2*768 + 2*785*768^2 + 4*785*768*3072 = 13,005,327,360
    # (x 12), patch embedding 2*784*192*768 = 231,211,008: 156.295 GFLOP
    assert STEGO.dino.vit_flops(cfg) == 12 * 13_005_327_360 + 231_211_008 == 156_295_139_328
    # the code head on 784 patches: 2*(768*90 + 768*768 + 768*90) = 1,456,128 each
    assert STEGO.code_head_flops(cfg) == 784 * 1_456_128
    # the head on the code at every pixel: 2*(90*256 + 256*32 + 32*91) = 68,288
    assert STEGO.head_flops(cfg) == 68_288 * 224 * 224
    assert STEGO.frame_flops(cfg) == 156_295_139_328 + 784 * 1_456_128 + 68_288 * 224 * 224
    mix = json.loads((ROOT / "portbench" / "traffic" / "online.json").read_text())
    assert STEGO.kernel_shapes(cfg, mix) == {"k1": (1, 12, 785, 64), "k2": (1, 28, 224, 224, 256, 32)}
    assert STEGO.num_segments(cfg) == 20


def test_the_reference_draws_the_ports_initial_centres():
    """The plain reference writes out the port's k-means draw (a permutation
    from a generator seeded 0) rather than importing it."""
    from wild_visual_navigation_tpu_torch.models.stego_head import kmeans_init_indices

    for n, s in ((784, 20), (64, 20), (16, 4)):
        assert torch.equal(STEGO.kmeans_init(n, s), kmeans_init_indices(torch.Generator().manual_seed(0), n, s))
