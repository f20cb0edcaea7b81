"""The FLOP and byte counts against values worked out by hand."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import counts, harness  # noqa: E402

DINO = harness.load_pipeline({"pipeline": "dino"})


def cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def test_tokens():
    assert DINO.tokens(cfg("dino_vits8_224")) == 28 * 28 + 1 == 785
    assert DINO.tokens(cfg("dinov2_vitb14_644_4cam")) == 46 * 46 + 1 == 2117


def test_k1_bound_at_vit_s8():
    # 4 B H S^2 D = 4 * 6 * 785^2 * 64 = 946,521,600 flops at 989 TFLOP/s: 0.957 us;
    # bytes 4 * 6 * 785 * 64 * 2 = 2,411,520 at 3.35 TB/s: 0.720 us
    assert counts.k1_bound_s(1, 6, 785, 64) == pytest.approx(946_521_600 / 989e12)
    assert counts.k1_bound_s(4, 12, 2117, 64) == pytest.approx(4 * 4 * 12 * 2117**2 * 64 / 989e12)


def test_k2_k3_k4_bounds_at_224():
    # K2, 224 x 224 from 28 patch rows: hw 28*224*256*2 = 3,211,264, zsts 28*224*35*4 = 878,080, tables
    # 224*4 + 224*32 = 8,064, weights 32*256*2 + 32*4 + 33*32*4 + 32*4 + 8 = 20,872, maps 2*50,176*4 = 401,408
    nbytes = 3_211_264 + 878_080 + 8_064 + 20_872 + 401_408
    assert counts.k2_bound_s(1, 28, 224, 224) == pytest.approx(nbytes / 3.35e12)
    # K3: 5*50,176*4 + 100*5*4 + 50,176*4 + 100*5*4 = 1,208,224 bytes
    assert counts.k3_bound_s(1, 224, 224, 100) == pytest.approx(1_208_224 / 3.35e12)
    # K4: 32*64*9 + 32*32*9 + 32*50,176 = 1,633,280 bytes
    assert counts.k4_bound_s(32, 224, 224) == pytest.approx(1_633_280 / 3.35e12)


def test_frame_flops():
    # ViT-S/8 at 224: per block 2*785*384*1152 + 4*785^2*384 + 2*785*384^2 + 4*785*384*1536 = 3,724,592,640
    # (x 12), patch embedding 2*784*192*384 = 115,605,504
    assert DINO.vit_flops(cfg("dino_vits8_224")) == 12 * 3_724_592_640 + 115_605_504
    # the head at every pixel: 2*(384*256 + 256*32 + 32*385) = 237,632 per pixel
    assert DINO.head_flops(cfg("dino_vits8_224")) == 237_632 * 224 * 224
    # ViT-B/14 at 644: per block 24*2117*768^2 + 4*2117^2*768; the head at 46 x 46 patches,
    # 2*(768*256 + 256*32 + 32*769) = 458,816 per patch
    c5 = cfg("dinov2_vitb14_644_4cam")
    block = 24 * 2117 * 768**2 + 4 * 2117**2 * 768
    assert DINO.vit_flops(c5) == 12 * block + 2 * 2116 * 588 * 768
    assert DINO.head_flops(c5) == 458_816 * 2116
