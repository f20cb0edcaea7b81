"""Write the demo golden's initial head as a plain .npz for the torch port.

The golden replay (assets/goldens/demo_mission_replay.npz, made by
tools/make_demo_assets.py) starts from the head that the JAX runtime of
`tools/make_demo_assets.py::build_runtime` draws when it is built: a
SimpleMLP [384 -> 64 -> 32 -> 1 + 384] from the JAX estimator's seed. The
torch port cannot draw that head (it has no JAX), so this tool, run with
the JAX package installed, builds that runtime and writes its head, its
confidence state and its step in the layout of
tools/convert_head_to_torch.py:

    params/Dense_i/kernel, params/Dense_i/bias   (flax layout, (in, out))
    cg_state/<field>                             (every ConfidenceState field)
    step

wild_visual_navigation_tpu_torch/utils/params.py::load_head_npz reads it;
wild_visual_navigation_tpu_torch/runtime/demo_golden.py replays the golden
from it. tests/test_torch_port_visu.py holds the committed file equal to
what the JAX package builds.

Usage:
    JAX_PLATFORMS=cpu python tools/convert_golden_head_to_torch.py
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "assets/goldens/demo_mission_head_init_torch.npz"


def golden_head_arrays() -> dict[str, np.ndarray]:
    """Flat {key: array} of the golden runtime's initial head, confidence
    state and step."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    from tools.make_demo_assets import build_runtime

    est = build_runtime().estimator
    params = est.params.get("params", est.params)
    out = {}
    for layer, leaves in sorted(params.items()):
        for leaf, value in sorted(leaves.items()):
            out[f"params/{layer}/{leaf}"] = np.asarray(value)
    for field, value in est.confidence_state._asdict().items():
        out[f"cg_state/{field}"] = np.asarray(value)
    out["step"] = np.asarray(est.step, np.int64)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    arrays = golden_head_arrays()
    np.savez(args.out, **arrays)
    print(f"wrote {args.out}: {len(arrays)} arrays")


if __name__ == "__main__":
    main()
