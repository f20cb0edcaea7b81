"""Convert a flax head checkpoint into a plain .npz for the torch port.

The shipped head (assets/checkpoints/replay_demo_head.ckpt) is a pickle
of flax msgpack bytes; the torch port reads no flax or msgpack, so this
tool, run with the JAX package installed, writes the same numbers as a
numpy archive that loads with `np.load(allow_pickle=False)`:

    params/Dense_i/kernel, params/Dense_i/bias   (flax layout, (in, out))
    cg_state/<field>                             (every ConfidenceState field)
    step

wild_visual_navigation_tpu_torch/utils/params.py::load_head_npz reads it.

Usage:
    python tools/convert_head_to_torch.py \
        --ckpt assets/checkpoints/replay_demo_head.ckpt \
        --out assets/checkpoints/replay_demo_head_torch.npz
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def head_arrays(ckpt_path) -> dict[str, np.ndarray]:
    """Flat {key: array} of a flax head checkpoint's params, cg_state and step."""
    from flax import serialization

    with open(ckpt_path, "rb") as f:
        payload = pickle.load(f)
    params = serialization.msgpack_restore(payload["params"])
    params = params.get("params", params)
    cg = serialization.msgpack_restore(payload["cg_state"])
    out = {}
    for layer, leaves in sorted(params.items()):
        for leaf, value in sorted(leaves.items()):
            out[f"params/{layer}/{leaf}"] = np.asarray(value)
    for field, value in cg.items():
        out[f"cg_state/{field}"] = np.asarray(value)
    out["step"] = np.asarray(int(payload.get("step", 0)), np.int64)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=str(ROOT / "assets/checkpoints/replay_demo_head.ckpt"))
    ap.add_argument("--out", default=str(ROOT / "assets/checkpoints/replay_demo_head_torch.npz"))
    args = ap.parse_args()
    arrays = head_arrays(args.ckpt)
    np.savez(args.out, **arrays)
    print(f"wrote {args.out}: {len(arrays)} arrays")


if __name__ == "__main__":
    main()
