#!/usr/bin/env python3
"""Read what the check compares over many seeds in one process, for
setting a cell's limits (never part of a measured run).

    python3 portbench/readings.py --workload <cell> --seconds <s> --out <file.jsonl> \\
        --runs sound:<seed>,... control:<seed>,... <fault>:<seed>,...

Each run is a whole run of the cell (set-up, a window of `--seconds` at the
cell's own load, the check), as `run.py` makes it, but without the
process's start-up: the sound program, the control (`run.py --control 1`),
or a fault of `faults.py` planted. One JSON line per run goes to `--out`:
its mode and seed, `correct`, the numbers compared (`readings`), the
control's reference one precision below (`reference_low`) and the samples.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.run import load_cell, set_caches  # noqa: E402


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--runs", nargs="+", required=True, help="mode:seed,seed,... with mode sound, control or a fault")
    args = ap.parse_args(argv)
    set_caches()
    cell, _, _, cfg, mix, limits = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("portbench: readings need a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from portbench import faults, harness

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for spec in args.runs:
        mode, seeds = spec.split(":")
        for seed in (int(x) for x in seeds.split(",")):
            handles = faults.plant(mode) if mode in faults.NAMES else []
            try:
                res, lines = harness.run(cfg, mix, limits, [], [], seed, args.seconds, False, "cuda",
                                         time.perf_counter(), control=mode == "control")
            finally:
                faults.unplant(handles)
            ctl = res.get("control", {})
            row = {"cell": cell["name"], "mode": mode, "seed": seed, "correct": res["correct"],
                   "readings": ctl.get("program_int8") or {k: v["value"] for k, v in res["checks"].items()},
                   "reference_low": ctl.get("reference_low"), "samples": lines[1 if not ctl else 2]}
            with out.open("a") as f:
                f.write(json.dumps(row) + "\n")
            print(json.dumps(row), file=sys.stderr)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
