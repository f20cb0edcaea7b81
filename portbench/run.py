#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root (or a checkout of it). The cell names a
configuration (`portbench/configs/<config>.json`, which names its pipeline,
`portbench/pipelines/<pipeline>.py`) and a traffic mix
(`portbench/traffic/<traffic>.json`) in BENCHMARK.json; its correctness
limits are `portbench/limits/<cell>.json`, its metrics the readers
`portbench/metrics/<metric>.py`. The last line of standard output is one
JSON object: `correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` also `breakdown`, and last `checks`, each number the check
compared beside its limit (also the last lines of standard error).

`--control 1` runs the control instead: the configuration's backbone on
the program's own int8 path, and the reference in low precision beside
the fp32 one; its `correct` has to come out false. `--fault <name>` plants
one of portbench/faults.py's faults in the program. Neither is part of a
measured run.

The run needs a CUDA device; without one it prints no result and exits 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cell_spec(bench: dict, workload: str) -> tuple[dict, list, list]:
    """(the workload's entry, its end-to-end metrics, its per-layer metrics)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")

    def mine(entries):
        return [m for m in entries if "workloads" not in m or workload in m["workloads"]]

    return cells[workload], mine(bench["end_to_end"]), mine(bench["per_layer"])


def load_cell(workload: str, root: Path = ROOT) -> tuple:
    """(workload entry, end-to-end metrics, per-layer metrics, configuration, mix, limits) of a cell.
    Loads the configuration's pipeline, so that a missing module or function fails here, before any run."""
    from portbench import harness

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell, e2e, per_layer = cell_spec(bench, workload)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / f"{cell['config']}.json").read_text())
    mix = json.loads((pb / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((pb / "limits" / f"{cell['name']}.json").read_text())["limits"]
    harness.load_pipeline(cfg, pb)
    return cell, e2e, per_layer, cfg, mix, limits


def set_caches() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--control", type=int, default=0, choices=(0, 1))
    ap.add_argument("--fault", default=None, help="plant a fault (portbench/faults.py) to read what the check sees")
    args = ap.parse_args(argv)

    set_caches()
    sys.path.insert(0, str(ROOT))
    cell, e2e, per_layer, cfg, mix, limits = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from portbench import faults, harness

    if args.fault:
        faults.plant(args.fault)
    result, lines = harness.run(cfg, mix, limits, e2e, per_layer, args.seed, args.seconds, bool(args.trace),
                                "cuda", T_START, control=bool(args.control))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
