"""portbench: the benchmark of wild_visual_navigation_tpu_torch on one H100.

Run one cell once from the repository's root:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes and metrics are named in
BENCHMARK.json and found here by name: `configs/<config>.json`,
`traffic/<traffic>.json`, `metrics/<metric>.py` and `limits/<cell>.json`;
a configuration names its pipeline (its weights, runtime build, plain
reference and counts), `pipelines/<pipeline>.py`, "dino" by default.
Nothing here imports JAX or the JAX package; `reference.py` and the
pipelines' references import nothing of the port either.
"""
