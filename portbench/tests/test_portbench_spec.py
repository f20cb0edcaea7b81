"""The benchmark is driven by data: every cell's configuration, traffic mix,
limits and metrics are files found by name, and a new one is picked up
without an edit to any other."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import check, harness  # noqa: E402
from portbench.run import cell_spec  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    w, e2e, per_layer = cell_spec(BENCH, cell)
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())["limits"]
    assert cfg["name"] == w["config"] and mix["loop"] in ("open", "closed")
    assert set(limits) == set(check.FRAME_NUMBERS + (check.LEARNER_NUMBERS if mix.get("learner") else ()))
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2 and per_layer
    for m in e2e + per_layer:
        assert callable(harness.load_metric(m["name"]).read)


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    for m in BENCH["per_layer"]:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert all(w in [x["name"] for x in BENCH["workloads"]] for w in m["workloads"])
        for w in m["workloads"]:  # the end-to-end metric it moves is reported in each cell it lists
            assert m["moves"] in [e["name"] for e in cell_spec(BENCH, w)[1]]
    assert all(e["bound"] <= 0.25 for e in BENCH["end_to_end"])


def test_new_metric_file_is_found_without_edits(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "spare_ms.later").with_suffix(".later.py").write_text(
        "def read(ctx):\n    return 2.5 * ctx\n")
    assert harness.load_metric("spare_ms.later", tmp_path).read(2) == 5.0


def test_cell_spec_picks_metrics_by_workloads():
    bench = {"workloads": [{"name": "a"}, {"name": "b"}],
             "end_to_end": [{"name": "x"}, {"name": "y", "workloads": ["b"]}],
             "per_layer": [{"name": "z", "workloads": ["a"]}]}
    _, e2e, per_layer = cell_spec(bench, "a")
    assert [m["name"] for m in e2e] == ["x"] and [m["name"] for m in per_layer] == ["z"]
    _, e2e, per_layer = cell_spec(bench, "b")
    assert [m["name"] for m in e2e] == ["x", "y"] and per_layer == []


@pytest.mark.parametrize("name,base", [("frame_p95_ms.online", "frame_p95_ms"),
                                       ("learn_tick_p95_ms.online", "learn_tick_p95_ms.batch"),
                                       ("flush_ms.online", "flush_ms.learn"),
                                       ("train_step_ms.online", "train_step_ms.learn"),
                                       ("k4_roofline.online", "k4_roofline.learn")])
def test_online_split_reads_as_its_base(name, base):
    from portbench import trace
    from portbench.tests.test_portbench_trace import Ev

    timings = SimpleNamespace(frame_lat=[0.012, 0.015, 0.031, 0.018], frames_failed=1, frame_due=[0.0, 0.1, 0.2, 0.3],
                              tick_lat=[0.020, 0.026, 0.090], ticks_failed=0, tick_due=[0.05, 0.15, 0.25],
                              window_s=51.0, profiled=None)
    tr = trace.reduce([Ev("portbench.robot_state_callback", "CPU", 1000, 4_000_000, tid=2, user=True),
                       Ev("portbench.learning_step", "CPU", 5_000_000, 3_000_000, tid=2, user=True),
                       Ev("cudaLaunchKernel", "CPU", 1100, 5, corr=7, tid=2),
                       Ev("hull_fill_kernel", "CUDA", 2000, 20_000, corr=7)], 0, 10_000_000)
    cfg = {"image_size": 224, "estimator": {"reprojection_fanout": 32}}
    ctx = SimpleNamespace(timings=timings, trace=tr, cfg=cfg, mix={"period_s": 0.1}, setup_s=1.0)
    value = harness.load_metric(name).read(ctx)
    assert value is not None and value > 0 and value == harness.load_metric(base).read(ctx)


def test_online_tails_leave_out_what_the_profiler_held_up():
    """Calls due while the profiler ran, and the backlog its stop left, are
    not read; the calls before and those after the loop caught up are."""
    from portbench.metrics._common import unprofiled

    due = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7]
    lat = [0.02, 0.03, 0.50, 2.10, 0.90, 0.15, 0.02, 0.04]  # profiled 0.15-0.35 s; backlog to 0.5 s
    assert unprofiled(lat, due, (0.15, 0.35), 0.1) == [0.02, 0.03, 0.02, 0.04]
    assert unprofiled(lat, due, None, 0.1) == lat
    timings = SimpleNamespace(frame_lat=lat, frame_due=due, frames_failed=0, window_s=1.0, profiled=(0.15, 0.35))
    ctx = SimpleNamespace(timings=timings, mix={"period_s": 0.1})
    assert harness.load_metric("frame_p95_ms.online").read(ctx) < 50.0 < harness.load_metric("frame_p95_ms").read(ctx)
    assert harness.load_metric("frame_p50_ms.online").read(ctx) == pytest.approx(25.0)  # median of 0.02, 0.03, 0.02, 0.04 s
    timings.profiled = None
    assert harness.load_metric("frame_p50_ms.online").read(ctx) == pytest.approx(95.0)  # median of all eight


def test_batch_tick_tail_leaves_out_the_profiled_ticks():
    """In a closed loop the ticks that started while the profiler ran are
    not read; those before its start and after its stop are."""
    lat = [0.014, 0.015, 0.090, 0.080, 0.016, 0.013]
    due = [0.0, 0.5, 1.0, 1.5, 2.0, 2.5]  # profiled 0.9-1.8 s
    timings = SimpleNamespace(tick_lat=lat, tick_due=due, ticks_failed=0, window_s=3.0, profiled=(0.9, 1.8))
    ctx = SimpleNamespace(timings=timings, mix={"period_s": 0.1})
    assert harness.load_metric("learn_tick_p95_ms.batch").read(ctx) < 20.0
    timings.profiled = None
    assert harness.load_metric("learn_tick_p95_ms.batch").read(ctx) > 80.0
