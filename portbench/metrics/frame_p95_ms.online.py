"""frame_p95_ms.online: frame_p95_ms as the online cell reads it, in a traced
run. Its runs there spread too widely for an end-to-end bound (the learner's
thread holds the GIL against the camera's for a varying share of the
frames), so it is kept beside the cell's frame_p50_ms.online as a per-layer
reading. A traced run profiles part of the window, and the profiler's start and stop
hold the camera up for seconds; the frames they held up are left out (a
frame that failed still counts as the whole window)."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_common", pathlib.Path(__file__).with_name("_common.py"))
common = importlib.util.module_from_spec(_s)
_s.loader.exec_module(common)


def read(ctx):
    t = ctx.timings
    lat = common.unprofiled(t.frame_lat, t.frame_due, t.profiled, float(ctx.mix["period_s"]))
    return common.percentile_ms(lat, t.frames_failed, t.window_s, 95)
