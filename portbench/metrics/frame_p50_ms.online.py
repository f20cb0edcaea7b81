"""frame_p50_ms.online: the median camera-frame latency of the online cell,
from the frame's due time until its maps are on the host, in a traced run
(a gated frame counts as the whole window). Its runs spread with the host's
speed by more than half of the largest end-to-end bound, so it is read per
layer beside the cell's frames_per_s. The frames that the profiler's start
and stop held up are left out."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_common", pathlib.Path(__file__).with_name("_common.py"))
common = importlib.util.module_from_spec(_s)
_s.loader.exec_module(common)


def read(ctx):
    t = ctx.timings
    lat = common.unprofiled(t.frame_lat, t.frame_due, t.profiled, float(ctx.mix["period_s"]))
    return common.percentile_ms(lat, t.frames_failed, t.window_s, 50)
