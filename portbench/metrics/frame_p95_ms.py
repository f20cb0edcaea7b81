"""frame_p95_ms: the 95th percentile of the camera-frame latency, from the frame's due time
(open loop) or its call (closed loop) until its maps are on the host, over
every frame of the window (a gated frame counts as the whole window)."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_common", pathlib.Path(__file__).with_name("_common.py"))
common = importlib.util.module_from_spec(_s)
_s.loader.exec_module(common)


def read(ctx):
    t = ctx.timings
    return common.percentile_ms(t.frame_lat, t.frames_failed, t.window_s, 95)
