"""learn_tick_p95_ms: the 95th percentile of a learner tick's latency
(robot_state_callback with its supervision flush, then learning_step, until
an event recorded after it has completed), from its due time (open loop)
or its start (closed loop); a tick that raised counts as the whole window."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_common", pathlib.Path(__file__).with_name("_common.py"))
common = importlib.util.module_from_spec(_s)
_s.loader.exec_module(common)


def read(ctx):
    t = ctx.timings
    return common.percentile_ms(t.tick_lat, t.ticks_failed, t.window_s, 95)
