"""learn_tick_p95_ms.batch: the 95th percentile of a learner tick's latency
(robot_state_callback with its supervision flush, then learning_step, until
an event recorded after it has completed), from its start, in the batch
cell's closed loop, where each tick follows the frames of its event and so
moves frames_per_s (a tick that raised counts as the whole window). Its runs
spread with the host's speed by more than half of the largest end-to-end
bound, so it is read per layer, in a traced run; the ticks that started
while the profiler ran are left out."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_common", pathlib.Path(__file__).with_name("_common.py"))
common = importlib.util.module_from_spec(_s)
_s.loader.exec_module(common)


def read(ctx):
    t = ctx.timings
    lat = common.unprofiled(t.tick_lat, t.tick_due, t.profiled, float("inf"))
    return common.percentile_ms(lat, t.ticks_failed, t.window_s, 95)
