"""learn_tick_p95_ms.online: the 95th percentile of a learner tick's latency in
the online cell, from its due time, in a traced run, where the learner's
thread contends with the camera's frames, so it moves frames_per_s there. Its
runs spread too widely for an end-to-end bound. The ticks that the
profiler's start and stop held up are left out (a tick that raised still
counts as the whole window)."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_common", pathlib.Path(__file__).with_name("_common.py"))
common = importlib.util.module_from_spec(_s)
_s.loader.exec_module(common)


def read(ctx):
    t, mix = ctx.timings, ctx.mix
    lat = common.unprofiled(t.tick_lat, t.tick_due, t.profiled, float(mix.get("learner_period_s", mix["period_s"])))
    return common.percentile_ms(lat, t.ticks_failed, t.window_s, 95)
