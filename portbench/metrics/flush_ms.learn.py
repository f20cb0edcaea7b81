"""flush_ms.learn: the median host duration of a robot_state_callback span
(the supervision generator, the graphs and the flush it launches), ms."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_common", pathlib.Path(__file__).with_name("_common.py"))
common = importlib.util.module_from_spec(_s)
_s.loader.exec_module(common)


def read(ctx):
    return None if ctx.trace is None else common.median_span_ms(ctx.trace, "robot_state_callback")
