"""device_idle.frames: the share of the traced window in which no device
operation ran: 1 - (the union of the operations' intervals / the window), in %."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_common", pathlib.Path(__file__).with_name("_common.py"))
common = importlib.util.module_from_spec(_s)
_s.loader.exec_module(common)



def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
