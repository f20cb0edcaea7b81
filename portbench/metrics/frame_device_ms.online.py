"""frame_device_ms.online: device milliseconds of the operations launched
inside an image_callback span, per call, over the traced window."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_common", pathlib.Path(__file__).with_name("_common.py"))
common = importlib.util.module_from_spec(_s)
_s.loader.exec_module(common)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    spans = tr.spans_named("image_callback")
    if not spans:
        return None
    return sum(sum(tr.op_ms(s.ops, ("",))) for s in spans) / len(spans)
