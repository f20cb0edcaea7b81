"""frame_launches.frames: device operations launched inside the frame
entry's spans (image_callback, or image_batch_callback divided by its
cameras), per camera frame, over the traced window."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_common", pathlib.Path(__file__).with_name("_common.py"))
common = importlib.util.module_from_spec(_s)
_s.loader.exec_module(common)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    spans, per = common.frame_spans(tr, int(ctx.mix.get("cameras", 1)))
    return sum(len(s.ops) for s in spans) / (len(spans) * per) if spans else None
