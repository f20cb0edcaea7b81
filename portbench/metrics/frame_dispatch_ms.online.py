"""frame_dispatch_ms.online: the median host duration of the program's
`frame.dispatch` span (the fused frame's call: the backbone, SLIC and the
head enqueued from image_callback), ms, over the traced window."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_program", pathlib.Path(__file__).with_name("_program.py"))
program = importlib.util.module_from_spec(_s)
_s.loader.exec_module(program)


def read(ctx):
    return program.median_ms(program.spans(ctx), "frame.dispatch")
