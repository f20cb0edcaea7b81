"""mfu.frames: model FLOPs of the camera frames whose entry span lies in the
traced window (the configuration's pipeline's `frame_flops`: for `dino`, the
ViT forward at its published widths and tokens, plus the head at the
configuration's scoring resolution), over the window times the H100's 989
TFLOP/s bf16 peak, in %."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_common", pathlib.Path(__file__).with_name("_common.py"))
common = importlib.util.module_from_spec(_s)
_s.loader.exec_module(common)



def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    from portbench import counts

    spans, per = common.frame_spans(tr, int(ctx.mix.get("cameras", 1)))
    if not spans:
        return None
    flops = ctx.pipeline.frame_flops(ctx.cfg)
    return 100.0 * len(spans) * per * flops / (tr.window_s * counts.PEAK_FLOPS["bf16_tensor"])
