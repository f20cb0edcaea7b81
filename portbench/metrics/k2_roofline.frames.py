"""k2_roofline.frames: K2's bound over its mean device time, in %. K2 is
pixelwise_score_kernel (csrc/pixelwise_score.cu), one launch scoring every
pixel of the frame's maps from patch rows, at the pipeline's `kernel_shapes`."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_common", pathlib.Path(__file__).with_name("_common.py"))
common = importlib.util.module_from_spec(_s)
_s.loader.exec_module(common)

KERNELS = ("pixelwise_score_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    from portbench import counts

    shape = ctx.pipeline.kernel_shapes(ctx.cfg, ctx.mix).get("k2")
    if shape is None:
        return None
    return common.kernel_share(ctx.trace, KERNELS, counts.k2_bound_s(*shape))
