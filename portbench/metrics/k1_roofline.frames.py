"""k1_roofline.frames: K1's bound at the cell's attention shape (cameras,
heads, tokens, head dim: the pipeline's `kernel_shapes`) over its mean
device time, in %. K1 is flash_fwd_bf16_kernel / flash_fwd_f32_kernel
(csrc/flash_attention.cuh)."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_common", pathlib.Path(__file__).with_name("_common.py"))
common = importlib.util.module_from_spec(_s)
_s.loader.exec_module(common)

KERNELS = ("flash_fwd_",)


def read(ctx):
    if ctx.trace is None:
        return None
    from portbench import counts

    shape = ctx.pipeline.kernel_shapes(ctx.cfg, ctx.mix).get("k1")
    if shape is None:
        return None
    return common.kernel_share(ctx.trace, KERNELS, counts.k1_bound_s(*shape))
