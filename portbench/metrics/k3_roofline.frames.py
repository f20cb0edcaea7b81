"""k3_roofline.frames: K3's bound (bytes: one SLIC step's features, centres,
ids) over its mean device time, in %. K3 is slic_step_kernel
(csrc/slic_step.cu), 11 launches per frame, at the pipeline's `kernel_shapes`."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_common", pathlib.Path(__file__).with_name("_common.py"))
common = importlib.util.module_from_spec(_s)
_s.loader.exec_module(common)

KERNELS = ("slic_step_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    from portbench import counts

    shape = ctx.pipeline.kernel_shapes(ctx.cfg, ctx.mix).get("k3")
    if shape is None:
        return None
    return common.kernel_share(ctx.trace, KERNELS, counts.k3_bound_s(*shape))
