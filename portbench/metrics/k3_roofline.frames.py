"""k3_roofline.frames: K3's bound (bytes: one SLIC step's features, centres,
ids) over its mean device time, in %. K3 is slic_step_kernel
(csrc/slic_step.cu), 11 launches per frame."""
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

    H = ctx.cfg["image_size"]
    b = counts.k3_bound_s(int(ctx.mix.get("cameras", 1)), H, H, ctx.cfg["segmentation"]["num_segments"])
    return common.kernel_share(ctx.trace, KERNELS, b)
