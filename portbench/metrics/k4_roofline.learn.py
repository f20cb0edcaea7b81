"""k4_roofline.learn: K4's bound over its mean device time, in %. K4 is the
kernel hull_fill_kernel (csrc/fill_hulls.cu); one launch per flush turns the
fan-out's footprints into (fan-out, H, W) masks (portbench/counts.py)."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_common", pathlib.Path(__file__).with_name("_common.py"))
common = importlib.util.module_from_spec(_s)
_s.loader.exec_module(common)

KERNELS = ("hull_fill_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    from portbench import counts

    H = ctx.cfg["image_size"]
    return common.kernel_share(ctx.trace, KERNELS, counts.k4_bound_s(ctx.cfg["estimator"]["reprojection_fanout"], H, H))
