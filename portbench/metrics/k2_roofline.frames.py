"""k2_roofline.frames: K2's bound over its mean device time, in %. K2 is
pixelwise_score_kernel (csrc/pixelwise_score.cu), one launch scoring every
pixel of the frame's maps from patch rows."""
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

    H = ctx.cfg["image_size"]
    Hp = H // ctx.cfg["model"]["patch_size"]
    hidden = ctx.cfg["head"]["hidden_sizes"]
    b = counts.k2_bound_s(int(ctx.mix.get("cameras", 1)), Hp, H, H, K1=hidden[0], K=hidden[1])
    return common.kernel_share(ctx.trace, KERNELS, b)
