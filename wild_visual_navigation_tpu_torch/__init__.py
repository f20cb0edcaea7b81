"""PyTorch / CUDA port of wild_visual_navigation_tpu.

The JAX package `wild_visual_navigation_tpu` is the reference; this
package mirrors its layout (ops/, models/, feature_extractor/, utils/,
cfg/, runtime/, traversability/, supervision/) and imports no JAX. Its
four hand-written CUDA kernels live in csrc/ and are built at first use by
ops/_cuda.py:

  K1 flash_attention  ops/flash_attention.py::flash_attention
  K2 pixelwise_score  ops/pixelwise_fused.py::score_pixels
  K3 slic_step        ops/slic_fused.py::slic_step
  K4 fill_hulls       ops/rasterize_fill.py::fill_hulls (the fill alone),
                      ::hull_masks and ::hull_fill (the hull and the fill in
                      one launch; hull_fill also writes the hull)

Each wrapper counts its launches in a `launches` attribute (K4's entry
points in `fill_hulls.launches`), under one lock: the runtime's camera
and learning threads launch kernels at the same time.
"""

from __future__ import annotations


def _wrappers() -> dict:
    from .ops.flash_attention import flash_attention
    from .ops.pixelwise_fused import score_pixels
    from .ops.rasterize_fill import fill_hulls
    from .ops.slic_fused import slic_step

    return {"flash_attention": flash_attention, "pixelwise_score": score_pixels, "slic_step": slic_step,
            "fill_hulls": fill_hulls}


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    from .ops import _cuda

    for fn in _wrappers().values():
        _cuda.set_launches(fn, 0)
