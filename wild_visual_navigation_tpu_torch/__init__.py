"""PyTorch / CUDA port of wild_visual_navigation_tpu.

The JAX package `wild_visual_navigation_tpu` is the reference; this
package mirrors its layout (ops/, models/, feature_extractor/, utils/,
cfg/, runtime/) and imports no JAX. Its three hand-written CUDA kernels
live in csrc/ and are built at first use by ops/_cuda.py:

  K1 flash_attention  ops/flash_attention.py::flash_attention
  K2 pixelwise_score  ops/pixelwise_fused.py::score_pixels
  K3 slic_step        ops/slic_fused.py::slic_step

Each wrapper counts its launches in a `launches` attribute.
"""

from __future__ import annotations


def _wrappers() -> dict:
    from .ops.flash_attention import flash_attention
    from .ops.pixelwise_fused import score_pixels
    from .ops.slic_fused import slic_step

    return {"flash_attention": flash_attention, "pixelwise_score": score_pixels, "slic_step": slic_step}


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
