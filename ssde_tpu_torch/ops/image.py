"""Image layout ops on NCHW tensors (counterpart of ``ssde_tpu/ops/image.py``).

Only what the GRU v10 inference path uses; the resampling and pooling ops
of the JAX module belong to training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (reference layers.py:196-199)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """torch's PixelShuffle: channels read as (C_out, r, r), the order that
    ``ssde_tpu.ops.image.pixel_shuffle`` copies on NHWC."""
    return F.pixel_shuffle(x, scale)
