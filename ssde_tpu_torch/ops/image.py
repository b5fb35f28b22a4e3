"""Image layout ops on NCHW tensors (counterpart of ``ssde_tpu/ops/image.py``)."""

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


def reflect_pad_2d(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """Reflection-pad H and W of NCHW ``x`` (nn.ReflectionPad2d, reference
    layers.py:128). A dimension of size 1 repeats its one value, as the JAX
    package's ``jnp.pad(mode="reflect")`` does; torch's reflect refuses it."""
    if min(x.shape[-2:]) > pad:
        return F.pad(x, (pad, pad, pad, pad), mode="reflect")
    for pads, n in (((pad, pad, 0, 0), x.shape[-1]), ((0, 0, pad, pad), x.shape[-2])):
        x = F.pad(x, pads, mode="reflect" if n > pad else "replicate")
    return x


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize (B, C, H, W) -> (B, C, out_h, out_w), the JAX
    function's arithmetic: ``align_corners=False`` takes source coordinate
    (i + 0.5) * in/out - 0.5 clamped at 0 (torch ``F.interpolate``'s
    convention); ``align_corners=True`` takes i * (in-1) / (out-1). The
    coordinates and the interpolation are float32, or float64 for a float64
    ``x`` (a reference run). The rows and columns are gathered with
    ``index_select``, whose backward is an ``index_add``: the backward of an
    advanced-index gather sorts its indices first, and on an NVIDIA H100 that
    took 63 % of the DPT train step's device time (``PERF.md`` §6, PR 18)."""
    B, C, H, W = x.shape
    out_h, out_w = out_hw
    dtype = x.dtype
    x = x if dtype == torch.float64 else x.float()

    def src_coords(out_size, in_size):
        i = torch.arange(out_size, dtype=x.dtype, device=x.device)
        if align_corners:
            if out_size == 1:
                return torch.zeros_like(i)
            return i * (in_size - 1) / (out_size - 1)
        return torch.clamp((i + 0.5) * (in_size / out_size) - 0.5, min=0.0)

    ys, xs = src_coords(out_h, H), src_coords(out_w, W)
    y0 = torch.clamp(torch.floor(ys).long(), 0, H - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, W - 1)
    y1, x1 = torch.clamp(y0 + 1, max=H - 1), torch.clamp(x0 + 1, max=W - 1)
    wy = (ys - y0.to(x.dtype))[None, None, :, None]
    wx = (xs - x0.to(x.dtype))[None, None, None, :]
    rows0, rows1 = x.index_select(2, y0), x.index_select(2, y1)
    top = rows0.index_select(3, x0) * (1 - wx) + rows0.index_select(3, x1) * wx
    bot = rows1.index_select(3, x0) * (1 - wx) + rows1.index_select(3, x1) * wx
    return (top * (1 - wy) + bot * wy).to(dtype)
