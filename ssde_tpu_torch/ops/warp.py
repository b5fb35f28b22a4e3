"""Exact bilinear border warp in plain PyTorch (counterpart of
``ssde_tpu/ops/warp.py`` ``grid_sample``).

Semantics are torch ``F.grid_sample(mode="bilinear", padding_mode="border")``
as the JAX function writes them: a coordinate in [-1, 1] is unnormalised
(``align_corners=False``: ((g + 1) * W - 1) / 2) and clamped to [0, W-1];
the 2x2 window is anchored at clip(floor(f), 0, W-2) and the fraction taken
against the anchor, so at the right border x0 = W-2 and wx = 1.

Images are NCHW here (B, C, H, W); grids are (B, Ho, Wo, 2) as in JAX.
:func:`warp_family_reference` and :func:`warp_family_bwd_reference` are the
plain versions of the family kernels (``ops/warp_banded``): one source at S
grids with the residuals of the backward, and the grid gradient assembled
from those residuals.
"""

from __future__ import annotations

import torch


def unnormalize(grid: torch.Tensor, H: int, W: int):
    """(..., 2) grid -> unclamped source pixel coordinates (rx, ry),
    ``align_corners=False``."""
    if grid.dtype != torch.float64:
        grid = grid.float()
    gx, gy = grid[..., 0], grid[..., 1]
    return ((gx + 1.0) * W - 1.0) * 0.5, ((gy + 1.0) * H - 1.0) * 0.5


def _taps(img: torch.Tensor, grid: torch.Tensor):
    """The four corner taps (B, C, Ho, Wo) and the fractions (B, 1, Ho, Wo)."""
    B, C, H, W = img.shape
    _, Ho, Wo, _ = grid.shape
    rx, ry = unnormalize(grid, H, W)
    fx, fy = torch.clamp(rx, 0.0, W - 1), torch.clamp(ry, 0.0, H - 1)
    x0 = torch.clamp(torch.floor(fx), 0.0, max(W - 2, 0))
    y0 = torch.clamp(torch.floor(fy), 0.0, max(H - 2, 0))
    wx, wy = (fx - x0)[:, None], (fy - y0)[:, None]
    base = (y0 * W + x0).long().reshape(B, 1, Ho * Wo).expand(B, C, Ho * Wo)
    flat = img.reshape(B, C, H * W)

    def tap(off):
        return torch.gather(flat, 2, base + off).reshape(B, C, Ho, Wo)

    return tap(0), tap(1), tap(W), tap(W + 1), wx, wy


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear border sample of ``img`` (B, C, H, W) at ``grid``
    (B, Ho, Wo, 2) -> (B, C, Ho, Wo). Differentiable in both arguments."""
    t00, t01, t10, t11, wx, wy = _taps(img, grid)
    top = t00 * (1 - wx) + t01 * wx
    bot = t10 * (1 - wx) + t11 * wx
    return top * (1 - wy) + bot * wy


def warp_family_reference(img: torch.Tensor, grids: torch.Tensor):
    """Plain version of the family warp: ``img`` (B, C, H, W) at ``grids``
    (S, B, Ho, Wo, 2) -> (out, rdx, rdy), each (S*B, C, Ho, Wo) with
    g = s*B + b. rdx = d out / d wx and rdy = d out / d wy, the residuals
    of the O(output) backward."""
    outs, rdxs, rdys = [], [], []
    for grid in grids:
        t00, t01, t10, t11, wx, wy = _taps(img, grid)
        top = t00 * (1 - wx) + t01 * wx
        bot = t10 * (1 - wx) + t11 * wx
        outs.append(top * (1 - wy) + bot * wy)
        rdxs.append((1 - wy) * (t01 - t00) + wy * (t11 - t10))
        rdys.append((1 - wx) * (t10 - t00) + wx * (t11 - t01))
    return torch.cat(outs), torch.cat(rdxs), torch.cat(rdys)


def grad_masks(grids: torch.Tensor, H: int, W: int):
    """d f / d g where the continuous coordinate was not clamped, else 0
    (the JAX ``_grad_masks``: strict inequalities against the unclamped
    coordinate), for x and y, each (S, B, Ho, Wo)."""
    rx, ry = unnormalize(grids, H, W)
    in_x = ((rx > 0) & (rx < W - 1)).float() * (W * 0.5)
    in_y = ((ry > 0) & (ry < H - 1)).float() * (H * 0.5)
    return in_x, in_y


def warp_family_bwd_reference(img: torch.Tensor, grids: torch.Tensor, dout: torch.Tensor):
    """Plain version of the family warp's backward: the gradient of
    ``warp_family_reference(img, grids)[0]`` in ``grids`` (S, B, Ho, Wo, 2)
    against ``dout`` (S*B, C, Ho, Wo), from the residuals (``_gsbp_bwd``:
    dgrid = sum_c dout * rd, masked and scaled by W/2, H/2)."""
    S, B, Ho, Wo, _ = grids.shape
    H, W = img.shape[2:]
    _, rdx, rdy = warp_family_reference(img, grids)
    in_x, in_y = grad_masks(grids, H, W)
    dwx = (dout * rdx).sum(1).reshape(S, B, Ho, Wo)
    dwy = (dout * rdy).sum(1).reshape(S, B, Ho, Wo)
    return torch.stack([dwx * in_x, dwy * in_y], -1)
