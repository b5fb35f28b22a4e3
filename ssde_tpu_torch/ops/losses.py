"""Self-supervision losses on NCHW tensors (counterpart of
``ssde_tpu/ops/losses.py``), in plain PyTorch.

``ssim`` and ``reprojection_loss`` are the plain formulation of the
photometric error; the fused kernels of ``ops/photometric`` are held to
them. Images are (B, 3, H, W), disparities (B, 1, H, W).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..parallel.dist import data_rank, data_world
from .image import reflect_pad_2d

_C1 = 0.01**2
_C2 = 0.03**2


def box_mean(x: torch.Tensor) -> torch.Tensor:
    """3x3 mean over the reflection-padded input, same size as ``x`` (the
    SSIM window, layers.py:223-227)."""
    return F.avg_pool2d(reflect_pad_2d(x), 3, stride=1)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(1 - SSIM) / 2 per pixel and channel, clamped to [0, 1]; 3x3 mean
    over reflection-padded inputs (reference layers.py:218-248)."""
    mu_x, mu_y = box_mean(x), box_mean(y)
    sigma_x = box_mean(x * x) - mu_x * mu_x
    sigma_y = box_mean(y * y) - mu_y * mu_y
    sigma_xy = box_mean(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + _C1) * (2 * sigma_xy + _C2)
    d = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    return torch.clamp((1 - n / d) / 2, 0.0, 1.0)


def reprojection_loss(pred: torch.Tensor, target: torch.Tensor,
                      no_ssim: bool = False) -> torch.Tensor:
    """0.85 * SSIM + 0.15 * L1, channel mean -> (B, 1, H, W)
    (reference trainer.py:517-530)."""
    l1 = torch.mean(torch.abs(target - pred), dim=1, keepdim=True)
    if no_ssim:
        return l1
    return 0.85 * torch.mean(ssim(pred, target), dim=1, keepdim=True) + 0.15 * l1


def smooth_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware first-order smoothness of ``disp`` (B, 1, H, W) against
    ``img`` (B, 3, H, W); a scalar (reference layers.py:202-215)."""
    grad_disp_x = torch.abs(disp[:, :, :, :-1] - disp[:, :, :, 1:])
    grad_disp_y = torch.abs(disp[:, :, :-1, :] - disp[:, :, 1:, :])
    grad_img_x = torch.mean(torch.abs(img[:, :, :, :-1] - img[:, :, :, 1:]), 1, keepdim=True)
    grad_img_y = torch.mean(torch.abs(img[:, :, :-1, :] - img[:, :, 1:, :]), 1, keepdim=True)
    return (torch.mean(grad_disp_x * torch.exp(-grad_img_x))
            + torch.mean(grad_disp_y * torch.exp(-grad_img_y)))


def min_reprojection(reproj: torch.Tensor, ident: Optional[torch.Tensor],
                     generator: Optional[torch.Generator] = None):
    """Per-pixel minimum over the identity and reprojection maps, each
    (B, F, H, W), and the automask (1 where a reprojection won).

    ``generator`` draws the 1e-5 tie-break noise on the identity maps
    (reference trainer.py:592-594), over the global batch inside a process
    group; None adds none. ``torch.amin`` shares
    the gradient among equal minima, as ``jnp.min`` does.
    """
    n_ident = 0
    combined = reproj
    if ident is not None:
        if generator is not None:
            # a rank of a data-parallel mesh draws the global batch's noise
            # and keeps its rows, as the JAX step's noise over the global
            # batch is sharded with it
            n, r = data_world(), data_rank()
            noise = torch.randn((n * ident.shape[0],) + tuple(ident.shape[1:]),
                                generator=generator, device=generator.device,
                                dtype=ident.dtype)
            if n > 1:
                noise = noise[r * ident.shape[0]:(r + 1) * ident.shape[0]]
            ident = ident + noise.to(ident.device) * 1e-5
        n_ident = ident.shape[1]
        combined = torch.cat([ident, reproj], 1)
    per_pixel = torch.amin(combined, dim=1, keepdim=True)
    if not n_ident:
        return per_pixel, torch.ones_like(per_pixel)
    idxs = torch.argmin(combined, dim=1, keepdim=True)
    return per_pixel, (idxs > n_ident - 1).to(combined.dtype)


def photometric_loss(preds: Sequence[torch.Tensor], identities: Sequence[torch.Tensor],
                     target: torch.Tensor, generator: Optional[torch.Generator] = None,
                     *, no_ssim: bool = False, disable_automasking: bool = False,
                     avg_reprojection: bool = False):
    """Min-reprojection + automask loss of one scale
    (``ssde_tpu.ops.losses.photometric_loss``): the per-pixel loss and the
    identity-selection mask, each (B, 1, H, W)."""
    reproj = torch.cat([reprojection_loss(p, target, no_ssim) for p in preds], 1)
    if avg_reprojection:
        reproj = reproj.mean(1, keepdim=True)
    ident = None
    if not disable_automasking:
        ident = torch.cat([reprojection_loss(p, target, no_ssim) for p in identities], 1)
        if avg_reprojection:
            ident = ident.mean(1, keepdim=True)
    return min_reprojection(reproj, ident, generator)
