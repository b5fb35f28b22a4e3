"""The family warp of the training loss: one source image at S coordinate
fields in one launch, its forward and its grid gradient each a
hand-written CUDA kernel (counterpart of ``ssde_tpu/ops/pallas/warp_banded.py``
``grid_sample_banded_planar``).

The TPU kernel clamps source rows outside a vertical band and zeroes
columns outside a 3-tile window, and keeps its taps and residuals in
bf16; those are Mosaic gather and HBM-traffic workarounds. This warp is
exact float32 border ``grid_sample`` (``ops/warp.grid_sample``) at every
coordinate, so it has no band to violate and the port logs no
``warp/band_violation``. Nor does it keep the TPU's residuals: the
backward kernel recomputes the taps from the image.

:func:`warp_family_fwd` and :func:`warp_family_bwd` launch
``ssde_tpu_torch/csrc/warp_family.cu`` for CUDA tensors and raise on
anything those kernels do not take; only tensors that lie on the CPU go to
the plain versions :func:`ops.warp.warp_family_reference` and
:func:`ops.warp.warp_family_bwd_reference`. :func:`grid_sample_family` is
the differentiable op: the gradient reaches the grids only, never the
image (raw data in this loss graph, as in the JAX package).
"""

from __future__ import annotations

import torch

from .build import launch
from .warp import warp_family_bwd_reference, warp_family_reference


def _check_args(img: torch.Tensor, grids: torch.Tensor) -> None:
    if img.device != grids.device:
        raise ValueError("warp_family: img and grids must be on one device")
    ok = (torch.float32, torch.float64) if img.device.type == "cpu" else (torch.float32,)
    if img.dtype not in ok or grids.dtype != img.dtype:
        raise TypeError(f"warp_family: img and grids must be float32 (float64 on "
                        f"the CPU), got {img.dtype} and {grids.dtype}")
    if img.dim() != 4 or grids.dim() != 5 or grids.shape[-1] != 2:
        raise ValueError(f"warp_family: img must be (B, C, H, W) and grids "
                         f"(S, B, Ho, Wo, 2), got {tuple(img.shape)} and "
                         f"{tuple(grids.shape)}")
    B, C, H, W = img.shape
    if grids.shape[1] != B:
        raise ValueError(f"warp_family: grids batch {grids.shape[1]} != image batch {B}")
    if min(H, W) < 2 or C < 1:
        raise ValueError(f"warp_family: unsupported image shape {tuple(img.shape)}")
    if not (img.is_contiguous() and grids.is_contiguous()):
        raise ValueError("warp_family: img and grids must be contiguous")


def warp_family_fwd(img: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """``img`` (B, C, H, W) sampled at ``grids`` (S, B, Ho, Wo, 2)
    (align_corners=False, border) -> (S*B, C, Ho, Wo) with g = s*B + b.
    float32; the CPU twin also takes float64, for reference runs."""
    _check_args(img, grids)
    if img.device.type == "cpu":
        return warp_family_reference(img, grids)[0]
    if img.device.type != "cuda":
        raise ValueError(f"warp_family: no kernel for device {img.device}")
    B, C, H, W = img.shape
    S, _, Ho, Wo, _ = grids.shape
    out = torch.empty((S * B, C, Ho, Wo), dtype=torch.float32, device=img.device)
    launch("ssde_warp_family_fwd", img.device, img.data_ptr(), grids.data_ptr(),
           out.data_ptr(), S, B, C, H, W, Ho, Wo)
    warp_family_fwd.launches += 1
    return out


warp_family_fwd.launches = 0  # kernel launches; the CPU twin does not count


def warp_family_bwd(img: torch.Tensor, grids: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """The gradient of ``warp_family_fwd(img, grids)`` in ``grids`` against
    ``dout`` (S*B, C, Ho, Wo) -> (S, B, Ho, Wo, 2): the channel sum of dout
    times d out / d (wx, wy), times W/2 (H/2) where the unclamped coordinate
    lies strictly inside the image, else 0 (``_gsbp_bwd``)."""
    _check_args(img, grids)
    S, B, Ho, Wo, _ = grids.shape
    C = img.shape[1]
    if dout.device != img.device:
        raise ValueError("warp_family: img, grids and dout must be on one device")
    if dout.dtype != img.dtype:
        raise TypeError(f"warp_family: dout must be {img.dtype}, got {dout.dtype}")
    if tuple(dout.shape) != (S * B, C, Ho, Wo):
        raise ValueError(f"warp_family: dout must be {(S * B, C, Ho, Wo)}, got "
                         f"{tuple(dout.shape)}")
    if not dout.is_contiguous():
        raise ValueError("warp_family: dout must be contiguous")
    if img.device.type == "cpu":
        return warp_family_bwd_reference(img, grids, dout)
    if img.device.type != "cuda":
        raise ValueError(f"warp_family: no kernel for device {img.device}")
    H, W = img.shape[2:]
    dgrid = torch.empty_like(grids)
    launch("ssde_warp_family_bwd", img.device, img.data_ptr(), grids.data_ptr(),
           dout.data_ptr(), dgrid.data_ptr(), S, B, C, H, W, Ho, Wo)
    warp_family_bwd.launches += 1
    return dgrid


warp_family_bwd.launches = 0  # kernel launches; the CPU twin does not count


class _GridSampleFamily(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, grids):
        ctx.save_for_backward(img, grids)
        return warp_family_fwd(img, grids)

    @staticmethod
    def backward(ctx, dout):
        img, grids = ctx.saved_tensors
        return None, warp_family_bwd(img, grids, dout.contiguous())


def grid_sample_family(img: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """Differentiable family warp: (S*B, C, Ho, Wo), gradient into
    ``grids`` only (``_gsbp_bwd``: dgrid = sum_c dout * rd, masked and
    scaled by W/2, H/2, the taps recomputed from ``img``)."""
    return _GridSampleFamily.apply(img.detach(), grids)
