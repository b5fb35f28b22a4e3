"""Fusion blocks on NCHW (counterpart of ``ssde_tpu/models/fusion.py``).

Two families, both with residual attention units or residual conv units:

* the 3-frame attention fusion of reference networks/fusion_v2.py, with
  channel-shared relative embeddings (``shared_rel=True``):
  ``FeatureFusionBlock`` (the scale-loop block), ``FeatureFusionBlock_v2``
  chained by ``Fusion`` (the pre-disp pyramid) and ``FeatureFusionBlock_v3``
  chained by ``Fusion_v3``. Their parameter names are the reference's,
  which ``ssde_tpu/checkpoint.py`` ``convert_fusion_v2`` (:361) reads;
* the fusion blocks of the recurrent family: ``GRUFusionBlock`` (GRU v2,
  reference rnn.py:696-737) and ``GRUFusionBlock_v2`` (v8, v9 and v10,
  rnn.py:739-779), with per-channel relative embeddings.

``UpscalePS`` is conv -> tanh -> PixelShuffle (fusion_v2.py:226-235), or
without its conv (``use_conv=False``) the recurrent family's
(rnn.py:783-792). Attention units always take their kernel path (attend3
on the card): on the TPU the fused attention kernel serves every fusion
shape (``fits_attend3``). The 3x3 convs of the 3-frame blocks are plain
convs (cuDNN on the card), as the JAX blocks' NHWC ``Conv3x3`` reaches no
Pallas kernel; the GRU blocks route theirs through the conv3x3 kernel with
``kernel``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.image import pixel_shuffle, resize_bilinear
from .attention import ResidualAttentionUnit
from .common import Conv3x3, ResidualConvUnit


class UpscalePS(nn.Module):
    """A zero-padded, biased 3x3 ``conv`` from ``in_channels`` to
    ``output_ch * scale**2``, tanh, PixelShuffle (reference
    fusion_v2.py:226-235). ``use_conv=False`` is the conv-free variant of
    rnn.py:783-792, tanh -> PixelShuffle, with no parameters."""

    def __init__(self, in_channels: int = 0, output_ch: int = 1, scale: int = 2,
                 use_conv: bool = True, device=None):
        super().__init__()
        self.scale = scale
        if use_conv:
            self.conv = nn.Conv2d(in_channels, output_ch * scale ** 2, 3, padding=1,
                                  device=device)
        else:
            self.conv = None

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        return pixel_shuffle(x.tanh(), self.scale)


def _units(n: int, features: int, attention: bool, device, shared_rel: bool = False):
    """``n`` residual units: attention units, with channel-shared relative
    embeddings in the 3-frame blocks (``shared_rel``, fusion_v2.py:57-58) and
    per-channel ones in the GRU blocks (rnn.py:578), or conv units."""
    if attention:
        return [ResidualAttentionUnit(features, shared_rel=shared_rel, device=device)
                for _ in range(n)]
    return [ResidualConvUnit(features, device) for _ in range(n)]


class FeatureFusionBlock(nn.Module):
    """fusion_v2.FeatureFusionBlock (reference fusion_v2.py:140-173;
    ``ssde_tpu/models/fusion.py:58-81``), the scale-loop block:
    rcu1(dt || upt) + rcu2(dt_1 || dt_2) -> rcu3 -> Conv3x3(features -> 1)
    with no activation. Returns (out, out resized bilinearly x2 with
    ``align_corners=True``)."""

    def __init__(self, features: int = 2, device=None):
        super().__init__()
        self.resConfUnit1, self.resConfUnit2, self.resConfUnit3 = _units(
            3, features, True, device, shared_rel=True)
        self.conv3x3 = Conv3x3(features, 1, device=device)

    def forward(self, dt, upt, dt_1, dt_2):
        out = (self.resConfUnit1(torch.cat([dt, upt], 1), True)
               + self.resConfUnit2(torch.cat([dt_1, dt_2], 1), True))
        out = self.conv3x3(self.resConfUnit3(out, True))
        return out, resize_bilinear(out, (2 * out.shape[2], 2 * out.shape[3]),
                                    align_corners=True)


class FeatureFusionBlock_v2(nn.Module):
    """fusion_v2.FeatureFusionBlock_v2 (reference fusion_v2.py:176-223;
    ``ssde_tpu/models/fusion.py:84-115``), a block of the pre-disp pyramid.
    ``init_scale`` (the coarsest block, no ``upt``) maps ``dt``, the
    decoder's 128 features at scale 3, through ``conv_init``, a zero-padded
    3x3 conv to 256;
    otherwise dt || upt. rcu1 of that + rcu2(dt_1 || dt_2) -> rcu3. At
    ``scale`` 1 it returns (Conv3x3(features -> 1), None); above, the
    depth ``upscale_1`` = UpscalePS(1, scale), at full resolution, and the
    features of the next finer block ``upscale_2`` = UpscalePS(features/4, 2)."""

    def __init__(self, features: int, scale: int, init_scale: bool = False, device=None):
        super().__init__()
        self.scale = scale
        self.conv_init = (nn.Conv2d(128, 256, 3, padding=1, device=device)
                          if init_scale else None)
        self.resConfUnit1, self.resConfUnit2, self.resConfUnit3 = _units(
            3, features, True, device, shared_rel=True)
        if scale == 1:
            self.conv3x3 = Conv3x3(features, 1, device=device)
        else:
            self.upscale_1 = UpscalePS(features, 1, scale, device=device)
            self.upscale_2 = UpscalePS(features, features // 4, 2, device=device)

    def forward(self, dt, upt, dt_1, dt_2):
        dt_upt = self.conv_init(dt) if upt is None else torch.cat([dt, upt], 1)
        out = (self.resConfUnit1(dt_upt, True)
               + self.resConfUnit2(torch.cat([dt_1, dt_2], 1), True))
        out = self.resConfUnit3(out, True)
        if self.scale == 1:
            return self.conv3x3(out), None
        return self.upscale_1(out), self.upscale_2(out)


class FeatureFusionBlock_v3(nn.Module):
    """fusion_v2.FeatureFusionBlock_v3 (reference fusion_v2.py:279-322;
    ``ssde_tpu/models/fusion.py:118-149``), on sigmoid disparities.
    ``init_scale`` maps ``dt`` through ``conv_1`` (a zero-padded 3x3 conv,
    1 -> 2); otherwise dt || upt. rcu1 of that and rcu2(dt_1 || dt_2), at
    ``features``, concatenated -> rcu3 at 2 * features -> Conv3x3 depth,
    and ``upscale`` = UpscalePS(1, 2) of the same for the next finer block.
    ``attention=False`` (``--disable_attention``) gives conv units."""

    def __init__(self, features: int = 2, attention: bool = True, init_scale: bool = False,
                 device=None):
        super().__init__()
        self.attention = attention
        self.conv_1 = nn.Conv2d(1, 2, 3, padding=1, device=device) if init_scale else None
        self.resConfUnit1, self.resConfUnit2 = _units(2, features, attention, device,
                                                      shared_rel=True)
        (self.resConfUnit3,) = _units(1, 2 * features, attention, device, shared_rel=True)
        self.conv3x3 = Conv3x3(2 * features, 1, device=device)
        self.upscale = UpscalePS(2 * features, 1, 2, device=device)

    def forward(self, dt, upt, dt_1, dt_2):
        a = self.attention
        dt_upt = self.conv_1(dt) if self.conv_1 is not None else torch.cat([dt, upt], 1)
        out = torch.cat([self.resConfUnit1(dt_upt, a),
                         self.resConfUnit2(torch.cat([dt_1, dt_2], 1), a)], 1)
        out = self.resConfUnit3(out, a)
        return self.conv3x3(out), self.upscale(out)


# Fusion's blocks, coarse to fine: (features, scale, init_scale), at
# decoder scales 3 .. 0 (ssde_tpu/models/fusion.py:162)
FUSION_SPECS = ((256, 8, True), (128, 4, False), (64, 2, False), (32, 1, False))


class Fusion(nn.Module):
    """Chains the 4 ``FeatureFusionBlock_v2`` ``fusion_block_{1..4}`` over
    the per-frame dicts of pre-disp decoder features, scales 3 -> 0
    (reference fusion_v2.py:239-275; ``ssde_tpu/models/fusion.py:152-170``).
    Every ``disp/{s}`` it returns is at full resolution; ``disp/0`` is a
    raw conv and the others tanh, not sigmoids."""

    def __init__(self, device=None):
        super().__init__()
        for n, (feat, scale, init) in enumerate(FUSION_SPECS, 1):
            setattr(self, f"fusion_block_{n}",
                    FeatureFusionBlock_v2(feat, scale, init_scale=init, device=device))

    def forward(self, dec, dec_t1, dec_t2):
        outputs, up = {}, None
        for n in range(1, 5):
            s = 4 - n
            outputs[f"disp/{s}"], up = getattr(self, f"fusion_block_{n}")(
                dec[f"disp/{s}"], up, dec_t1[f"disp/{s}"], dec_t2[f"disp/{s}"])
        return outputs


class Fusion_v3(nn.Module):
    """Chains the 4 ``FeatureFusionBlock_v3`` ``fusion_block_{1..4}`` (2
    features; the first with ``init_scale``) over the per-frame dicts of
    sigmoid disparities, scales 3 -> 0 (reference fusion_v2.py:325-363;
    ``ssde_tpu/models/fusion.py:173-190``)."""

    def __init__(self, attention: bool = True, device=None):
        super().__init__()
        for n in range(1, 5):
            setattr(self, f"fusion_block_{n}",
                    FeatureFusionBlock_v3(2, attention, init_scale=n == 1, device=device))

    def forward(self, dec, dec_t1, dec_t2):
        outputs, up = {}, None
        for n in range(1, 5):
            s = 4 - n
            outputs[f"disp/{s}"], up = getattr(self, f"fusion_block_{n}")(
                dec[f"disp/{s}"], up, dec_t1[f"disp/{s}"], dec_t2[f"disp/{s}"])
        return outputs


class GRUFusionBlock(nn.Module):
    """rnn.FeatureFusionBlock (reference rnn.py:696-737;
    ``ssde_tpu/models/fusion.py:193-215``): rcu1(i1) + rcu2(i2) -> rcu3 ->
    Conv3x3(features -> 1) -> sigmoid; with ``up`` also that disparity
    resized bilinearly x2 with ``align_corners=True``.

    ``kernel`` routes the 3x3 convs (the conv units' and the head's)
    through the conv3x3 kernel; attention units take attend3 at every
    scale, as in :class:`GRUFusionBlock_v2`."""

    def __init__(self, features: int, up: bool = True, attention: bool = True,
                 device=None):
        super().__init__()
        self.up, self.attention = up, attention
        self.resConfUnit1, self.resConfUnit2, self.resConfUnit3 = _units(
            3, features, attention, device)
        self.conv3x3 = Conv3x3(features, 1, device=device)

    def forward(self, input_1, input_2, kernel: bool = False):
        unit_kernel = self.attention or kernel
        out = self.resConfUnit1(input_1, unit_kernel) + self.resConfUnit2(input_2, unit_kernel)
        out = self.conv3x3(self.resConfUnit3(out, unit_kernel), act="sigmoid", kernel=kernel)
        if self.up:
            return out, resize_bilinear(out, (2 * out.shape[2], 2 * out.shape[3]),
                                        align_corners=True)
        return out


class GRUFusionBlock_v2(nn.Module):
    """rnn.FeatureFusionBlock_v2 (reference rnn.py:739-779):
    pre = rcu1(i1) + i2; out = sigmoid(Conv3x3(rcu2(pre)));
    up output = PixelShuffle(tanh(relu(pre))) when ``up``. The residual
    units are ``ResidualAttentionUnit(shared_rel=False)`` with
    ``attention`` (v9), ``ResidualConvUnit`` without it.

    ``kernel`` routes the 3x3 convs (the conv units' and the head's)
    through the conv3x3 kernel. The attention units always take their
    kernel path (attend3): on the TPU the fused attention kernel serves
    every scale of the 640x192 block (``fits_attend3``), so here it runs
    at all four."""

    def __init__(self, features: int, up: bool = True, attention: bool = False,
                 device=None):
        super().__init__()
        self.up, self.attention = up, attention
        self.resConfUnit1, self.resConfUnit2 = _units(2, features, attention, device)
        self.conv3x3 = Conv3x3(features, 1, device=device)
        self.upscale = UpscalePS(scale=2, use_conv=False) if up else None

    def forward(self, input_1, input_2, kernel: bool = False):
        unit_kernel = self.attention or kernel
        pre = self.resConfUnit1(input_1, unit_kernel) + input_2
        out = self.conv3x3(self.resConfUnit2(pre, unit_kernel), act="sigmoid",
                           kernel=kernel)
        if self.up:
            # resConfUnit2's in-place relu has mutated `pre` by the time the
            # reference calls upscale (rnn.py:766-773): up sees relu(pre)
            return out, self.upscale(pre.relu())
        return out
