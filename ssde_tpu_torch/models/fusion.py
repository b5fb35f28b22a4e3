"""Fusion blocks of the ConvGRU heads on NCHW (counterpart of
``ssde_tpu/models/fusion.py``).

The fusion blocks of the recurrent family: ``GRUFusionBlock`` (GRU v2,
reference rnn.py:696-737) and ``GRUFusionBlock_v2`` (v8, v9 and v10,
rnn.py:739-779), with residual attention units (v2, v8, v9) or residual
conv units (v2_wo_att, v10, and any of them with ``--disable_attention``),
and the conv-free ``UpscalePS`` (rnn.py:783-792).
"""

from __future__ import annotations

import torch.nn as nn

from ..ops.image import pixel_shuffle, resize_bilinear
from .attention import ResidualAttentionUnit
from .common import Conv3x3, ResidualConvUnit


class UpscalePS(nn.Module):
    """tanh -> PixelShuffle, the conv-free variant (``use_conv=False``) of
    reference rnn.py:783-792. It has no parameters."""

    def __init__(self, scale: int = 2):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return pixel_shuffle(x.tanh(), self.scale)


def _units(n: int, features: int, attention: bool, device):
    """``n`` residual units: attention units with per-channel relative
    embeddings (``shared_rel=False``, rnn.py:578) or conv units."""
    if attention:
        return [ResidualAttentionUnit(features, shared_rel=False, device=device)
                for _ in range(n)]
    return [ResidualConvUnit(features, device) for _ in range(n)]


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
        self.upscale = UpscalePS(2) if up else None

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
