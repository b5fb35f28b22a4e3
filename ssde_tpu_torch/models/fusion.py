"""Fusion blocks of the ConvGRU heads on NCHW (counterpart of
``ssde_tpu/models/fusion.py``).

Only what GRU v10 runs: ``GRUFusionBlock_v2`` without attention and the
conv-free ``UpscalePS`` (reference rnn.py:739-792). The attention fusion
blocks arrive with v9.
"""

from __future__ import annotations

import torch.nn as nn

from ..ops.image import pixel_shuffle
from .common import Conv3x3, ResidualConvUnit


class UpscalePS(nn.Module):
    """tanh -> PixelShuffle, the conv-free variant (``use_conv=False``) of
    reference rnn.py:783-792. It has no parameters."""

    def __init__(self, scale: int = 2):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return pixel_shuffle(x.tanh(), self.scale)


class GRUFusionBlock_v2(nn.Module):
    """rnn.FeatureFusionBlock_v2 (reference rnn.py:739-779):
    pre = rcu1(i1) + i2; out = sigmoid(Conv3x3(rcu2(pre)));
    up output = PixelShuffle(tanh(relu(pre))) when ``up``."""

    def __init__(self, features: int, up: bool = True, attention: bool = False,
                 device=None):
        super().__init__()
        if attention:
            raise NotImplementedError("attention fusion blocks arrive with GRU v9")
        self.up = up
        self.resConfUnit1 = ResidualConvUnit(features, device)
        self.resConfUnit2 = ResidualConvUnit(features, device)
        self.conv3x3 = Conv3x3(features, 1, device=device)
        self.upscale = UpscalePS(2) if up else None

    def forward(self, input_1, input_2, kernel: bool = False):
        pre = self.resConfUnit1(input_1, kernel) + input_2
        out = self.conv3x3(self.resConfUnit2(pre, kernel), act="sigmoid",
                           kernel=kernel)
        if self.up:
            # resConfUnit2's in-place relu has mutated `pre` by the time the
            # reference calls upscale (rnn.py:766-773): up sees relu(pre)
            return out, self.upscale(pre.relu())
        return out
