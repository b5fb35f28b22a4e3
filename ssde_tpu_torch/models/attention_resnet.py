"""Attention-augmented ResNet encoders on NCHW (counterpart of
``ssde_tpu/models/attention_resnet.py``).

* :class:`ResnetEncoderAttention` — the ResNet encoder with one
  ``AttentionConv(k=7, groups=8)`` after each of layers 1-4 (reference
  networks/resnet_encoder_attention.py:123-166): the depth encoder of
  ``--model rn_encoder_with_attention``. Its keys are the ResNet's
  (``encoder.*``) and ``atten1`` .. ``atten4``, so a Monodepth2
  ``encoder.pth`` holds its ResNet part.
* :class:`AttentionResNet` — the "stand-alone self-attention" ResNet
  (reference networks/attention_model.py:131-239): Bottlenecks of
  expansion 1 whose middle conv is an ``AttentionConv``, the stride an
  avg-pool after the block; it normalises its own input. No trainer runs
  it. Its modules carry the JAX tree's names (``layer1_0.atten``,
  ``layer2_0.shortcut_bn``, ...).

The 7x7 convs run the plain streaming path: kernel #3 takes 3x3 windows
only, in the JAX package as here.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attention import AttentionConv
from .resnet import BatchNorm2d, ResnetEncoder


class ResnetEncoderAttention(ResnetEncoder):
    """:class:`~.resnet.ResnetEncoder` whose layer1..4 features each pass an
    ``AttentionConv(C, C, 7, groups=8)`` (no bias); the first feature map
    is the ResNet's."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1, device=None):
        super().__init__(num_layers, num_input_images, device)
        for i, c in enumerate(self.num_ch_enc[1:], start=1):
            setattr(self, f"atten{i}", AttentionConv(c, c, 7, groups=8, device=device))

    def init_weights_(self, generator: torch.Generator) -> None:
        """The ResNet's init, then each attention conv's own."""
        super().init_weights_(generator)
        for i in range(1, 5):
            getattr(self, f"atten{i}").init_weights_(generator)

    def forward(self, x) -> List[torch.Tensor]:
        feats = super().forward(x)
        return feats[:1] + [getattr(self, f"atten{i}")(f)
                            for i, f in enumerate(feats[1:], start=1)]


class AttentionBottleneck(nn.Module):
    """1x1 conv-bn-relu -> AttentionConv(k=7, groups=8)-bn-relu -> 1x1
    conv-bn, avg-pooled by ``stride`` after the block; a 1x1 strided conv
    and bn on the shortcut where the stride or the width changes."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, device=None):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(in_channels, out_channels, 1, bias=False, device=device)
        self.bn1 = BatchNorm2d(out_channels, device=device)
        self.atten = AttentionConv(out_channels, out_channels, 7, groups=8, device=device)
        self.bn2 = BatchNorm2d(out_channels, device=device)
        self.conv3 = nn.Conv2d(out_channels, out_channels, 1, bias=False, device=device)
        self.bn3 = BatchNorm2d(out_channels, device=device)
        if stride != 1 or in_channels != out_channels:
            self.shortcut_conv = nn.Conv2d(in_channels, out_channels, 1, stride, bias=False,
                                           device=device)
            self.shortcut_bn = BatchNorm2d(out_channels, device=device)
        else:
            self.shortcut_conv = self.shortcut_bn = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.atten(out)))
        out = self.bn3(self.conv3(out))
        if self.stride >= 2:
            out = F.avg_pool2d(out, self.stride, self.stride)
        sc = x if self.shortcut_conv is None else self.shortcut_bn(self.shortcut_conv(x))
        return F.relu(out + sc)


class AttentionResNet(nn.Module):
    """The self-attention ResNet, returning 5 feature maps with channels
    (64, 64, 128, 256, 512) as ``ResnetEncoder`` does."""

    num_ch_enc = (64, 64, 128, 256, 512)

    def __init__(self, num_blocks: Sequence[int] = (2, 2, 2, 2), num_input_images: int = 1,
                 device=None):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        self.conv1 = nn.Conv2d(3 * num_input_images, 64, 7, 2, 3, bias=False, device=device)
        self.bn1 = BatchNorm2d(64, device=device)
        inplanes, planes = 64, 64
        for s, n in enumerate(self.num_blocks):
            for b in range(n):
                stride = 2 if s > 0 and b == 0 else 1
                setattr(self, f"layer{s + 1}_{b}",
                        AttentionBottleneck(inplanes, planes, stride, device))
                inplanes = planes
            planes *= 2

    def forward(self, x) -> List[torch.Tensor]:
        x = (x - 0.45) / 0.225
        features = [F.relu(self.bn1(self.conv1(x)))]
        x = F.max_pool2d(features[0], 3, 2, 1)
        for s, n in enumerate(self.num_blocks):
            for b in range(n):
                x = getattr(self, f"layer{s + 1}_{b}")(x)
            features.append(x)
        return features


def AttentionResNet18(**kw) -> AttentionResNet:
    """The reference's ResNet18 preset (attention_model.py:228)."""
    return AttentionResNet((2, 2, 2, 2), **kw)


def AttentionResNet26(**kw) -> AttentionResNet:
    return AttentionResNet((1, 2, 4, 1), **kw)


def AttentionResNet38(**kw) -> AttentionResNet:
    return AttentionResNet((2, 3, 5, 2), **kw)


def AttentionResNet50(**kw) -> AttentionResNet:
    return AttentionResNet((3, 4, 6, 3), **kw)
