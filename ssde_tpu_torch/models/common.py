"""Shared building blocks on NCHW (counterpart of ``ssde_tpu/models/common.py``).

Parameter names are the reference torch modules' (layers.py:106-136,
networks/fusion_v2.py:11-43), so reference ``state_dict``s load as they are.
``kernel=True`` routes a 3x3 conv through the hand-written CUDA kernel
(:func:`ssde_tpu_torch.ops.conv3x3.conv3x3`); otherwise it is the plain
``F.pad`` + ``F.conv2d`` version.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3x3 import conv3x3, conv3x3_reference
from ..parallel.tensor import column_parallel


def sample_(t: torch.Tensor, generator: torch.Generator, fill) -> None:
    """Fill ``t`` with ``fill(buffer)`` drawn on the generator's device."""
    buf = torch.empty(t.shape, dtype=t.dtype, device=generator.device)
    fill(buf)
    with torch.no_grad():
        t.copy_(buf)


def init_conv_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """torch's default Conv2d init (kaiming-uniform, a=sqrt(5): both weight
    and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in))) from ``generator``."""
    bound = 1.0 / math.sqrt(conv.weight[0].numel())
    uni = lambda b: b.uniform_(-bound, bound, generator=generator)
    sample_(conv.weight, generator, uni)
    if conv.bias is not None:
        sample_(conv.bias, generator, uni)


def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Default-initialise every Conv2d of ``module``, in registration order;
    a submodule with an ``init_weights_`` method of its own (the attention
    modules, which follow the reference's init) runs that instead."""
    if isinstance(module, nn.Conv2d):
        init_conv_(module, generator)
        return
    for child in module.children():
        own = getattr(child, "init_weights_", None)
        if own is not None:
            own(generator)
        else:
            init_weights_(child, generator)


def kernel_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype of a kernel conv's operands: autocast's where it is on for
    ``x``'s device (the compute dtype), else ``x``'s. Autocast does not reach
    the kernels, so their callers cast explicitly, as the JAX modules cast
    inputs and weights to their ``dtype`` (recurrent.py:168-170)."""
    dev = x.device.type
    return torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype


def conv(x, layer: nn.Conv2d, pad: str, act: str = "none", kernel: bool = False):
    """3x3 SAME conv of ``x`` with ``layer``'s weights, plain or kernel (in
    :func:`kernel_dtype`); column-parallel where ``layer`` is sharded over
    the model axis (``parallel.tensor``: the kernel then computes the
    rank's output channels alone)."""
    if not kernel:
        return column_parallel(
            x, layer, lambda t: conv3x3_reference(t, layer.weight, layer.bias, pad, act))
    dt = kernel_dtype(x)
    b = None if layer.bias is None else layer.bias.to(dt)
    return column_parallel(x.to(dt), layer, lambda t: conv3x3(t, layer.weight.to(dt), b, pad, act))


class Conv3x3(nn.Module):
    """Reflection-pad(1) + 3x3 conv (reference layers.py:121-136);
    ``use_refl=False`` selects zero padding."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_refl: bool = True, device=None):
        super().__init__()
        self.pad = "reflect" if use_refl else "zero"
        self.conv = nn.Conv2d(in_channels, out_channels, 3, device=device)

    def forward(self, x, act: str = "none", kernel: bool = False):
        return conv(x, self.conv, self.pad, act, kernel)


class ConvBlock(nn.Module):
    """Conv3x3 + ELU (reference layers.py:106-118)."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels, device=device)

    def forward(self, x):
        return self.conv(x, act="elu")


class ResidualConvUnit(nn.Module):
    """relu-conv-relu-conv + skip, zero padding (reference
    networks/fusion_v2.py:11-43)."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, device=device)

    def forward(self, x, kernel: bool = False):
        # the reference's in-place relu aliases x: the residual adds
        # relu(x), not x (fusion_v2.py:29-43)
        r = F.relu(x)
        out = conv(r, self.conv1, "zero", "relu", kernel)
        return conv(out, self.conv2, "zero", "none", kernel) + r
