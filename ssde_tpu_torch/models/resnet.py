"""ResNet encoder family on NCHW (counterpart of ``ssde_tpu/models/resnet.py``).

The module tree is the reference's (networks/resnet_encoder.py:17-98): a
``ResnetEncoder`` whose ``encoder`` attribute is a torchvision-shaped ResNet,
so the keys are ``encoder.conv1.weight``, ``encoder.layer1.0.bn1.running_mean``,
``encoder.layer2.0.downsample.0.weight`` and so on. The classifier head
(``encoder.fc``) is not built: the encoder never runs it.
"""

from __future__ import annotations

import contextlib
import math
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.dist import all_reduce_sum, data_group, data_world
from .common import sample_

_STAGES = {
    18: ([2, 2, 2, 2], "basic"),
    34: ([3, 4, 6, 3], "basic"),
    50: ([3, 4, 6, 3], "bottleneck"),
    101: ([3, 4, 23, 3], "bottleneck"),
    152: ([3, 8, 36, 3], "bottleneck"),
}


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm that keeps its running statistics as flax does.

    In training mode it normalises with the batch statistics (the biased
    variance, as torch already does) and updates the running mean and
    variance with momentum 0.9 on the old value and the *biased* batch
    variance (``ssde_tpu/models/resnet.py`` ``_BatchNorm``: flax
    ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``). torch's own update uses
    the unbiased variance; the update runs through torch's and is then
    corrected by hand, which needs the old running variance only (C values)
    and no second pass over the activations. Parameters, buffers and
    ``state_dict`` keys are torch's.

    While ``stats_frozen`` (:func:`running_stats_frozen`) it normalises as in
    training but updates nothing: the forward that a checkpointed region
    (``torch.utils.checkpoint``) runs again in the backward must not move the
    statistics a second time.

    On a mesh whose data axis has more than one rank (data parallelism,
    :mod:`ssde_tpu_torch.parallel`) training mode normalises with the
    statistics of the global batch, as the JAX step's BatchNorm over a
    sharded batch axis does (:meth:`_forward_global`), summed over the
    rank's data group. (The rest of its model group holds the same rows: a
    sum over the world would count each row, and each row's loss gradient,
    m times, which cancel, at m times the bytes.)
    """

    def __init__(self, num_features: int, device=None):
        super().__init__(num_features, eps=1e-5, momentum=0.1, device=device)
        self.stats_frozen = False

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if data_world() > 1:
            return self._forward_global(x)
        if self.stats_frozen:  # the same kernel on copies of the statistics
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, self.momentum, self.eps)
        # torch's update goes to a copy (autograd may keep it for the
        # backward); torch: new = 0.9 old + 0.1 var * n / (n - 1),
        # flax: 0.9 old + 0.1 var
        new_var = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, new_var, self.weight, self.bias,
                           True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.copy_(new_var - (new_var - 0.9 * self.running_var) / n)
            self.num_batches_tracked.add_(1)
        return out

    def _forward_global(self, x):
        """Training mode over the ranks' batches together: the per-channel
        sum and count summed over the ranks give the mean, then the summed
        squared deviations from it the biased variance (two passes), both in
        float32 or wider, also under bf16 autocast, and through the
        differentiable all-reduce so that each rank's backward counts every
        rank's loss. The running statistics take flax's update from the
        global figures, identical on every rank; not while ``stats_frozen``.
        Collectives run in the same order on every rank: every rank runs the
        same modules."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        c = x.shape[1]
        group = data_group()
        sums = all_reduce_sum(torch.cat([xf.sum((0, 2, 3)),
                                         xf.new_full((1,), x.numel() // c)]), group)
        mean = sums[:c] / sums[c]
        centred = xf - mean.view(1, c, 1, 1)
        var = all_reduce_sum((centred * centred).sum((0, 2, 3)), group) / sums[c]
        scale = torch.rsqrt(var + self.eps) * self.weight
        out = centred * scale.view(1, c, 1, 1) + self.bias.view(1, c, 1, 1)
        if not self.stats_frozen:
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * var)
                self.num_batches_tracked.add_(1)
        return out.to(x.dtype)


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module):
    """Freeze the running statistics of every :class:`BatchNorm2d` in
    ``module`` for the duration (the recompute of a checkpointed forward)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.stats_frozen = True
    try:
        yield
    finally:
        for m in bns:
            m.stats_frozen = False


def _bn(c, device):
    return BatchNorm2d(c, device=device)


def _downsample(cin, cout, stride, device):
    return nn.Sequential(
        nn.Conv2d(cin, cout, 1, stride, bias=False, device=device),
        _bn(cout, device))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False, device=device)
        self.bn1 = _bn(planes, device)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False, device=device)
        self.bn2 = _bn(planes, device)
        self.downsample = (_downsample(inplanes, planes, stride, device)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False, device=device)
        self.bn1 = _bn(planes, device)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False, device=device)
        self.bn2 = _bn(planes, device)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False, device=device)
        self.bn3 = _bn(planes * 4, device)
        self.downsample = (_downsample(inplanes, planes * 4, stride, device)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class _ResNet(nn.Module):
    """torchvision's ResNet trunk without the classifier; ``num_input_images``
    widens conv1 to 3*N channels (the pose encoder's stacked-pair stem,
    reference resnet_encoder.py:17-59)."""

    def __init__(self, num_layers: int, num_input_images: int = 1, device=None):
        super().__init__()
        if num_layers not in _STAGES:
            raise ValueError(f"{num_layers} is not a valid number of resnet layers")
        stages, kind = _STAGES[num_layers]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3 * num_input_images, 64, 7, 2, 3, bias=False,
                               device=device)
        self.bn1 = _bn(64, device)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes, planes = 64, 64
        for i, n_blocks in enumerate(stages):
            stride = 1 if i == 0 else 2
            blocks = []
            for j in range(n_blocks):
                out_ch = planes * block.expansion
                need_ds = j == 0 and (stride != 1 or inplanes != out_ch)
                blocks.append(block(inplanes, planes, stride if j == 0 else 1,
                                    need_ds, device))
                inplanes = out_ch
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            planes *= 2


class ResnetEncoder(nn.Module):
    """ResNet-{18,34,50,101,152} encoder returning 5 feature maps
    (reference resnet_encoder.py:62-98): channels [64, 64, 128, 256, 512],
    x4 above layer1 for the bottleneck depths. BatchNorm uses its running
    statistics in ``eval()`` mode."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1,
                 device=None):
        super().__init__()
        self.num_layers = num_layers
        self.encoder = _ResNet(num_layers, num_input_images, device)
        base = [64, 64, 128, 256, 512]
        self.num_ch_enc = (base if num_layers <= 34
                           else [base[0]] + [c * 4 for c in base[1:]])

    def init_weights_(self, generator: torch.Generator) -> None:
        """torchvision's init: convs kaiming-normal (fan_out, relu), BN
        weight 1 / bias 0, running statistics 0 / 1; the trunk's modules only."""
        for m in self.encoder.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                std = math.sqrt(2.0 / fan_out)
                sample_(m.weight, generator,
                         lambda b: b.normal_(0.0, std, generator=generator))
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x) -> List[torch.Tensor]:
        e = self.encoder
        x = (x - 0.45) / 0.225
        features = [F.relu(e.bn1(e.conv1(x)))]
        x = e.maxpool(features[-1])
        for i in range(1, 5):
            x = getattr(e, f"layer{i}")(x)
            features.append(x)
        return features


def randomize_bn_stats_(module: nn.Module, generator: torch.Generator) -> None:
    """Non-trivial BatchNorm running statistics, as the golden fixture does
    (scripts/make_golden_fixture.py:61-74): mean N(0, 0.05^2), var
    U[0.75, 1.25). Random weights stand in for a trained checkpoint this way."""
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            sample_(m.running_mean, generator,
                     lambda b: b.normal_(0.0, 0.05, generator=generator))
            sample_(m.running_var, generator,
                     lambda b: b.uniform_(0.75, 1.25, generator=generator))
