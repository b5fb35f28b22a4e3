"""Local windowed self-attention on NCHW (counterpart of
``ssde_tpu/models/attention.py``).

The reference's AttentionConv (networks/attention.py:9-61): per channel, a
softmax over the k x k window of ``q * (k_i + rel_i)`` weighting the values
``v_i``; q, k and v are biased or unbiased 1x1 convs, k and v of the
zero-padded input, so with a bias the pad ring carries it. The relative
embeddings add ``rel_h`` (by window row) to the first C/2 channels and
``rel_w`` (by window column) to the rest: per channel, or one scalar per
window row or column with ``shared_rel`` (fusion_v2.py:57-58). Parameters
carry the reference's names and ``.pth`` shapes: ``query_conv``,
``key_conv``, ``value_conv`` and ``rel_h`` (C/2, 1, 1, k, 1), ``rel_w``
(C/2, 1, 1, 1, k), or (1, 1, 1, k, 1) and (1, 1, 1, 1, k) shared, which is
what ``ssde_tpu/checkpoint.py``'s ``_convert_attention_conv`` (:279-296) and
the port's ``load_reference_folder`` read.

``kernel=True`` runs the fused kernel path of the JAX module
(``_kernel_path`` / ``_planar_kernel``, :237-284): the 1x1 convs of the
unpadded input, the pad ring filled with the bias, and
:func:`ssde_tpu_torch.ops.attention_win.attend3` (kernels #3/#4 on the
card), its operands in :func:`~.common.kernel_dtype` and ``rel`` in
float32. Otherwise it is ``_streaming`` (:171-215), the plain formulation.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention_win import attend3
from .common import kernel_dtype, sample_


def _kaiming_out_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """The reference's kaiming-normal (fan_out, relu) init of a conv weight."""
    fan_out = conv.weight.shape[0] * conv.weight[0, 0].numel()
    std = math.sqrt(2.0 / fan_out)
    sample_(conv.weight, generator, lambda b: b.normal_(0.0, std, generator=generator))


def _conv1x1(cin: int, cout: int, bias: bool, device) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, bias=bias, device=device)


def pad_ring(x: torch.Tensor, b) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H+2, W+2) with the one-pixel ring holding the
    per-channel ``b`` (``_pad_ring``, attention.py:80-89), or zeros for None."""
    if b is None:
        return F.pad(x, (1, 1, 1, 1))
    B, C, H, W = x.shape
    ring = b.view(1, C, 1, 1)
    x = torch.cat([ring.expand(B, C, H, 1), x, ring.expand(B, C, H, 1)], 3)
    return torch.cat([ring.expand(B, C, 1, W + 2), x, ring.expand(B, C, 1, W + 2)], 2)


class AttentionConv(nn.Module):
    """Windowed per-channel attention, stride 1, ``(k - 1) / 2`` padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 use_bias: bool = False, shared_rel: bool = False, groups: int = 1,
                 device=None):
        super().__init__()
        k, C = kernel_size, out_channels
        self.kernel_size, self.out_channels, self.shared_rel = k, C, shared_rel
        # bookkeeping only, as in the JAX module (attention.py:10-12): the
        # logits are per channel whatever the groups
        self.groups = groups
        n = 1 if shared_rel else C // 2
        self.rel_h = nn.Parameter(torch.empty(n, 1, 1, k, 1, device=device))
        self.rel_w = nn.Parameter(torch.empty(n, 1, 1, 1, k, device=device))
        self.key_conv = _conv1x1(in_channels, C, use_bias, device)
        self.query_conv = _conv1x1(in_channels, C, use_bias, device)
        self.value_conv = _conv1x1(in_channels, C, use_bias, device)
        self.init_weights_(torch.default_generator)

    def init_weights_(self, generator) -> None:
        """The reference's init (attention.py:53-61): the q, k, v conv
        weights kaiming-normal (fan_out, relu), their biases torch's
        default, the relative embeddings N(0, 1)."""
        for conv in (self.key_conv, self.query_conv, self.value_conv):
            _kaiming_out_(conv, generator)
            if conv.bias is not None:
                bound = 1.0 / math.sqrt(conv.weight[0].numel())
                sample_(conv.bias, generator,
                        lambda b: b.uniform_(-bound, bound, generator=generator))
        for rel in (self.rel_h, self.rel_w):
            sample_(rel, generator, lambda b: b.normal_(0.0, 1.0, generator=generator))

    def rel_table(self) -> torch.Tensor:
        """(k*k, C): the embedding added to the key at window slot kh*k + kw
        (``_rel_table``, attention.py:217-235)."""
        k, C = self.kernel_size, self.out_channels
        rh = self.rel_h.reshape(-1, k, 1).expand(-1, k, k).reshape(-1, k * k)
        rw = self.rel_w.reshape(-1, 1, k).expand(-1, k, k).reshape(-1, k * k)
        if self.shared_rel:
            rh, rw = rh.expand(C // 2, -1), rw.expand(C - C // 2, -1)
        return torch.cat([rh, rw], 0).t().contiguous()

    def forward(self, x: torch.Tensor, kernel: bool = False) -> torch.Tensor:
        if kernel:
            return self._kernel_path(x)
        return self._streaming(x)

    def _streaming(self, x):
        """The plain path: the 1x1 convs of the zero-padded input (the ring
        carries the bias), then the max-subtracted softmax over the window
        in the input dtype."""
        k = self.kernel_size
        p = (k - 1) // 2
        q = self.query_conv(x)
        xp = F.pad(x, (p, p, p, p))
        key, val = self.key_conv(xp), self.value_conv(xp)
        B, C, H, W = q.shape
        rel = self.rel_table().to(q.dtype)
        taps = [(dh, dw) for dh in range(k) for dw in range(k)]
        logits = [q * (key[:, :, dh:dh + H, dw:dw + W] + rel[i].view(1, C, 1, 1))
                  for i, (dh, dw) in enumerate(taps)]
        m = torch.stack(logits).amax(0).detach()  # a constant of the softmax
        num = den = 0.0
        for logit, (dh, dw) in zip(logits, taps):
            e = torch.exp(logit - m)
            den = den + e
            num = num + e * val[:, :, dh:dh + H, dw:dw + W]
        return num / den

    def _kernel_path(self, x):
        """The fused path: the 1x1 convs of the unpadded input in the
        kernel dtype, the ring filled with the bias, then attend3."""
        if self.kernel_size != 3:
            raise ValueError(f"the attend3 kernel takes a 3x3 window, not {self.kernel_size}")
        dt = kernel_dtype(x)
        x = x.to(dt)

        def conv(layer):
            b = None if layer.bias is None else layer.bias.to(dt)
            return F.conv2d(x, layer.weight.to(dt), b), b

        q, _ = conv(self.query_conv)
        key, bk = conv(self.key_conv)
        val, bv = conv(self.value_conv)
        return attend3(q.contiguous(), pad_ring(key, bk), pad_ring(val, bv), self.rel_table())


class AttentionStem(nn.Module):
    """Multi-value-projection attention stem (reference attention.py:63-127;
    ``ssde_tpu/models/attention.py:287-334``), stride 1, ``(k - 1) / 2``
    padding: ``m`` value convs mixed per window slot by a softmax over m of
    learned row and column embeddings, then the per-channel window softmax
    of ``q * k_i`` without relative embeddings. No kernel reaches it; it is
    in no trainer's path."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 groups: int = 1, m: int = 4, use_bias: bool = False, device=None):
        super().__init__()
        k, cg = kernel_size, out_channels // groups
        self.kernel_size, self.m = k, m
        self.emb_a = nn.Parameter(torch.empty(cg, k, device=device))
        self.emb_b = nn.Parameter(torch.empty(cg, k, device=device))
        self.emb_mix = nn.Parameter(torch.empty(m, cg, device=device))
        self.key_conv = _conv1x1(in_channels, out_channels, use_bias, device)
        self.query_conv = _conv1x1(in_channels, out_channels, use_bias, device)
        self.value_conv = nn.ModuleList(
            [_conv1x1(in_channels, out_channels, use_bias, device) for _ in range(m)])
        self.init_weights_(torch.default_generator)

    def init_weights_(self, generator) -> None:
        """The reference's init (attention.py:90-100): the convs
        kaiming-normal (fan_out, relu), the embeddings N(0, 1)."""
        for conv in (self.key_conv, self.query_conv, *self.value_conv):
            _kaiming_out_(conv, generator)
            if conv.bias is not None:
                bound = 1.0 / math.sqrt(conv.weight[0].numel())
                sample_(conv.bias, generator,
                        lambda b: b.uniform_(-bound, bound, generator=generator))
        for emb in (self.emb_a, self.emb_b, self.emb_mix):
            sample_(emb, generator, lambda b: b.normal_(0.0, 1.0, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, m = self.kernel_size, self.m
        p = (k - 1) // 2
        q = self.query_conv(x)
        xp = F.pad(x, (p, p, p, p))
        key = self.key_conv(xp)
        vals = torch.stack([conv(xp) for conv in self.value_conv])  # (m, B, C, H+2p, W+2p)
        emb = ((self.emb_mix @ self.emb_a)[:, :, None]
               + (self.emb_mix @ self.emb_b)[:, None, :])          # (m, k, k)
        emb = torch.softmax(emb.reshape(m, k * k), 0).to(vals.dtype)
        B, C, H, W = q.shape
        taps = [(dh, dw) for dh in range(k) for dw in range(k)]
        logits = torch.stack([q * key[:, :, dh:dh + H, dw:dw + W] for dh, dw in taps], 2)
        v = torch.stack([torch.einsum("m,mbchw->bchw", emb[:, i],
                                      vals[:, :, :, dh:dh + H, dw:dw + W])
                         for i, (dh, dw) in enumerate(taps)], 2)  # (B, C, k*k, H, W)
        return (torch.softmax(logits, 2) * v).sum(2)


class ResidualAttentionUnit(nn.Module):
    """relu-atten-relu-atten + skip (reference fusion_v2.py:105-137,
    rnn.py:640-662): two biased AttentionConvs, per-channel rel in the GRU
    blocks (``shared_rel=False``), channel-shared in fusion_v2."""

    def __init__(self, features: int, shared_rel: bool = True, device=None):
        super().__init__()
        self.atten1 = AttentionConv(features, features, 3, use_bias=True,
                                    shared_rel=shared_rel, device=device)
        self.atten2 = AttentionConv(features, features, 3, use_bias=True,
                                    shared_rel=shared_rel, device=device)

    def forward(self, x, kernel: bool = False):
        # the reference's in-place relu aliases x: the residual adds
        # relu(x), not x (fusion_v2.py:127-137, rnn.py:650-662)
        r = F.relu(x)
        out = F.relu(self.atten1(r, kernel))
        return self.atten2(out, kernel) + r
