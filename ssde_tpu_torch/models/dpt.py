"""DPT-hybrid (ViT-B/16 on a ResNet-50 stem) depth model on NCHW
(counterpart of ``ssde_tpu/models/dpt.py``).

The model ``--model dpt_gru`` trains (``ssde_tpu/models/dpt.py:175-264``):

* the stem: conv1, bn1, max-pool and the Bottlenecks of ResNet-50's
  layers 1-3, giving maps at 1/4 (256 channels), 1/8 (512) and 1/16 (1024);
* a 1x1 patch embedding of the 1/16 map to 768-d tokens, a cls token and a
  learned position embedding on a 24x24 grid plus a cls slot, resized
  bilinearly (``align_corners=False``) to the token grid;
* 12 pre-LayerNorm transformer blocks (12 heads, MLP 3072, tanh GELU);
* hooks at the stem's 1/4 and 1/8 maps, block 9's raw output and the
  tokens after the final ``norm``; the two token hooks reassembled by the
  "project" readout, a 1x1 projection and, for the last, a 3x3 stride-2
  conv to 1/32;
* four RefineNet fusion blocks (256 features, ``align_corners=True`` x2
  upsampling; the coarsest has no skip and so no ``rcu1``) and the head:
  3x3 conv, x2 upsample to the input size, 3x3 conv, ReLU, 1x1 conv.

``forward`` returns ``disp/0`` = sigmoid of the float32 logits (float64 in
a float64 run), (B, 1, H, W), and ``inv_depth`` = ReLU of the logits,
(B, H, W), as the JAX model does;
with ``capture_attention`` also ``attention``, the softmax maps of blocks
3, 6, 9 and 12 as ``attn_1`` .. ``attn_4``, (B, 12, N+1, N+1).

The attention is the plain product softmax(q * scale . k^T) . v on
``torch.matmul``: the maps are part of the output, and the JAX package
runs it outside any Pallas kernel. The parameters carry the JAX tree's
names (``stem.layer1_0``, ``block_3.attn.qkv``, ``fusion2.rcu1.conv1``, ...),
so :func:`ssde_tpu_torch.checkpoint.dpt_from_flax` is a rename plus
transposes; the stem's Bottlenecks are :class:`~.resnet.Bottleneck`, whose
BatchNorm keeps flax's running update. ``init_weights_`` draws flax's
defaults: lecun-normal (truncated) kernels, zero biases, unit norms, a
zero cls token and an N(0, 0.02) position embedding.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.image import resize_bilinear
from .common import sample_
from .resnet import BatchNorm2d, Bottleneck

DIM, HEADS, MLP, DEPTH = 768, 12, 3072, 12
POS_GRID = 24  # the canonical token grid of the position embedding (384 / 16)
ATTN_BLOCKS = (2, 5, 8, 11)  # blocks 3, 6, 9, 12: the maps returned
HOOK_BLOCK = 8  # block 9's raw output feeds reassemble3


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal in +-2 std with variance
    1 / fan_in, std corrected for the truncation."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    sample_(w, generator, lambda b: nn.init.trunc_normal_(b, 0.0, std, -2 * std, 2 * std,
                                                          generator=generator))


class _ResNet50Stem(nn.Module):
    """conv1 + bn1 + max-pool, then ResNet-50's layers 1-3 as Bottlenecks
    named ``layer{stage}_{block}``: (f_4, f_8, f_16) with 256, 512, 1024
    channels (``dpt.py:52-85``)."""

    STAGES = (3, 4, 6)

    def __init__(self, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False, device=device)
        self.bn1 = BatchNorm2d(64, device=device)
        inplanes, planes = 64, 64
        for s, n in enumerate(self.STAGES):
            stride = 1 if s == 0 else 2
            for b in range(n):
                setattr(self, f"layer{s + 1}_{b}",
                        Bottleneck(inplanes, planes, stride if b == 0 else 1, b == 0, device))
                inplanes = planes * 4
            planes *= 2

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        feats = []
        for s, n in enumerate(self.STAGES):
            for b in range(n):
                x = getattr(self, f"layer{s + 1}_{b}")(x)
            feats.append(x)
        return tuple(feats)


class _Attention(nn.Module):
    def __init__(self, dim: int = DIM, num_heads: int = HEADS, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x):
        """(B, N, C) -> (out (B, N, C), the softmax map (B, heads, N, N))."""
        B, N, C = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(B, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        # q is scaled before the product (dpt.py:100-101), which matters in bf16
        attn = torch.softmax(torch.matmul(q * (C // h) ** -0.5, k.transpose(-2, -1)), -1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out), attn


class _Block(nn.Module):
    """Pre-LN transformer block; flax's LayerNorm epsilon 1e-6 and its tanh
    GELU (``nn.gelu``)."""

    def __init__(self, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(DIM, eps=1e-6, device=device)
        self.attn = _Attention(device=device)
        self.norm2 = nn.LayerNorm(DIM, eps=1e-6, device=device)
        self.mlp_fc1 = nn.Linear(DIM, MLP, device=device)
        self.mlp_fc2 = nn.Linear(MLP, DIM, device=device)

    def forward(self, x):
        y, attn = self.attn(self.norm1(x))
        x = x + y
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="tanh"))
        return x + y, attn


class _Readout(nn.Module):
    """readout "project": each spatial token beside the cls token, a Linear
    to 768 and GELU."""

    def __init__(self, device=None):
        super().__init__()
        self.project = nn.Linear(2 * DIM, DIM, device=device)

    def forward(self, tokens):
        cls, spatial = tokens[:, :1], tokens[:, 1:]
        x = torch.cat([spatial, cls.expand_as(spatial)], -1)
        return F.gelu(self.project(x), approximate="tanh")


class _ResidualConvUnit(nn.Module):
    """relu-conv-relu-conv + x (the skip adds x itself, ``dpt.py:141-153``;
    unlike the fusion models' unit, which adds relu(x))."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, device=device)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class _FusionBlock(nn.Module):
    """rcu1(skip) + carry -> rcu2 -> x2 bilinear (align_corners) -> 1x1.
    ``skip=False`` builds the coarsest block, which has no ``rcu1``."""

    def __init__(self, features: int, skip: bool = True, device=None):
        super().__init__()
        self.rcu1 = _ResidualConvUnit(features, device) if skip else None
        self.rcu2 = _ResidualConvUnit(features, device)
        self.out_conv = nn.Conv2d(features, features, 1, device=device)

    def forward(self, carry, skip=None):
        x = carry if skip is None else carry + self.rcu1(skip)
        x = self.rcu2(x)
        h, w = x.shape[2:]
        return self.out_conv(resize_bilinear(x, (2 * h, 2 * w), align_corners=True))


class DPTDepthModel(nn.Module):
    """DPT-hybrid depth (``non_negative``: ``inv_depth`` is the ReLU of the
    logits, else the logits). Input (B, 3, H, W) in [0, 1], H and W
    multiples of 32; BatchNorm by the module's train/eval mode."""

    def __init__(self, features: int = 256, non_negative: bool = True, device=None):
        super().__init__()
        self.non_negative = non_negative
        self.stem = _ResNet50Stem(device)
        self.patch_embed = nn.Conv2d(1024, DIM, 1, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, DIM, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, POS_GRID ** 2 + 1, DIM, device=device))
        for i in range(DEPTH):
            setattr(self, f"block_{i}", _Block(device))
        self.norm = nn.LayerNorm(DIM, eps=1e-6, device=device)
        for n in (3, 4):
            setattr(self, f"reassemble{n}_readout", _Readout(device))
            setattr(self, f"reassemble{n}_proj", nn.Conv2d(DIM, DIM, 1, device=device))
        self.reassemble4_resample = nn.Conv2d(DIM, DIM, 3, 2, 1, device=device)
        for i, cin in enumerate((256, 512, DIM, DIM), start=1):
            setattr(self, f"scratch_rn{i}",
                    nn.Conv2d(cin, features, 3, padding=1, bias=False, device=device))
        for i in (1, 2, 3, 4):
            setattr(self, f"fusion{i}", _FusionBlock(features, skip=i != 4, device=device))
        self.head_conv1 = nn.Conv2d(features, features // 2, 3, padding=1, device=device)
        self.head_conv2 = nn.Conv2d(features // 2, 32, 3, padding=1, device=device)
        self.head_conv3 = nn.Conv2d(32, 1, 1, device=device)

    def init_weights_(self, generator: torch.Generator) -> None:
        """flax's default init of the JAX model, drawn from ``generator``."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.reset_parameters()
        nn.init.zeros_(self.cls_token)
        sample_(self.pos_embed, generator,
                lambda b: b.normal_(0.0, 0.02, generator=generator))

    def _reassemble(self, tokens, n: int, grid: Tuple[int, int]):
        B = tokens.shape[0]
        y = getattr(self, f"reassemble{n}_readout")(tokens)
        y = y.transpose(1, 2).reshape(B, DIM, *grid)
        y = getattr(self, f"reassemble{n}_proj")(y)
        return self.reassemble4_resample(y) if n == 4 else y

    def forward(self, x, capture_attention: bool = False) -> Dict[str, torch.Tensor]:
        B, _, H, W = x.shape
        assert H % 32 == 0 and W % 32 == 0, "input dims must be /32"
        gh, gw = H // 16, W // 16
        f4, f8, f16 = self.stem(x)

        tokens = self.patch_embed(f16).flatten(2).transpose(1, 2)  # (B, gh*gw, 768)
        pos = self.pos_embed
        grid = pos[:, 1:].reshape(1, POS_GRID, POS_GRID, DIM).permute(0, 3, 1, 2)
        pos_sp = resize_bilinear(grid, (gh, gw), align_corners=False)
        tokens = tokens + pos_sp.flatten(2).transpose(1, 2)
        cls = (self.cls_token + pos[:, :1]).expand(B, 1, DIM)
        t = torch.cat([cls, tokens.to(cls.dtype)], 1)

        attn_maps, hook = {}, None
        for i in range(DEPTH):
            t, attn = getattr(self, f"block_{i}")(t)
            if i in ATTN_BLOCKS:
                attn_maps[f"attn_{(i + 1) // 3}"] = attn
            if i == HOOK_BLOCK:
                hook = t
        t = self.norm(t)  # the last hook reads the tokens after the final norm

        l3 = self._reassemble(hook, 3, (gh, gw))   # 1/16, 768
        l4 = self._reassemble(t, 4, (gh, gw))      # 1/32, 768
        r1, r2, r3, r4 = (getattr(self, f"scratch_rn{i}")(f)
                          for i, f in enumerate((f4, f8, l3, l4), start=1))
        p = self.fusion4(r4)
        p = self.fusion3(p, r3)
        p = self.fusion2(p, r2)
        p = self.fusion1(p, r1)  # 1/2

        h = resize_bilinear(self.head_conv1(p), (H, W), align_corners=True)
        logits = self.head_conv3(F.relu(self.head_conv2(h)))
        if logits.dtype != torch.float64:  # float64 stays float64 (a reference run)
            logits = logits.float()
        out = {"disp/0": torch.sigmoid(logits),
               "inv_depth": (F.relu(logits) if self.non_negative else logits)[:, 0]}
        if capture_attention:
            out["attention"] = attn_maps
        return out


def get_mean_attention_map(attn: torch.Tensor, token_index: int,
                           grid_hw: Tuple[int, int]) -> torch.Tensor:
    """The mean over heads of one spatial query token's attention to the
    spatial tokens (``dpt.py:267-279``): ``attn`` (B, heads, N+1, N+1);
    ``token_index`` indexes the spatial tokens, a negative one from the
    end (-1 the lower right); returns (B, gh, gw)."""
    gh, gw = grid_hw
    spatial = attn[:, :, 1:, 1:]
    row = spatial[:, :, token_index if token_index >= 0 else spatial.shape[2] + token_index]
    return row.mean(1).reshape(attn.shape[0], gh, gw)
