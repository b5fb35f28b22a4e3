"""ConvGRU recurrent depth heads on NCHW (counterpart of
``ssde_tpu/models/recurrent.py``).

The v9 and v10 wiring is ported (reference rnn.py:472-569): the same GRU
cells and fusion blocks, with residual attention units in v9's fusion blocks
(unless ``attention=False``, ``--disable_attention``) and residual conv units
in v10's. The other versions raise ``NotImplementedError`` until their turn.
Parameters carry the reference's names: ``cgru_{s}.h0_layer1`` (1, C, H,
W), ``cgru_{s}.cgru_1.conv_gates`` / ``conv_can`` and ``fusion_{s}.*``.

Each block step is ``(dec_outputs, hidden) -> (hidden', disp)``; callers
carry the hidden state across frames.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from ..ops.conv3x3 import conv3x3, conv3x3_reference
from .common import kernel_dtype
from .fusion import GRUFusionBlock_v2

# per-version input/hidden channels per scale, of the versions ported so far
# (the JAX package's GRU_HIDDEN_SPECS has all of them)
GRU_HIDDEN_SPECS = {
    "v9": dict(in_ch=(32, 64, 128, 128), hid=(32, 64, 128, 256), cell="gru"),
    "v10": dict(in_ch=(32, 64, 128, 128), hid=(32, 64, 128, 256), cell="gru"),
}


def kernel_scales(version: str) -> Tuple[bool, ...]:
    """Per scale: do its 3x3 convs (GRU cell, fusion RCUs, sigmoid head) run
    the hand-written CUDA kernel?

    These are the scales that ``_gru_planar_cfg``
    (ssde_tpu/models/recurrent.py:70-113) sends through the Pallas
    ``_fwd_kernel`` on the TPU: the GRU scales below the hardwired scale 3
    with ``hid <= 64``. Its remaining terms (``W >= 256``, the 128-lane
    padding budget) are lane-layout conditions with no counterpart in NCHW,
    so the choice here depends on the version only. For v9 and v10: scales
    0 and 1. (The attention units of v9 take the attend3 kernel at every
    scale: ``models/fusion.GRUFusionBlock_v2``.)
    """
    hid = GRU_HIDDEN_SPECS[version]["hid"]
    return tuple(s < 3 and h <= 64 for s, h in enumerate(hid))


class ConvGRUCell(nn.Module):
    """Conv gates (reset/update) + tanh candidate (reference rnn.py:101-140).

    The parameters are the reference's ``conv_gates`` (cx+hid -> 2*hid) on
    concat([x, h]) and ``conv_can`` (cx+hid -> hid) on concat([x, reset*h]).
    The compute is split as in the JAX package (recurrent.py:133-155):
    conv(concat([a, b]), K) == conv(a, K[:, :ca]) + conv(b, K[:, ca:]), so x
    is convolved once to 3*hid channels with the concatenated bias, h once
    to 2*hid without bias, and reset*h to hid without bias.
    """

    def __init__(self, input_dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.input_dim, self.hidden_dim = input_dim, hidden_dim
        cin = input_dim + hidden_dim
        self.conv_gates = nn.Conv2d(cin, 2 * hidden_dim, 3, padding=1, device=device)
        self.conv_can = nn.Conv2d(cin, hidden_dim, 3, padding=1, device=device)

    def split_weights(self):
        """(kx, bx, kh_gates, kh_can): the weights of the three convs."""
        cx = self.input_dim
        wg, wc = self.conv_gates.weight, self.conv_can.weight
        kx = torch.cat([wg[:, :cx], wc[:, :cx]], dim=0)
        bx = torch.cat([self.conv_gates.bias, self.conv_can.bias])
        return kx, bx, wg[:, cx:].contiguous(), wc[:, cx:].contiguous()

    def forward(self, x, h, kernel: bool = False):
        hid = self.hidden_dim
        fn = conv3x3 if kernel else conv3x3_reference
        kx, bx, kgh, kch = self.split_weights()
        if kernel:  # the kernel's operands in the compute dtype
            dt = kernel_dtype(x)
            x, h, kx, bx, kgh, kch = (t.to(dt) for t in (x, h, kx, bx, kgh, kch))
        xs = fn(x, kx, bx, "zero", "none")
        gates = xs[:, :2 * hid] + fn(h, kgh, None, "zero", "none")
        reset = torch.sigmoid(gates[:, :hid])
        update = torch.sigmoid(gates[:, hid:])
        cand = torch.tanh(xs[:, 2 * hid:] + fn(reset * h, kch, None, "zero", "none"))
        return (1.0 - update) * h + update * cand


class RecurrentUnit(nn.Module):
    """One per-scale GRU cell with a learned initial state ``h0_layer1``
    (1, C, H, W), broadcast over the batch (reference rnn.py:82-163)."""

    def __init__(self, input_dim: int, hidden_dim: int, height: int, width: int,
                 device=None):
        super().__init__()
        self.h0_layer1 = nn.Parameter(
            torch.zeros(1, hidden_dim, height, width, device=device))
        self.cgru_1 = ConvGRUCell(input_dim, hidden_dim, device)

    def initial_state(self, batch_size: int) -> torch.Tensor:
        return self.h0_layer1.expand(batch_size, -1, -1, -1).contiguous()

    def forward(self, x, h, kernel: bool = False):
        return self.cgru_1(x, h, kernel)


class ConvGRUBlocks(nn.Module):
    """Per-scale recurrent blocks, one step. (height, width) is the scale-0
    resolution; scale s runs at (H/2^s, W/2^s)."""

    def __init__(self, version: str = "v10", height: int = 192, width: int = 640,
                 attention: bool = True, device=None):
        super().__init__()
        if version not in GRU_HIDDEN_SPECS:
            raise NotImplementedError(
                f"GRU {version} is not ported yet (ported: {tuple(GRU_HIDDEN_SPECS)})")
        self.version = version
        spec = GRU_HIDDEN_SPECS[version]
        self.n_scales = len(spec["hid"])
        self.kernel_scales = kernel_scales(version)
        feats = (32, 64, 128, 256)
        # v10's fusion blocks never have attention (recurrent.py:317-324)
        att = attention and version != "v10"
        for s in range(self.n_scales):
            setattr(self, f"cgru_{s}", RecurrentUnit(
                spec["in_ch"][s], spec["hid"][s], height >> s, width >> s, device))
            setattr(self, f"fusion_{s}", GRUFusionBlock_v2(
                feats[s], up=s > 0, attention=att, device=device))

    def unit(self, s: int) -> RecurrentUnit:
        return getattr(self, f"cgru_{s}")

    def fusion(self, s: int) -> GRUFusionBlock_v2:
        return getattr(self, f"fusion_{s}")

    def initial_state(self, batch_size: int) -> List[torch.Tensor]:
        return [self.unit(s).initial_state(batch_size) for s in range(self.n_scales)]

    def forward(self, dec_outputs: Dict[str, torch.Tensor],
                hidden: List[torch.Tensor]):
        """v8/v9/v10 wiring (ssde_tpu/models/recurrent.py:382-425): scale 3
        reads concat([disp/3] * 2), each fusion block mixes the mean of the
        old and new hidden state, scales run coarse to fine with ``up``
        fed forward."""
        disp, new = {}, [None] * self.n_scales
        k = self.kernel_scales
        dec3 = dec_outputs["disp/3"]
        new[3] = self.unit(3)(dec3, hidden[3], k[3])
        disp["disp/3"], up = self.fusion(3)(
            torch.cat([dec3, dec3], dim=1), (hidden[3] + new[3]) / 2, k[3])
        for s in (2, 1, 0):
            x = torch.cat([dec_outputs[f"disp/{s}"], up], dim=1)
            new[s] = self.unit(s)(x, hidden[s], k[s])
            mix = (hidden[s] + new[s]) / 2
            if s > 0:
                disp[f"disp/{s}"], up = self.fusion(s)(x, mix, k[s])
            else:
                disp["disp/0"] = self.fusion(0)(x, mix, k[0])
        return new, disp


def make_gru(version: str, height: int, width: int, attention: bool = True,
             device=None) -> ConvGRUBlocks:
    """Factory mirroring the reference's --gru_version selector
    (trainer_gru.py:108-155)."""
    return ConvGRUBlocks(version, height, width, attention=attention, device=device)
