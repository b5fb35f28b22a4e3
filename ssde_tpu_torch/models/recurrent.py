"""ConvGRU / ConvLSTM recurrent depth heads on NCHW (counterpart of
``ssde_tpu/models/recurrent.py``).

Every ``--gru_version`` of the JAX package is ported, in its wiring
(reference rnn.py): v1 and v3 (per-scale sigmoid ``conv3x3_{s}`` heads),
v2 (``GRUFusionBlock``, residual attention units unless ``v2_wo_att`` or
``--disable_attention``), v4 (hidden states only; v6 is its alias), v5
(the encoder's five feature maps in, hidden states out, at H/2^(s+1)), v7
(PixelShuffle-fed coarse to fine), v8 (the v9 wiring with ConvLSTM
cells), v9 (``GRUFusionBlock_v2`` with attention units) and v10 (with
conv units). ``Head`` is the external sigmoid heads of v4/v6/v7.
Parameters carry the reference's names: ``cgru_{s}.h0_layer1`` (1, C, H,
W), ``cgru_{s}.c0_layer1`` (LSTM), ``cgru_{s}.cgru_1.conv_gates`` /
``conv_can`` or ``cgru_{s}.clstm_1.conv``, ``conv3x3_{s}.conv`` and
``fusion_{s}.*``.

Each block step is ``(dec_outputs, hidden) -> (hidden', disp or None)``;
callers carry the hidden state across frames. An LSTM scale's state is
the tuple (h, c).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.conv3x3 import conv3x3, conv3x3_reference
from ..ops.image import pixel_shuffle
from ..parallel.tensor import copy_to_model, gather_from_model, is_sharded
from .common import Conv3x3, kernel_dtype
from .fusion import GRUFusionBlock, GRUFusionBlock_v2

# per-version input/hidden channels and cell per scale
# (ssde_tpu/models/recurrent.py:261-271)
GRU_HIDDEN_SPECS = {
    "v1": dict(in_ch=(1, 1, 1, 1), hid=(1, 1, 1, 1), cell="gru"),
    "v2": dict(in_ch=(2, 2, 2, 1), hid=(2, 2, 2, 2), cell="gru"),
    "v3": dict(in_ch=(16, 32, 64, 128), hid=(16, 32, 64, 128), cell="gru"),
    "v4": dict(in_ch=(16, 32, 64, 128), hid=(16, 32, 64, 128), cell="gru"),
    "v5": dict(in_ch=(64, 64, 128, 256, 512), hid=(64, 64, 128, 256, 512), cell="gru"),
    "v7": dict(in_ch=(32, 64, 128, 128), hid=(32, 64, 128, 256), cell="gru"),
    "v8": dict(in_ch=(32, 64, 128, 128), hid=(32, 64, 128, 256), cell="lstm"),
    "v9": dict(in_ch=(32, 64, 128, 128), hid=(32, 64, 128, 256), cell="gru"),
    "v10": dict(in_ch=(32, 64, 128, 128), hid=(32, 64, 128, 256), cell="gru"),
}
# the --gru_version names that select another's block (make_gru)
ALIASES = {"v6": "v4", "v2_wo_att": "v2"}
VERSIONS = tuple(GRU_HIDDEN_SPECS) + tuple(ALIASES)


def block_version(version: str) -> str:
    """The block wiring that ``--gru_version`` selects (v6 -> v4,
    v2_wo_att -> v2); raises ``ValueError`` for an unknown name."""
    if version not in VERSIONS:
        raise ValueError(f"unknown gru version {version!r}; expected one of {VERSIONS}")
    return ALIASES.get(version, version)


def scale_shift(version: str, s: int) -> int:
    """log2 of scale ``s``'s downsampling: s, except v5, whose units sit in
    the encoder's skips at H/2^(s+1) (recurrent.py:284-300)."""
    return s + 1 if block_version(version) == "v5" else s


def kernel_scales(version: str) -> Tuple[bool, ...]:
    """Per scale: do its 3x3 convs (the recurrent cell, the fusion block's
    conv units and sigmoid head, the ``conv3x3_{s}`` heads and ``Head``)
    run the hand-written CUDA kernel?

    These are the scales that ``_gru_planar_cfg`` and ``_planar_cell``
    (ssde_tpu/models/recurrent.py:37-113) send through the Pallas
    ``_fwd_kernel`` on the TPU: the scales below 3 with ``hid <= 64``. Their
    remaining terms (``W >= 256``, the 128-lane padding budget) are
    lane-layout conditions with no counterpart in NCHW, so the choice here
    depends on the version only: scales 0-2 for v1-v4, 0 and 1 for v5, v7
    and v8-v10. (Attention units take the attend3 kernel at every scale:
    ``models/fusion``.)
    """
    hid = GRU_HIDDEN_SPECS[block_version(version)]["hid"]
    return tuple(s < 3 and h <= 64 for s, h in enumerate(hid))


def _convs(x, kernel: bool, *operands):
    """``operands`` as the convs take them: for the kernel in its operand
    dtype (:func:`~.common.kernel_dtype`) and contiguous (a timestep's input
    is a strided view of the B*T frames), else as they are."""
    if not kernel:
        return operands
    dt = kernel_dtype(x)
    return tuple(None if t is None else t.to(dt).contiguous() for t in operands)


def _copy(t: torch.Tensor, sharded: bool) -> torch.Tensor:
    """``t`` as the input of a conv that is column-parallel where ``sharded``."""
    return copy_to_model(t) if sharded else t


def _gather(t: torch.Tensor, sharded: bool) -> torch.Tensor:
    """The whole output of a conv from this rank's slice ``t`` where ``sharded``."""
    return gather_from_model(t) if sharded else t


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
        """On the model axis ``conv_gates`` and ``conv_can`` are sharded
        together (``parallel.mesh.model_sharded_params``) and run
        column-parallel: the rank computes its slices of the gates and of
        the candidate, each gathered into its own place (the x conv's output
        is [gates slice, candidate slice], which one gather would
        interleave)."""
        hid = self.hidden_dim
        fn = conv3x3 if kernel else conv3x3_reference
        s = is_sharded(self.conv_gates)
        x, h, kx, bx, kgh, kch = _convs(x, kernel, x, h, *self.split_weights())
        ng = kgh.shape[0]  # the gate channels this rank computes
        xs = fn(_copy(x, s), kx, bx, "zero", "none")
        gates = _gather(xs[:, :ng] + fn(_copy(h, s), kgh, None, "zero", "none"), s)
        reset = torch.sigmoid(gates[:, :hid])
        update = torch.sigmoid(gates[:, hid:])
        can = xs[:, ng:] + fn(_copy(reset * h, s), kch, None, "zero", "none")
        cand = torch.tanh(_gather(can, s))
        return (1.0 - update) * h + update * cand


class ConvLSTMCell(nn.Module):
    """One conv (cx+hid -> 4*hid) giving the gates i, f, o, g (reference
    rnn.py:32-79), its compute split as the JAX cell's (recurrent.py:184-203):
    x convolved with the bias plus h without; c' = sig(f) c + sig(i) tanh(g),
    h' = sig(o) tanh(c')."""

    def __init__(self, input_dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.input_dim, self.hidden_dim = input_dim, hidden_dim
        self.conv = nn.Conv2d(input_dim + hidden_dim, 4 * hidden_dim, 3, padding=1,
                              device=device)

    def forward(self, x, state, kernel: bool = False):
        h, c = state
        cx = self.input_dim
        fn = conv3x3 if kernel else conv3x3_reference
        w = self.conv.weight
        x, h, kx, bx, kh = _convs(x, kernel, x, h, w[:, :cx].contiguous(), self.conv.bias,
                                  w[:, cx:].contiguous())
        s = is_sharded(self.conv)  # the gates' slice, gathered before the chunks
        gates = fn(_copy(x, s), kx, bx, "zero", "none") + fn(_copy(h, s), kh, None, "zero", "none")
        i, f, o, g = _gather(gates, s).chunk(4, 1)
        c_next = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_next), c_next


class RecurrentUnit(nn.Module):
    """One per-scale cell with a learned initial state ``h0_layer1``
    (1, C, H, W), and ``c0_layer1`` for an LSTM, broadcast over the batch
    (reference rnn.py:82-163)."""

    def __init__(self, input_dim: int, hidden_dim: int, height: int, width: int,
                 cell: str = "gru", device=None):
        super().__init__()
        self.cell = cell
        shape = (1, hidden_dim, height, width)
        self.h0_layer1 = nn.Parameter(torch.zeros(shape, device=device))
        if cell == "lstm":
            self.c0_layer1 = nn.Parameter(torch.zeros(shape, device=device))
            self.clstm_1 = ConvLSTMCell(input_dim, hidden_dim, device)
        elif cell == "gru":
            self.cgru_1 = ConvGRUCell(input_dim, hidden_dim, device)
        else:
            raise ValueError(f"unknown cell {cell!r}; expected 'gru' or 'lstm'")

    def initial_parameters(self) -> List[nn.Parameter]:
        """The learned initial state: [h0] or [h0, c0]."""
        return [self.h0_layer1] + ([self.c0_layer1] if self.cell == "lstm" else [])

    def initial_state(self, batch_size: int):
        """h0 (and c0: the tuple (h0, c0)) broadcast to ``batch_size``."""
        s = [p.expand(batch_size, -1, -1, -1).contiguous() for p in self.initial_parameters()]
        return tuple(s) if self.cell == "lstm" else s[0]

    def forward(self, x, state, kernel: bool = False):
        if self.cell == "lstm":
            return self.clstm_1(x, state, kernel)
        return self.cgru_1(x, state, kernel)


def hidden_of(state) -> torch.Tensor:
    """h of a scale's state: the state itself, or h of an LSTM's (h, c)."""
    return state[0] if isinstance(state, tuple) else state


class ConvGRUBlocks(nn.Module):
    """Per-scale recurrent blocks, one step. (height, width) is the scale-0
    resolution; scale s runs at (H, W) / 2^:func:`scale_shift`."""

    def __init__(self, version: str = "v10", height: int = 192, width: int = 640,
                 attention: bool = True, device=None):
        super().__init__()
        version = block_version(version)
        self.version = version
        spec = GRU_HIDDEN_SPECS[version]
        self.n_scales = len(spec["hid"])
        self.kernel_scales = kernel_scales(version)
        feats = (32, 64, 128, 256)
        # v10's fusion blocks never have attention (recurrent.py:317-324)
        att = attention and version != "v10"
        for s in range(self.n_scales):
            d = scale_shift(version, s)
            setattr(self, f"cgru_{s}", RecurrentUnit(
                spec["in_ch"][s], spec["hid"][s], height >> d, width >> d, spec["cell"],
                device))
            if version in ("v1", "v3"):
                setattr(self, f"conv3x3_{s}", Conv3x3(spec["hid"][s], 1, device=device))
            elif version == "v2":
                setattr(self, f"fusion_{s}", GRUFusionBlock(
                    2, up=s > 0, attention=attention, device=device))
            elif version in ("v8", "v9", "v10"):
                setattr(self, f"fusion_{s}", GRUFusionBlock_v2(
                    feats[s], up=s > 0, attention=att, device=device))

    def unit(self, s: int) -> RecurrentUnit:
        return getattr(self, f"cgru_{s}")

    def fusion(self, s: int) -> nn.Module:
        return getattr(self, f"fusion_{s}")

    def initial_parameters(self) -> List[nn.Parameter]:
        """Every scale's learned initial state (h0, and c0 for an LSTM)."""
        return [p for s in range(self.n_scales) for p in self.unit(s).initial_parameters()]

    def initial_state(self, batch_size: int) -> list:
        return [self.unit(s).initial_state(batch_size) for s in range(self.n_scales)]

    def forward(self, dec_outputs, hidden: list):
        """One step (ssde_tpu/models/recurrent.py:330-425): ``dec_outputs``
        is the decoder's ``disp/{s}`` dict, or for v5 the list of the
        encoder's 5 feature maps; returns (new hidden, the ``disp/{s}``
        dict or None where an external head or decoder makes it)."""
        v, k = self.version, self.kernel_scales
        unit = lambda s, x: self.unit(s)(x, hidden[s], k[s])  # noqa: E731
        if v == "v5":
            return [unit(s, dec_outputs[s]) for s in range(5)], None
        dec = lambda s: dec_outputs[f"disp/{s}"]  # noqa: E731
        if v in ("v1", "v3", "v4"):
            new = [unit(s, dec(s)) for s in range(4)]
            if v == "v4":
                return new, None
            return new, {f"disp/{s}": getattr(self, f"conv3x3_{s}")(new[s], "sigmoid", k[s])
                         for s in range(4)}
        new = [None] * 4
        if v == "v7":
            new[3] = unit(3, dec(3))
            for s in (2, 1, 0):
                new[s] = unit(s, torch.cat([dec(s), pixel_shuffle(new[s + 1], 2)], 1))
            return new, None
        # v2 and v8/v9/v10: scale 3 reads the coarsest decoder output alone
        # (its fusion block concat([disp/3] * 2)), the finer scales concat it
        # with the coarser scale's ``up``; v8-v10's fusion blocks take the
        # mean of the old and new hidden state, v2's the new one
        mix = (lambda s: new[s]) if v == "v2" else \
            (lambda s: (hidden_of(hidden[s]) + hidden_of(new[s])) / 2)
        disp = {}
        new[3] = unit(3, dec(3))
        disp["disp/3"], up = self.fusion(3)(torch.cat([dec(3), dec(3)], 1), mix(3), k[3])
        for s in (2, 1, 0):
            x = torch.cat([dec(s), up], 1)
            new[s] = unit(s, x)
            if s > 0:
                disp[f"disp/{s}"], up = self.fusion(s)(x, mix(s), k[s])
            else:
                disp["disp/0"] = self.fusion(0)(x, mix(0), k[0])
        return new, disp


class Head(nn.Module):
    """External sigmoid conv heads ``conv3x3_{s}`` (Cin -> 1, reflect pad)
    of v4/v6 (16/32/64/128 channels, rnn.py:909-957) and v7 (32/64/128/256,
    rnn.py:1107-1130); ``ssde_tpu/models/recurrent.py:430-446``. Scale s's
    conv takes the kernel where ``kernel_scales[s]``."""

    def __init__(self, channels: Sequence[int] = (16, 32, 64, 128),
                 kernel_scales: Sequence[bool] = (False,) * 4, device=None):
        super().__init__()
        self.kernel_scales = tuple(kernel_scales)
        for s, c in enumerate(channels):
            setattr(self, f"conv3x3_{s}", Conv3x3(c, 1, device=device))

    def forward(self, outputs, zero_scale_only: bool = False) -> Dict[str, torch.Tensor]:
        """``outputs``: a list of per-scale maps or a ``disp/{s}`` dict."""
        disp = {}
        for s in ((0,) if zero_scale_only else (0, 1, 2, 3)):
            x = outputs[s] if isinstance(outputs, (list, tuple)) else outputs[f"disp/{s}"]
            disp[f"disp/{s}"] = getattr(self, f"conv3x3_{s}")(x, "sigmoid",
                                                              self.kernel_scales[s])
        return disp


def make_gru(version: str, height: int, width: int, attention: bool = True,
             device=None) -> ConvGRUBlocks:
    """Factory mirroring the reference's --gru_version selector
    (trainer_gru.py:108-155; ``ssde_tpu/models/recurrent.py:449-458``): v6
    is v4's wiring, ``v2_wo_att`` v2's without attention."""
    if version == "v2_wo_att":
        attention = False
    return ConvGRUBlocks(version, height, width, attention=attention, device=device)
