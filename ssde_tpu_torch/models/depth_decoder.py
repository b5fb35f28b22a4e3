"""U-Net depth decoder on NCHW (counterpart of
``ssde_tpu/models/depth_decoder.py``, reference networks/depth_decoder.py).

Five up-stages (channels 256..16): ConvBlock, nearest x2 upsample, encoder
skip concat, ConvBlock; sigmoid ``dispconv`` heads at the requested scales.
``pre_disp=True`` returns the ConvBlock features instead, the hook of the
GRU variants. The modules sit in the reference's ordered ``decoder``
ModuleList (``decoder.N.conv.conv.weight``), upconv_4_0 first and the
dispconvs last. The ``dispconv`` modules exist even when only
``pre_disp`` outputs are used, so reference keys load.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.image import upsample2x_nearest
from .common import Conv3x3, ConvBlock

NUM_CH_DEC = (16, 32, 64, 128, 256)


def module_order(scales: Sequence[int]) -> Tuple[str, ...]:
    """Names of the ``decoder.N`` entries, in index order."""
    names = []
    for i in range(4, -1, -1):
        names += [f"upconv_{i}_0", f"upconv_{i}_1"]
    return tuple(names + [f"dispconv_{s}" for s in scales])


class DepthDecoder(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int], scales=(0, 1, 2, 3),
                 num_output_channels: int = 1, use_skips: bool = True,
                 device=None):
        super().__init__()
        self.scales = tuple(scales)
        self.use_skips = use_skips
        mods = {}
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
            mods[f"upconv_{i}_0"] = ConvBlock(cin, NUM_CH_DEC[i], device)
            cin = NUM_CH_DEC[i] + (num_ch_enc[i - 1] if use_skips and i > 0 else 0)
            mods[f"upconv_{i}_1"] = ConvBlock(cin, NUM_CH_DEC[i], device)
        for s in self.scales:
            mods[f"dispconv_{s}"] = Conv3x3(NUM_CH_DEC[s], num_output_channels,
                                            device=device)
        self._index = {n: k for k, n in enumerate(module_order(self.scales))}
        self.decoder = nn.ModuleList([mods[n] for n in module_order(self.scales)])

    def _m(self, name: str) -> nn.Module:
        return self.decoder[self._index[name]]

    def dispconv_parameters(self):
        """The parameters of the sigmoid ``dispconv`` heads."""
        return [p for s in self.scales for p in self._m(f"dispconv_{s}").parameters()]

    def forward(self, input_features: Sequence[torch.Tensor],
                pre_disp: bool = False) -> Dict[str, torch.Tensor]:
        outputs = {}
        x = input_features[-1]
        for i in range(4, -1, -1):
            x = upsample2x_nearest(self._m(f"upconv_{i}_0")(x))
            if self.use_skips and i > 0:
                x = torch.cat([x, input_features[i - 1]], dim=1)
            x = self._m(f"upconv_{i}_1")(x)
            if i in self.scales:
                outputs[f"disp/{i}"] = (x if pre_disp else
                                        self._m(f"dispconv_{i}")(x, act="sigmoid"))
        return outputs
