"""Pose networks on NCHW (counterpart of ``ssde_tpu/models/pose.py``).

``PoseDecoder`` (reference networks/pose_decoder.py:14-54): one shared 1x1
``squeeze`` conv on the last feature map of every input, then two ReLU 3x3
convs and a 1x1 conv to 6 values per predicted frame, averaged over the
image and scaled by 0.01. The modules sit in the reference's ``net``
ModuleList (``net.0`` squeeze, ``net.1``..``net.3`` pose_0..pose_2), so
reference ``pose.pth`` keys load as they are.

``PoseCNN`` (``--pose_model_type posecnn``, reference
networks/pose_cnn.py:13-50): seven stride-2 ReLU convs straight from the
stacked RGB frames, a 1x1 ``pose_conv`` to 6 values per frame after the
first, the spatial mean and x0.01; the reference's keys ``net.0`` ..
``net.6`` and ``pose_conv``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class PoseDecoder(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int], num_input_features: int = 1,
                 num_frames_to_predict_for: int = 2, stride: int = 1, device=None):
        super().__init__()
        self.num_frames = num_frames_to_predict_for
        self.net = nn.ModuleList([
            nn.Conv2d(num_ch_enc[-1], 256, 1, device=device),
            nn.Conv2d(num_input_features * 256, 256, 3, stride, 1, device=device),
            nn.Conv2d(256, 256, 3, stride, 1, device=device),
            nn.Conv2d(256, 6 * num_frames_to_predict_for, 1, device=device),
        ])

    def forward(self, input_features: Sequence[Sequence[torch.Tensor]]):
        """``input_features``: per input image, its encoder feature list.
        Returns (axisangle, translation), each (B, frames, 1, 3)."""
        squeeze = self.net[0]
        out = torch.cat([F.relu(squeeze(f[-1])) for f in input_features], 1)
        out = F.relu(self.net[1](out))
        out = F.relu(self.net[2](out))
        out = self.net[3](out).mean((2, 3))
        out = 0.01 * out.reshape(-1, self.num_frames, 1, 6)
        return out[..., :3], out[..., 3:]


class PoseCNN(nn.Module):
    # (out channels, kernel, stride, padding) of net.0 .. net.6
    SPECS = ((16, 7, 2, 3), (32, 5, 2, 2), (64, 3, 2, 1), (128, 3, 2, 1),
             (256, 3, 2, 1), (256, 3, 2, 1), (256, 3, 2, 1))

    def __init__(self, num_input_frames: int = 2, device=None):
        super().__init__()
        self.num_input_frames = num_input_frames
        convs, cin = [], 3 * num_input_frames
        for ch, k, s, p in self.SPECS:
            convs.append(nn.Conv2d(cin, ch, k, s, p, device=device))
            cin = ch
        self.net = nn.ModuleList(convs)
        self.pose_conv = nn.Conv2d(cin, 6 * (num_input_frames - 1), 1, device=device)

    def forward(self, x: torch.Tensor):
        """``x`` (B, 3 * frames, H, W). Returns (axisangle, translation),
        each (B, frames - 1, 1, 3)."""
        for conv in self.net:
            x = F.relu(conv(x))
        out = self.pose_conv(x).mean((2, 3))
        out = 0.01 * out.reshape(-1, self.num_input_frames - 1, 1, 6)
        return out[..., :3], out[..., 3:]
