"""Stateful evaluation runner for the recurrent (GRU) models (counterpart of
``ssde_tpu/eval/gru_runners.py``).

Three protocols share one per-frame step with carried hidden state:

  * single-image    -- fresh h0 per test image
  * warm-up         -- run previous frames through the recurrence, then
                       predict the test frame
  * scene-streaming -- carry the hidden state across an ordered scene,
                       one depth per frame

The public contract is the JAX runner's: numpy NHWC frames (B, H, W, 3) in
[0, 1] go in, (B, H, W) sigmoid disparity comes out. Frames move to the
models' device and to NCHW there; the step runs under
``torch.inference_mode()``. Every version's step contract is the JAX
runner's (``ssde_tpu/eval/gru_runners.py:59-97``): v5 runs the decoder on
the encoder features plus the mean of the hidden states before and after
the step; v4/v6 add that mean to the decoder outputs and run the ``Head``
at scale 0; v7 feeds the block the mean of the current and previous
hidden states and runs the ``Head`` on the new ones at scale 0; the other
versions' blocks make the disparity themselves.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..train.steps_gru import PRE_DISP_VERSIONS, GRUModels


class GRUStreamEvaluator:
    """Carries recurrent state across frames; emits scale-0 disparity."""

    def __init__(self, models: GRUModels):
        self.models = models
        self.opts = models.opts
        self.version = self.opts.gru_version
        self.device = next(models.encoder.parameters()).device
        self.pre_disp = (self.version in PRE_DISP_VERSIONS
                         and bool(self.opts.gru_pre_disp))

    # carry = (hidden, hidden_prev), the JAX runner's carry
    @torch.inference_mode()
    def initial_carry(self, batch_size: int = 1):
        h0 = self.models.gru.initial_state(batch_size)
        return (h0, h0)

    def to_device(self, image: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) numpy frame -> (B, 3, H, W) float32 on the device."""
        x = torch.from_numpy(np.ascontiguousarray(image, dtype=np.float32))
        return x.to(self.device).permute(0, 3, 1, 2).contiguous()

    @torch.inference_mode()
    def step(self, carry, image: torch.Tensor):
        """One frame: NCHW image on the device -> (carry', (B, 1, H, W) disp);
        the carry is (hidden, the hidden state before it)."""
        m, v = self.models, self.version
        hidden, hidden_prev = carry
        feats = m.encoder(image)
        if v == "v5":
            h_new, _ = m.gru(feats, hidden)
            fused = [f + (h + hn) / 2 for f, h, hn in zip(feats, hidden, h_new)]
            return (h_new, hidden), m.depth(fused)["disp/0"]
        dec = m.depth(feats, pre_disp=self.pre_disp)
        if v in ("v4", "v6"):
            h_new, _ = m.gru(dec, hidden)
            # the head reads scale 0 only
            fused = {"disp/0": dec["disp/0"] + (h_new[0] + hidden[0]) / 2}
            return (h_new, hidden), m.head(fused, zero_scale_only=True)["disp/0"]
        if v == "v7":
            h_new, _ = m.gru(dec, [(c + p) / 2 for c, p in zip(hidden, hidden_prev)])
            return (h_new, hidden), m.head(h_new, zero_scale_only=True)["disp/0"]
        h_new, disp = m.gru(dec, hidden)
        return (h_new, hidden), disp["disp/0"]

    @staticmethod
    def to_host(disp: torch.Tensor) -> np.ndarray:
        """(B, 1, H, W) disparity -> (B, H, W) numpy (waits for the card)."""
        return disp[:, 0].float().cpu().numpy()

    def predict_single(self, image: np.ndarray) -> np.ndarray:
        """Fresh h0, one frame -> (B, H, W) sigmoid disparity."""
        carry = self.initial_carry(image.shape[0])
        _, disp = self.step(carry, self.to_device(image))
        return self.to_host(disp)

    def predict_with_warmup(self, prev_frames: List[np.ndarray],
                            image: np.ndarray) -> np.ndarray:
        """Warm the recurrence on previous frames, then predict."""
        carry = self.initial_carry(image.shape[0])
        for f in prev_frames:
            carry, _ = self.step(carry, self.to_device(f))
        _, disp = self.step(carry, self.to_device(image))
        return self.to_host(disp)

    def predict_scene(self, frames) -> List[np.ndarray]:
        """Stream a whole ordered scene, emitting one disparity per frame."""
        out = []
        carry = None
        for f in frames:
            f = np.asarray(f)
            if carry is None:
                carry = self.initial_carry(f.shape[0])
            carry, disp = self.step(carry, self.to_device(f))
            out.append(self.to_host(disp))
        return out
