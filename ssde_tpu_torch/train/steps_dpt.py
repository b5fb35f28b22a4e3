"""The DPT-hybrid train step, ``--model dpt_gru`` (counterpart of
``ssde_tpu/train/steps_dpt.py``).

The DPT forward takes the place of the ResNet encoder and DepthDecoder and
gives one full-resolution ``disp/0``; the pose networks, the warp and the
min-reprojection loss are the mono step's (:func:`steps.predict_poses`,
:func:`steps.generate_images_pred`, :func:`steps.compute_losses`), at
scale 0 only: the DPT trainer forces frames [0, -1, 1] and scales [0]
(``ssde_tpu/train/trainer.py:460-494``), so the photometric launch takes
G = 4B pairs (6B under ``--use_stereo``, which adds the source "s"). The
DPT step takes ``--use_stereo``, ``--no_ssim`` and ``--avg_reprojection``
(the shared loss); the other Monodepth2 options raise
(:func:`steps.check_supported`). Precision is the mono step's: the networks
under autocast in ``compute_dtype``, the geometry, warp and loss in
float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..config import Options
from ..models import PoseDecoder, ResnetEncoder
from ..models.common import init_weights_
from ..models.dpt import DPTDepthModel
from . import steps
from .state import TrainState


@dataclasses.dataclass
class DPTModels:
    """Module bundle of the DPT trainer."""

    dpt: DPTDepthModel
    pose_encoder: ResnetEncoder
    pose: PoseDecoder
    opts: Options

    @property
    def source_ids(self):
        """The warp sources of the loss: (-1, 1), and "s" under
        ``--use_stereo`` (``ssde_tpu/train/steps_dpt.py:35-40``)."""
        return (-1, 1, "s") if steps.stereo(self.opts) else (-1, 1)

    def modules(self):
        return (self.dpt, self.pose_encoder, self.pose)

    def parameters(self) -> List[torch.nn.Parameter]:
        return [p for m in self.modules() for p in m.parameters()]

    def train(self, mode: bool = True) -> "DPTModels":
        for m in self.modules():
            m.train(mode)
        return self


def build_dpt_models(opts: Options, device="cuda",
                     generator: Optional[torch.Generator] = None) -> DPTModels:
    """The DPT-hybrid (``non_negative``) and a separate ResNet pose encoder on
    stacked pairs + the PoseDecoder, float32 parameters. With a
    ``generator`` the weights are drawn from it on the CPU (flax's defaults
    for the DPT, torchvision's init for the pose encoder, torch's default for
    the decoder) before the move to ``device``."""
    steps.check_supported(opts, "dpt")
    dpt = DPTDepthModel(non_negative=True)
    pose_encoder = ResnetEncoder(opts.num_layers, num_input_images=2)
    pose = PoseDecoder(pose_encoder.num_ch_enc, num_input_features=1,
                       num_frames_to_predict_for=2)
    if generator is not None:
        dpt.init_weights_(generator)
        pose_encoder.init_weights_(generator)
        init_weights_(pose, generator)
    return DPTModels(*(m.to(device) for m in (dpt, pose_encoder, pose)), opts)


def dpt_loss_fn(models: DPTModels, inputs, generator: Optional[torch.Generator] = None):
    """DPT on ``color_aug/0/0`` -> poses -> warp -> loss
    (``ssde_tpu/train/steps_dpt.py:70-91``); returns (loss, losses,
    outputs). The modules' train/eval mode decides BatchNorm."""
    opts = models.opts
    device = inputs["color_aug/0/0"].device
    with steps._autocast(opts, device):
        outputs = models.dpt(inputs["color_aug/0/0"])
        outputs.update(steps.predict_poses(models, inputs))
    with torch.autocast(device.type, enabled=False):
        outputs = steps.generate_images_pred(inputs, outputs, opts, models.source_ids)
        losses = steps.compute_losses(inputs, outputs, opts, models.source_ids, generator)
    return losses["loss"], losses, outputs


def train_step(models: DPTModels, state: TrainState, batch,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step on a device batch: the mono step's preprocessing
    (``ssde_tpu/train/steps_dpt.py:97-114``), forward in train mode,
    backward, Adam. Returns the losses (detached, on the device)."""
    inputs = steps.preprocess_train(batch, models.opts)
    models.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, losses, _ = dpt_loss_fn(models, inputs, generator)
    loss.backward()
    state.apply_gradients()
    return {k: v.detach() for k, v in losses.items()}
