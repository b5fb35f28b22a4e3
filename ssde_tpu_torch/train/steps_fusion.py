"""The 3-frame attention-fusion models: the bundle, serving and the train
step (counterpart of ``ssde_tpu/train/steps_fusion.py``).

Three variants, as in the JAX package:

* ``pyramid`` — decoder pre-disp features -> ``Fusion`` (the
  ``FeatureFusionBlock_v2`` PixelShuffle pyramid); every disparity at full
  resolution;
* ``v3`` — sigmoid disparities -> ``Fusion_v3`` (attention units, or conv
  units with ``--disable_attention``);
* ``scale_loop`` — sigmoid disparities -> one shared
  ``FeatureFusionBlock(features=2)`` applied per scale, coarse to fine,
  carrying its upsampled output from a zero map at the coarsest scale.

Frames [0, -1, -2] ride the batch axis through one encoder and decoder
pass and are split afterwards, in temporal order, the JAX package's
(``steps_fusion.py:13-19``), not the reference ``trainer.py``'s [-2, -1, 0].
The bundle also holds the pose networks of the fusion trainers, which
serving does not run.

Training (:func:`fusion_loss_fn`, :func:`train_step`) runs the fusion on
the augmented frames, then the mono step's poses, warp and loss with
sources (-1, 1) (``steps_fusion.py:117-177``). Precision is the mono
step's: the networks under autocast in ``compute_dtype``, the geometry,
warp and loss in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..config import Options
from ..data.transforms import preprocess_batch
from ..models import (DepthDecoder, FeatureFusionBlock, Fusion, Fusion_v3, PoseDecoder,
                      ResnetEncoder)
from ..models.common import init_weights_
from . import steps
from .state import TrainState

VARIANTS = ("pyramid", "v3", "scale_loop")
# the frames that ride the batch axis, in this order
CONTEXT_IDS = (0, -1, -2)
# the frames a training batch carries (ssde_tpu/train/steps_fusion.py:166)
TRAIN_FRAMES = (0, -1, -2, 1)


@dataclasses.dataclass
class FusionModels:
    """Module bundle of the fusion trainers and ``evaluate_depth_fusion``."""

    encoder: ResnetEncoder
    depth: DepthDecoder
    fusion: torch.nn.Module
    pose_encoder: ResnetEncoder
    pose: PoseDecoder
    opts: Options
    variant: str  # one of VARIANTS

    # the warp sources of the loss (ssde_tpu/train/steps_fusion.py:58)
    source_ids = (-1, 1)

    @property
    def pre_disp(self) -> bool:
        """The pyramid fuses the decoder's pre-disp features."""
        return self.variant == "pyramid"

    def modules(self):
        return (self.encoder, self.depth, self.fusion, self.pose_encoder, self.pose)

    def parameters(self) -> List[torch.nn.Parameter]:
        """The parameters the step trains. Under ``pre_disp`` (the pyramid)
        the decoder's ``dispconv_*`` heads never run and are left out, as
        the JAX tree has no such entries."""
        skip = {id(p) for p in self.depth.dispconv_parameters()} if self.pre_disp else set()
        return [p for m in self.modules() for p in m.parameters() if id(p) not in skip]

    def train(self, mode: bool = True) -> "FusionModels":
        for m in self.modules():
            m.train(mode)
        return self


def build_fusion_models(opts: Options, variant: str, device="cuda",
                        generator: Optional[torch.Generator] = None) -> FusionModels:
    """The ResNet depth encoder and DepthDecoder, the ``variant``'s fusion
    module, and a separate ResNet pose encoder on stacked pairs + the
    PoseDecoder; float32 parameters. With a ``generator`` the weights are
    drawn from it on the CPU (torchvision's init for the encoders, torch's
    default for the convs, the reference's for the attention convs) before
    the move to ``device``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown fusion variant {variant!r}; one of {VARIANTS}")
    encoder = ResnetEncoder(opts.num_layers)
    depth = DepthDecoder(encoder.num_ch_enc, scales=tuple(opts.scales))
    if variant == "pyramid":
        fusion = Fusion()
    elif variant == "v3":
        fusion = Fusion_v3(attention=not opts.disable_attention)
    else:
        fusion = FeatureFusionBlock(features=2)
    pose_encoder = ResnetEncoder(opts.num_layers, num_input_images=2)
    pose = PoseDecoder(pose_encoder.num_ch_enc, num_input_features=1,
                       num_frames_to_predict_for=2)
    if generator is not None:
        encoder.init_weights_(generator)
        init_weights_(depth, generator)
        init_weights_(fusion, generator)
        pose_encoder.init_weights_(generator)
        init_weights_(pose, generator)
    mods = [m.to(device) for m in (encoder, depth, fusion, pose_encoder, pose)]
    return FusionModels(*mods, opts, variant)


def fuse(models: FusionModels, inputs: Dict[str, torch.Tensor], key: str = "color"
         ) -> Dict[str, torch.Tensor]:
    """The fused ``disp/{s}`` of a preprocessed batch: frames
    ``{key}/{i}/0`` for i in 0, -1, -2 (``color`` in evaluation,
    ``color_aug`` in training) through one encoder and decoder pass
    (pre-disp features for the pyramid; BatchNorm pools over the 3B
    frames), split into the three per-frame dicts, then the fusion
    (``ssde_tpu/train/steps_fusion.py:123-149``). Runs the modules in the
    modes they are in."""
    B = inputs[f"{key}/0/0"].shape[0]
    x = torch.cat([inputs[f"{key}/{i}/0"] for i in CONTEXT_IDS], 0)
    dec_all = models.depth(models.encoder(x), pre_disp=models.pre_disp)
    # batch slices of contiguous maps, so the attention kernel's operands
    # made from them are contiguous too
    dec, dec_t1, dec_t2 = ({k: v[j * B:(j + 1) * B].contiguous() for k, v in dec_all.items()}
                           for j in range(3))
    if models.variant != "scale_loop":
        return models.fusion(dec, dec_t1, dec_t2)
    scales = sorted((int(k.split("/")[1]) for k in dec), reverse=True)
    outputs = {}
    upt = torch.zeros_like(dec[f"disp/{scales[0]}"])
    for s in scales:
        outputs[f"disp/{s}"], upt = models.fusion(dec[f"disp/{s}"], upt,
                                                  dec_t1[f"disp/{s}"], dec_t2[f"disp/{s}"])
    return outputs


def fusion_infer(models: FusionModels, inputs: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """:func:`fuse` of an evaluation batch (``preprocess_batch`` with
    ``is_train=False`` over frames 0, -1, -2) in eval mode (BatchNorm from
    its running statistics) under ``torch.inference_mode``: the ``disp/{s}``,
    (B, 1, h, w). The modules' modes are restored afterwards."""
    mods = (models.encoder, models.depth, models.fusion)
    modes = [m.training for m in mods]
    try:
        for m in mods:
            m.eval()
        with torch.inference_mode():
            return fuse(models, inputs)
    finally:
        for m, mode in zip(mods, modes):
            m.train(mode)


def fusion_loss_fn(models: FusionModels, inputs, generator: Optional[torch.Generator] = None):
    """:func:`fuse` of the augmented frames, poses for (-1, 1) from one
    pose-encoder pass, then the mono step's warp and loss with sources
    (-1, 1) (``ssde_tpu/train/steps_fusion.py:117-157``); returns (loss,
    losses, outputs). The modules' train/eval mode decides BatchNorm."""
    opts = models.opts
    device = inputs["color_aug/0/0"].device
    with steps._autocast(opts, device):
        outputs = fuse(models, inputs, "color_aug")
        outputs.update(steps.predict_poses(models, inputs))
    with torch.autocast(device.type, enabled=False):
        outputs = steps.generate_images_pred(inputs, outputs, opts, models.source_ids)
        losses = steps.compute_losses(inputs, outputs, opts, models.source_ids, generator)
    return losses["loss"], losses, outputs


def preprocess_fusion_train(batch, opts: Options):
    """The fusion train step's preprocessing: frames 0, -1, -2 and 1,
    jitter on, frame 0's pyramid and the scale-0 augmented frames only
    (``ssde_tpu/train/steps_fusion.py:164-168``)."""
    return preprocess_batch(batch, opts.height, opts.width, opts.num_scales,
                            list(TRAIN_FRAMES), is_train=True, pyramid_frames=[0],
                            aug_num_scales=1)


def train_step(models: FusionModels, state: TrainState, batch,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step on a device batch: preprocess, forward in train
    mode, backward, Adam. Returns the losses (detached, on the device)."""
    inputs = preprocess_fusion_train(batch, models.opts)
    models.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, losses, _ = fusion_loss_fn(models, inputs, generator)
    loss.backward()
    state.apply_gradients()
    return {k: v.detach() for k, v in losses.items()}
