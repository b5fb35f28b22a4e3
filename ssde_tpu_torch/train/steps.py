"""The self-supervised mono train step (counterpart of the mono path of
``ssde_tpu/train/steps.py`` :40-649).

Device-side preprocessing -> ResNet18 depth encoder and DepthDecoder ->
a ResNet18 pose encoder over both frame pairs in one pass and the
PoseDecoder -> reprojection of every scale's depth -> one family-warp
launch per source over all scales -> one photometric launch over the
warped and identity maps -> min-reprojection with automask and edge-aware
smoothness -> backward -> Adam.

Precision as in the JAX package (``steps.py:9-11``): the networks run
under autocast in ``compute_dtype`` (bfloat16 by default); geometry, the
warp, the photometric loss and the parameters stay float32.

Options the port does not carry yet raise ``NotImplementedError`` naming
the option (:func:`check_supported`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence

import torch

from ..config import Options
from ..data.transforms import preprocess_batch
from ..models import DepthDecoder, PoseDecoder, ResnetEncoder, ResnetEncoderAttention
from ..models.common import init_weights_
from ..ops.geometry import disp_to_depth, reproject_coords, transformation_from_parameters
from ..ops.image import resize_bilinear
from ..ops.losses import min_reprojection, smooth_loss
from ..ops.photometric import photometric_error
from ..ops.warp_banded import grid_sample_family
from .state import TrainState

# every Options.warp_backend name; each runs the one exact family warp
# (the port of kernel #7 stands in for #8-#10 and the XLA variants)
WARP_BACKENDS = ("auto", "banded", "onehot", "family", "pallas", "mxu", "gather")


def check_supported(opts: Options) -> None:
    """Raise ``NotImplementedError`` for an option this slice does not port."""
    unported = {
        "predictive_mask": opts.predictive_mask,
        "v1_multiscale": opts.v1_multiscale,
        "use_stereo": opts.use_stereo or "s" in opts.frame_ids,
        "no_ssim": opts.no_ssim,
        "avg_reprojection": opts.avg_reprojection,
        f"pose_model_type={opts.pose_model_type!r}": opts.pose_model_type != "separate_resnet",
        f"pose_model_input={opts.pose_model_input!r}": opts.pose_model_input != "pairs",
    }
    for name, on in unported.items():
        if on:
            raise NotImplementedError(
                f"{name}: not ported yet; the port trains the default mono "
                "configuration (separate_resnet pose on pairs, automask, "
                "SSIM+L1, full-resolution multiscale)")
    if opts.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown compute_dtype {opts.compute_dtype!r}")


@dataclasses.dataclass
class MonoModels:
    """Module bundle of the monodepth2 trainer."""

    encoder: ResnetEncoder
    depth: DepthDecoder
    pose_encoder: ResnetEncoder
    pose: PoseDecoder
    opts: Options

    @property
    def source_ids(self) -> Sequence:
        # the reference hard-codes the warp sources to [-1, 1] whatever
        # --frame_ids says (trainer.py:550,558)
        return [-1, 1] if any(f not in (0, "s") for f in self.opts.frame_ids) else []

    def modules(self):
        return (self.encoder, self.depth, self.pose_encoder, self.pose)

    def parameters(self):
        return [p for m in self.modules() for p in m.parameters()]

    def train(self, mode: bool = True) -> "MonoModels":
        for m in self.modules():
            m.train(mode)
        return self


def build_mono_models(opts: Options, device="cuda",
                      generator: Optional[torch.Generator] = None,
                      attention_encoder: bool = False) -> MonoModels:
    """ResNet depth encoder (``ResnetEncoderAttention`` with
    ``attention_encoder``, ``--model rn_encoder_with_attention``) +
    DepthDecoder, and a separate ResNet pose encoder on stacked pairs (6
    input channels) + PoseDecoder, float32 parameters. With a ``generator``
    the weights are drawn from it on the CPU (torchvision's init for the
    encoders, the reference's for the attention convs, torch's default for
    the decoders) before the move to ``device``."""
    check_supported(opts)
    encoder = (ResnetEncoderAttention if attention_encoder else ResnetEncoder)(opts.num_layers)
    depth = DepthDecoder(encoder.num_ch_enc, scales=tuple(opts.scales))
    pose_encoder = ResnetEncoder(opts.num_layers, num_input_images=2)
    pose = PoseDecoder(pose_encoder.num_ch_enc, num_input_features=1,
                       num_frames_to_predict_for=2)
    if generator is not None:
        encoder.init_weights_(generator)
        init_weights_(depth, generator)
        pose_encoder.init_weights_(generator)
        init_weights_(pose, generator)
    mods = [m.to(device) for m in (encoder, depth, pose_encoder, pose)]
    return MonoModels(*mods, opts)


def _full(t: torch.Tensor) -> torch.Tensor:
    """float32, the precision of the geometry, warp and loss; float64
    stays float64 (a reference run of the whole step on the CPU)."""
    return t if t.dtype == torch.float64 else t.float()


def _autocast(opts: Options, device: torch.device):
    if opts.compute_dtype != "bfloat16":
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=torch.bfloat16)


def predict_poses(models: MonoModels, inputs) -> Dict[str, torch.Tensor]:
    """Both temporal pairs, (-1, 0) and (0, 1), through ONE pose-encoder
    pass on the batch axis (so BatchNorm pools its statistics over the
    pairs, as in the JAX step, ``steps.py:219-236``); ``cam_T_cam/0/{f}``
    with ``invert = f < 0`` (reference trainer.py:375-442)."""
    frames = {i: inputs[f"color_aug/{i}/0"] for i in (-1, 0, 1)}
    B = frames[0].shape[0]
    pairs = torch.cat([torch.cat([frames[-1], frames[0]], 1),
                       torch.cat([frames[0], frames[1]], 1)], 0)
    aa, t = models.pose([models.pose_encoder(pairs)])
    outputs = {}
    for i, f in enumerate((-1, 1)):
        a_f, t_f = aa[i * B:(i + 1) * B], t[i * B:(i + 1) * B]
        outputs[f"axisangle/0/{f}"] = a_f
        outputs[f"translation/0/{f}"] = t_f
        with torch.autocast(pairs.device.type, enabled=False):  # SE(3) in float32
            outputs[f"cam_T_cam/0/{f}"] = transformation_from_parameters(
                _full(a_f[:, 0]), _full(t_f[:, 0]), invert=f < 0)
    return outputs


def generate_images_pred(inputs, outputs, opts: Options, source_ids) -> Dict:
    """Warp the sources into frame 0 with the predicted depth and poses
    (reference trainer.py:465-515). Every scale's disparity is resized to
    full resolution and samples the full-resolution source, so the S grids
    of one source go to ONE family-warp launch: ``color_planar/{f}`` is
    (S*B, 3, H, W) scale-major."""
    if opts.warp_backend not in WARP_BACKENDS:
        raise ValueError(f"unknown warp_backend {opts.warp_backend!r}; expected "
                         f"one of {WARP_BACKENDS}")
    H, W = opts.height, opts.width
    grids = {f: [] for f in source_ids}
    for scale in opts.scales:
        disp = _full(outputs[f"disp/{scale}"])
        if disp.shape[2:] != (H, W):
            disp = resize_bilinear(disp, (H, W), align_corners=False)
        _, depth = disp_to_depth(disp, opts.min_depth, opts.max_depth)
        outputs[f"depth/0/{scale}"] = depth
        for f in source_ids:
            pix = reproject_coords(depth, inputs["inv_K/0"], inputs["K/0"],
                                   outputs[f"cam_T_cam/0/{f}"])
            outputs[f"sample/{f}/{scale}"] = pix
            grids[f].append(pix)
    for f in source_ids:
        src = _full(inputs[f"color/{f}/0"]).contiguous()
        out = grid_sample_family(src, torch.stack(grids[f]).contiguous())
        outputs[f"color_planar/{f}"] = out
        B = src.shape[0]
        for i, scale in enumerate(opts.scales):
            outputs[f"color/{f}/{scale}"] = out[i * B:(i + 1) * B]
    return outputs


def compute_losses(inputs, outputs, opts: Options, source_ids,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Min-reprojection + automask + smoothness over scales (reference
    trainer.py:517-622), on the JAX step's batched planar path
    (``steps.py:426-462``): the S*F warped maps and the F identity maps go
    through ONE photometric launch with G = (S+1)*F*B, pair g against
    target[g % B]. ``generator`` draws the automask tie-break noise; None
    adds none."""
    S, F = len(opts.scales), len(source_ids)
    target = _full(inputs["color/0/0"]).contiguous()
    B = target.shape[0]
    automask = not opts.disable_automasking
    parts = [outputs[f"color_planar/{f}"] for f in source_ids]
    if automask:
        parts += [_full(inputs[f"color/{f}/0"]) for f in source_ids]
    rep_all = photometric_error(torch.cat(parts, 0).contiguous(), target)
    n_warp = F * S

    def maps(first):  # F maps of B, starting at pair block j -> (B, F, H, W)
        return torch.stack([rep_all[(first(j)) * B:(first(j) + 1) * B]
                            for j in range(F)], 1)

    ident = maps(lambda j: n_warp + j) if automask else None
    losses, total = {}, 0.0
    for i, scale in enumerate(opts.scales):
        reproj = maps(lambda j: j * S + i)
        per_pixel, mask = min_reprojection(reproj, ident, generator)
        outputs[f"identity_selection/{scale}"] = mask
        loss = per_pixel.mean()
        disp = _full(outputs[f"disp/{scale}"])
        color = _full(inputs[f"color/0/{scale}"])
        if disp.shape[2:] != color.shape[2:]:
            color = _full(inputs["color/0/0"])
        norm_disp = disp / (disp.mean((2, 3), keepdim=True) + 1e-7)
        loss = loss + opts.disparity_smoothness * smooth_loss(norm_disp, color) / (2**scale)
        losses[f"loss/{scale}"] = loss
        total = total + loss
    losses["loss"] = total / S
    return losses


def mono_loss_fn(models: MonoModels, inputs, generator: Optional[torch.Generator] = None):
    """encoder -> depth -> poses -> warp -> loss; returns (loss, losses,
    outputs). The modules' train/eval mode decides BatchNorm: batch
    statistics and a running update in training, running statistics in
    eval (the JAX ``train`` flag)."""
    opts = models.opts
    device = inputs["color_aug/0/0"].device
    with _autocast(opts, device):
        outputs = models.depth(models.encoder(inputs["color_aug/0/0"]))
        outputs.update(predict_poses(models, inputs))
    with torch.autocast(device.type, enabled=False):
        outputs = generate_images_pred(inputs, outputs, opts, models.source_ids)
        losses = compute_losses(inputs, outputs, opts, models.source_ids, generator)
    return losses["loss"], losses, outputs


def preprocess_train(batch, opts: Options):
    """The train step's preprocessing: jitter on, frame 0's pyramid and the
    scale-0 augmented frames only (``steps.py:633-640``)."""
    return preprocess_batch(batch, opts.height, opts.width, opts.num_scales,
                            list(opts.frame_ids), is_train=True,
                            pyramid_frames=[0], aug_num_scales=1)


def train_step(models: MonoModels, state: TrainState, batch,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step on a device batch: preprocess, forward in train
    mode, backward, Adam. Returns the losses (detached, on the device)."""
    inputs = preprocess_train(batch, models.opts)
    models.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, losses, _ = mono_loss_fn(models, inputs, generator)
    loss.backward()
    state.apply_gradients()
    return {k: v.detach() for k, v in losses.items()}


def mono_infer(models: MonoModels, images: torch.Tensor) -> torch.Tensor:
    """Disparity at scale 0 of (B, 3, H, W) images in [0, 1]: the
    counterpart of ``make_mono_infer_fn`` (``ssde_tpu/train/steps.py:652-664``).
    The encoder runs in eval mode (BatchNorm from its running statistics,
    which stay as they are) and the decoder after it, under
    ``torch.inference_mode`` on the models' device; (B, 1, H, W) float32.
    The modules' train/eval modes are restored afterwards."""
    mods = (models.encoder, models.depth)
    modes = [m.training for m in mods]
    device = next(models.encoder.parameters()).device
    try:
        for m in mods:
            m.eval()
        with torch.inference_mode():
            disp = models.depth(models.encoder(images.to(device)))["disp/0"]
    finally:
        for m, mode in zip(mods, modes):
            m.train(mode)
    return disp.float()
