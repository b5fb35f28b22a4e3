"""The self-supervised mono train step (counterpart of the mono path of
``ssde_tpu/train/steps.py`` :40-649).

Device-side preprocessing -> ResNet18 depth encoder and DepthDecoder ->
the pose network -> reprojection of every scale's depth -> one family-warp
launch per source over all scales -> one photometric launch over the
warped and identity maps -> min-reprojection with automask and edge-aware
smoothness -> backward -> Adam.

Every Monodepth2 training option of the JAX step is carried:

* ``--use_stereo`` (or "s" in ``--frame_ids``): the opposite camera's frame
  is a warp source at ``inputs["stereo_T"]``; with ``--frame_ids 0`` it is
  the only one and no pose network is built or run (S training);
* ``--pose_model_type``: ``separate_resnet`` (a ResNet pose encoder and
  the PoseDecoder), ``posecnn`` (``PoseCNN`` on the stacked frames, its
  translation scaled by the mean inverse depth) or ``shared`` (the
  PoseDecoder on the depth encoder's features of every frame);
  ``--pose_model_input all`` feeds every temporal frame at once;
* ``--predictive_mask`` (needs ``--disable_automasking``): a second
  DepthDecoder whose sigmoid channels weight the reprojection;
* ``--v1_multiscale``: each scale warps the sources at its own resolution
  (#7 at S = 1 per scale and source) against frame 0 at that scale, one
  photometric launch per scale;
* ``--no_ssim`` (the L1 term alone, in plain PyTorch: no photometric
  kernel runs, as in the JAX step) and ``--avg_reprojection``.

Precision as in the JAX package (``steps.py:9-11``): the networks run
under autocast in ``compute_dtype`` (bfloat16 by default); geometry, the
warp, the photometric loss and the parameters stay float32.

The other trainers share :func:`predict_poses`, :func:`generate_images_pred`
and :func:`compute_losses`; :func:`check_supported` raises for an option
that a trainer's JAX step cannot run.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from ..config import Options
from ..data.transforms import preprocess_batch
from ..models import (DepthDecoder, PoseCNN, PoseDecoder, ResnetEncoder,
                      ResnetEncoderAttention)
from ..models.common import init_weights_
from ..ops.geometry import disp_to_depth, reproject_coords, transformation_from_parameters
from ..ops.image import resize_bilinear
from ..ops.losses import min_reprojection, reprojection_loss, smooth_loss
from ..ops.photometric import photometric_error
from ..ops.warp_banded import grid_sample_family
from .state import TrainState

# every Options.warp_backend name; each runs the one exact family warp
# (the port of kernel #7 stands in for #8-#10 and the XLA variants)
WARP_BACKENDS = ("auto", "banded", "onehot", "family", "pallas", "mxu", "gather")

# the Monodepth2 options beyond the default configuration, and the trainers
# whose JAX steps run each: the mono step (monodepth2 and
# rn_encoder_with_attention) all of them; the DPT and fusion steps build
# separate_resnet pose on pairs and no mask decoder, and share the loss;
# the GRU step too, and its trainer refuses --use_stereo on its own
# (trainer_gru.GRUTrainer)
OPTIONS = ("use_stereo", "pose_model_type", "pose_model_input", "predictive_mask",
           "v1_multiscale", "no_ssim", "avg_reprojection")
TAKES = {"mono": frozenset(OPTIONS),
         "dpt": frozenset({"use_stereo", "no_ssim", "avg_reprojection"}),
         "fusion": frozenset({"use_stereo", "no_ssim", "avg_reprojection"}),
         "gru": frozenset({"no_ssim", "avg_reprojection"})}


def stereo(opts: Options) -> bool:
    return bool(opts.use_stereo) or "s" in opts.frame_ids


def frame_ids(opts: Options) -> List:
    """``--frame_ids`` and, under stereo, "s": the frames a batch carries
    (the JAX trainer appends "s" to ``opt.frame_ids``, reference
    trainer.py:59-60)."""
    ids = list(opts.frame_ids)
    return ids + ["s"] if stereo(opts) and "s" not in ids else ids


def temporal_ids(opts: Options) -> List:
    return [f for f in opts.frame_ids if f != "s"]


def use_pose_net(opts: Options) -> bool:
    """False for stereo alone, ``--use_stereo --frame_ids 0``
    (``ssde_tpu/train/steps.py:616``), asked of ``--frame_ids`` without
    "s", as the reference asks before it appends "s" (trainer.py:59-60)."""
    return not (stereo(opts) and temporal_ids(opts) == [0])


def num_pose_frames(opts: Options) -> int:
    return 2 if opts.pose_model_input == "pairs" else len(temporal_ids(opts))


def check_supported(opts: Options, trainer: str = "mono") -> None:
    """Raise ``NotImplementedError`` for an option that ``trainer``'s JAX
    step cannot run (:data:`TAKES`), naming the option and the trainer;
    ``ValueError`` for ``--predictive_mask`` without
    ``--disable_automasking`` (the JAX step asserts it) and an unknown
    ``compute_dtype``."""
    on = {"use_stereo": stereo(opts),
          "pose_model_type": opts.pose_model_type != "separate_resnet",
          "pose_model_input": opts.pose_model_input != "pairs",
          "predictive_mask": bool(opts.predictive_mask),
          "v1_multiscale": bool(opts.v1_multiscale),
          "no_ssim": bool(opts.no_ssim),
          "avg_reprojection": bool(opts.avg_reprojection)}
    for name in OPTIONS:
        if on[name] and name not in TAKES[trainer]:
            value = getattr(opts, name)
            raise NotImplementedError(
                f"--{name}" + ("" if isinstance(value, bool) else f" {value}")
                + f": the {trainer} trainer does not take it (its JAX step cannot run it; "
                "ROADMAP.md Queue 1); the monodepth2 and rn_encoder_with_attention "
                "trainers do")
    if opts.predictive_mask and not opts.disable_automasking:
        raise ValueError("--predictive_mask requires --disable_automasking (the reference "
                         "trainer asserts the same)")
    if opts.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown compute_dtype {opts.compute_dtype!r}")


@dataclasses.dataclass
class MonoModels:
    """Module bundle of the monodepth2 trainer. ``pose_encoder`` is None
    for ``posecnn`` and ``shared``, ``pose_encoder`` and ``pose`` for
    stereo alone; ``predictive_mask`` is set under ``--predictive_mask``."""

    encoder: ResnetEncoder
    depth: DepthDecoder
    pose_encoder: Optional[ResnetEncoder]
    pose: Optional[torch.nn.Module]
    opts: Options
    predictive_mask: Optional[DepthDecoder] = None

    @property
    def source_ids(self) -> Sequence:
        # the reference hard-codes the temporal warp sources to [-1, 1]
        # whatever --frame_ids says (trainer.py:550,558); stereo adds "s"
        ids = [-1, 1] if any(f not in (0, "s") for f in self.opts.frame_ids) else []
        return ids + ["s"] if stereo(self.opts) else ids

    def modules(self):
        return tuple(m for m in (self.encoder, self.depth, self.pose_encoder, self.pose,
                                 self.predictive_mask) if m is not None)

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
    DepthDecoder, the pose network of ``--pose_model_type`` (``ssde_tpu/
    train/steps.py:63-98``: a separate ResNet pose encoder on stacked
    frames + PoseDecoder, a PoseCNN, or a PoseDecoder on two depth-encoder
    feature sets; none for stereo alone) and under ``--predictive_mask`` a
    DepthDecoder with a channel per source frame; float32 parameters. With
    a ``generator`` the weights are drawn from it on the CPU (torchvision's
    init for the encoders, the reference's for the attention convs,
    torch's default for the decoders and PoseCNN) before the move to
    ``device``."""
    check_supported(opts)
    encoder = (ResnetEncoderAttention if attention_encoder else ResnetEncoder)(opts.num_layers)
    depth = DepthDecoder(encoder.num_ch_enc, scales=tuple(opts.scales))
    pose_encoder = pose = mask = None
    n_pose = num_pose_frames(opts)
    if not use_pose_net(opts):
        pass
    elif opts.pose_model_type == "posecnn":
        pose = PoseCNN(n_pose)
    elif opts.pose_model_type == "shared":
        pose = PoseDecoder(encoder.num_ch_enc, num_input_features=2,
                           num_frames_to_predict_for=1)
    else:
        pose_encoder = ResnetEncoder(opts.num_layers, num_input_images=n_pose)
        pose = PoseDecoder(pose_encoder.num_ch_enc, num_input_features=1,
                           num_frames_to_predict_for=2)
    if opts.predictive_mask:
        mask = DepthDecoder(encoder.num_ch_enc, scales=tuple(opts.scales),
                            num_output_channels=len(frame_ids(opts)) - 1)
    if generator is not None:
        encoder.init_weights_(generator)
        init_weights_(depth, generator)
        if pose_encoder is not None:
            pose_encoder.init_weights_(generator)
        for m in (pose, mask):
            if m is not None:
                init_weights_(m, generator)
    mods = [None if m is None else m.to(device)
            for m in (encoder, depth, pose_encoder, pose, mask)]
    return MonoModels(*mods[:4], opts, mods[4])


def _full(t: torch.Tensor) -> torch.Tensor:
    """float32, the precision of the geometry, warp and loss; float64
    stays float64 (a reference run of the whole step on the CPU)."""
    return t if t.dtype == torch.float64 else t.float()


def _autocast(opts: Options, device: torch.device):
    if opts.compute_dtype != "bfloat16":
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=torch.bfloat16)


def predict_poses(models, inputs, shared_features=None) -> Dict[str, torch.Tensor]:
    """``axisangle/0/{f}``, ``translation/0/{f}`` and ``cam_T_cam/0/{f}``
    of the temporal sources (reference trainer.py:375-442,
    ``ssde_tpu/train/steps.py:152-241``).

    Pairs, ordered in time, (-1, 0) and (0, 1), with ``invert = f < 0``:
    through ONE pose-encoder (or PoseCNN) pass on the batch axis, so
    BatchNorm pools its statistics over the pairs, as in the JAX step; for
    ``shared``, the PoseDecoder on each pair of ``shared_features`` (frame
    -> the depth encoder's feature list). ``--pose_model_input all``: every
    temporal frame stacked through the pose network at once, frame k+1's
    pose from output k, no inversion."""
    opts = models.opts
    outputs = {}

    def emit(f, aa, t, idx, invert):
        outputs[f"axisangle/0/{f}"] = aa
        outputs[f"translation/0/{f}"] = t
        with torch.autocast(aa.device.type, enabled=False):  # SE(3) in float32
            outputs[f"cam_T_cam/0/{f}"] = transformation_from_parameters(
                _full(aa[:, idx]), _full(t[:, idx]), invert=invert)

    def pose_net(x):
        if models.pose_encoder is None:
            return models.pose(x)
        return models.pose([models.pose_encoder(x)])

    if num_pose_frames(opts) != 2:
        ids = temporal_ids(opts)
        if opts.pose_model_type == "shared":
            aa, t = models.pose([shared_features[i] for i in ids])
        else:
            aa, t = pose_net(torch.cat([inputs[f"color_aug/{i}/0"] for i in ids], 1))
        for i, f in enumerate(ids[1:]):
            emit(f, aa, t, i, False)
        return outputs
    if opts.pose_model_type == "shared":
        for f in (-1, 1):
            pair = ([shared_features[f], shared_features[0]] if f < 0
                    else [shared_features[0], shared_features[f]])
            aa, t = models.pose(pair)
            emit(f, aa, t, 0, f < 0)
        return outputs
    frames = {i: inputs[f"color_aug/{i}/0"] for i in (-1, 0, 1)}
    B = frames[0].shape[0]
    aa, t = pose_net(torch.cat([torch.cat([frames[-1], frames[0]], 1),
                                torch.cat([frames[0], frames[1]], 1)], 0))
    for i, f in enumerate((-1, 1)):
        emit(f, aa[i * B:(i + 1) * B], t[i * B:(i + 1) * B], 0, f < 0)
    return outputs


def generate_images_pred(inputs, outputs, opts: Options, source_ids) -> Dict:
    """Warp the sources into frame 0 with the predicted depth and poses
    (reference trainer.py:465-515, ``ssde_tpu/train/steps.py:243-352``).
    Source "s" takes ``inputs["stereo_T"]``; under ``posecnn`` the
    translation is scaled by the mean inverse depth. By default every
    scale's disparity is resized to full resolution and samples the
    full-resolution source, so the S grids of one source go to ONE
    family-warp launch: ``color_planar/{f}`` is (S*B, 3, H, W) scale-major.
    Under ``--v1_multiscale`` each scale keeps its disparity's resolution
    and samples ``color/{f}/{scale}`` with ``K``/``inv_K`` at that scale:
    one launch per (scale, source) at S = 1 (the JAX step takes its exact
    per-pair sampler there; both are exact)."""
    if opts.warp_backend not in WARP_BACKENDS:
        raise ValueError(f"unknown warp_backend {opts.warp_backend!r}; expected "
                         f"one of {WARP_BACKENDS}")
    H, W = opts.height, opts.width
    grids = {f: [] for f in source_ids}
    for scale in opts.scales:
        disp = _full(outputs[f"disp/{scale}"])
        source_scale = scale if opts.v1_multiscale else 0
        if not opts.v1_multiscale and disp.shape[2:] != (H, W):
            disp = resize_bilinear(disp, (H, W), align_corners=False)
        _, depth = disp_to_depth(disp, opts.min_depth, opts.max_depth)
        outputs[f"depth/0/{scale}"] = depth
        for f in source_ids:
            if f == "s":
                T = _full(inputs["stereo_T"])
            elif opts.pose_model_type == "posecnn":
                aa = _full(outputs[f"axisangle/0/{f}"])
                t = _full(outputs[f"translation/0/{f}"])
                mean_inv_depth = (1.0 / depth).mean((1, 2, 3))
                T = transformation_from_parameters(
                    aa[:, 0], t[:, 0] * mean_inv_depth[:, None, None], invert=f < 0)
            else:
                T = outputs[f"cam_T_cam/0/{f}"]
            pix = reproject_coords(depth, inputs[f"inv_K/{source_scale}"],
                                   inputs[f"K/{source_scale}"], T)
            outputs[f"sample/{f}/{scale}"] = pix
            grids[f].append(pix)
    for f in source_ids:
        if opts.v1_multiscale:
            for scale, pix in zip(opts.scales, grids[f]):
                src = _full(inputs[f"color/{f}/{scale}"]).contiguous()
                outputs[f"color/{f}/{scale}"] = grid_sample_family(src, pix[None].contiguous())
            continue
        src = _full(inputs[f"color/{f}/0"]).contiguous()
        out = grid_sample_family(src, torch.stack(grids[f]).contiguous())
        outputs[f"color_planar/{f}"] = out
        B = src.shape[0]
        for i, scale in enumerate(opts.scales):
            outputs[f"color/{f}/{scale}"] = out[i * B:(i + 1) * B]
    return outputs


def _photometric(preds: torch.Tensor, target: torch.Tensor, no_ssim: bool) -> torch.Tensor:
    """(G, H, W) error of ``preds`` (G, 3, H, W) against ``target[g % B]``:
    the photometric kernels, or under ``--no_ssim`` the plain L1 term
    (``ops/losses.reprojection_loss``), as the JAX step runs no kernel then
    (``steps.py:366``)."""
    if no_ssim:
        tiled = target.repeat(preds.shape[0] // target.shape[0], 1, 1, 1)
        return reprojection_loss(preds, tiled, no_ssim=True)[:, 0]
    return photometric_error(preds.contiguous(), target.contiguous())


def compute_losses(inputs, outputs, opts: Options, source_ids,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Min-reprojection + automask + smoothness over scales (reference
    trainer.py:517-622, ``ssde_tpu/train/steps.py:391-577``). By default on
    the JAX step's batched planar path (``steps.py:426-462``): the S*F
    warped maps and the F identity maps go through ONE photometric launch
    with G = (S+1)*F*B, pair g against target[g % B]. Under
    ``--v1_multiscale`` each scale compares against ``color/0/{scale}``:
    one launch per scale with G = 2*F*B. ``--avg_reprojection`` averages
    over the sources before the minimum, the identity maps too;
    ``--predictive_mask`` weights the reprojection by the mask decoder's
    output (resized to the error maps) and adds 0.2 * mean(-log mask).
    ``generator`` draws the automask tie-break noise; None adds none."""
    S, F = len(opts.scales), len(source_ids)
    automask = not opts.disable_automasking
    B = inputs["color/0/0"].shape[0]

    def blocks(rep, idx):  # the maps of pair blocks idx, B pairs each -> (B, n, H, W)
        return torch.stack([rep[k * B:(k + 1) * B] for k in idx], 1)

    reproj, ident = {}, {}
    if opts.v1_multiscale:
        for scale in opts.scales:
            parts = [outputs[f"color/{f}/{scale}"] for f in source_ids]
            if automask:
                parts += [_full(inputs[f"color/{f}/{scale}"]) for f in source_ids]
            rep = _photometric(torch.cat(parts, 0), _full(inputs[f"color/0/{scale}"]),
                               opts.no_ssim)
            reproj[scale] = blocks(rep, range(F))
            ident[scale] = blocks(rep, range(F, 2 * F)) if automask else None
    else:
        parts = [outputs[f"color_planar/{f}"] for f in source_ids]
        if automask:
            parts += [_full(inputs[f"color/{f}/0"]) for f in source_ids]
        rep = _photometric(torch.cat(parts, 0), _full(inputs["color/0/0"]), opts.no_ssim)
        shared = blocks(rep, range(F * S, F * S + F)) if automask else None
        for i, scale in enumerate(opts.scales):
            reproj[scale] = blocks(rep, [j * S + i for j in range(F)])
            ident[scale] = shared
    losses, total = {}, 0.0
    for scale in opts.scales:
        rep_s, ident_s, mask_loss = reproj[scale], ident[scale], 0.0
        if opts.predictive_mask and not automask:
            pmask = _full(outputs["predictive_mask"][f"disp/{scale}"])
            if pmask.shape[2:] != rep_s.shape[2:]:
                pmask = resize_bilinear(pmask, rep_s.shape[2:], align_corners=False)
            rep_s = rep_s * pmask
            mask_loss = 0.2 * torch.mean(-torch.log(torch.clamp(pmask, 1e-7, 1.0)))
        if opts.avg_reprojection:
            rep_s = rep_s.mean(1, keepdim=True)
            ident_s = None if ident_s is None else ident_s.mean(1, keepdim=True)
        per_pixel, mask = min_reprojection(rep_s, ident_s, generator)
        outputs[f"identity_selection/{scale}"] = mask
        loss = per_pixel.mean() + mask_loss
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
    """encoder -> depth (and mask) -> poses -> warp -> loss; returns (loss,
    losses, outputs). For ``shared`` every temporal frame goes through the
    depth encoder in one pass on the batch axis (``ssde_tpu/train/
    steps.py:588-605``); stereo alone runs no pose network (:616). The
    modules' train/eval mode decides BatchNorm: batch statistics and a
    running update in training, running statistics in eval (the JAX
    ``train`` flag)."""
    opts = models.opts
    x0 = inputs["color_aug/0/0"]
    device = x0.device
    shared = None
    with _autocast(opts, device):
        if opts.pose_model_type == "shared" and use_pose_net(opts):
            ids, B = temporal_ids(opts), x0.shape[0]
            feats_all = models.encoder(torch.cat([inputs[f"color_aug/{i}/0"] for i in ids], 0))
            shared = {f: [x[j * B:(j + 1) * B] for x in feats_all] for j, f in enumerate(ids)}
            feats = shared[0]
        else:
            feats = models.encoder(x0)
        outputs = models.depth(feats)
        if models.predictive_mask is not None:
            outputs["predictive_mask"] = models.predictive_mask(feats)
        if use_pose_net(opts):
            outputs.update(predict_poses(models, inputs, shared))
    with torch.autocast(device.type, enabled=False):
        outputs = generate_images_pred(inputs, outputs, opts, models.source_ids)
        losses = compute_losses(inputs, outputs, opts, models.source_ids, generator)
    return losses["loss"], losses, outputs


def preprocess_train(batch, opts: Options):
    """The train step's preprocessing (``steps.py:633-640``) of
    :func:`frame_ids`: jitter on, frame 0's pyramid and the scale-0
    augmented frames only; under ``--v1_multiscale`` every frame's pyramid
    and every scale augmented."""
    v1 = bool(opts.v1_multiscale)
    return preprocess_batch(batch, opts.height, opts.width, opts.num_scales,
                            frame_ids(opts), is_train=True,
                            pyramid_frames=None if v1 else [0],
                            aug_num_scales=None if v1 else 1)


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
