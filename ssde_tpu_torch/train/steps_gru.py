"""The recurrent (GRU) sequence step (counterpart of
``ssde_tpu/train/steps_gru.py``): model construction, the B-major
flattening of a (B, T) sequence batch, the unroll of the block over T, the
sequence loss and one train step.

The whole sequence goes through the networks as B*T frames: one encoder
and decoder pass (BatchNorm pools its statistics over all of them, as in
the JAX step), one pose pass over both pairs of every frame, then the
block unrolled over T by a Python loop (JAX's ``lax.scan``), and the mono
step's warp and loss (``train/steps.py``) on the flattened batch. Frames
are flattened B-major everywhere (the reference mixes B-major and T-major
and is consistent only at batch size 1; ``steps_gru.py:9-17``).

Precision as in the JAX package: the networks run under autocast in
``compute_dtype``; the kernel convs of the block cast their operands to it
(``models/common.kernel_dtype``) and the hidden state is carried in it,
while the ``h0_layer1`` parameters, the geometry, the warp and the loss
stay float32. GRU v9 (attention fusion) and v10 are ported.

Rematerialisation follows ``--gru_remat`` as the JAX step's ``_remat_mode``
does (``steps_gru.py:52-87``), with the same B*T thresholds under "auto":
nothing up to B*T = 24 (the benchmark shape), the unrolled block's steps
up to 32, and beyond that (the Options defaults B=12, T=10 are 120) the
encoder and decoder passes too, each through ``torch.utils.checkpoint``.
The JAX ``remat_attention`` has no counterpart: the attention kernel keeps
no softmax residuals (its backward recomputes them).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..config import Options
from ..data.transforms import preprocess_batch
from ..models import ConvGRUBlocks, DepthDecoder, PoseDecoder, ResnetEncoder, make_gru
from ..models.common import init_weights_
from ..models.resnet import running_stats_frozen
from . import steps
from .state import TrainState

PRE_DISP_VERSIONS = {"v3", "v4", "v6", "v7", "v8", "v9", "v10"}


PORTED_VERSIONS = ("v9", "v10")


def check_version(opts: Options) -> None:
    """Raise ``NotImplementedError`` for every GRU version but v9 and v10,
    naming the slice of the port that brings it."""
    v = opts.gru_version
    if v not in PORTED_VERSIONS:
        raise NotImplementedError(
            f"GRU {v}: the port runs GRU v9 and v10 only; {v} comes with slice 5 "
            "(GRU v1-v8 and the v4/v6/v7 heads)")


def remat_mode(opts: Options) -> str:
    """What the step rematerialises in the backward (``_remat_mode``,
    ``ssde_tpu/train/steps_gru.py:52-82``): "0" nothing, "scan" each step of
    the unrolled block, "1" that and the B*T-frame encoder and decoder
    passes; "auto" picks by B*T: "0" up to 24, "scan" up to 32, else "1"."""
    mode = str(opts.gru_remat)
    if mode == "auto":
        bt = opts.batch_size * opts.len_sequence
        return "0" if bt <= 24 else ("scan" if bt <= 32 else "1")
    if mode in ("0", "false", "False"):
        return "0"
    if mode in ("1", "true", "True"):
        return "1"
    if mode == "scan":
        return mode
    raise ValueError(f"--gru_remat {mode!r}: expected auto, 0, 1 or scan")


def _remat(module: torch.nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)`` with its activations recomputed in the
    backward instead of kept; the recompute leaves ``module``'s BatchNorm
    statistics alone (the forward already moved them)."""
    return checkpoint(module, *args, use_reentrant=False, **kwargs,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          running_stats_frozen(module)))


def check_supported(opts: Options) -> None:
    """Raise for what the GRU trainer does not port: the version, then the
    mono step's options."""
    check_version(opts)
    steps.check_supported(opts)


@dataclasses.dataclass
class GRUModels:
    """Module bundle of the GRU family, with the ``MonoModels`` interface
    (``modules``, ``parameters``, ``train``, ``source_ids``) so that the
    mono step's ``predict_poses``, ``generate_images_pred`` and
    ``compute_losses`` take it as they are."""

    encoder: ResnetEncoder
    depth: DepthDecoder
    gru: ConvGRUBlocks
    head: Optional[torch.nn.Module]
    opts: Options
    pose_encoder: Optional[ResnetEncoder] = None
    pose: Optional[PoseDecoder] = None

    source_ids = (-1, 1)

    @property
    def pre_disp(self) -> bool:
        return self.opts.gru_version in PRE_DISP_VERSIONS and bool(self.opts.gru_pre_disp)

    def modules(self):
        return tuple(m for m in (self.encoder, self.depth, self.gru, self.pose_encoder,
                                 self.pose) if m is not None)

    def parameters(self) -> List[torch.nn.Parameter]:
        """The parameters the step trains. Under ``pre_disp`` the decoder's
        ``dispconv_*`` heads never run (the block makes the disparity), get
        no gradient and are left out, as the JAX tree has no such entries
        (``checkpoint.depth_from_flax``)."""
        skip = {id(p) for p in self.depth.dispconv_parameters()} if self.pre_disp else set()
        return [p for m in self.modules() for p in m.parameters() if id(p) not in skip]

    def h0_parameters(self) -> List[torch.nn.Parameter]:
        """The learned initial hidden states, which the h0 freeze stops."""
        return [self.gru.unit(s).h0_layer1 for s in range(self.gru.n_scales)]

    def train(self, mode: bool = True) -> "GRUModels":
        for m in self.modules():
            m.train(mode)
        return self


def build_gru_models(opts: Options, device="cuda",
                     generator: Optional[torch.Generator] = None) -> GRUModels:
    """Depth encoder and decoder, the recurrent block, and the pose encoder
    on pairs + PoseDecoder; float32 parameters, in eval mode.

    With a ``generator`` the weights are initialised from it on the CPU
    (torchvision's scheme for the encoders, torch's default for the rest;
    h0 stays zero as in the JAX package) before the move to ``device``.
    Without one, load weights afterwards (:mod:`ssde_tpu_torch.checkpoint`).
    """
    check_version(opts)
    encoder = ResnetEncoder(opts.num_layers)
    depth = DepthDecoder(encoder.num_ch_enc, scales=tuple(opts.scales))
    gru = make_gru(opts.gru_version, opts.height, opts.width,
                   attention=not opts.disable_attention)
    pose_encoder = ResnetEncoder(opts.num_layers, num_input_images=2)
    pose = PoseDecoder(pose_encoder.num_ch_enc, num_input_features=1,
                       num_frames_to_predict_for=2)
    if generator is not None:
        encoder.init_weights_(generator)
        init_weights_(depth, generator)
        init_weights_(gru, generator)
        pose_encoder.init_weights_(generator)
        init_weights_(pose, generator)
    encoder, depth, gru, pose_encoder, pose = (
        m.to(device).eval() for m in (encoder, depth, gru, pose_encoder, pose))
    return GRUModels(encoder, depth, gru, None, opts, pose_encoder, pose)


def preprocess_gru_batch(batch: Dict[str, torch.Tensor], opts: Options,
                         is_train: bool = True):
    """(B, T, H, W, 3) sequence batch on the device -> (the flattened B*T
    mono-style inputs, B, T); frame 0's pyramid and the scale-0 augmented
    frames only (``steps_gru.py:118-132``)."""
    B, T = batch["color/0"].shape[:2]
    flat = {f"color/{i}": batch[f"color/{i}"].flatten(0, 1) for i in (0, -1, 1)}
    for k in ("K", "jitter"):
        if k in batch:
            flat[k] = batch[k].repeat_interleave(T, dim=0)
    inputs = preprocess_batch(flat, opts.height, opts.width, opts.num_scales, [0, -1, 1],
                              is_train=is_train, pyramid_frames=[0], aug_num_scales=1)
    return inputs, B, T


def gru_unroll(models: GRUModels, dec: Dict[str, torch.Tensor], B: int, T: int,
               remat: bool = False):
    """The v9/v10 block over T (``steps_gru.py:143-184``): per-scale decoder
    outputs (B*T, C, h, w), B-major -> ``disp/{s}`` (B*T, 1, h, w),
    B-major. The hidden state starts from h0, in the compute dtype. With
    ``remat`` each step's activations are recomputed in the backward."""
    hidden = models.gru.initial_state(B)
    if models.opts.compute_dtype == "bfloat16":
        # carry the hidden state in bf16; the h0 parameters stay float32
        hidden = [h.to(torch.bfloat16) for h in hidden]
    per_t = {k: v.unflatten(0, (B, T)) for k, v in dec.items()}
    disps = []
    for t in range(T):
        inputs = {k: v[:, t] for k, v in per_t.items()}
        if remat:
            hidden, disp = _remat(models.gru, inputs, hidden)
        else:
            hidden, disp = models.gru(inputs, hidden)
        disps.append(disp)
    return {k: torch.stack([d[k] for d in disps], 1).flatten(0, 1) for k in disps[0]}


def gru_loss_fn(models: GRUModels, inputs, B: int, T: int,
                generator: Optional[torch.Generator] = None):
    """encoder and decoder over B*T frames -> the unrolled block -> poses
    -> warp -> loss (``steps_gru.py:215-259``); returns (loss, losses,
    outputs). The modules' train/eval mode decides BatchNorm; with a
    gradient, :func:`remat_mode` decides what is recomputed."""
    opts = models.opts
    device = inputs["color_aug/0/0"].device
    mode = remat_mode(opts) if torch.is_grad_enabled() else "0"
    with steps._autocast(opts, device):
        if mode == "1":
            feats = _remat(models.encoder, inputs["color_aug/0/0"])
            dec = _remat(models.depth, feats, pre_disp=models.pre_disp)
        else:
            dec = models.depth(models.encoder(inputs["color_aug/0/0"]), pre_disp=models.pre_disp)
        outputs = gru_unroll(models, dec, B, T, remat=mode != "0")
        outputs.update(steps.predict_poses(models, inputs))
    with torch.autocast(device.type, enabled=False):
        outputs = steps.generate_images_pred(inputs, outputs, opts, models.source_ids)
        losses = steps.compute_losses(inputs, outputs, opts, models.source_ids, generator)
    return losses["loss"], losses, outputs


def train_step(models: GRUModels, state: TrainState, batch,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step on a device sequence batch: preprocess, forward in
    train mode, backward, Adam. Returns the losses (detached, on the
    device)."""
    inputs, B, T = preprocess_gru_batch(batch, models.opts, is_train=True)
    models.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, losses, _ = gru_loss_fn(models, inputs, B, T, generator)
    loss.backward()
    state.apply_gradients()
    return {k: v.detach() for k, v in losses.items()}
