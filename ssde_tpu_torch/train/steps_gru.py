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
while the learned initial states, the geometry, the warp and the loss
stay float32. Every ``--gru_version`` is ported; :func:`gru_unroll` has the
JAX step's four paths: v5 (the decoder on the encoder features plus the
mean of consecutive hidden states), the versions whose block makes the
disparity (v1, v2, v3, v8, v9, v10), v4/v6 (the ``--fuse`` mean added to
the decoder features, then the ``Head``) and v7 (a (current, previous)
carry, then the ``Head``).

Rematerialisation follows ``--gru_remat`` as the JAX step's ``_remat_mode``
does (``steps_gru.py:52-87``), with the same B*T thresholds under "auto":
nothing up to B*T = 24 (the benchmark shape), the unrolled block's steps
up to 32, and beyond that (the Options defaults B=12, T=10 are 120) the
encoder and decoder passes too (v5's decoder, which runs after the
block, included), each through ``torch.utils.checkpoint``.
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
from ..models import ConvGRUBlocks, DepthDecoder, Head, PoseDecoder, ResnetEncoder, make_gru
from ..models.common import init_weights_
from ..models.recurrent import block_version, kernel_scales
from ..models.resnet import running_stats_frozen
from . import steps
from .state import TrainState

# the versions with an external Head, and its channels per scale
# (ssde_tpu/train/steps_gru.py:47-48)
HEAD_VERSIONS = {"v4": (16, 32, 64, 128), "v6": (16, 32, 64, 128),
                 "v7": (32, 64, 128, 256)}
PRE_DISP_VERSIONS = {"v3", "v4", "v6", "v7", "v8", "v9", "v10"}


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
    """Raise for what the GRU trainer does not take: an unknown
    ``--gru_version`` (``ValueError``), then the Monodepth2 options that
    the JAX GRU step cannot run (``steps.check_supported``)."""
    block_version(opts.gru_version)
    steps.check_supported(opts, "gru")


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
        return tuple(m for m in (self.encoder, self.depth, self.gru, self.head,
                                 self.pose_encoder, self.pose) if m is not None)

    def parameters(self) -> List[torch.nn.Parameter]:
        """The parameters the step trains. Under ``pre_disp`` the decoder's
        ``dispconv_*`` heads never run (the block makes the disparity), get
        no gradient and are left out, as the JAX tree has no such entries
        (``checkpoint.depth_from_flax``)."""
        skip = {id(p) for p in self.depth.dispconv_parameters()} if self.pre_disp else set()
        return [p for m in self.modules() for p in m.parameters() if id(p) not in skip]

    def h0_parameters(self) -> List[torch.nn.Parameter]:
        """The learned initial states (every scale's ``h0_layer1``, and
        ``c0_layer1`` for an LSTM), which the h0 freeze stops, as the JAX
        freeze stops ``h0`` and ``c0`` (``ssde_tpu/train/state.py:159-164``)."""
        return self.gru.initial_parameters()

    def train(self, mode: bool = True) -> "GRUModels":
        for m in self.modules():
            m.train(mode)
        return self


def build_gru_models(opts: Options, device="cuda",
                     generator: Optional[torch.Generator] = None) -> GRUModels:
    """Depth encoder and decoder, the recurrent block, its ``Head`` for
    v4/v6/v7, and the pose encoder on pairs + PoseDecoder; float32
    parameters, in eval mode.

    With a ``generator`` the weights are initialised from it on the CPU
    (torchvision's scheme for the encoders, torch's default for the rest;
    h0 stays zero as in the JAX package) before the move to ``device``.
    Without one, load weights afterwards (:mod:`ssde_tpu_torch.checkpoint`).
    """
    encoder = ResnetEncoder(opts.num_layers)
    depth = DepthDecoder(encoder.num_ch_enc, scales=tuple(opts.scales))
    gru = make_gru(opts.gru_version, opts.height, opts.width,
                   attention=not opts.disable_attention)
    head = None
    if opts.gru_version in HEAD_VERSIONS:
        head = Head(HEAD_VERSIONS[opts.gru_version], kernel_scales(opts.gru_version))
    pose_encoder = ResnetEncoder(opts.num_layers, num_input_images=2)
    pose = PoseDecoder(pose_encoder.num_ch_enc, num_input_features=1,
                       num_frames_to_predict_for=2)
    if generator is not None:
        encoder.init_weights_(generator)
        init_weights_(depth, generator)
        init_weights_(gru, generator)
        if head is not None:
            init_weights_(head, generator)
        pose_encoder.init_weights_(generator)
        init_weights_(pose, generator)
    encoder, depth, gru, pose_encoder, pose = (
        m.to(device).eval() for m in (encoder, depth, gru, pose_encoder, pose))
    if head is not None:
        head = head.to(device).eval()
    return GRUModels(encoder, depth, gru, head, opts, pose_encoder, pose)


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


def _per_t(x: torch.Tensor, B: int, T: int) -> List[torch.Tensor]:
    """(B*T, ...) B-major -> the T tensors (B, ...) of each timestep."""
    return list(x.unflatten(0, (B, T)).unbind(1))


def _flat(xs: List[torch.Tensor]) -> torch.Tensor:
    """T tensors (B, ...) -> (B*T, ...) B-major."""
    return torch.stack(xs, 1).flatten(0, 1)


def gru_unroll(models: GRUModels, dec_or_feats, B: int, T: int, mode: str = "0"):
    """The block over T (``steps_gru.py:143-212``): the decoder's per-scale
    outputs (B*T, C, h, w) B-major -- for v5 the encoder's 5 feature maps --
    -> ``disp/{s}`` (B*T, 1, h, w) B-major. The hidden state starts from the
    learned initial state, in the compute dtype. Under the remat ``mode``
    "scan" and "1" each step's activations are recomputed in the backward,
    and under "1" v5's decoder pass too.

    v5 runs the decoder on each scale's features plus the mean of the
    hidden states before and after the step; v4/v6 add that mean to the
    decoder outputs and v7 feeds the block the mean of its last two hidden
    states, and both then run the ``Head`` on all B*T frames at once.
    """
    gru, version = models.gru, models.opts.gru_version
    h0 = gru.initial_state(B)
    if models.opts.compute_dtype == "bfloat16":
        # carry the hidden state, an LSTM's (h, c) included, in bf16; the
        # h0/c0 parameters stay float32
        bf16 = lambda t: t.to(torch.bfloat16)  # noqa: E731
        h0 = [tuple(map(bf16, h)) if isinstance(h, tuple) else bf16(h) for h in h0]
    step = (lambda *a: _remat(gru, *a)) if mode != "0" else gru
    if version == "v5":
        per_t = [list(f) for f in zip(*(_per_t(f, B, T) for f in dec_or_feats))]
    else:
        per_t = [dict(zip(dec_or_feats, d)) for d in
                 zip(*(_per_t(v, B, T) for v in dec_or_feats.values()))]
    hidden, prev, disps, seq = h0, h0, [], []
    for t in range(T):
        h_in = hidden
        if version == "v7":
            h_in = [(c + p) / 2 for c, p in zip(hidden, prev)]
        new, disp = step(per_t[t], h_in)
        prev, hidden = hidden, new
        disps.append(disp)
        seq.append(new)
    if disps[0] is not None:  # the block made the disparity
        return {k: _flat([d[k] for d in disps]) for k in disps[0]}
    n = gru.n_scales
    if version == "v7":
        return models.head([_flat([h[s] for h in seq]) for s in range(n)])
    # the --fuse mean of consecutive hidden states, h0 before the first
    mix = [_flat([(a[s] + b[s]) / 2 for a, b in zip([h0] + seq[:-1], seq)])
           for s in range(n)]
    if version == "v5":
        fused = [f + m for f, m in zip(dec_or_feats, mix)]
        return _remat(models.depth, fused) if mode == "1" else models.depth(fused)
    return models.head({f"disp/{s}": dec_or_feats[f"disp/{s}"] + mix[s] for s in range(n)})


def gru_loss_fn(models: GRUModels, inputs, B: int, T: int,
                generator: Optional[torch.Generator] = None):
    """encoder and decoder over B*T frames -> the unrolled block -> poses
    -> warp -> loss (``steps_gru.py:215-259``; for v5 the decoder runs
    after the block, in :func:`gru_unroll`); returns (loss, losses,
    outputs). The modules' train/eval mode decides BatchNorm; with a
    gradient, :func:`remat_mode` decides what is recomputed."""
    opts = models.opts
    device = inputs["color_aug/0/0"].device
    mode = remat_mode(opts) if torch.is_grad_enabled() else "0"
    with steps._autocast(opts, device):
        x = inputs["color_aug/0/0"]
        feats = _remat(models.encoder, x) if mode == "1" else models.encoder(x)
        if opts.gru_version == "v5":
            dec = feats
        elif mode == "1":
            dec = _remat(models.depth, feats, pre_disp=models.pre_disp)
        else:
            dec = models.depth(feats, pre_disp=models.pre_disp)
        outputs = gru_unroll(models, dec, B, T, mode)
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
