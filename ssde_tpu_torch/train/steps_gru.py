"""Model construction for the recurrent (GRU) family (counterpart of the
inference part of ``ssde_tpu/train/steps_gru.py``, :47-115).

The pose networks, the losses and the sequence train step belong to
training and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ssde_tpu.config import Options

from ..models import ConvGRUBlocks, DepthDecoder, ResnetEncoder, make_gru
from ..models.common import init_weights_

HEAD_VERSIONS = {"v4": (16, 32, 64, 128), "v6": (16, 32, 64, 128),
                 "v7": (32, 64, 128, 256)}
PRE_DISP_VERSIONS = {"v3", "v4", "v6", "v7", "v8", "v9", "v10"}


@dataclasses.dataclass
class GRUModels:
    encoder: ResnetEncoder
    depth: DepthDecoder
    gru: ConvGRUBlocks
    head: Optional[torch.nn.Module]
    opts: Options


def build_gru_models(opts: Options, device="cpu",
                     generator: Optional[torch.Generator] = None) -> GRUModels:
    """Encoder, decoder and recurrent block for ``opts``, in eval mode.

    With a ``generator`` the weights are initialised from it (torchvision's
    scheme for the encoder, torch's default for the rest; h0 stays zero as
    in the JAX package); the modules are built on the CPU and then moved to
    ``device``. Without one, load weights afterwards
    (:mod:`ssde_tpu_torch.checkpoint`).
    """
    if opts.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype {opts.compute_dtype!r}: the port runs float32 only")
    if opts.gru_version in HEAD_VERSIONS:
        raise NotImplementedError(f"GRU {opts.gru_version} heads are not ported yet")
    encoder = ResnetEncoder(opts.num_layers)
    depth = DepthDecoder(encoder.num_ch_enc, scales=tuple(opts.scales))
    gru = make_gru(opts.gru_version, opts.height, opts.width,
                   attention=not opts.disable_attention)
    if generator is not None:
        encoder.init_weights_(generator)
        init_weights_(depth, generator)
        init_weights_(gru, generator)
    mods = [m.to(device).eval() for m in (encoder, depth, gru)]
    return GRUModels(*mods, None, opts)
