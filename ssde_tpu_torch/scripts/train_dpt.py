#!/usr/bin/env python
"""--model selector training entry on the GPU (counterpart of
``scripts/train_dpt.py``).

Run: python -m ssde_tpu_torch.scripts.train_dpt [--model dpt_gru]
       --data_path <KITTI raw tree> [--split eigen_zhou] [Options flags]

``dpt_gru`` (the default) is the DPT-hybrid trainer (ViT-B/16 on a
ResNet-50 stem, frames [0, -1, 1], scale 0), ``monodepth2`` the mono
self-supervised trainer (ResNet depth and pose encoders, frames
[0, -1, 1], scales 0-3), ``rn_encoder_with_attention`` the mono trainer
with an attention conv after each ResNet layer, and ``rn_fusion`` the
``Fusion_v3`` trainer (frames [0, -1, -2, 1]); bf16 autocast by default,
on a KITTI raw or odometry tree (``--dataset``), or on
``--synthetic_data``. Every ``--save_frequency`` epochs it writes
``<log_dir>/<model_name>/models/weights_<epoch>/`` (one ``.pth`` per
module and ``adam.pth``); ``--load_weights_folder`` resumes from such a
folder, or from the JAX package's folder of ``.ckpt`` files and ``adam.ckpt``.
"""

from __future__ import annotations

from typing import Optional

from ..config import MonodepthOptions, Options
from ..train.trainer import (AttentionTrainer, DPTTrainer, FusionV3Trainer, Trainer, TrainerBase,
                             train_main)

TRAINERS = {"monodepth2": Trainer, "rn_encoder_with_attention": AttentionTrainer,
            "rn_fusion": FusionV3Trainer, "dpt_gru": DPTTrainer}


def build_trainer(opts: Options, device=None) -> TrainerBase:
    """The trainer for ``opts.model``."""
    if opts.model not in TRAINERS:
        raise ValueError(f"unknown --model {opts.model}")
    return TRAINERS[opts.model](opts, device)


def main(argv=None) -> Optional[TrainerBase]:
    """Train; the trainer, or None where ``--num_devices`` gives a mesh of
    more than one device (one process per device, ``train.trainer.train_main``)."""
    opts = MonodepthOptions().parse(argv)
    if opts.model not in TRAINERS:
        raise ValueError(f"unknown --model {opts.model}")
    return train_main(TRAINERS[opts.model], opts)


if __name__ == "__main__":
    main()
