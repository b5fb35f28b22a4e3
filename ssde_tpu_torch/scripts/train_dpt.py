#!/usr/bin/env python
"""--model selector training entry on the GPU (counterpart of
``scripts/train_dpt.py``).

Run: python -m ssde_tpu_torch.scripts.train_dpt --model monodepth2
       --data_path <KITTI raw tree> [--split eigen_zhou] [Options flags]

``monodepth2`` is the mono self-supervised trainer (ResNet depth and pose
encoders, frames [0, -1, 1], scales 0-3, bf16 autocast by default) and
``rn_fusion`` the ``Fusion_v3`` trainer (frames [0, -1, -2, 1]), on a KITTI
raw or odometry tree (``--dataset``), or on ``--synthetic_data``. Every
``--save_frequency`` epochs it writes
``<log_dir>/<model_name>/models/weights_<epoch>/`` (one ``.pth`` per
module and ``adam.pth``); ``--load_weights_folder`` resumes from such a
folder. The other models raise ``NotImplementedError`` naming the slice of
the port that brings them.
"""

from __future__ import annotations

from ..config import MonodepthOptions, Options
from ..train.trainer import FusionV3Trainer, Trainer, TrainerBase

_LATER = {
    "rn_encoder_with_attention": "slice 5 (the attention encoder)",
    "dpt_gru": "slice 5 (DPT)",
}


def build_trainer(opts: Options, device=None) -> TrainerBase:
    """The trainer for ``opts.model``."""
    if opts.model == "monodepth2":
        return Trainer(opts, device)
    if opts.model == "rn_fusion":
        return FusionV3Trainer(opts, device)
    if opts.model in _LATER:
        raise NotImplementedError(
            f"--model {opts.model} is not ported yet: it comes with {_LATER[opts.model]}")
    raise ValueError(f"unknown --model {opts.model}")


def main(argv=None) -> TrainerBase:
    trainer = build_trainer(MonodepthOptions().parse(argv))
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
