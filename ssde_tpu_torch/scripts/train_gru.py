#!/usr/bin/env python
"""Recurrent (GRU) sequence training on the GPU (counterpart of
``scripts/train_gru.py``).

Run: python -m ssde_tpu_torch.scripts.train_gru --gru_version v10
       --data_path <KITTI raw tree> [--len_sequence 3] [Options flags]

GRU v9 (attention fusion; ``--disable_attention`` for conv units) or v10
(ResNet18 depth and pose encoders, frames [0, -1, 1], bf16 autocast by
default), on the card unless ``--no_cuda``, over T-frame windows of the
``--split``'s ``train_sequences`` scenes (or ``--synthetic_data``). It
writes and reads ``weights_<epoch>/`` as the mono trainer does, with
``gru.pth`` beside the mono modules. The other versions raise
``NotImplementedError`` naming the slice of the port that brings them.
"""

from __future__ import annotations

from ..config import MonodepthOptions, Options
from ..train.trainer_gru import GRUTrainer


def build_trainer(opts: Options, device=None) -> GRUTrainer:
    """The GRU trainer for ``opts`` (on ``device``, default as the trainer's)."""
    return GRUTrainer(opts, device)


def main(argv=None) -> GRUTrainer:
    trainer = build_trainer(MonodepthOptions().parse(argv))
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
