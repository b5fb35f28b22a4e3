#!/usr/bin/env python
"""Recurrent (GRU) sequence training on the GPU (counterpart of
``scripts/train_gru.py``).

Run: python -m ssde_tpu_torch.scripts.train_gru --gru_version v9
       --synthetic_data --num_epochs 1 --save_frequency 2 [Options flags]

GRU v9 (attention fusion; ``--disable_attention`` for conv units) or v10
(ResNet18 depth and pose encoders, frames [0, -1, 1], bf16 autocast by
default), on the card unless ``--no_cuda``; the other versions raise
``NotImplementedError`` naming the slice of the port that brings them. Checkpoints are not written yet, so a run must end before its first
save (``--save_frequency`` > ``--num_epochs``).
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
