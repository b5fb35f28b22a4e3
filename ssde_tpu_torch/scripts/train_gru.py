#!/usr/bin/env python
"""Recurrent (GRU) sequence training on the GPU (counterpart of
``scripts/train_gru.py``).

Run: python -m ssde_tpu_torch.scripts.train_gru
       --data_path <KITTI raw tree> [--gru_version v5] [--len_sequence 3] [Options flags]

Any ``--gru_version``: v5 (the default), v1, v2 (attention fusion;
``v2_wo_att`` or ``--disable_attention`` for conv units), v3, v4, v6 (v4's
wiring), v7, v8 (ConvLSTM), v9 or v10. ResNet18 depth and pose encoders,
frames [0, -1, 1], bf16 autocast by default, on the card unless
``--no_cuda``, over T-frame windows of the ``--split``'s
``train_sequences`` scenes (or ``--synthetic_data``). It writes and reads
``weights_<epoch>/`` as the mono trainer does, with ``gru.pth`` (and
``head.pth`` for v4, v6 and v7) beside the mono modules.
"""

from __future__ import annotations

from typing import Optional

from ..config import MonodepthOptions, Options
from ..train.trainer import train_main
from ..train.trainer_gru import GRUTrainer


def build_trainer(opts: Options, device=None) -> GRUTrainer:
    """The GRU trainer for ``opts`` (on ``device``, default as the trainer's)."""
    return GRUTrainer(opts, device)


def main(argv=None) -> Optional[GRUTrainer]:
    """Train; the trainer, or None where ``--num_devices`` gives a mesh of
    more than one device (one process per device, ``train.trainer.train_main``)."""
    return train_main(GRUTrainer, MonodepthOptions().parse(argv))


if __name__ == "__main__":
    main()
