#!/usr/bin/env python
"""``Fusion_v3`` multi-frame training on the GPU (counterpart of
``scripts/train_fusion_v3.py``).

Run: python -m ssde_tpu_torch.scripts.train_fusion_v3
       --data_path <KITTI raw tree> [--disable_attention] [Options flags]

ResNet18 depth and pose encoders, the sigmoid disparities of frames
[0, -1, -2] fused by ``Fusion_v3`` (attention units, or conv units with
``--disable_attention``), the loss over sources -1 and 1, bf16 autocast by
default, on the card unless ``--no_cuda``. The training list is the
split's ``train_files_seq.txt`` where it exists, else ``train_files.txt``.
It writes and reads ``weights_<epoch>/`` with ``fusion.pth`` beside the
mono modules.
"""

from __future__ import annotations

from typing import Optional

from ..config import MonodepthOptions, Options
from ..train.trainer import FusionV3Trainer, train_main


def build_trainer(opts: Options, device=None) -> FusionV3Trainer:
    """The v3 fusion trainer for ``opts`` (on ``device``, default as the
    trainer's)."""
    return FusionV3Trainer(opts, device)


def main(argv=None) -> Optional[FusionV3Trainer]:
    """Train; the trainer, or None where ``--num_devices`` gives a mesh of
    more than one device (one process per device, ``train.trainer.train_main``)."""
    return train_main(FusionV3Trainer, MonodepthOptions().parse(argv))


if __name__ == "__main__":
    main()
