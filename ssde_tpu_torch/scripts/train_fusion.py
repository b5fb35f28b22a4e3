#!/usr/bin/env python
"""3-frame attention-fusion training, the pre-disp PixelShuffle pyramid, on
the GPU (counterpart of ``scripts/train_fusion.py``).

Run: python -m ssde_tpu_torch.scripts.train_fusion
       --data_path <KITTI raw tree> [--split eigen_zhou] [Options flags]

ResNet18 depth and pose encoders, the decoder's pre-disp features of frames
[0, -1, -2] fused by ``Fusion``, the loss over sources -1 and 1, bf16
autocast by default, on the card unless ``--no_cuda`` (or
``--synthetic_data`` for hermetic data). It writes and reads
``weights_<epoch>/`` as the mono trainer does, with ``fusion.pth`` beside
the mono modules.
"""

from __future__ import annotations

from typing import Optional

from ..config import MonodepthOptions, Options
from ..train.trainer import FusionTrainer, train_main


def build_trainer(opts: Options, device=None) -> FusionTrainer:
    """The pyramid fusion trainer for ``opts`` (on ``device``, default as the
    trainer's)."""
    return FusionTrainer(opts, device)


def main(argv=None) -> Optional[FusionTrainer]:
    """Train; the trainer, or None where ``--num_devices`` gives a mesh of
    more than one device (one process per device, ``train.trainer.train_main``)."""
    return train_main(FusionTrainer, MonodepthOptions().parse(argv))


if __name__ == "__main__":
    main()
