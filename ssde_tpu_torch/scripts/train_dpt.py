#!/usr/bin/env python
"""--model selector training entry on the GPU (counterpart of
``scripts/train_dpt.py``).

Run: python -m ssde_tpu_torch.scripts.train_dpt --model monodepth2
       --synthetic_data --num_epochs 1 --save_frequency 2 [Options flags]

Only ``monodepth2`` is ported: the mono self-supervised trainer (ResNet
depth and pose encoders, frames [0, -1, 1], scales 0-3, bf16 autocast by
default). The other models raise ``NotImplementedError`` naming the slice
of the port that brings them. Checkpoints are not written yet, so a run
must end before its first save (``--save_frequency`` > ``--num_epochs``).
"""

from __future__ import annotations

from ..config import MonodepthOptions, Options
from ..train.trainer import Trainer

_LATER = {
    "rn_encoder_with_attention": "slice 5 (the attention encoder)",
    "rn_fusion": "slice 5 (the fusion trainers)",
    "dpt_gru": "slice 5 (DPT)",
}


def build_trainer(opts: Options, device=None) -> Trainer:
    """The trainer for ``opts.model``."""
    if opts.model == "monodepth2":
        return Trainer(opts, device)
    if opts.model in _LATER:
        raise NotImplementedError(
            f"--model {opts.model} is not ported yet: it comes with {_LATER[opts.model]}")
    raise ValueError(f"unknown --model {opts.model}")


def main(argv=None) -> Trainer:
    trainer = build_trainer(MonodepthOptions().parse(argv))
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
