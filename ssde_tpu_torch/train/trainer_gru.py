"""The recurrent sequence trainer (counterpart of
``ssde_tpu/train/trainer_gru.py``): GRU v9 or v10 over T-frame sequences with the
min-reprojection loss at every timestep, on the port's
:class:`~ssde_tpu_torch.train.trainer.TrainerBase` loop.

As in the JAX trainer: frames are [0, -1, 1]; ``--fuse 0`` is overridden
(the reference forces ``fuse=True``); ``--use_stereo`` raises; the rate is
constant unless ``--gru_lr_decay`` (the reference never steps its StepLR);
from epoch ``--h_s_epoch`` on the learned initial hidden states are frozen
exactly while everything else trains on. Only ``--synthetic_data`` is
ported (``SyntheticSeqDataset``, the JAX trainer's hermetic path); the KITTI
sequences, the monodepth2 warm start from ``models/mono_640x192`` and the
checkpoints are not, and ``--load_weights_folder`` or that warm start raise
(:func:`~ssde_tpu_torch.train.trainer.refuse_weights_to_load`).
"""

from __future__ import annotations

import torch

from ..config import Options
from ..data.pipeline import Loader
from ..data.synthetic import SyntheticSeqDataset
from .state import TrainState
from .steps_gru import (build_gru_models, check_supported, gru_loss_fn,
                        preprocess_gru_batch, train_step)
from .trainer import TrainerBase


class GRUTrainer(TrainerBase):
    step_fn = staticmethod(train_step)
    check_supported = staticmethod(check_supported)

    def __init__(self, options: Options, device=None, seed: int = 0):
        options.frame_ids = [0, -1, 1]
        if not options.fuse:
            print("---> --fuse 0 is overridden to 1 (the reference forces "
                  "fuse=True, trainer_gru.py:62; the concat branch is "
                  "unreachable there)")
            options.fuse = 1
        if options.use_stereo:
            raise ValueError(
                "--use_stereo is not supported by the GRU trainer: the sequence "
                "dataset emits temporal tuples only (no color/s or stereo_T). "
                "Use the mono trainer for stereo.")
        self._h0_frozen = False
        super().__init__(options, device, seed)

    def _build_data(self):
        opt = self.opt
        if not opt.synthetic_data:
            raise NotImplementedError(
                "the KITTI sequence datasets are not ported yet; pass --synthetic_data")
        self.train_dataset = SyntheticSeqDataset(
            opt.height, opt.width, n=opt.len_sequence, length=opt.batch_size * 4)
        self.val_dataset = SyntheticSeqDataset(
            opt.height, opt.width, n=opt.len_sequence, length=opt.batch_size * 2,
            is_train=False)
        self.train_loader = Loader(self.train_dataset, opt.batch_size, shuffle=True,
                                   drop_last=True, num_workers=opt.num_workers)
        self.val_loader = Loader(self.val_dataset, opt.batch_size, shuffle=False,
                                 drop_last=True, num_workers=opt.num_workers)
        self._val_iter = None

    def _build_models_and_state(self):
        opt = self.opt
        self.models = build_gru_models(opt, self.device,
                                       torch.Generator().manual_seed(self.seed))
        # the reference never steps its StepLR (trainer_gru.py:316): the rate
        # is constant unless --gru_lr_decay
        step_size = opt.scheduler_step_size if opt.gru_lr_decay else 0
        self.state = TrainState(self.models.parameters(), opt.learning_rate, step_size,
                                max(1, len(self.train_loader)))

    def run_epoch(self):
        if self.epoch >= self.opt.h_s_epoch and not self._h0_frozen:
            print(f"---> Freezing learned hidden states at epoch {self.epoch}")
            self.state.freeze(self.models.h0_parameters())
            self._h0_frozen = True
        return super().run_epoch()

    def process_batch(self, batch, generator=None):
        """Forward one device sequence batch in eval mode: (inputs,
        outputs, losses)."""
        inputs, B, T = preprocess_gru_batch(batch, self.opt, is_train=False)
        self.models.train(False)
        with torch.no_grad():
            _, losses, outputs = gru_loss_fn(self.models, inputs, B, T, generator)
        return inputs, outputs, losses
