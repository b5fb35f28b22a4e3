"""The recurrent sequence trainer (counterpart of
``ssde_tpu/train/trainer_gru.py``): any GRU version (v1-v10) over T-frame
sequences with the min-reprojection loss at every timestep, on the port's
:class:`~ssde_tpu_torch.train.trainer.TrainerBase` loop.

As in the JAX trainer: frames are [0, -1, 1]; ``--fuse 0`` is overridden
(the reference forces ``fuse=True``); ``--use_stereo`` raises; the rate is
constant unless ``--gru_lr_decay`` (the reference never steps its StepLR);
from epoch ``--h_s_epoch`` on the learned initial states (h0, and c0 of
v8's ConvLSTM) are frozen exactly while everything else trains on. The
data are T-frame windows of the ``--split``'s
``train_sequences``/``val_sequences`` scenes under ``--data_path``
(:class:`~ssde_tpu_torch.data.sequence.KITTISeqDataset`), or
``--synthetic_data``. Checkpoints, loading and the monodepth2 warm start
are the base trainer's, with ``gru.pth`` (and ``head.pth`` for v4, v6 and
v7) beside the mono modules; the depth metrics take the (B, T) ground
truth B-major. On a data-parallel mesh the ranks split the sequences (B),
never the frames (T), and ``--gru_remat auto`` decides by the global B*T,
as the JAX step's traced shapes are global.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Options
from ..data.sequence import KITTISeqDataset, count_scene_frames, generate_frame_tuples
from ..data.splits import readlines, split_file
from ..data.synthetic import SyntheticSeqDataset
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

    def _frame_idxs(self):
        return [0, -1, 1]

    def _build_data(self):
        opt = self.opt
        if opt.synthetic_data:
            self.train_dataset = SyntheticSeqDataset(
                opt.height, opt.width, n=opt.len_sequence, length=opt.batch_size * 4)
            self.val_dataset = SyntheticSeqDataset(
                opt.height, opt.width, n=opt.len_sequence, length=opt.batch_size * 2,
                is_train=False)
        else:
            train_scenes = readlines(split_file(opt.split, "train_sequences"))
            val_scenes = readlines(split_file(opt.split, "val_sequences"))
            n_frames = count_scene_frames(train_scenes + val_scenes, opt.data_path)
            # k=2 extra frames: windows of T+2 so that every centre frame has
            # both neighbours (reference trainer_gru.py:222)
            train_tuples = generate_frame_tuples(n_frames, train_scenes, opt.len_sequence, 2,
                                                 opt.train_n_tuples)
            val_tuples = generate_frame_tuples(n_frames, val_scenes, opt.len_sequence, 2,
                                               opt.test_n_tuples)
            self.train_dataset = KITTISeqDataset(
                opt.data_path, train_tuples, opt.height, opt.width, opt.len_sequence,
                is_train=True, decoded_cache=opt.decoded_cache)
            self.val_dataset = KITTISeqDataset(
                opt.data_path, val_tuples, opt.height, opt.width, opt.len_sequence,
                is_train=False, decoded_cache=opt.decoded_cache)
        self._make_loaders()

    def _build_models(self):
        return build_gru_models(self.opt, self.device,
                                torch.Generator().manual_seed(self.seed))

    def _scheduler_step_size(self) -> int:
        # the reference never steps its StepLR (trainer_gru.py:316): the rate
        # is constant unless --gru_lr_decay
        return self.opt.scheduler_step_size if self.opt.gru_lr_decay else 0

    def run_epoch(self):
        if self.epoch >= self.opt.h_s_epoch and not self._h0_frozen:  # on every rank
            if self.lead:
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

    def compute_depth_losses(self, batch, outputs):
        """(B, T, H, W) ground truth flattened B-major, as the B*T depths
        are (``ssde_tpu/train/trainer_gru.py:172-175``)."""
        gt = np.asarray(batch["depth_gt"])
        return super().compute_depth_losses(
            {"depth_gt": gt.reshape((-1,) + gt.shape[2:])}, outputs)
