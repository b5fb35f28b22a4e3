"""The mono trainer (counterpart of ``ssde_tpu/train/trainer.py``
``TrainerBase`` and ``Trainer``, :55-392).

An epoch loop around :func:`ssde_tpu_torch.train.steps.train_step`: the
loader collates numpy batches in worker threads, each batch goes to the
device from pinned memory, and at the JAX trainer's logging points the
loss line is printed and :meth:`TrainerBase.val` runs one validation
batch (loss only). There is no TensorBoard writer, mesh or
``device_prefetch`` yet.

The port's warp is exact, so it reports no ``warp/band_violation`` and the
JAX trainer's ``_check_band_violation`` guard has nothing to check.
Checkpoints in the reference's per-module ``.pth`` layout (``save_model``,
``load_model``) and the depth-metric ``val`` belong to the next training
slice: until then :meth:`TrainerBase.train` refuses a run whose epochs
would reach ``save_model``, and the trainers refuse the weights the JAX
trainers would load (:func:`refuse_weights_to_load`) rather than train
from a random initialisation instead.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import torch

from ..config import Options
from ..data.pipeline import Loader, to_device
from ..data.synthetic import SyntheticKittiDataset
from ..data.transforms import preprocess_batch
from .state import TrainState
from .steps import build_mono_models, check_supported, mono_loss_fn, train_step


def _hm(seconds: float) -> str:
    m = int(seconds) // 60
    return f"{m // 60:02d}h{m % 60:02d}m"


def train_device(opt: Options, device=None) -> torch.device:
    """The trainers' device: ``device`` if given, else the CPU under
    ``--no_cuda`` and the card otherwise. A card that is asked for and
    absent is an error: nothing falls back to the CPU."""
    if device is None:
        device = "cpu" if opt.no_cuda else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available: the trainer runs on the card; "
                           "pass --no_cuda (or device='cpu') to train on the CPU")
    return device


def refuse_weights_to_load(opt: Options) -> None:
    """Raise ``NotImplementedError`` naming the flag wherever the JAX
    trainers load weights (``ssde_tpu/train/trainer.py:160-179``,
    ``trainer_gru.py:125-149``): ``--load_weights_folder`` set, or
    ``--mono_pretrained`` on with no folder while ``models/mono_640x192``
    exists relative to the working directory. Loading is not ported yet."""
    if opt.load_weights_folder is not None:
        raise NotImplementedError(
            f"--load_weights_folder {opt.load_weights_folder}: loading weights into the "
            "trainers is not ported yet; leave it unset to train from a random "
            "initialisation")
    folder = os.path.join("models", "mono_640x192")
    if opt.mono_pretrained and os.path.isdir(folder):
        raise NotImplementedError(
            f"--mono_pretrained: the monodepth2 warm start from {folder} is not ported "
            "yet; pass --mono_pretrained 0 to train from a random initialisation")


class TrainerBase:
    """Data, models, optimizer and the epoch loop; the step itself is
    :attr:`step_fn`, :func:`ssde_tpu_torch.train.steps.train_step` here.
    Runs on the card unless ``device`` or ``--no_cuda`` asks for the CPU."""

    step_fn = staticmethod(train_step)
    check_supported = staticmethod(check_supported)

    def __init__(self, options: Options, device=None, seed: int = 0):
        self.opt = options
        assert self.opt.height % 32 == 0, "'height' must be a multiple of 32"
        assert self.opt.width % 32 == 0, "'width' must be a multiple of 32"
        assert self.opt.frame_ids[0] == 0, "frame_ids must start with 0"
        self.check_supported(self.opt)
        refuse_weights_to_load(self.opt)
        self.device = train_device(self.opt, device)
        self.step = 0
        self.epoch = 0
        self.seed = seed
        self._build_data()
        self._build_models_and_state()
        self.num_total_steps = len(self.train_loader) * self.opt.num_epochs
        self.start_time = time.time()
        print(f"Training model named: {self.opt.model_name}")
        print(f"Device: {self.device}"
              + (f" ({torch.cuda.get_device_name(self.device)})"
                 if self.device.type == "cuda" else ""))

    # ------------------------------------------------------------- data
    def _build_data(self):
        opt = self.opt
        if not opt.synthetic_data:
            raise NotImplementedError(
                "the KITTI datasets are not ported yet; pass --synthetic_data")
        ids = list(opt.frame_ids)
        self.train_dataset = SyntheticKittiDataset(
            opt.height, opt.width, length=opt.batch_size * 8, frame_idxs=ids)
        self.val_dataset = SyntheticKittiDataset(
            opt.height, opt.width, length=opt.batch_size * 2, frame_idxs=ids,
            is_train=False)
        self.train_loader = Loader(self.train_dataset, opt.batch_size, shuffle=True,
                                   drop_last=True, num_workers=opt.num_workers)
        self.val_loader = Loader(self.val_dataset, opt.batch_size, shuffle=False,
                                 drop_last=True, num_workers=opt.num_workers)
        self._val_iter = None

    # ------------------------------------------------- models and state
    def _build_models_and_state(self):
        self.models = build_mono_models(self.opt, self.device,
                                        torch.Generator().manual_seed(self.seed))
        self.state = TrainState(self.models.parameters(), self.opt.learning_rate,
                                self.opt.scheduler_step_size,
                                max(1, len(self.train_loader)))

    # ------------------------------------------------------------ train
    def train(self):
        """``num_epochs`` epochs. Refused while any epoch would end in a
        checkpoint (``--save_frequency`` <= ``--num_epochs``)."""
        if self.opt.save_frequency <= self.opt.num_epochs:
            raise NotImplementedError(
                "save_model (the per-module .pth checkpoints) is not ported yet; "
                "pass --save_frequency greater than --num_epochs")
        self.start_time = time.time()
        for self.epoch in range(self.opt.num_epochs):
            self.run_epoch()

    def run_epoch(self) -> List[Dict[str, torch.Tensor]]:
        """One pass over the training set; the losses of every step, on the
        device (reading them back waits for the steps)."""
        print(f"Training epoch {self.epoch}", flush=True)
        self.train_dataset.set_epoch(self.epoch)
        gen = torch.Generator(self.device).manual_seed(self.epoch)
        history = []
        for batch_idx, host in enumerate(self.train_loader):
            before = time.time()
            losses = self.step_fn(self.models, self.state, to_device(host, self.device), gen)
            history.append(losses)
            early_phase = batch_idx % self.opt.log_frequency == 0 and self.step < 2000
            if early_phase or self.step % 2000 == 0:
                loss = float(losses["loss"])  # waits for the step
                self.log_time(time.time() - before, loss)
                self.val()
            self.step += 1
        return history

    def log_time(self, duration: float, loss: float) -> None:
        """The reference's console line (trainer.py:654-664)."""
        elapsed = time.time() - self.start_time
        left = (self.num_total_steps / max(self.step, 1) - 1.0) * elapsed if self.step else 0
        print(f"step {self.step:>6} | examples/s: {self.opt.batch_size / max(duration, 1e-9):5.1f}"
              f" | loss: {loss:.5f} | time elapsed: {_hm(elapsed)} | time left: {_hm(left)}",
              flush=True)

    # -------------------------------------------------------------- val
    def process_batch(self, batch, generator=None):
        """Forward one device batch in eval mode: (inputs, outputs, losses)."""
        inputs = preprocess_batch(batch, self.opt.height, self.opt.width,
                                  self.opt.num_scales, list(self.opt.frame_ids),
                                  is_train=False)
        self.models.train(False)
        with torch.no_grad():
            _, losses, outputs = mono_loss_fn(self.models, inputs, generator)
        return inputs, outputs, losses

    def val(self) -> Dict[str, float]:
        """Losses of the next validation batch (loss only: the depth
        metrics need KITTI ground truth)."""
        if self._val_iter is None:
            self._val_iter = iter(self.val_loader)
        try:
            host = next(self._val_iter)
        except StopIteration:
            self._val_iter = iter(self.val_loader)
            host = next(self._val_iter)
        _, _, losses = self.process_batch(to_device(host, self.device))
        scalars = {k: float(v) for k, v in losses.items()}
        print("val " + " ".join(f"{k} {v:.5f}" for k, v in sorted(scalars.items())),
              flush=True)
        return scalars


class Trainer(TrainerBase):
    """Plain monodepth2-style training."""
