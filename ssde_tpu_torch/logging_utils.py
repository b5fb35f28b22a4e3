"""Training logs: TensorBoard writers, the console line and the options
dump (counterpart of ``ssde_tpu/logging_utils.py``).

The reference's logging contract (trainer.py:166-168, 654-709): one
``SummaryWriter`` per mode under ``<log_dir>/<model_name>/{train,val}``,
scalar losses and depth metrics, image panels of at most 4 samples, the
``examples/s`` console line and ``models/opt.json``. As in the JAX package
(``ssde_tpu/logging_utils.py:18-22``), the writers are TensorBoard's where
the ``tensorboard`` package imports and do nothing where it does not.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from .utils import normalize_image, sec_to_hm_str


def _summary_writer_cls():
    """torch's ``SummaryWriter``, or None without the ``tensorboard``
    package. Imported on first use: the import is slow where tensorboard
    finds TensorFlow beside it."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter


def _host(x: torch.Tensor) -> np.ndarray:
    """A tensor of any dtype on any device as float32 numpy."""
    return x.detach().float().cpu().numpy()


class Writers:
    """One TensorBoard writer per mode, or none (then every call is a
    no-op). :meth:`images` takes the port's NCHW tensors and writes the
    tags, steps and pixels the JAX ``Writers`` writes from NHWC arrays."""

    def __init__(self, log_path: str, modes=("train", "val")):
        self.writers = {}
        summary_writer = _summary_writer_cls() if modes else None
        if summary_writer is not None:
            for mode in modes:
                self.writers[mode] = summary_writer(os.path.join(log_path, mode))

    def scalars(self, mode: str, step: int, losses: Dict[str, float]):
        w = self.writers.get(mode)
        if w is None:
            return
        for name, value in losses.items():
            w.add_scalar(name, float(value), step)

    def images(self, mode: str, step: int, inputs, outputs, scales, frame_ids,
               max_images: int = 4):
        """``color_{fid}_{s}/{j}`` (B, 3, h, w), ``disp_{s}/{j}`` (B, 1, h, w)
        through :func:`normalize_image` and ``automask_{s}/{j}`` from
        ``identity_selection/{s}`` (B, 1, h, w), for the first
        ``max_images`` samples."""
        w = self.writers.get(mode)
        if w is None:
            return
        n = min(max_images, inputs["color/0/0"].shape[0])
        for j in range(n):
            for s in scales:
                for fid in frame_ids:
                    if f"color/{fid}/{s}" in inputs:
                        w.add_image(f"color_{fid}_{s}/{j}",
                                    _host(inputs[f"color/{fid}/{s}"][j]), step)
                if f"disp/{s}" in outputs:
                    disp = _host(outputs[f"disp/{s}"][j, 0])
                    w.add_image(f"disp_{s}/{j}", normalize_image(disp)[None], step)
                key = f"identity_selection/{s}"
                if key in outputs:
                    w.add_image(f"automask_{s}/{j}", _host(outputs[key][j, 0])[None], step)

    def close(self):
        for w in self.writers.values():
            w.close()


class TimeLogger:
    """examples/s + ETA console line (reference trainer.py:654-664)."""

    def __init__(self, num_total_steps: int, batch_size: int):
        self.start_time = time.time()
        self.num_total_steps = max(1, num_total_steps)
        self.batch_size = batch_size

    def log(self, step: int, duration: float, loss: float):
        samples_per_sec = self.batch_size / max(duration, 1e-9)
        time_sofar = time.time() - self.start_time
        training_time_left = (
            self.num_total_steps / max(step, 1) - 1.0
        ) * time_sofar if step > 0 else 0
        print(
            "step {:>6} | examples/s: {:5.1f} | loss: {:.5f} | "
            "time elapsed: {} | time left: {}".format(
                step, samples_per_sec, loss,
                sec_to_hm_str(time_sofar), sec_to_hm_str(training_time_left),
            ),
            flush=True,
        )
        return samples_per_sec


def save_opts(log_path: str, opts):
    """Dump the flag namespace to models/opt.json (trainer.py:700-709)."""
    models_dir = os.path.join(log_path, "models")
    os.makedirs(models_dir, exist_ok=True)
    opts.save(os.path.join(models_dir, "opt.json"))
