"""Optimizer of the port's training (counterpart of ``ssde_tpu/train/state.py``).

Adam (b1 0.9, b2 0.999, eps 1e-8: optax's defaults, and torch's; the
update lr * m_hat / (sqrt(v_hat) + eps) is the same formula) with StepLR as
the JAX package keys it: on the global step, lr * gamma^(step // boundary)
with boundary = step_size * steps_per_epoch, so the rate decays at every
multiple of ``scheduler_step_size`` epochs. ``scheduler_step_size <= 0``
keeps the rate constant.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

from ..parallel.dist import all_reduce_mean_, data_group, in_group


def lr_at(step: int, learning_rate: float, scheduler_step_size: int,
          steps_per_epoch: int, gamma: float = 0.1) -> float:
    """The rate of update number ``step`` (0 for the first update)."""
    if scheduler_step_size <= 0:
        return learning_rate
    boundary = scheduler_step_size * max(1, steps_per_epoch)
    return learning_rate * gamma ** (step // boundary)


class TrainState:
    """Parameters' optimizer and the global step. :meth:`apply_gradients`
    sets the scheduled rate, takes one Adam step and counts it; parameters
    passed to :meth:`freeze` stop training from then on."""

    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-4,
                 scheduler_step_size: int = 15, steps_per_epoch: int = 1):
        self.learning_rate = learning_rate
        self.scheduler_step_size = scheduler_step_size
        self.steps_per_epoch = steps_per_epoch
        self.step = 0
        self.optimizer = torch.optim.Adam(list(params), lr=learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.frozen: List[torch.nn.Parameter] = []

    @property
    def lr(self) -> float:
        return lr_at(self.step, self.learning_rate, self.scheduler_step_size,
                     self.steps_per_epoch)

    def freeze(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Stop ``params`` exactly; the others and their Adam moments train
        on unchanged (the GRU trainer's h0 freeze, ``ssde_tpu/train/state.py``
        :145-183). Their gradients are dropped before each step, so torch's
        Adam skips them. optax instead zeroes their gradients and updates
        and so keeps decaying their moments; nothing reads those moments
        again, and every other parameter sees the same moments and
        (per-parameter) step count either way."""
        self.frozen.extend(params)

    def apply_gradients(self) -> None:
        """The scheduled rate, one Adam step, the count. Inside a process
        group every gradient that is not None (the frozen ones dropped
        first) is first replaced by its mean over the rank's data group (the
        world where the mesh has no model axis): the JAX step's gradient
        AllReduce over the mesh, for every trainer. (On a model axis a
        sharded layer's slice is the same slice on every rank of the data
        group, and a replicated parameter's gradient is the same on every
        rank of the model group.)"""
        for p in self.frozen:
            p.grad = None
        if in_group():
            all_reduce_mean_([p.grad for group in self.optimizer.param_groups
                              for p in group["params"] if p.grad is not None], data_group())
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr
        self.optimizer.step()
        self.step += 1
