"""Column-parallel layers over the model axis (the counterpart of what XLA's
SPMD partitioner makes of a conv whose kernel is output-channel sharded,
``ssde_tpu/parallel/mesh.py:102-111``).

A sharded layer (:func:`ssde_tpu_torch.parallel.mesh.model_sharded_params`)
holds the rows of its weight (and bias) for its rank's contiguous slice of
the output channels. Megatron's column-parallel pattern runs it:

* :func:`copy_to_model` on its input: the identity; its backward sums the
  input gradient over the model group (the rank's conv saw only its slice
  of the output, so its dx is a partial sum);
* the layer's own conv or linear on that input, which computes the slice
  alone;
* :func:`gather_from_model` on the result: every rank of the model group
  gets the whole output, slices in rank order along the channels, so that
  everything downstream is replicated within the group; its backward keeps
  the rank's own slice of the (replicated) output gradient.

The gather is an all-gather of the group's slices
(``torch.distributed.all_gather``, which gloo also runs on CUDA tensors);
the reduction an all-reduce. :data:`STATS` counts both, calls and bytes;
each runs inside a profiler range, ``model_axis:gather`` or
``model_axis:reduction``, from which a ``torch.profiler`` trace reads their
time.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

from .dist import model_group, model_rank, model_world

# per process: calls and bytes of the model axis' collectives, forward
# gathers and backward reductions
STATS: Dict[str, int] = {}


def reset_stats() -> None:
    STATS.update(gathers=0, gather_bytes=0, reductions=0, reduction_bytes=0)


reset_stats()


def _collective(kind: str, t: torch.Tensor, run: Callable[[], None]) -> None:
    STATS[kind + "s"] += 1
    STATS[kind + "_bytes"] += t.numel() * t.element_size()
    with torch.profiler.record_function("model_axis:" + kind):
        run()


def _all_reduce_model(t: torch.Tensor) -> torch.Tensor:
    out = t.contiguous().clone()
    _collective("reduction", out, lambda: dist.all_reduce(out, group=model_group()))
    return out


def all_gather_model(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's ``t`` put together along ``dim``, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(model_world())]
    _collective("gather", t, lambda: dist.all_gather(parts, t, group=model_group()))
    return torch.cat(parts, dim)


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_model(grad)


class _GatherFromModel(torch.autograd.Function):
    """The model group's slices put together along ``dim``, in rank order;
    the backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.width = dim, x.shape[dim]
        return all_gather_model(x, dim)

    @staticmethod
    def backward(ctx, grad):
        start = model_rank() * ctx.width
        return grad.narrow(ctx.dim, start, ctx.width).contiguous(), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the input of a column-parallel layer (see the module)."""
    return _CopyToModel.apply(x)


def gather_from_model(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole output of a column-parallel layer from this rank's slice
    ``x`` (see the module)."""
    return _GatherFromModel.apply(x, dim)


def is_sharded(layer: torch.nn.Module) -> bool:
    """Whether ``layer`` holds a slice of its output channels."""
    return getattr(layer, "model_shard", None) is not None


def column_parallel(x: torch.Tensor, layer: torch.nn.Module,
                    fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``fn(x)``, a conv of ``x`` through ``layer``'s weights, made
    column-parallel where ``layer`` is sharded: copy, ``fn`` on the slice,
    gather along the channels. An unsharded layer runs ``fn(x)`` as it is."""
    if not is_sharded(layer):
        return fn(x)
    return gather_from_model(fn(copy_to_model(x)))
