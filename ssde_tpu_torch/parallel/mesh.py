"""The device mesh (counterpart of ``ssde_tpu/parallel/mesh.py``): its
data axis and its model axis.

The JAX package builds one ``Mesh`` over the chips, shards the batch axis,
replicates parameters and Adam state, and lets XLA insert the gradient
AllReduce; BatchNorm's statistics are over the global batch (sync-BN) and
the loss is the global batch's mean. The port keeps those semantics with
one process per device (:func:`ssde_tpu_torch.parallel.dist.launch`):

* :func:`make_mesh` is the ordered list of devices, by the JAX rule;
* :func:`shard_batch` is what ``NamedSharding(mesh, P("data"))`` places on
  one device: its contiguous rows of the host batch;
* :func:`replicate_` broadcasts rank 0's parameters and buffers, as the
  replicated placement (``replicated``, ``host_to_device``) gives every
  device the same tree;
* :func:`device_prefetch` is the host-to-device handoff of the training
  loop.

So one step over a global batch of B split over n devices computes what one
device computes on the whole batch.

The model axis (``mesh.py:102-142``) is tensor parallelism over ranks:

* :func:`make_mesh_2d` is the (data, model) mesh by the JAX rule, its
  devices in rank order and its ``shape`` beside them, for ``launch``;
* :func:`model_sharded_params` keeps, on each rank, its slice of every
  conv's and linear's output channels (the JAX spec ``P(None, ..., "model")``
  on flax's trailing output axis); such a layer then computes its slice
  alone and all-gathers it (:mod:`.tensor`), so that one step on the mesh
  computes what one device computes unsharded, and gradients and Adam
  moments exist for the slices only;
* :func:`unshard_params` gathers the slices back into whole layers.

On a 2-D mesh a rank's rows of the batch are ``shard_batch(batch,
data_rank(), data_world())``; BatchNorm's statistics and the gradient mean
run over its data group.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .dist import broadcast_, mesh_shape, model_rank, world_size
from .tensor import all_gather_model, copy_to_model, gather_from_model, is_sharded

DATA_AXIS = "data"
MODEL_AXIS = "model"
# what model_sharded_params does not cover yet, and where that work is listed
NOT_COVERED = ("the model axis does not cover it yet (ROADMAP.md Queue 1 item 12c: the "
               "attention units, the 3-frame fusion models, the DPT, PoseCNN and the "
               "attention encoder)")


def visible_cards() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def cpu_devices(num_devices: int = 0) -> List[torch.device]:
    """The CPU "devices" of ``--no_cuda``: ``num_devices`` CPU ranks (0:
    one), as the JAX tests pin n virtual CPU devices."""
    return [torch.device("cpu")] * max(1, num_devices)


def make_mesh(num_devices: int = 0, devices: Optional[Sequence] = None,
              batch_size: Optional[int] = None) -> List[torch.device]:
    """The mesh's devices in rank order (``ssde_tpu/parallel/mesh.py:26-42``):
    ``devices`` (default every visible card), the first ``num_devices`` of
    them unless that is 0, then clamped to the largest count that divides
    ``batch_size`` (a batch of 2 on 8 devices uses 2)."""
    devices = visible_cards() if devices is None else [torch.device(d) for d in devices]
    if not devices:
        raise RuntimeError("make_mesh: no device (no CUDA card is visible)")
    if num_devices:
        devices = devices[:num_devices]
    if batch_size is not None:
        n = len(devices)
        while n > 1 and batch_size % n:
            n -= 1
        devices = devices[:n]
    return devices


class Mesh2D(list):
    """The devices of a (data, model) mesh in rank order, and its ``shape``:
    rank r sits at :meth:`position` (r // model, r % model)."""

    def __init__(self, devices: Sequence[torch.device], shape: Tuple[int, int]):
        super().__init__(devices)
        self.shape = tuple(shape)

    def position(self, rank: int) -> Tuple[int, int]:
        return divmod(rank, self.shape[1])


def make_mesh_2d(data: int = 0, model: int = 1, devices: Optional[Sequence] = None) -> Mesh2D:
    """The (data, model) mesh (``ssde_tpu/parallel/mesh.py:116-123``):
    ``devices`` (default every visible card), ``data`` 0 taking
    ``len(devices) // model``, the first ``data * model`` of them in rank
    order. Two ranks may name one card: they share it (over gloo)."""
    devices = visible_cards() if devices is None else [torch.device(d) for d in devices]
    if model < 1:
        raise ValueError(f"make_mesh_2d: model={model}")
    if not data:
        data = len(devices) // model
    if data < 1 or data * model > len(devices):
        raise ValueError(f"make_mesh_2d: a ({data}, {model}) mesh needs {data * model} "
                         f"devices, {len(devices)} given")
    return Mesh2D(devices[:data * model], (data, model))


def describe_mesh(mesh: Sequence[torch.device], backend: Optional[str]) -> str:
    """``data=n [devices] over <backend>``: the trainer's mesh line."""
    return (f"{DATA_AXIS}={len(mesh)} [{', '.join(str(d) for d in mesh)}] "
            f"over {backend or 'no process group (one process)'}")


def shard_rows(n: int, rank: int, world: int) -> slice:
    """The rows of a batch of ``n`` that rank ``rank`` of ``world`` holds:
    the contiguous ``n / world`` rows from ``rank * n / world``. ``n`` must
    divide evenly, as a sharded batch axis must."""
    if n % world:
        raise ValueError(f"a batch of {n} does not split over {world} devices")
    k = n // world
    return slice(rank * k, (rank + 1) * k)


def shard_batch(batch: Dict[str, np.ndarray], rank: int, world: int) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s rows of every array of a host batch (leading axis B)."""
    return {k: v[shard_rows(len(v), rank, world)] for k, v in batch.items()}


def replicate_(modules: Iterable[torch.nn.Module]) -> None:
    """Every rank takes rank 0's parameters and buffers, in place (as
    ``DistributedDataParallel`` does at its start). Outside a process group
    nothing happens."""
    if world_size() == 1:
        return
    tensors, seen = [], set()
    for m in modules:
        for t in m.state_dict(keep_vars=True).values():
            if id(t) not in seen:
                seen.add(id(t))
                tensors.append(t.data)
    broadcast_(tensors)


def device_prefetch(iterator: Iterable[dict], device, size: int = 2,
                    explicit: Optional[bool] = None) -> Iterator[dict]:
    """The training loop's host-to-device handoff
    (``ssde_tpu/parallel/mesh.py:65-99``). At world size 1 the host batches
    pass through (the step's own copy from pinned memory is the measured
    path there); with more ranks, or ``explicit``, it double-buffers: batch
    N+1 is copied to ``device`` from pinned memory, without blocking, before
    batch N is yielded to its step. Batches keep their order."""
    from ..data.pipeline import to_device

    if explicit is None:
        explicit = world_size() > 1
    if not explicit:
        yield from iterator
        return
    buf = deque()
    for batch in iterator:
        buf.append(to_device(batch, device))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


# ------------------------------------------------------------- model axis
def _covered_types():
    """The module types whose layers the model axis runs column-parallel:
    the mono step's networks at the Options defaults (ResNet encoders,
    DepthDecoder, PoseDecoder) and the recurrent blocks without an attention
    unit, with the Head."""
    from ..models import common, depth_decoder, fusion, pose, recurrent, resnet

    return {torch.nn.Conv2d, torch.nn.Linear, torch.nn.Sequential, torch.nn.ModuleList,
            torch.nn.MaxPool2d, resnet.BatchNorm2d, resnet.ResnetEncoder, resnet._ResNet,
            resnet.BasicBlock, resnet.Bottleneck, depth_decoder.DepthDecoder,
            common.Conv3x3, common.ConvBlock, common.ResidualConvUnit, pose.PoseDecoder,
            recurrent.ConvGRUBlocks, recurrent.RecurrentUnit, recurrent.ConvGRUCell,
            recurrent.ConvLSTMCell, recurrent.Head, fusion.GRUFusionBlock,
            fusion.GRUFusionBlock_v2, fusion.UpscalePS}


def _layers(modules: Sequence[torch.nn.Module]) -> List[torch.nn.Module]:
    """Every conv and linear of ``modules``, once each, in module order."""
    out, seen = [], set()
    for top in modules:
        for mod in top.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)) and id(mod) not in seen:
                seen.add(id(mod))
                out.append(mod)
    return out


def _kept_whole(modules: Sequence[torch.nn.Module], m: int) -> set:
    """The ids of the convs the JAX rule would shard and the port keeps
    whole: a GRU cell's ``conv_gates`` (2·hid) where its ``conv_can`` (hid)
    does not divide by m (v1's width 1). The cell's x conv computes both,
    so the two shard together or not at all."""
    from ..models.recurrent import ConvGRUCell

    return {id(c.conv_gates) for top in modules for c in top.modules()
            if isinstance(c, ConvGRUCell) and c.hidden_dim % m}


def _copy_hook(mod, args):
    return (copy_to_model(args[0]),) + tuple(args[1:])


def _gather_hook(mod, args, out):
    return gather_from_model(out, 1 if isinstance(mod, torch.nn.Conv2d) else -1)


def model_sharded_params(modules: Iterable[torch.nn.Module],
                         mesh: Sequence[torch.device]) -> List[torch.nn.Module]:
    """Shard ``modules`` over ``mesh``'s model axis, in place
    (``ssde_tpu/parallel/mesh.py:126-142``); returns the sharded layers.

    Every ``nn.Conv2d`` and ``nn.Linear`` whose output channels divide by
    the axis' size m keeps this rank's contiguous slice of its weight's
    output rows and of its bias, and from then on computes that slice alone
    and all-gathers it (called as a module: through hooks; through
    ``models.common.conv`` and the recurrent cells: by those). Every other
    parameter and buffer stays whole: BatchNorm's, the 1-channel heads',
    and two that the JAX rule shards where their trailing axis divides
    (placement does not change the numbers): the recurrent units' learned
    initial states, and a GRU cell's ``conv_gates`` whose ``conv_can`` does
    not divide (v1's width-1 cells stay whole). The weights must already be
    the same on every rank (one seed, or ``replicate_`` first). Build the
    optimizer's state after this, or before any step: gradients and Adam
    moments then exist for the slices.

    Raises ``NotImplementedError`` for a module the model axis does not
    cover yet (:data:`NOT_COVERED`), before it changes anything, and
    ``RuntimeError`` outside a rank of ``mesh`` (``launch``). A mesh with
    model = 1 shards nothing."""
    modules = list(modules)
    covered = _covered_types()
    for top in modules:
        for name, mod in top.named_modules():
            if type(mod) not in covered:
                raise NotImplementedError(
                    f"model_sharded_params: {type(mod).__name__} "
                    f"({type(top).__name__}{'.' + name if name else ''}): {NOT_COVERED}")
    shape = tuple(getattr(mesh, "shape", (len(mesh), 1)))
    if shape != mesh_shape():
        raise RuntimeError(f"model_sharded_params: this process is not a rank of a {shape} "
                           f"mesh (it is of {mesh_shape()}); run it in parallel.launch")
    m, r = shape[1], model_rank()
    if m == 1:
        return []
    sharded, whole = [], _kept_whole(modules, m)
    for layer in _layers(modules):
        out = layer.weight.shape[0]
        if is_sharded(layer) or out % m or id(layer) in whole:
            continue
        rows = slice(r * out // m, (r + 1) * out // m)
        for p in (layer.weight, layer.bias):
            if p is not None:
                p.data = p.data[rows].clone()
        layer.model_shard = (r, m, out)
        layer.model_shard_hooks = (layer.register_forward_pre_hook(_copy_hook),
                                   layer.register_forward_hook(_gather_hook))
        sharded.append(layer)
    return sharded


def unshard_params(modules: Iterable[torch.nn.Module], optimizer=None) -> None:
    """The inverse of :func:`model_sharded_params`, in place: every sharded
    layer's weight and bias (their gradients, and with ``optimizer`` their
    Adam moments) all-gathered over the model group into the whole tensors,
    and the layer computing all of its output again. Every rank of the
    model group calls it (a collective)."""
    for layer in filter(is_sharded, _layers(list(modules))):
        for p in (layer.weight, layer.bias):
            if p is None:
                continue
            grad = None if p.grad is None else all_gather_model(p.grad, 0)
            state = optimizer.state.get(p, {}) if optimizer is not None else {}
            for k in ("exp_avg", "exp_avg_sq"):
                if k in state:
                    state[k] = all_gather_model(state[k], 0)
            p.grad = None
            p.data = all_gather_model(p.data, 0)
            p.grad = grad
        for hook in layer.model_shard_hooks:
            hook.remove()
        layer.model_shard = layer.model_shard_hooks = None
