"""The data-parallel mesh (counterpart of ``ssde_tpu/parallel/mesh.py``'s
data axis).

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
device computes on the whole batch. The model axis (``make_mesh_2d``,
``model_sharded_params``) is not ported.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .dist import broadcast_, world_size

DATA_AXIS = "data"


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
