"""One process per device of the mesh, and the collectives of a step.

The JAX package runs its data-parallel step as one program over the mesh,
and XLA inserts the collectives (``ssde_tpu/parallel/mesh.py:1-12``). Here
:func:`launch` starts one process per mesh entry
(``torch.multiprocessing.start_processes`` from a fork server, which
imports torch once for every launch of the caller), each with its device
set and a
``torch.distributed`` process group (NCCL on cards, gloo on the CPU; the
rendezvous a ``FileStore`` in a temporary directory, so no network is
needed), and the step's collectives are explicit:

* :func:`all_reduce_mean_`: the gradient AllReduce, the mean over the ranks
  (``train/state.TrainState.apply_gradients``);
* :func:`all_reduce_sum`: a sum over the ranks whose backward is the same
  sum, for BatchNorm's global-batch statistics (``models/resnet.BatchNorm2d``);
* :func:`broadcast_`: rank 0's parameters and buffers to every rank
  (``mesh.replicate_``).

On a (data, model) mesh (``mesh.make_mesh_2d``) rank r sits at
(r // m, r % m), as JAX's ``np.array(devices[:d*m]).reshape(d, m)``
places device r (``ssde_tpu/parallel/mesh.py:116-123``): a model group is
m consecutive ranks, a data group the ranks of one model index. Each
collective takes a ``group``, the world by default; :func:`data_group`
and :func:`model_group` name a rank's two. A mesh with model = 1 has no
groups of its own: its data group is the world, as before there was a
model axis.

Outside a process group every rank function reads world size 1 and rank 0.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import shutil
import tempfile
from collections import defaultdict
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before it raises (a rank
# that died or hangs ends the run with an error after at most this long)
DEFAULT_TIMEOUT_S = 1800.0

# the mesh of the process group this process is a rank of, its (data,
# model) shape and this rank's data and model groups (None: the world); set
# by launch
_MESH: Optional[List[torch.device]] = None
_SHAPE: Optional[Tuple[int, int]] = None
_DATA_GROUP = None
_MODEL_GROUP = None
# what the fork server that starts the ranks imports once, so that a rank
# starts in a fraction of a second instead of importing torch and the
# trainers anew. The server stays one thread and never touches a card (a
# rank forked from it initialises CUDA itself); TensorBoard is left out, as
# its import starts threads where it finds TensorFlow.
PRELOAD = ("torch", "ssde_tpu_torch.train.trainer", "ssde_tpu_torch.train.trainer_gru")


def in_group() -> bool:
    """Whether this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if in_group() else 1


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def current_mesh() -> Optional[List[torch.device]]:
    """The mesh that :func:`launch` started this rank on; None outside it."""
    return _MESH


def mesh_shape() -> Tuple[int, int]:
    """(data, model) of this rank's mesh: (world size, 1) in a group that
    ``launch`` did not give a model axis; (1, 1) outside a process group."""
    if not in_group():
        return (1, 1)
    return _SHAPE or (world_size(), 1)


def data_world() -> int:
    """The data axis' size: the ranks that split the batch."""
    return mesh_shape()[0]


def model_world() -> int:
    """The model axis' size: the ranks that split every sharded layer's
    output channels."""
    return mesh_shape()[1]


def data_rank() -> int:
    """This rank's index on the data axis, r // m: its rows of the batch."""
    return rank() // model_world()


def model_rank() -> int:
    """This rank's index on the model axis, r % m: its slice of the channels."""
    return rank() % model_world()


def data_group():
    """The process group of this rank's data axis (None: the world)."""
    return _DATA_GROUP


def model_group():
    """The process group of this rank's model axis (None: the world)."""
    return _MODEL_GROUP


def _make_groups(shape: Tuple[int, int]) -> None:
    """Every group of the (data, model) mesh ``shape``, made on every rank in
    one order (``dist.new_group`` is collective); this rank keeps its own
    two. A model = 1 mesh makes none: its data group is the world."""
    global _SHAPE, _DATA_GROUP, _MODEL_GROUP
    d, m = shape
    _SHAPE = (d, m)
    if m == 1:
        return
    r = dist.get_rank()
    for i in range(d):  # model groups: m consecutive ranks
        group = dist.new_group(list(range(i * m, (i + 1) * m)))
        if r // m == i:
            _MODEL_GROUP = group
    for j in range(m):  # data groups: the ranks of model index j
        group = dist.new_group(list(range(j, d * m, m)))
        if r % m == j:
            _DATA_GROUP = group


def backend() -> Optional[str]:
    return dist.get_backend() if in_group() else None


def default_backend(mesh: Sequence[torch.device]) -> str:
    """NCCL on cards, gloo on the CPU."""
    return "nccl" if torch.device(mesh[0]).type == "cuda" else "gloo"


def _by_dtype(tensors: Sequence[torch.Tensor]):
    groups = defaultdict(list)
    for t in tensors:
        groups[(t.dtype, t.device)].append(t)
    return groups.values()


def _coalesced_(tensors: Sequence[torch.Tensor], collective: Callable) -> None:
    """Run ``collective`` in place on one flat buffer per dtype and device
    holding ``tensors``, and copy the result back into each."""
    for group in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the ranks of ``group`` (default
    the world): summed in one flat buffer per dtype, then divided by the
    group's size. Every rank ends with the same values. Outside a group
    nothing happens."""
    if not in_group() or not tensors:
        return
    n = dist.get_world_size(group)

    def mean_(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(n)

    _coalesced_(tensors, mean_)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """Give every rank of ``group`` (default the world) the values of
    ``tensors`` on global rank ``src``, in place."""
    if not in_group() or not tensors:
        return
    _coalesced_(tensors, lambda flat: dist.broadcast(flat, src, group=group))


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of a group; its backward sums the output
    gradients over the same ranks, so that each rank's input gradient counts
    every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (default the world),
    differentiable (a new tensor)."""
    return _AllReduceSum.apply(x, group)


class _CallerStdio:
    """The caller's standard output and error, handed to a rank as it
    starts: a rank forked from the fork server would otherwise write to the
    server's, which are the caller's of the first launch."""

    def __reduce__(self):
        from multiprocessing.reduction import DupFd

        return _attach_stdio, (DupFd(1), DupFd(2))


def _attach_stdio(out, err) -> None:
    for fd, handle in ((1, out), (2, err)):
        inherited = handle.detach()
        os.dup2(inherited, fd)
        os.close(inherited)


def _rank_main(rank_: int, fn, mesh, shape, backend_: str, folder: str, timeout_s: float,
               threads: int, args, _stdio=None) -> None:
    """One rank of :func:`launch`: its device, the group and the mesh's
    groups of ``shape``, ``fn``, its result to ``folder``, the groups
    destroyed (``_stdio`` attached the caller's standard output and error as
    it was unpickled)."""
    global _MESH, _SHAPE, _DATA_GROUP, _MODEL_GROUP
    device = mesh[rank_]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(backend_, init_method=f"file://{os.path.join(folder, 'store')}",
                            world_size=len(mesh), rank=rank_,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            device_id=device if backend_ == "nccl" else None)
    _MESH = list(mesh)
    _make_groups(shape)
    out = fn(*args)  # an exception ends this process; the parent ends the others
    torch.save(out, os.path.join(folder, f"rank{rank_}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    _MESH, _SHAPE, _DATA_GROUP, _MODEL_GROUP = None, None, None, None


def launch(fn: Callable, mesh: Sequence[torch.device], *args, backend: Optional[str] = None,
           timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(*args)`` once on every device of ``mesh``, one process a
    device, inside a process group; return each rank's result
    (``fn``'s return value, saved with ``torch.save``), in rank order.
    A mesh with a ``shape`` (``mesh.make_mesh_2d``) is a (data, model)
    mesh, and each rank gets its data and model groups; any other is the
    data axis alone.

    The backend is NCCL on cards and gloo on the CPU unless ``backend``
    names one (gloo also takes CUDA tensors: two ranks may share a card
    over it). ``fn`` and ``args`` must pickle (a module-level function). A
    rank's device is set before ``fn`` runs; CPU ranks share the caller's
    torch threads. A failed start of the group raises and nothing runs on
    fewer devices; a rank that raises ends the run with
    ``torch.multiprocessing.ProcessRaisedException``, and a rank that waits
    on one that died or hangs raises after ``timeout_s``. The port's kernel
    library is built here, before the ranks start, when the mesh has a card.
    """
    shape = tuple(getattr(mesh, "shape", (len(mesh), 1)))
    mesh = [torch.device(d) for d in mesh]
    if not mesh:
        raise ValueError("launch: the mesh is empty")
    if shape[0] * shape[1] != len(mesh):
        raise ValueError(f"launch: a {shape} mesh of {len(mesh)} devices")
    backend = backend or default_backend(mesh)
    if mesh[0].type == "cuda":
        from ..ops.build import load_library

        load_library()  # one nvcc run, not one per rank
    threads = max(1, torch.get_num_threads() // len(mesh))
    folder = tempfile.mkdtemp(prefix="ssde_launch_")
    multiprocessing.set_forkserver_preload(list(PRELOAD))
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, mesh, shape, backend, folder, timeout_s, threads, args,
                              _CallerStdio()),
            nprocs=len(mesh), join=True, start_method="forkserver")
        return [torch.load(os.path.join(folder, f"rank{r}.pt"), weights_only=False)
                for r in range(len(mesh))]
    finally:
        shutil.rmtree(folder, ignore_errors=True)
