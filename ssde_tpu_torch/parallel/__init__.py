"""Data parallelism over cards (counterpart of ``ssde_tpu/parallel``'s
data axis): :mod:`.mesh` the devices and the batch's placement, :mod:`.dist`
the processes and their collectives."""

from .dist import (all_reduce_mean_, all_reduce_sum, backend, broadcast_, current_mesh,
                   default_backend, in_group, launch, rank, world_size)
from .mesh import (DATA_AXIS, cpu_devices, describe_mesh, device_prefetch, make_mesh,
                   replicate_, shard_batch, shard_rows, visible_cards)
