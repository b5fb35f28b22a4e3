"""Parallelism over devices (counterpart of ``ssde_tpu/parallel``): the
data axis and the model axis of the mesh. :mod:`.mesh` the devices, the
batch's placement and the parameters' sharding, :mod:`.dist` the processes
and their collectives, :mod:`.tensor` the column-parallel layers."""

from .dist import (all_reduce_mean_, all_reduce_sum, backend, broadcast_, current_mesh,
                   data_group, data_rank, data_world, default_backend, in_group, launch,
                   mesh_shape, model_group, model_rank, model_world, rank, world_size)
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh2D, cpu_devices, describe_mesh, device_prefetch,
                   make_mesh, make_mesh_2d, model_sharded_params, replicate_, shard_batch,
                   shard_rows, unshard_params, visible_cards)
from .tensor import copy_to_model, gather_from_model
