"""Distributed training of the port (``paddle_tpu/distributed``): one
process a rank over ``torch.distributed`` (``launch``,
``init_parallel_env``), the collectives (``collective``), rank meshes
and the hybrid topology (``mesh``), tensor-parallel layers
(``parallel_layers``), placements, the canonical Llama layout and ZeRO
(``sharding``, ``fleet``), the training half of the ``MeshExecutor``
(``executor``), activation recomputation (``recompute``), the process
context and local bootstrap (``bootstrap``), sharded state-dict
checkpoints (``checkpoint``), expert-parallel routing (``utils``'s
``global_scatter``/``global_gather``), the MoE layers (``moe``), and
sequence and context parallelism (``sequence_parallel``; the ring and
Ulysses attentions, exported here as the JAX package exports them)."""
from ..kernels.ring_attention import ring_attention
from ..kernels.ulysses_attention import ulysses_attention
from . import (bootstrap, checkpoint, collective, executor, fleet, launch,
               sequence_parallel, sharding)
from .collective import (Group, ParallelMode, ReduceOp, all_gather,
                         all_gather_object, all_reduce, alltoall,
                         alltoall_single, barrier, broadcast,
                         broadcast_object_list, get_group, irecv, isend,
                         new_group, recv, reduce, reduce_scatter, scatter,
                         send, split, wait)
from .env import ParallelEnv, get_rank, get_world_size
from .executor import (MeshExecutor, active_mesh, active_mesh_axes,
                       as_executor, current_executor, default_shardplan_mesh)
from .mesh import (CommunicateTopology, HybridCommunicateGroup, Mesh,
                   ProcessMesh, fleet_mesh, get_hybrid_communicate_group,
                   get_mesh, init_mesh, reset_mesh, sequence_group,
                   set_mesh, use_mesh)
from .parallel import (DataParallel, current_device, destroy_parallel_env,
                       init_parallel_env)
from .parallel_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                              RNGStatesTracker, RowParallelLinear,
                              VocabParallelEmbedding, get_rng_state_tracker,
                              model_parallel_random_seed)
from .recompute import RecomputeWrapper, recompute, recompute_sequential
from .sharding import (PartitionSpec, Placement, SpecLayout,
                       get_sharding_spec, group_sharded_parallel,
                       llama_param_role, llama_param_specs, mark_sharding,
                       reshard, save_group_sharded_model, shard_op,
                       shard_tensor)


def is_initialized() -> bool:
    return get_mesh() is not None


__all__ = [
    "bootstrap", "checkpoint",
    "ColumnParallelLinear", "CommunicateTopology", "DataParallel", "Group",
    "HybridCommunicateGroup", "Mesh", "MeshExecutor", "ParallelCrossEntropy",
    "ParallelEnv", "ParallelMode", "PartitionSpec", "Placement",
    "ProcessMesh", "RNGStatesTracker", "RecomputeWrapper", "ReduceOp",
    "RowParallelLinear", "SpecLayout", "VocabParallelEmbedding",
    "active_mesh", "active_mesh_axes", "all_gather", "all_gather_object",
    "all_reduce", "alltoall", "alltoall_single", "as_executor", "barrier",
    "broadcast", "broadcast_object_list", "collective", "current_device",
    "current_executor", "default_shardplan_mesh", "destroy_parallel_env",
    "executor", "fleet", "fleet_mesh", "get_group",
    "get_hybrid_communicate_group", "get_mesh", "get_rank",
    "get_rng_state_tracker", "get_sharding_spec", "get_world_size",
    "group_sharded_parallel", "init_mesh", "init_parallel_env", "irecv",
    "is_initialized", "isend", "launch", "llama_param_role",
    "llama_param_specs", "mark_sharding", "model_parallel_random_seed",
    "new_group", "recompute", "recompute_sequential", "recv", "reduce",
    "reduce_scatter", "reset_mesh", "reshard", "ring_attention",
    "save_group_sharded_model", "scatter", "send", "sequence_group",
    "sequence_parallel", "set_mesh", "shard_op", "shard_tensor", "sharding",
    "split", "ulysses_attention", "use_mesh", "wait",
]
