"""Multi-device execution: the mesh and the shuffle-exchange tier (port
of ``parallel/__init__.py``).

Partition exchange is a first-class component: Spark-compatible hash
partitioning (``ops/partition.py``, kernel K5 on CUDA) and an
all-to-all over a mesh of devices. The tier is single-controller, as the
JAX package's: one process drives every shard. A mesh's pool may repeat
a device, so one card, or the CPU in the tests
(``devices=[torch.device("cpu")] * n``), carries any number of logical
shards.

Fault tolerance: ``run_collective`` gives every launch a lineage-replay
retry boundary, ``MeshHealth`` heartbeats a mesh with a deadline, and
``MeshRunner`` degrades to the surviving device count and replays
instead of dying (``tolerant.py``, ``planmesh.py``).
"""

from .mesh import (
    MeshHealth,
    make_mesh,
    shard_table,
    replicate_table,
    local_shards,
)
from .tolerant import MeshRunner, run_collective
from .planmesh import (
    MeshUnsupported,
    prepare_exchange,
    run_plan_mesh,
    run_plan_mesh_stream,
)
from .shuffle import (
    ShuffleOverflowError,
    SkewPlan,
    exchange,
    exchange_ragged,
    partition_counts,
    plan_capacity,
    plan_skew,
    shuffle_table,
    shuffle_table_compact,
    total_recv_capacity,
)
from .distributed import (
    GroupOverflowError,
    JoinOverflowError,
    broadcast_inner_join,
    distributed_anti_join,
    distributed_distinct,
    distributed_left_join,
    distributed_semi_join,
    distributed_groupby,
    distributed_inner_join,
    distributed_sort,
)

__all__ = [
    "MeshHealth",
    "MeshRunner",
    "MeshUnsupported",
    "run_collective",
    "run_plan_mesh",
    "run_plan_mesh_stream",
    "prepare_exchange",
    "make_mesh",
    "shard_table",
    "replicate_table",
    "local_shards",
    "exchange",
    "exchange_ragged",
    "partition_counts",
    "plan_capacity",
    "shuffle_table",
    "shuffle_table_compact",
    "total_recv_capacity",
    "plan_skew",
    "SkewPlan",
    "ShuffleOverflowError",
    "GroupOverflowError",
    "JoinOverflowError",
    "broadcast_inner_join",
    "distributed_anti_join",
    "distributed_distinct",
    "distributed_left_join",
    "distributed_semi_join",
    "distributed_groupby",
    "distributed_inner_join",
    "distributed_sort",
]
