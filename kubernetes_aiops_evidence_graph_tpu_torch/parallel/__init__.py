"""Multi-device serving and training: the mesh, placements, the
host-driven per-position runner with its collectives, sharded snapshot
scoring, the mesh-resident rules and learned ticks, the graph
partitioner and the sharded GNN train step. ``multihost.py`` is ROADMAP
item 9c."""
from .mesh import (
    Mesh, MeshUnavailable, dp_sharded, ensure_host_devices, graph_sharded,
    make_mesh, replicated, serving_mesh,
)
from .partition import PartitionedGraph, partition_snapshot
from .sharded_gnn import device_put_partitioned, make_sharded_train_step
from .sharded_rules import (
    ShardedBatch, device_put_graph_sharded, device_put_sharded_batch,
    make_graph_sharded_score, make_sharded_score, shard_batch,
)

__all__ = [
    "Mesh", "MeshUnavailable", "make_mesh", "serving_mesh",
    "ensure_host_devices", "replicated", "dp_sharded", "graph_sharded",
    "ShardedBatch", "shard_batch", "make_sharded_score",
    "device_put_sharded_batch", "make_graph_sharded_score",
    "device_put_graph_sharded", "PartitionedGraph", "partition_snapshot",
    "make_sharded_train_step", "device_put_partitioned",
]
