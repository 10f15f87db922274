"""Multi-device serving for the rules path: the mesh, placements, the
host-driven per-position runner with its collectives, sharded snapshot
scoring and the mesh-resident rules tick. The learned scorer's mesh
(``partition.py``, ``sharded_gnn.py``, ``sharded_gnn_tick``) and
``multihost.py`` are ROADMAP items 9b and 9c."""
from .mesh import (
    Mesh, MeshUnavailable, dp_sharded, ensure_host_devices, graph_sharded,
    make_mesh, replicated, serving_mesh,
)
from .sharded_rules import (
    ShardedBatch, device_put_graph_sharded, device_put_sharded_batch,
    make_graph_sharded_score, make_sharded_score, shard_batch,
)

__all__ = [
    "Mesh", "MeshUnavailable", "make_mesh", "serving_mesh",
    "ensure_host_devices", "replicated", "dp_sharded", "graph_sharded",
    "ShardedBatch", "shard_batch", "make_sharded_score",
    "device_put_sharded_batch", "make_graph_sharded_score",
    "device_put_graph_sharded",
]
