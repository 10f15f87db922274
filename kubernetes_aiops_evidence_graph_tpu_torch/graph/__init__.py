from .builder import GraphBuilder
from .schema import DIM, EntityKind, F, RelationKind
from .snapshot import GraphSnapshot, build_snapshot, extract_node_features
from .store import EvidenceGraphStore

__all__ = [
    "DIM", "EntityKind", "F", "RelationKind",
    "EvidenceGraphStore", "GraphBuilder",
    "GraphSnapshot", "build_snapshot", "extract_node_features",
]
