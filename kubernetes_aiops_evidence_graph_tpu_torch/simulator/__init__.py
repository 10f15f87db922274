from .cluster import FakeCluster
from .scenarios import SCENARIOS, Scenario, inject
from .topology import generate_cluster

__all__ = ["FakeCluster", "SCENARIOS", "Scenario", "inject", "generate_cluster"]
