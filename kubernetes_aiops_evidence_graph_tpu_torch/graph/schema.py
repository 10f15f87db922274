"""Evidence-graph schema: entity kinds, relation kinds, node-feature layout.

Entity labels and relation types mirror the reference's Neo4j schema
(neo4j.py:299-320 uniqueness constraints; kubernetes_collector.py:296-313 and
neo4j.py:204-265 relation usage). The node-feature layout is new: it is the
tensorized form of the reference rules engine's signal dict
(rules_engine.py:274-290) so that per-incident signals can be computed on
TPU as one batched reduction over the graph instead of a Python fold over
evidence dicts.

Every feature has a reduction mode describing how per-node values fold into
a per-incident signal across the K-hop neighborhood:

* ``or``  — flag; incident signal = any reachable node has it (count > 0)
* ``sum`` — additive count (e.g. error_count, rules_engine.py:335)
* ``max`` — maximum over reachable nodes (e.g. restart_count,
  rules_engine.py:319)

``or`` and ``sum`` are both computed by one reach@features matmul on the
MXU; ``max`` features get a segment-max pass.
"""
from __future__ import annotations

from enum import IntEnum


class EntityKind(IntEnum):
    INCIDENT = 0
    POD = 1
    DEPLOYMENT = 2
    REPLICASET = 3
    NODE = 4
    SERVICE = 5
    HPA = 6
    CONFIGMAP = 7
    CHANGE_EVENT = 8
    NAMESPACE = 9
    CONTAINER = 10

    @classmethod
    def from_label(cls, label: str) -> "EntityKind":
        return _LABEL_TO_KIND.get(label, cls.CONTAINER)


_LABEL_TO_KIND = {
    "Incident": EntityKind.INCIDENT,
    "Pod": EntityKind.POD,
    "Deployment": EntityKind.DEPLOYMENT,
    "ReplicaSet": EntityKind.REPLICASET,
    "Node": EntityKind.NODE,
    "Service": EntityKind.SERVICE,
    "HPA": EntityKind.HPA,
    "ConfigMap": EntityKind.CONFIGMAP,
    "ChangeEvent": EntityKind.CHANGE_EVENT,
    "Namespace": EntityKind.NAMESPACE,
    "Container": EntityKind.CONTAINER,
}

KIND_TO_LABEL = {v: k for k, v in _LABEL_TO_KIND.items()}


class RelationKind(IntEnum):
    AFFECTS = 0            # Incident -> Pod/Deployment/... (kubernetes_collector.py:306)
    SCHEDULED_ON = 1       # Pod -> Node (kubernetes_collector.py:300)
    OWNS = 2               # Deployment -> ReplicaSet -> Pod (neo4j.py:237)
    SELECTS = 3            # Service -> Pod
    CALLS = 4              # Service -> Service (neo4j.py:254-278)
    HAS_RECENT_CHANGE = 5  # Deployment -> ChangeEvent (deploy_diff_collector.py:233-268)
    CORRELATES_WITH = 6    # Incident -> ChangeEvent
    IN_NAMESPACE = 7       # any -> Namespace (new)
    MOUNTS = 8             # Pod -> ConfigMap (new)

    @classmethod
    def from_label(cls, label: str) -> "RelationKind":
        return _REL_TO_KIND[label]


_REL_TO_KIND = {
    "AFFECTS": RelationKind.AFFECTS,
    "SCHEDULED_ON": RelationKind.SCHEDULED_ON,
    "OWNS": RelationKind.OWNS,
    "SELECTS": RelationKind.SELECTS,
    "CALLS": RelationKind.CALLS,
    "HAS_RECENT_CHANGE": RelationKind.HAS_RECENT_CHANGE,
    "CORRELATES_WITH": RelationKind.CORRELATES_WITH,
    "IN_NAMESPACE": RelationKind.IN_NAMESPACE,
    "MOUNTS": RelationKind.MOUNTS,
}

REL_TO_LABEL = {v: k for k, v in _REL_TO_KIND.items()}


# ---------------------------------------------------------------------------
# Node feature layout
# ---------------------------------------------------------------------------

class F(IntEnum):
    """Feature indices into the dense node-feature matrix [N, DIM].

    Groups mirror the reference signal dict keys (rules_engine.py:274-290):
    waiting_reasons / terminated_reasons sets become one-hot flags; the
    booleans become flags; counters keep their reference reduction.
    """
    # container waiting reasons (kubernetes_collector.py:269-285)
    W_CRASHLOOPBACKOFF = 0
    W_IMAGEPULLBACKOFF = 1
    W_ERRIMAGEPULL = 2
    W_IMAGEINSPECTERROR = 3
    # container terminated reasons
    T_OOMKILLED = 4
    T_CONTAINERCANNOTRUN = 5
    T_CREATECONTAINERCONFIGERROR = 6
    T_ERROR = 7
    # pod state
    RESTART_COUNT = 8          # reduce: max (rules_engine.py:319)
    POD_NOT_READY = 9          # not-ready >= 300s (rule readiness_probe_failing)
    READINESS_PROBE_FAILING = 10
    # logs (logs_collector.py:20-31 pattern categories + rule vocab)
    ERROR_COUNT = 11           # reduce: sum (rules_engine.py:335)
    LOG_ERROR = 12
    LOG_CRITICAL = 13
    LOG_OOM = 14
    LOG_NETWORK = 15
    LOG_AUTH = 16
    LOG_MISSING = 17
    LOG_NULL_POINTER = 18
    LOG_CONNECTION = 19
    LOG_DISK = 20
    LOG_TLS = 21
    LOG_TIMEOUT = 22
    # changes (deploy_diff_collector.py)
    HAS_RECENT_DEPLOY = 23
    HAS_IMAGE_CHANGE = 24
    HAS_CONFIG_CHANGE = 25
    CHANGE_RECENCY = 26        # reduce: max; 1 - age/30min clamped to [0,1]
    # metrics (metrics_collector.py:247-329 thresholds)
    MEMORY_USAGE_HIGH = 27
    CPU_THROTTLING = 28
    HPA_AT_MAX = 29
    LATENCY_HIGH = 30
    # node conditions (kubernetes_collector.py:504-557)
    NODE_NOT_READY = 31
    NODE_DISK_PRESSURE = 32
    NODE_MEMORY_PRESSURE = 33
    NODE_PID_PRESSURE = 34
    NODE_NETWORK_UNAVAILABLE = 35
    # misc
    NETWORK_ERROR_COUNT = 36   # reduce: sum
    SIGNAL_STRENGTH = 37       # reduce: max
    IS_ANOMALY = 38
    DEPLOY_UNAVAILABLE = 39
    POD_PROBLEM = 40           # derived: any waiting/terminated reason,
                               # restarts > PROBLEM_POD_RESTARTS, or not ready


DIM = 48  # padded past max(F)+1 so new features don't change compiled shapes

# Reduction masks (index lists) — everything not listed is "or"/"sum"-safe
# through the matmul; MAX_FEATURES additionally get a segment-max pass.
MAX_FEATURES = (int(F.RESTART_COUNT), int(F.CHANGE_RECENCY), int(F.SIGNAL_STRENGTH))
SUM_FEATURES = (int(F.ERROR_COUNT), int(F.NETWORK_ERROR_COUNT))

WAITING_REASON_FEATURES = {
    "CrashLoopBackOff": F.W_CRASHLOOPBACKOFF,
    "ImagePullBackOff": F.W_IMAGEPULLBACKOFF,
    "ErrImagePull": F.W_ERRIMAGEPULL,
    "ImageInspectError": F.W_IMAGEINSPECTERROR,
}

TERMINATED_REASON_FEATURES = {
    "OOMKilled": F.T_OOMKILLED,
    "ContainerCannotRun": F.T_CONTAINERCANNOTRUN,
    "CreateContainerConfigError": F.T_CREATECONTAINERCONFIGERROR,
    "Error": F.T_ERROR,
}

LOG_PATTERN_FEATURES = {
    "error": F.LOG_ERROR,
    "critical": F.LOG_CRITICAL,
    "oom": F.LOG_OOM,
    "network": F.LOG_NETWORK,
    "auth": F.LOG_AUTH,
    "missing": F.LOG_MISSING,
    "null_pointer": F.LOG_NULL_POINTER,
    "connection": F.LOG_CONNECTION,
    "disk": F.LOG_DISK,
    "tls": F.LOG_TLS,
    "timeout": F.LOG_TIMEOUT,
}

NODE_CONDITION_FEATURES = {
    "NotReady": F.NODE_NOT_READY,
    "DiskPressure": F.NODE_DISK_PRESSURE,
    "MemoryPressure": F.NODE_MEMORY_PRESSURE,
    "PIDPressure": F.NODE_PID_PRESSURE,
    "NetworkUnavailable": F.NODE_NETWORK_UNAVAILABLE,
}
