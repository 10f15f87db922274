"""Environment-driven configuration.

One flat, env-overridable settings object, built as a frozen dataclass
from ``KAEG_*`` environment variables. It holds only the knobs the port's
modules read; each keeps the JAX package's field name and default, so an
env file written for that package sets the same values here. A later
slice adds the fields its modules read. An env variable that names no
field here is reported and ignored, never silently taken.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, fields
from functools import lru_cache
from typing import Any

from .. import ladders as _ladders


def _parse_buckets(raw: str) -> tuple[int, ...]:
    """Parse a bucket ladder from env: positive ints, sorted ascending."""
    vals = sorted(int(p) for p in raw.split(",") if p.strip())
    if not vals or vals[0] <= 0:
        raise ValueError(f"bucket ladder must be positive ints, got {raw!r}")
    return tuple(vals)


@dataclass(frozen=True)
class Settings:
    # --- app ---
    app_name: str = "kaeg-tpu"
    app_env: str = "development"  # development|staging|uat|production
    log_level: str = "INFO"
    debug: bool = False

    # --- api / ingestion (ingestion/, app.py) ---
    api_host: str = "0.0.0.0"
    api_port: int = 8000
    webhook_rate_limit_per_minute: int = 100
    dedup_ttl_seconds: int = 4 * 3600
    # columnar webhook batches (ingestion/columnar.py) with the hashed
    # dedup ring (ingestion/dedup.FingerprintRing); False = the per-alert
    # dict path
    ingest_columnar: bool = True
    ingest_dedup_window: int = 32768
    # per-tenant token-bucket admission with severity shedding on the
    # columnar path (ingestion/admission.py), and its storm mode
    ingest_admission: bool = True
    admission_rate_per_sec: float = 2000.0
    admission_burst: float = 4000.0
    storm_enter_shed_ratio: float = 0.25
    storm_exit_shed_ratio: float = 0.02
    storm_dwell_s: float = 1.0
    storm_eviction_rate_per_s: float = 500.0
    storm_busy_rate_per_s: float = 50.0
    storm_sample_every: int = 8
    # past this many unsynced store-journal records a busy absorb()
    # drains synchronously instead of yielding (rca/streaming.py)
    ingest_max_journal_backlog: int = 8192
    # circuit breaker around the SQLite persist and its spill journal
    breaker_failure_threshold: int = 5
    breaker_cooldown_s: float = 2.0
    persist_spill_cap: int = 4096

    # --- storage ---
    db_path: str = "kaeg.sqlite"
    graph_persist_path: str = ""

    # --- tracing export (observability/otlp.py) ---
    otlp_endpoint: str = ""
    otel_service_name: str = "kaeg-tpu"

    evidence_time_window_minutes: int = 15
    max_log_lines: int = 1000
    max_metric_points: int = 500

    # --- collector backends ---
    # fake|kubernetes: "kubernetes" is the live K8s API + Prometheus +
    # Loki backend of collectors/live.py (app.main)
    cluster_backend: str = "fake"
    prometheus_url: str = "http://localhost:9090"
    loki_url: str = "http://localhost:3100"

    # --- rca ---
    # cpu|tpu|gnn: "tpu" is the rules scorer (kernels/rules_fold),
    # "gnn" the learned one (kernels/gms and the serving ticks)
    rca_backend: str = "tpu"
    llm_provider: str = "none"                     # none|gemini|openai|ollama
    llm_api_key: str = ""
    llm_model: str = ""
    # workflow verdict fetch of the snapshot path: "top" fetches only the
    # per-incident verdict fields, "full" every matched rule
    workflow_verdict_fields: str = "top"

    # --- remediation / policy ---
    remediation_enabled: bool = True
    remediation_dry_run: bool = True
    remediation_auto_approve_dev: bool = True
    remediation_max_blast_radius: float = 50.0
    verification_wait_seconds: int = 120
    approval_timeout_seconds: int = 4 * 3600
    remediation_max_scale_replicas: int = 10
    remediation_compensation: bool = True
    remediation_compensation_attempts: int = 2
    # fenced workflow leases, the resumer sweep and its budget
    workflow_lease_enabled: bool = True
    workflow_lease_ttl_s: float = 60.0
    workflow_resume_interval_s: float = 30.0
    workflow_max_resumes: int = 5

    # --- integrations ---
    slack_webhook_url: str = ""
    slack_channel: str = "#incidents"
    jira_url: str = ""
    jira_project: str = "OPS"
    jira_user: str = ""
    jira_token: str = ""

    # --- observability (observability/scope.py) ---
    scope_telemetry: bool = True
    scope_flight_records: int = 256
    scope_flight_dir: str = ""
    flight_dump_keep: int = 64

    # --- the crash shield (rca/shield.py) ---
    # when enabled, the workflow worker wraps the resident scorer in a
    # ShieldedScorer: every applied delta batch is write-ahead journaled
    # (O(delta)) and the resident state snapshots every
    # `shield_snapshot_every_ticks` caller boundaries, so a failure
    # recovers via snapshot + journal-suffix replay, bit-identical and
    # cheaper than a full rebuild
    shield_enabled: bool = False
    shield_dir: str = ""                       # "" -> .kaeg_shield/<pid>
    shield_snapshot_every_ticks: int = 512
    # WAL group commit: every batch is written and flushed before it is
    # applied; the fsync may be deferred up to this many batches (1 =
    # strict)
    shield_wal_fsync_every_ticks: int = 8
    # a tick slower than this counts a watchdog trip and drops the
    # pipeline to depth 1 (a launched kernel cannot be cancelled; the
    # watchdog bounds recurrence)
    shield_tick_timeout_s: float = 30.0
    # bounded retry for transient faults: exponential backoff with
    # deterministic seeded jitter (workflow/engine.RetryPolicy semantics)
    shield_retry_attempts: int = 2
    shield_retry_backoff_s: float = 0.05
    # shard-loss survival (rca/heal.py) on a graph-sharded mesh: a
    # shard-localized fault feeds a per-position CircuitBreaker;
    # mesh_shard_failure_threshold CONSECUTIVE failures on one position
    # classify it persistently failed, and the shield's mesh_heal rung
    # (between journal replay and full rebuild) re-places the resident
    # state onto a survivor mesh at the largest viable D' < D. After
    # mesh_heal_cooldown_s the position's breaker admits its half-open
    # probe and the mesh re-expands D' -> D. Both directions are
    # write-ahead journaled (a crash mid-heal recovers to a consistent
    # shard count)
    mesh_heal_enabled: bool = True
    mesh_shard_failure_threshold: int = 3
    mesh_heal_cooldown_s: float = 5.0
    # attestation at snapshot boundaries: a checksum fold of the resident
    # node tables on the device against the host mirrors, per shard
    # block; a silently corrupted block is repaired in place from the
    # host truth
    mesh_attest: bool = True

    # --- serving meshes (parallel/): the rules scorer serves on a
    # graph-sharded and/or data-parallel mesh, the learned scorer on the
    # graph axis, with or without the shield and the elastic controller;
    # the positions may repeat one card or span several ---
    serve_graph_shards: int = 1
    mesh_dp: int = 1

    # --- serving (rca/streaming.py) ---
    # max ticks in flight (dispatched but unfetched). Depth 1 = a
    # serialized dispatch→fetch loop; depth 2 (default) overlaps host
    # delta-packing of tick t+1 with device execution of tick t. When the
    # queue is full, pending deltas coalesce into one larger tick
    # (bounded by the top of the DELTA_BUCKETS ladder). Results are
    # bit-identical at every depth.
    serve_pipeline_depth: int = 2

    # --- multi-tenant fleet (rca/surge.py SurgeServer) and the elastic
    # controller (rca/elastic.py) ---
    # the ElasticController reads pipeline occupancy / stall seconds, the
    # admission shed-ratio EWMA and the roofline drift of one pack, and
    # gates D -> D' scale decisions behind hysteresis + dwell; a step
    # re-shards through the shield's scale_mesh over the shield's pool of
    # positions
    elastic_enabled: bool = False
    # both directions must hold for dwell_s before a scale fires
    elastic_dwell_s: float = 10.0
    # scale UP when occupancy (inflight/depth) or shed EWMA exceeds these,
    # or the roofline drift exceeds this fraction; DOWN when all fall low
    elastic_up_occupancy: float = 0.75
    elastic_down_occupancy: float = 0.25
    elastic_up_shed: float = 0.05
    elastic_down_shed: float = 0.005
    elastic_up_roofline: float = 0.85
    elastic_down_roofline: float = 0.30
    # cooldown between consecutive scale events (seconds)
    elastic_cooldown_s: float = 30.0
    # fleet bin-packing: max tenants per MultiTenantScorer pack and max
    # packs (1 = every tenant on pack 0)
    swell_pack_tenants: int = 4
    swell_max_packs: int = 1
    # per-tenant admitted-rows/s load estimate smoothing
    swell_load_alpha: float = 0.2
    # fleet-WAL path for placement/migration records; empty = in memory
    swell_journal_path: str = ""

    # --- learned RCA (rca/gnn_backend.py, rca/gnn_streaming.py) ---
    # a .npz checkpoint (flat keys, see rca/gnn.flat_params); "" = the one
    # shipped in the package (checkpoints/gnn.npz)
    gnn_checkpoint: str = ""
    # "" = float32 message passing; "bfloat16" casts the matmul operands
    # (accumulation stays float32)
    gnn_compute_dtype: str = ""
    # the fused serving tick (kernels/fused_tick.fused_gnn_tick): delta
    # scatter, message pass and verdict in one chain of hand kernels.
    # Needs a non-empty EDGE_TILE-aligned relation layout and a compute
    # dtype of "" or "bfloat16"; the composed tick serves otherwise
    gnn_fused_tick: bool = False
    # the streamed tick (kernels/fused_tick.fused_gnn_tick_dma): the
    # fused tick over two persistent activation buffers, node_block rows
    # per block, with the f32/bf16/int8 feature tiers. Takes precedence
    # over gnn_fused_tick when its layout check passes
    gnn_tick_dma: bool = False
    # node rows per block in the streamed tick's embed and update (clamped
    # to the node bucket, which it must divide)
    gnn_dma_node_block: int = _ladders.DMA_NODE_BLOCK
    # quantized node-feature table of the streamed tick: "" = float32,
    # "bfloat16", or "int8" with a per-column absmax scale
    # (ops/fused_tick.quantize_features). Only read when gnn_tick_dma is on
    gnn_feature_quant: str = ""

    # --- online learning (learn/) ---
    # harvest production labels, fine-tune a candidate from the serving
    # params, gate it on a holdout, hot-swap it into the resident scorers
    learn_enabled: bool = False
    learn_interval_s: float = 30.0       # background loop cadence
    learn_steps: int = 120               # fine-tune steps per cycle
    learn_lr: float = 1e-3
    # proximal anchor: the fine-tune loss carries 0.5*w*||theta - serving||^2
    learn_anchor_weight: float = 1e-3
    learn_min_episodes: int = 2          # buffer floor before training
    learn_buffer_cap: int = 64           # dedup'd replay buffer episodes
    # simulator episodes mixed into every fine-tune, and the simulator
    # holdout suite the gate evaluates against
    learn_sim_episodes: int = 4
    learn_sim_holdout: int = 2
    learn_sim_pods: int = 96
    learn_sim_incidents: int = 6
    # every Nth harvested production episode joins the gate's holdout
    learn_holdout_every: int = 4
    # rules-tier top-1 at >= learn_weak_confidence labels incidents that
    # got no operator feedback and no verification outcome
    learn_weak_labels: bool = True
    learn_weak_confidence: float = 0.9
    # > 1 (a data-parallel fine-tune) is not ported yet and raises
    learn_mesh_shards: int = 1
    # hold one loss + grads through the params' device (the kernels, on the
    # card) against a CPU copy through the plain versions before the
    # fine-tune; a mismatch raises (learn/trainer.check_grads_parity)
    learn_pallas_grads: bool = False

    # --- snapshot padding ladders (graph/snapshot.py; rungs in ladders.py)
    node_bucket_sizes: tuple = _ladders.NODE_BUCKET_SIZES
    incident_bucket_sizes: tuple = _ladders.INCIDENT_BUCKET_SIZES

    @property
    def environment(self) -> str:
        """Normalized short environment name (dev|staging|uat|prod)."""
        e = self.app_env.lower()
        return {"development": "dev", "production": "prod"}.get(e, e)


_ENV_PREFIX = "KAEG_"


_PROCESS_GROUP_ENV = frozenset({
    "KAEG_COORDINATOR", "KAEG_NUM_PROCESSES", "KAEG_PROCESS_ID",
    "KAEG_AUTO_DISTRIBUTED"})
"""Variables ``parallel/multihost.init_distributed`` reads: not settings,
and not warned about."""


def load_settings(**overrides: Any) -> Settings:
    """Build Settings from KAEG_* env vars, then apply explicit overrides
    (an override that names no field raises TypeError)."""
    kwargs: dict[str, Any] = {}
    known = set()
    for f in fields(Settings):
        env_name = _ENV_PREFIX + f.name.upper()
        known.add(env_name)
        if env_name not in os.environ:
            continue
        raw = os.environ[env_name]
        if isinstance(f.default, bool):
            kwargs[f.name] = raw.strip().lower() in ("1", "true", "yes", "on")
        elif isinstance(f.default, int):
            kwargs[f.name] = int(raw)
        elif isinstance(f.default, float):
            kwargs[f.name] = float(raw)
        elif isinstance(f.default, tuple):
            kwargs[f.name] = _parse_buckets(raw)
        else:
            kwargs[f.name] = raw
    ignored = sorted(k for k in os.environ
                     if k.startswith(_ENV_PREFIX) and k not in known
                     and k not in _PROCESS_GROUP_ENV)
    if ignored:
        warnings.warn(f"{', '.join(ignored)}: no such setting in this "
                      "package; ignored", stacklevel=2)
    kwargs.update(overrides)
    return Settings(**kwargs)


@lru_cache(maxsize=1)
def get_settings() -> Settings:
    """Process-wide lazy singleton."""
    return load_settings()
