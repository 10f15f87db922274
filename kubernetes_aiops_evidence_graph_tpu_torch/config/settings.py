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
    # --- evidence collection (collectors/) ---
    evidence_time_window_minutes: int = 15
    max_log_lines: int = 1000
    max_metric_points: int = 500

    # --- serving (rca/streaming.py) ---
    # max ticks in flight (dispatched but unfetched). Depth 1 = a
    # serialized dispatch→fetch loop; depth 2 (default) overlaps host
    # delta-packing of tick t+1 with device execution of tick t. When the
    # queue is full, pending deltas coalesce into one larger tick
    # (bounded by the top of the DELTA_BUCKETS ladder). Results are
    # bit-identical at every depth.
    serve_pipeline_depth: int = 2

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

    # --- snapshot padding ladders (graph/snapshot.py; rungs in ladders.py)
    node_bucket_sizes: tuple = _ladders.NODE_BUCKET_SIZES
    incident_bucket_sizes: tuple = _ladders.INCIDENT_BUCKET_SIZES


_ENV_PREFIX = "KAEG_"


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
        elif isinstance(f.default, tuple):
            kwargs[f.name] = _parse_buckets(raw)
        else:
            kwargs[f.name] = raw
    ignored = sorted(k for k in os.environ
                     if k.startswith(_ENV_PREFIX) and k not in known)
    if ignored:
        warnings.warn(f"{', '.join(ignored)}: no such setting in this "
                      "package; ignored", stacklevel=2)
    kwargs.update(overrides)
    return Settings(**kwargs)


@lru_cache(maxsize=1)
def get_settings() -> Settings:
    """Process-wide lazy singleton."""
    return load_settings()
