"""Time-series metric statistics for evidence payloads.

The reference collects full Prometheus ``query_range`` series, downsamples
to ≤500 points, and keeps last-50 values + min/max/avg/current per query
(metrics_collector.py:161-245) — but then thresholds only the LAST sample
(:247-329), so a spike that receded or a trend racing toward a limit is
invisible to the rules. Here every query family names the windowed
statistic its threshold applies to (``EVAL_STAT``), so trend/spike
evidence ("memory rising toward limit", "sustained error rate") can flip a
rule an instant value misses. Both signal folds — the CPU oracle
(rca/signals.py) and the graph-feature path (graph/builder.py) — read the
eval value through :func:`metric_eval`, keeping backend parity exact.
"""
from __future__ import annotations

Sample = tuple[float, float]          # (epoch seconds, value)

#: which windowed statistic each query family's threshold applies to.
#: ``max``  — spikes count even if they receded (restarts, OOM, HPA-at-max)
#: ``avg``  — sustained elevation counts, a final-sample dip doesn't hide it
#: ``projected`` — max of window-max and a 15-min linear extrapolation:
#:   "rising toward the limit" fires before the limit is crossed
EVAL_STAT: dict[str, str] = {
    "pod_restarts": "max",
    "oom_events": "max",
    "hpa_at_max": "max",
    "node_not_ready": "max",
    "error_rate": "avg",
    "latency_p99_seconds": "avg",
    "cpu_throttle_ratio": "avg",
    "memory_usage_pct": "projected",
}

PROJECTION_HORIZON_MIN = 15.0         # matches the evidence time window


def downsample(samples: list[Sample], max_points: int) -> list[Sample]:
    """Stride-downsample to ≤ max_points, anchored so the NEWEST sample is
    always kept — current_value and the projection eval must read the
    latest point, not a stale one. (The reference's floor-stride version,
    :205-212, can exceed the cap and drop the newest sample.)"""
    n = len(samples)
    if max_points <= 0 or n <= max_points:
        return samples
    stride = -(-n // max_points)          # ceil -> result length ≤ max_points
    return samples[(n - 1) % stride::stride]


def trend_per_min(samples: list[Sample]) -> float:
    """Least-squares slope in value-units per minute over the window."""
    n = len(samples)
    if n < 2:
        return 0.0
    ts = [s[0] / 60.0 for s in samples]
    vs = [s[1] for s in samples]
    mt = sum(ts) / n
    mv = sum(vs) / n
    denom = sum((t - mt) ** 2 for t in ts)
    if denom <= 0.0:
        return 0.0
    return sum((t - mt) * (v - mv) for t, v in zip(ts, vs)) / denom


def series_stats(samples: list[Sample], keep: int = 50) -> dict:
    """The reference's stats block (:214-245): last-``keep`` samples,
    current/min/max/avg — plus the slope the projection eval uses."""
    values = [v for _, v in samples]
    if not values:
        return {"values": [], "num_points": 0, "current_value": None,
                "min_value": None, "max_value": None, "avg_value": None,
                "trend_per_min": 0.0}
    return {
        "values": [[t, v] for t, v in samples[-keep:]],
        "num_points": len(samples),
        "current_value": values[-1],
        "min_value": min(values),
        "max_value": max(values),
        "avg_value": sum(values) / len(values),
        "trend_per_min": trend_per_min(samples),
    }


def eval_value(query_name: str, stats: dict) -> float | None:
    """The number the family's threshold applies to."""
    cur = stats.get("current_value")
    if cur is None:
        return None
    stat = EVAL_STAT.get(query_name, "current")
    if stat == "max":
        return stats.get("max_value", cur)
    if stat == "avg":
        return stats.get("avg_value", cur)
    if stat == "projected":
        projected = cur + max(0.0, stats.get("trend_per_min", 0.0)) \
            * PROJECTION_HORIZON_MIN
        return max(stats.get("max_value", cur), projected)
    return cur


def metric_eval(data: dict) -> float:
    """Value to threshold when folding a METRIC_SIGNAL payload — the series
    eval value when present, else the instant value (old payloads, external
    producers)."""
    v = data.get("eval_value")
    if v is None:
        v = data.get("current_value", 0)
    return float(v or 0)
