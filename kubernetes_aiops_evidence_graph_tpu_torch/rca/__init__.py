"""RCA engine — plugin seam between the CPU oracle and the device scorers
(``rca_backend={cpu|tpu|gnn}``; the name ``tpu`` keeps its meaning — the
batched rules scorer — and resolves to the CUDA backend here; ``gnn`` is
the learned scorer)."""
from __future__ import annotations

from .cpu_backend import CpuRcaBackend, match_rules, rank
from .ruleset import Cond, NUM_CONDS, NUM_RULES, RULE_INDEX, RULES, Rule
from .signals import Signals, condition_vector, extract_signals


def get_backend(name: str, device=None):
    """A fresh RCA backend by name. ``tpu`` is the batched rules scorer
    (rca/cuda_backend.py), ``gnn`` the learned one with the shipped
    checkpoint (rca/gnn_backend.py); both are imported lazily so CPU-only
    callers never import torch. ``device`` is passed to them (default:
    CUDA, see device.py)."""
    if name == "cpu":
        return CpuRcaBackend()
    if name == "tpu":
        from .cuda_backend import CudaRcaBackend
        return CudaRcaBackend(device=device)
    if name == "gnn":
        from .gnn_backend import GnnRcaBackend
        return GnnRcaBackend(device=device)
    raise KeyError(f"unknown rca backend {name!r}; available: cpu, tpu, gnn")


__all__ = [
    "CpuRcaBackend", "get_backend", "match_rules", "rank",
    "Cond", "NUM_CONDS", "NUM_RULES", "RULES", "RULE_INDEX", "Rule",
    "Signals", "condition_vector", "extract_signals",
]
