"""RCA engine — plugin seam between the CPU oracle and the device scorers
(``rca_backend={cpu|tpu|gnn}``; the name ``tpu`` keeps its meaning — the
batched rules scorer — and resolves to the CUDA backend here; ``gnn`` is
the learned scorer)."""
from __future__ import annotations

import threading

from .cpu_backend import CpuRcaBackend, match_rules, rank
from .ruleset import Cond, NUM_CONDS, NUM_RULES, RULE_INDEX, RULES, Rule
from .signals import Signals, condition_vector, extract_signals

_INSTANCES: dict[tuple, object] = {}
_BUILD_LOCK = threading.Lock()   # one build per key across step threads
builds = 0
"""Backend objects ``get_backend`` has built in this process (a count, as
a kernel wrapper counts its launches)."""


def get_backend(name: str, device=None):
    """Resolve an RCA backend by name, memoized per (name, device) so the
    rules backend's device-resident snapshot cache survives across calls
    and the learned one loads its checkpoint once. ``tpu`` is the batched
    rules scorer (rca/cuda_backend.py), ``gnn`` the learned one with the
    configured checkpoint (rca/gnn_backend.py); both are imported lazily
    so CPU-only callers never import torch. ``device`` is resolved first
    (default: CUDA, see device.py), so a missing card raises and nothing
    is memoized."""
    global builds
    if name == "cpu":
        key: tuple = (name,)
    elif name in ("tpu", "gnn"):
        from ..device import resolve_device
        key = (name, resolve_device(device))
    else:
        raise KeyError(f"unknown rca backend {name!r}; available: cpu, tpu, gnn")
    with _BUILD_LOCK:
        inst = _INSTANCES.get(key)
        if inst is None:
            if name == "cpu":
                inst = CpuRcaBackend()
            elif name == "tpu":
                from .cuda_backend import CudaRcaBackend
                inst = CudaRcaBackend(device=key[1])
            else:
                from .gnn_backend import GnnRcaBackend
                inst = GnnRcaBackend(device=key[1])
            builds += 1
            _INSTANCES[key] = inst
    return inst


__all__ = [
    "CpuRcaBackend", "get_backend", "match_rules", "rank",
    "Cond", "NUM_CONDS", "NUM_RULES", "RULES", "RULE_INDEX", "Rule",
    "Signals", "condition_vector", "extract_signals",
]
