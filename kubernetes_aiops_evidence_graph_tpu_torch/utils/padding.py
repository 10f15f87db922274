"""Padding / bucketing for XLA static shapes.

Dynamic graphs (pod churn, variable evidence counts) would force XLA
recompilation on every size change. We round all array dims up to a fixed
bucket ladder so the jit cache stays small and compiles amortize
(SURVEY.md §7 "hard parts": static shapes vs dynamic graphs).
"""
from __future__ import annotations

import numpy as np


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= n; if n exceeds the ladder, round up to the next
    power of two so shapes stay discrete."""
    for b in buckets:
        if n <= b:
            return b
    p = int(buckets[-1])
    while p < n:
        p *= 2
    return p


def pad_to(arr: np.ndarray, size: int, axis: int = 0, fill: float | int = 0) -> np.ndarray:
    """Pad ``arr`` along ``axis`` to ``size`` with ``fill`` (no-op if already)."""
    cur = arr.shape[axis]
    if cur == size:
        return arr
    if cur > size:
        raise ValueError(f"cannot pad axis {axis} of length {cur} down to {size}")
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, size - cur)
    return np.pad(arr, widths, constant_values=fill)
