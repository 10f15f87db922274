"""ctypes bindings for the native host kernels (kernels/kaeg_native.cpp).

The library builds with ``g++`` at first use (``kernels/_build.py``, into
the git-ignored ``kernels/_build/``) and loads with ctypes. A failed build
or load raises ``kernels._build.KernelError`` naming the compiler's
error: nothing here falls back to the Python paths in its place.
``available()`` reports whether the library is built and loaded.

Each entry point counts its calls (``calls``), as the kernel wrappers
count their launches.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from .kernels import _build

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

calls = {"scan_logs": 0, "khop_reach": 0}
"""Native calls so far, by entry point; a run resets them to show that its
path went through the library."""


def _load() -> ctypes.CDLL:
    """The loaded library, built on first use; raises ``KernelError``."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = _build.load("kaeg_native")
            try:
                lib.scan_logs.restype = ctypes.c_int64
                lib.scan_logs.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                    ctypes.c_int32, ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
                ]
                lib.khop_reach.restype = None
                lib.khop_reach.argtypes = [
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
                ]
            except AttributeError as exc:
                raise _build.KernelError(
                    f"kaeg_native: missing symbol: {exc}") from exc
            _lib = lib
    return _lib


def available() -> bool:
    """True when the library is built and loaded (building it if needed);
    False when that failed. No port path uses this to choose a fallback:
    the entry points raise."""
    try:
        _load()
    except _build.KernelError:
        return False
    return True


# category table mirroring collectors/logs.py ERROR_PATTERNS as
# boundary-aware substring alternatives; order matters (indices align).
# boundaries flag mirrors the \b anchors of each regex exactly
LOG_CATEGORIES = (
    ("error", "error|err", True),
    ("critical", "critical|fatal|panic", True),
    ("oom", "out of memory|oom kill|oom-kill|oomkill", False),
    ("network", "network unreachable|no route to host|dial tcp", True),
    ("auth", "unauthorized|forbidden|permission denied|auth", True),
    ("missing", "not found|no such file|missing", True),
    ("null_pointer", "nil pointer|null pointer|NoneType", False),
    ("connection", "connection refused|connection reset|connection closed", False),
    ("disk", "no space left|disk full|i/o error", True),
    ("tls", "tls|x509|certificate", True),
    ("timeout", "timed out|time out|timeout|timedout", True),
)
_CAT_BLOB = "\n".join(alts for _, alts, _b in LOG_CATEGORIES).encode()
_BOUND_MASK = sum((1 << i) for i, (_, _, b) in enumerate(LOG_CATEGORIES) if b)


def scan_logs_native(lines: list[str], max_lines: int | None = None):
    """Returns (counts per category, per-line category bitmasks aligned with
    `lines`). Scans every line unless `max_lines` caps it (the returned
    flags array then has only `max_lines` entries — callers must not index
    past it). Raises ``KernelError`` when the library cannot be built."""
    lib = _load()
    calls["scan_logs"] += 1
    if not lines:
        return ({name: 0 for name, _a, _b in LOG_CATEGORIES},
                np.zeros(0, dtype=np.uint64))
    # embedded newlines would desync line indexing — flatten them
    n_lines = len(lines) if max_lines is None else min(len(lines), max_lines)
    buf = "\n".join(l.replace("\n", " ") for l in lines[:n_lines]
                    ).encode("utf-8", "replace")
    counts = (ctypes.c_int64 * len(LOG_CATEGORIES))()
    flags = (ctypes.c_uint64 * n_lines)()
    n = lib.scan_logs(buf, len(buf), _CAT_BLOB, len(LOG_CATEGORIES),
                      _BOUND_MASK, counts, flags, n_lines)
    return (
        {LOG_CATEGORIES[i][0]: int(counts[i]) for i in range(len(LOG_CATEGORIES))},
        np.frombuffer(bytes(flags), dtype=np.uint64, count=int(n)),
    )


def khop_reach_native(edge_src: np.ndarray, edge_dst: np.ndarray,
                      num_nodes: int, seed: int, hops: int) -> np.ndarray:
    """BFS reach mask uint8 [num_nodes] (seed included; edges directed as
    given, so pass both directions for undirected reach).

    Indices are validated here — the C++ kernel does raw array writes, so
    an out-of-range seed raises and out-of-range edges (e.g. unfiltered
    padding) are dropped rather than corrupting memory. Raises
    ``KernelError`` when the library cannot be built."""
    lib = _load()
    if not 0 <= seed < num_nodes:
        raise ValueError(f"seed {seed} out of range [0, {num_nodes})")
    calls["khop_reach"] += 1
    src = np.ascontiguousarray(edge_src, dtype=np.int32)
    dst = np.ascontiguousarray(edge_dst, dtype=np.int32)
    valid = (src >= 0) & (src < num_nodes) & (dst >= 0) & (dst < num_nodes)
    if not valid.all():
        src = np.ascontiguousarray(src[valid])
        dst = np.ascontiguousarray(dst[valid])
    reach = np.zeros(num_nodes, dtype=np.uint8)
    lib.khop_reach(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(src), num_nodes, seed, hops,
        reach.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return reach
