"""Roofline accounting for the device passes, on an NVIDIA H100.

The port of the JAX package's ``rca/device_metrics.py``. It turns a
pass's measured time into statements about the card: bytes touched,
float32 operations, achieved bytes/s, and the share of the pass the
card's roofline explains. Four parts:

1. **Analytic cost models** — :func:`fold_accounting`,
   :func:`gnn_layer_accounting` and :func:`roofline_record`, copied as
   they are (arithmetic on padded shapes).

2. **Tick pricing** — :func:`tick_cost` gives the minimum bytes and
   float32 operations of each tick the resident scorers dispatch, per
   entry point, in closed form from padded shapes with every padded slot
   and edge counted live (as the JAX package prices a tick's jaxpr). Its
   kernel terms are the kernel wrappers' own bounds in closed form
   (``kernels/rules_fold.bound_bytes``, ``kernels/gms.bound``,
   ``kernels/fused_tick.bound``); the roofline gauges
   (``observability/scope.ROOFLINE``) read it, so the gauges and the
   kernel table speak of the same work.

3. **Measured anchors** — the card's achievable device-memory rate
   (chained elementwise passes over a 512 MiB buffer), its bf16 matrix
   product rate (chained ``[n, n] @ [n, n]``) and the cost of one
   device→host copy of a fresh small result. They are anchors for the
   card, measured with CUDA events as the slope between two chain
   lengths; they port no Pallas kernel (the JAX versions are plain
   ``jnp`` operations), so plain torch operations and ``torch.matmul``
   are what they time. The H100 SXM 80GB HBM3 datasheet ceilings are
   reported beside them.

4. **Device-only time against dispatch** — k chained scoring passes
   (``rules_fold``, B1) captured in one ``torch.cuda.CUDAGraph`` run with
   no per-pass host launch, so the slope over two chain lengths is the
   device-only time of a pass; the same k passes issued one by one give
   the chained-dispatch slope; the difference is the overhead of one
   dispatch. Each pass feeds the previous pass's ``top_score`` into its
   ``chain`` input (``min(chain, 0)`` is added to every count: zero for
   real scores, so the passes give the bits of one dispatch, but no pass
   can be skipped). :func:`measure_gnn_forward_per_pass_s` does the same
   for the learned forward (B2 in every layer).

On the CPU (``device="cpu"``) the probes time the host with
``time.perf_counter`` and the fields that exist only on the card (the
graph slope, the overhead) are ``None``. Without a card and without
``"cpu"`` they raise (``device.resolve_device``).
"""
from __future__ import annotations

import time

import torch

from ..device import resolve_device
from ..graph.schema import DIM, EntityKind
from ..kernels.rules_fold import rules_fold
from .gnn import NUM_CLASSES, NUM_RELS
from .ruleset import NUM_CONDS, NUM_RULES

# H100 SXM 80GB HBM3 datasheet ceilings (dense, no sparsity; at the full
# 700 W power limit), reported beside the measured anchors
H100_HBM_BYTES_PER_S = 3.35e12
H100_BF16_FLOP_PER_S = 989e12
H100_F32_FLOP_PER_S = 67e12
H100_HBM_GBPS = H100_HBM_BYTES_PER_S / 1e9
H100_BF16_TFLOPS = H100_BF16_FLOP_PER_S / 1e12
H100_F32_TFLOPS = H100_F32_FLOP_PER_S / 1e12


# -- analytic cost models -------------------------------------------------

def fold_accounting(pi: int, width: int, pair_width: int, dim: int,
                    num_conds: int | None = None,
                    num_rules: int | None = None) -> dict:
    """Minimum HBM bytes + FLOPs of one rules scoring pass.

    Traffic model (f32 = 4 bytes):
      reads  — gathered feature rows Pi*W*DIM, slot tables ev_idx +
               ev_pair_slot Pi*W*2, counts Pi;
      writes — folded counts Pi*DIM, pair counts Pi*Wr, score outputs
               Pi*(C + 3R + 4).
    FLOPs: mask build + masked multiply-add fold 3*Pi*W*DIM, one-hot pair
    contraction 2*Pi*W*Wr, condition thresholds ~8*Pi*C, rule matmul
    2*Pi*C*R, scoring tail ~6*Pi*R.
    """
    c = num_conds if num_conds is not None else NUM_CONDS
    r = num_rules if num_rules is not None else NUM_RULES
    reads = pi * width * dim * 4 + pi * width * 2 * 4 + pi * 4
    writes = pi * dim * 4 + pi * pair_width * 4 + pi * (c + 3 * r + 4) * 4
    flops = (3 * pi * width * dim + 2 * pi * width * pair_width
             + 8 * pi * c + 2 * pi * c * r + 6 * pi * r)
    return {"bytes": reads + writes, "flops": flops,
            "reads": reads, "writes": writes}


def gnn_layer_accounting(pn: int, e: int, hidden: int,
                         bucketed: bool = False,
                         compute_bytes: int = 4) -> dict:
    """Minimum HBM bytes + FLOPs of one GNN message-passing layer.

    ``bucketed=False`` — the transform-then-gather mapping: all R
    transformed copies computed densely, each edge gathers its
    rel-specific source row, one [E, H] segment-sum.
    ``bucketed=True`` — the relation-bucketed mapping: per-relation
    slices gather [E_r, H] source rows, one [H, H] matmul each,
    per-slice segment-sums into one [N, H] accumulator (``e`` = the SUM
    of padded slice capacities). ``compute_bytes`` scales the
    matmul-operand traffic terms for the bf16 compute path;
    accumulator/output/index traffic stays f32/int32 at 4 bytes.
    """
    r = NUM_RELS
    if bucketed:
        cb = compute_bytes
        reads = (e * hidden * cb + 2 * pn * hidden * 4
                 + ((r + 1) * hidden * hidden + hidden) * cb
                 + e * hidden * cb + 3 * e * 4 + pn * 4)
        writes = (e * hidden * cb + (e + 2 * pn) * hidden * 4)
        flops = (2 * e * hidden * hidden + 2 * pn * hidden * hidden
                 + 2 * e * hidden + 4 * pn * hidden)
        return {"bytes": reads + writes, "flops": flops,
                "reads": reads, "writes": writes}
    reads = (3 * pn * hidden + r * hidden * hidden + hidden * hidden
             + hidden + e * hidden + 2 * e + pn) * 4
    writes = (pn * r * hidden + 2 * pn * hidden + e * hidden) * 4
    flops = (2 * pn * r * hidden * hidden + 2 * pn * hidden * hidden
             + 2 * e * hidden + pn * hidden + 3 * pn * hidden)
    return {"bytes": reads + writes, "flops": flops,
            "reads": reads, "writes": writes}


def roofline_record(bytes_touched: int, flops: int, per_pass_s: float,
                    bw_gbps: float, tflops: float) -> dict:
    """Per-pass achieved rates + the roofline-explained share of the time.

    roofline_ms is the time the pass WOULD take if it ran at the given
    rates (max of the bandwidth term and the compute term); roofline_pct
    = that floor / the measured pass time. 100% = at the hardware
    ceiling; small % = the pass is dominated by per-kernel launch/sync
    overheads rather than streaming or FLOPs."""
    bw_s = bytes_touched / (bw_gbps * 1e9)
    fl_s = flops / (tflops * 1e12) if tflops > 0 else 0.0
    floor_s = max(bw_s, fl_s)
    return {
        "bytes_per_pass": int(bytes_touched),
        "flops_per_pass": int(flops),
        "achieved_gbps": round(bytes_touched / per_pass_s / 1e9, 2),
        "achieved_gflops": round(flops / per_pass_s / 1e9, 2),
        "roofline_floor_ms": round(floor_s * 1e3, 5),
        "roofline_pct": round(100.0 * floor_s / per_pass_s, 2),
        "bound": "bandwidth" if bw_s >= fl_s else "compute",
    }


# -- tick pricing -----------------------------------------------------------
#
# Each term is (bytes, f32 operations): every input read once and every
# output written once. Padded shapes, with every padded evidence slot and
# every padded edge counted live.

_RULES_OUT_BYTES = NUM_CONDS + NUM_RULES + NUM_RULES * 4 + 4 + 1 + 4 + 4
"""The seven outputs of one rules pass per incident row (``conds``,
``matched``, ``scores``, ``top_idx``, ``any_match``, ``top_conf``,
``top_score``), as ``kernels/rules_fold.bound_bytes`` counts them."""

GNN_ENTRYPOINTS = ("streaming.gnn_tick.bucketed", "streaming.gnn_tick.fused",
                   "streaming.gnn_tick.fused.bf16", "streaming.gnn_tick.dma",
                   "streaming.gnn_tick.dma.bf16", "streaming.gnn_tick.dma.int8",
                   "streaming.gnn_tick.sharded")
"""The learned scorer's entry points, one a tier (``rca/gnn_streaming.
GnnStreamingScorer._tick_entrypoint``)."""


def rules_fold_term(pn: int, pi: int, width: int, dim: int = DIM
                    ) -> tuple[int, int]:
    """B1 with every slot live and every slot on its own feature row (as
    many distinct rows as the table has): ``rules_fold.bound_bytes`` and
    the operations ``chip_smoke.kernel_timing`` counts (one add per
    gathered value, one per slot into the pair histogram)."""
    live = pi * width
    rows = min(live, pn)
    nbytes = rows * dim * 4 + live * 8 + pi * 8 + pi * _RULES_OUT_BYTES
    return nbytes, live * (dim + 1)


def gms_term(pn: int, e: int, hidden: int, k_out: int, num_rels: int,
             operand_bytes: int = 4) -> tuple[int, int]:
    """B2 (one message pass) with every edge of the ``e`` slice slots live
    and as many distinct source rows as there are (``gms.bound``)."""
    rows = min(e, pn)
    nbytes = (rows * hidden * operand_bytes + e * 12
              + num_rels * hidden * k_out * operand_bytes + pn * k_out * 4)
    return nbytes, 2 * e * hidden * k_out


def _gnn_weights(dim: int, hidden: int, classes: int, layers: int,
                 num_rels: int, num_kinds: int) -> int:
    return 4 * (dim * hidden + hidden + num_kinds * hidden
                + hidden * classes + classes
                + layers * (hidden * hidden + num_rels * hidden * hidden
                            + hidden))


def fused_tick_term(*, pn: int, pe: int, pi: int, pk: int, ek: int,
                    dim: int, hidden: int, classes: int, layers: int,
                    num_rels: int, num_kinds: int, feat_quant: str = "",
                    dma: bool = False) -> tuple[int, int]:
    """B3 (``dma=False``) or B4 with every edge live:
    ``kernels/fused_tick.bound``'s ``bytes`` and ``ops``."""
    qb = {"": 0, "bfloat16": 2, "int8": 1}[feat_quant]
    fb = qb or 4
    weights = _gnn_weights(dim, hidden, classes, layers, num_rels, num_kinds)
    reads = (pn * dim * fb + 8 * pn + 12 * pe
             + 4 * (3 * pk + 5 * ek + 2 * pi) + weights + pk * dim * qb
             + (4 * dim if feat_quant == "int8" else 0))
    writes = (8 * pk + 16 * ek + 2 * 4 * pi * classes + pk * dim * qb
              + (2 * 4 * pn * hidden if dma else 0))
    ops = 2 * (pn * dim * hidden
               + layers * (pe * hidden * hidden + pn * hidden * hidden)
               + pi * hidden * classes)
    return reads + writes, ops


def _rules_tick(pn: int, pi: int, width: int, pk: int, rk: int,
                dim: int = DIM, **_ignored) -> dict:
    """The rules tick: the packed delta copied into the resident tables
    (the feature rows and the evidence rows), then B1."""
    li = pk + 2 * rk + 2 * rk * width
    delta = (li * 4 + 2 * pk * dim * 4 + rk * (2 * width + 1) * 4, 0)
    return {"delta": delta, "B1": rules_fold_term(pn, pi, width, dim)}


def _sharded_rules_tick(pn: int, pi: int, width: int, pk: int, rk: int,
                        shards: int, pair_width: int, dim: int = DIM,
                        **_ignored) -> dict:
    """The graph-sharded rules tick (``parallel/sharded_streaming.
    sharded_rules_tick``) over D = ``shards`` positions: each copies its
    routed feature rows (``pk`` a shard) and the row delta in, folds its
    node block (``rules_fold_partial``, with every slot live every slot
    falls in one block, so the gathered rows, the pair ids and the adds
    split over the blocks while each block reads every slot's node id and
    writes its ``[pi, DIM + pair_width]`` partial), the D partials are
    summed over the graph axis, then ``rules_tail`` (B1's two entries)."""
    li = pk + 2 * rk + 2 * rk * width
    delta = (shards * (li * 4 + 2 * pk * dim * 4
                       + rk * (2 * width + 1) * 4), 0)
    live = pi * width
    part = pi * (dim + pair_width) * 4
    fold = (min(live, pn) * dim * 4 + live * 4
            + shards * (live * 4 + pi * 4 + part), live * (dim + 1))
    psum = ((shards - 1) * 3 * part, (shards - 1) * pi * (dim + pair_width))
    tail = (pi * (dim + pair_width + 1) * 4 + pi * _RULES_OUT_BYTES, 0)
    return {"delta": delta, "B1.partial": fold, "psum": psum,
            "B1.tail": tail}


def _composed_tick(pn: int, pi: int, pe: int, pk: int, ek: int, dim: int,
                   hidden: int, classes: int, layers: int, num_rels: int,
                   num_kinds: int, compute_bytes: int = 4) -> dict:
    """The composed learned tick (``rca/gnn_streaming._gnn_tick``): the
    mirror delta copied in, the degree, the embed, per layer B2 and the
    self product with the update, the readout and its softmax."""
    ints = 4 * (3 * pk + 5 * ek + 2 * pi)
    delta = (ints + 8 * pk + 16 * ek, 0)
    degree = (pe * 8 + pn * 4, pe)
    embed = (pn * dim * 4 + 8 * pn + 4 * (dim * hidden + hidden
                                          + num_kinds * hidden)
             + pn * hidden * 4, 2 * pn * dim * hidden)
    b2 = gms_term(pn, pe, hidden, hidden, num_rels, compute_bytes)
    update = (pn * hidden * 4 * 3 + pn * 4
              + (hidden * hidden + hidden) * 4,
              2 * pn * hidden * hidden + 4 * pn * hidden)
    readout = (pi * 4 + pi * hidden * 4 + (hidden * classes + classes) * 4
               + 2 * pi * classes * 4, 2 * pi * hidden * classes)
    return {"delta": delta, "degree": degree, "embed": embed,
            "B2": (layers * b2[0], layers * b2[1]),
            "update": (layers * update[0], layers * update[1]),
            "readout": readout}


def tick_cost(entrypoint: str, **shapes) -> dict:
    """Minimum bytes and float32 operations of one tick the resident
    scorers dispatch, at padded shapes with every padded slot and edge
    counted live. ``{"bytes", "flops", "terms": {name: (bytes, ops)}}``.

    ``streaming.rules_tick`` takes ``pn, pi, width, pk, rk`` (``dim``
    defaults to the schema's); ``streaming.rules_tick.sharded`` also
    ``shards`` and ``pair_width`` (``pk`` per shard), and prices the sum
    over the graph axis as ``collective_bytes`` (the D - 1 partials that
    move to the row's first position); the learned entry points take ``pn, pi,
    pe`` (the mirror's edge slots), ``pk, ek`` and the params' shapes
    ``hidden, layers`` (``dim, classes, num_rels, num_kinds`` default to
    the schema's). ``streaming.gnn_tick.sharded`` also takes ``shards``
    (``pe``, ``pk`` and ``ek`` per shard) and prices the ring's
    ``(layers + 1) * shards`` hops of one ``[Pn/D, H]`` block each as
    ``collective_bytes``. A learned entry point prices the GNN tick alone: the
    rules tick dispatched beside it is priced under its own entry point.
    The kernel terms are named by kernel (``B1``..``B4``)."""
    collective = 0
    if entrypoint == "streaming.rules_tick":
        terms = _rules_tick(**shapes)
    elif entrypoint == "streaming.rules_tick.sharded":
        terms = _sharded_rules_tick(**shapes)
        collective = ((shapes["shards"] - 1) * shapes["pi"]
                      * (shapes.get("dim", DIM) + shapes["pair_width"]) * 4)
    elif entrypoint in GNN_ENTRYPOINTS:
        g = dict(dim=DIM, classes=NUM_CLASSES, num_rels=NUM_RELS,
                 num_kinds=len(EntityKind))
        g.update(shapes)
        g.pop("width", None), g.pop("pair_width", None), g.pop("rk", None)
        if entrypoint == "streaming.gnn_tick.sharded":
            cb = 2 if g.pop("compute_dtype", None) == "bfloat16" else 4
            terms = _sharded_gnn_tick(compute_bytes=cb, **g)
            collective = ((g["layers"] + 1) * g["shards"]
                          * (g["pn"] // g["shards"]) * g["hidden"] * 4)
        elif entrypoint == "streaming.gnn_tick.bucketed":
            cb = 2 if g.pop("compute_dtype", None) == "bfloat16" else 4
            terms = _composed_tick(compute_bytes=cb, **g)
        else:
            g.pop("compute_dtype", None)
            dma = ".dma" in entrypoint
            quant = {"bf16": "bfloat16", "int8": "int8"}.get(
                entrypoint.rsplit(".", 1)[-1], "") if dma else ""
            terms = {"B4" if dma else "B3": fused_tick_term(
                feat_quant=quant, dma=dma, **g)}
    else:
        raise KeyError(f"no cost model for entry point {entrypoint!r}")
    return {"bytes": int(sum(b for b, _ in terms.values())),
            "flops": int(sum(o for _, o in terms.values())),
            "collective_bytes": int(collective), "terms": terms}


# -- measured anchors -------------------------------------------------------

def _clock(dev: torch.device):
    """``run(fn) -> seconds``: CUDA events around ``fn`` on the card (the
    device's own clock), ``time.perf_counter`` on the CPU."""
    if dev.type == "cuda":
        def run(fn) -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
    else:
        def run(fn) -> float:
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
    return run


def _slope(run, k1: int, k2: int, repeats: int = 2) -> float:
    """Per-pass seconds from two chained-run lengths: ``run(k)`` times a
    chain of k passes (the best of ``repeats``)."""
    t1 = min(run(k1) for _ in range(repeats))
    t2 = min(run(k2) for _ in range(repeats))
    return max((t2 - t1) / (k2 - k1), 1e-9)


def measure_hbm_gbps(mib: int = 512, k1: int = 4, k2: int = 32,
                     device: "str | torch.device | None" = None) -> float:
    """Achievable device-memory rate in GB/s: chained in-place passes
    ``x *= a`` over a ``mib`` MiB float32 buffer (each reads and writes
    the buffer once: 2 * size bytes a pass), the slope between ``k1`` and
    ``k2`` passes."""
    dev = resolve_device(device)
    n = mib * (1 << 20) // 4
    x = torch.ones(n, dtype=torch.float32, device=dev)
    clock = _clock(dev)

    def run(k: int) -> float:
        def chain():
            for _ in range(k):
                x.mul_(1.0000001)
        return clock(chain)

    run(k1)   # warm the kernel and the allocator before timing
    per_pass = _slope(run, k1, k2)
    return 2 * n * 4 / per_pass / 1e9


def measure_matmul_tflops(n: int = 8192, k1: int = 2, k2: int = 10,
                          device: "str | torch.device | None" = None
                          ) -> float:
    """Achievable bf16 matrix-product rate in TFLOP/s: chained
    ``c = c @ a`` over ``[n, n]`` (2 n³ operations a pass; ``a`` holds
    1/n, so the chain stays finite and exact), the slope between ``k1``
    and ``k2`` products."""
    dev = resolve_device(device)
    a = torch.full((n, n), 1.0 / n, dtype=torch.bfloat16, device=dev)
    clock = _clock(dev)

    def run(k: int) -> float:
        def chain():
            c = a
            for _ in range(k):
                c = c @ a
        return clock(chain)

    run(k1)
    per_pass = _slope(run, k1, k2)
    return 2 * n ** 3 / per_pass / 1e12


def measure_fetch_rtt_ms(samples: int = 5,
                         device: "str | torch.device | None" = None
                         ) -> float:
    """Median ms of ONE device→host copy of a fresh 8-element result
    (each sample computes a new one, so nothing is cached); the wait for
    the small kernel that makes it is inside."""
    dev = resolve_device(device)
    x = torch.ones(8, dtype=torch.float32, device=dev)
    (x * 2.0).cpu()   # warm
    times = []
    for i in range(samples):
        y = (x + float(i)) * 2.0
        t0 = time.perf_counter()
        y.cpu()
        times.append(time.perf_counter() - t0)
    times.sort()
    return max(times[len(times) // 2], 1e-9) * 1e3


# -- device-only time against dispatch --------------------------------------

def _capture(fn):
    """``fn()`` captured in one CUDA graph after one eager warm-up call on
    a side stream (kernel tables uploaded, layouts' tile runs cached):
    returns ``(graph, outputs of the captured call)``."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def _chained_folds(args: tuple, pair_width: int, k: int,
                   chain0: torch.Tensor) -> tuple:
    """k chained ``rules_fold`` passes: each pass's ``top_score`` is the
    next pass's ``chain``. Returns the last pass's seven outputs."""
    out = rules_fold(*args, chain0, pair_width)
    for _ in range(k - 1):
        out = rules_fold(*args, out[6], pair_width)
    return out


def loop_score(device_args: tuple, pair_width: int, k: int) -> tuple:
    """The last pass of k chained scoring passes: on the card the k
    passes run as one captured CUDA graph (one replay), on the CPU as k
    plain passes. ``device_args`` = (features, ev_idx, ev_cnt,
    ev_pair_slot) on one device. Equal bit for bit to one dispatch."""
    dev = device_args[0].device
    chain0 = torch.zeros(device_args[1].shape[0], dtype=torch.float32,
                         device=dev)
    if dev.type != "cuda":
        return _chained_folds(device_args, pair_width, k, chain0)
    graph, out = _capture(lambda: _chained_folds(device_args, pair_width, k,
                                                 chain0))
    graph.replay()
    return out


def _slopes(dev: torch.device, eager, graphed, k1: int, k2: int,
            repeats: int, profiled=None) -> dict:
    """The chained-dispatch slope (``eager(k)`` issues k passes one by
    one) and, on the card, the graph slope (``graphed(k)`` returns a
    replay of k captured passes) and their difference. When the capture
    is refused and ``profiled`` is given, the device-only time is
    ``profiled()`` instead and ``method`` says so."""
    clock = _clock(dev)
    eager(k1)   # warm
    dispatch_s = _slope(lambda k: clock(lambda: eager(k)), k1, k2, repeats)
    rec = {"method": "host", "k": [k1, k2], "device_s_per_pass": None,
           "dispatch_s_per_pass": dispatch_s, "overhead_s_per_dispatch": None,
           "graph_replays": 0, "graph_passes": 0}
    if dev.type != "cuda":
        return rec
    try:
        replays = {k: graphed(k) for k in (k1, k2)}
    except RuntimeError as exc:
        if profiled is None or "captur" not in str(exc).lower():
            raise
        # a pass whose host part does not capture: its device-only time
        # from the profiler's CUDA activity (kernels and copies)
        rec.update(method="profiler", device_s_per_pass=profiled(),
                   capture_error=str(exc)[:200])
        rec["overhead_s_per_dispatch"] = (dispatch_s
                                          - rec["device_s_per_pass"])
        return rec
    device_s = _slope(lambda k: clock(replays[k]), k1, k2, repeats)
    rec.update(method="cuda_graph", device_s_per_pass=device_s,
               overhead_s_per_dispatch=dispatch_s - device_s,
               graph_replays=2 * repeats, graph_passes=repeats * (k1 + k2))
    return rec


def measure_scan_per_pass_s(batch, device_args: tuple, k1: int = 16,
                            k2: int = 256, repeats: int = 3) -> dict:
    """Per-pass seconds of the rules scoring pass (B1), two ways (module
    docstring, part 4): ``device_s_per_pass`` (the CUDA-graph slope,
    ``None`` off the card), ``dispatch_s_per_pass`` (k passes issued one
    by one) and ``overhead_s_per_dispatch``. ``batch`` is the
    ``cuda_backend.DeviceBatch`` (its ``pair_width``); ``device_args`` =
    (features, ev_idx, ev_cnt, ev_pair_slot) on the device. The graph's
    replays are counted in ``graph_replays`` x passes, apart from the
    wrapper's launch count (its host-side count moves only at the
    capture)."""
    dev = device_args[0].device
    pw = int(batch.pair_width)
    chain0 = torch.zeros(device_args[1].shape[0], dtype=torch.float32,
                         device=dev)

    def eager(k):
        _chained_folds(device_args, pw, k, chain0)

    def graphed(k):
        graph, _ = _capture(lambda: _chained_folds(device_args, pw, k,
                                                   chain0))
        return graph.replay

    return _slopes(dev, eager, graphed, k1, k2, repeats)


def measure_gnn_forward_per_pass_s(params, batch: dict, k1: int = 4,
                                   k2: int = 16, repeats: int = 2,
                                   compute_dtype: str | None = None) -> dict:
    """Per-forward seconds of the learned forward (every layer's message
    pass is B2), as :func:`measure_scan_per_pass_s` does for B1. Each
    forward's features are scaled by ``1 + carry * 1e-38`` with ``carry``
    the previous forward's mean logit: exactly 1.0 in float32, so the
    logits are unchanged, but every forward depends on the one before.
    ``batch`` is ``gnn.snapshot_batch``'s dict; its arrays go to the
    params' device."""
    from . import gnn
    dev = params["embed_w"].device
    offs = tuple(batch.get("rel_offsets") or ())
    args = [torch.as_tensor(batch[k]).to(dev) for k in gnn._BATCH_ARRAYS]
    feats, rest = args[0], args[1:]
    carry0 = torch.zeros((), dtype=torch.float32, device=dev)

    def chain(k):
        carry = carry0
        with torch.no_grad():
            for _ in range(k):
                logits = gnn.forward(params, feats * (1.0 + carry * 1e-38),
                                     *rest, rel_offsets=offs,
                                     compute_dtype=compute_dtype)
                carry = logits.mean()
        return carry

    def graphed(k):
        graph, _ = _capture(lambda: chain(k))
        return graph.replay

    def profiled() -> float:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            chain(k2)
            torch.cuda.synchronize()
        busy_us = sum(e.self_device_time_total
                      for e in prof.key_averages())
        return busy_us / 1e6 / k2

    return _slopes(dev, chain, graphed, k1, k2, repeats, profiled)


def _sharded_gnn_tick(pn: int, pi: int, pe: int, pk: int, ek: int,
                      shards: int, dim: int, hidden: int, classes: int,
                      layers: int, num_rels: int, num_kinds: int,
                      compute_bytes: int = 4) -> dict:
    """The graph-sharded learned tick (``parallel/sharded_streaming.
    sharded_gnn_tick``) over D = ``shards`` positions of ``pn / D`` node
    rows and ``pe`` edge slots each: every position copies its mirror
    delta in and takes its degree and embed; per layer it assembles its
    ``[pe, H]`` source rows from the ring (each slot's row read once),
    runs B2 on them at ``(pn / D, pe)`` and the update; the ring's
    ``(layers + 1) * D`` block copies; one readout and its softmax."""
    nps = pn // shards
    ints = 4 * (3 * pk + 5 * ek + 2 * pi)
    delta = (shards * (ints + 8 * pk + 16 * ek), 0)
    degree = (shards * (pe * 8 + nps * 4), shards * pe)
    embed = (shards * (nps * dim * 4 + 8 * nps + nps * hidden * 4
                       + 4 * (dim * hidden + hidden + num_kinds * hidden)),
             shards * 2 * nps * dim * hidden)
    assemble = (shards * (pe * 4 + 2 * pe * hidden * 4), 0)
    b2 = (pe * hidden * compute_bytes + pe * 12
          + num_rels * hidden * hidden * compute_bytes + nps * hidden * 4,
          2 * pe * hidden * hidden)
    update = (nps * hidden * 4 * 3 + nps * 4
              + (hidden * hidden + hidden) * 4,
              2 * nps * hidden * hidden + 4 * nps * hidden)
    ring = ((layers + 1) * shards * 2 * nps * hidden * 4, 0)
    readout = (pi * 4 + pi * hidden * 4 + (hidden * classes + classes) * 4
               + 2 * pi * classes * 4, 2 * pi * hidden * classes)
    return {"delta": delta, "degree": degree, "embed": embed,
            "assemble": (layers * assemble[0], 0),
            "B2": (layers * shards * b2[0], layers * shards * b2[1]),
            "update": (layers * shards * update[0],
                       layers * shards * update[1]),
            "ring": ring, "readout": readout}
