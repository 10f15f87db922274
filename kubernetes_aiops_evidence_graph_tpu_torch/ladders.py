"""Bucket ladders: the one declared set of rungs every padded shape in the
port is drawn from.

The values are those of the JAX package's ladder registry, so both
packages pad to identical shapes and score identical tensors. A CUDA
kernel takes its sizes at launch and compiles once, so here the ladders
bound host staging buffers and keep the two packages comparable; they
are not a compile-cache key.
"""
from __future__ import annotations

# streaming churn ladders (rca/streaming.py): feature-delta rows and
# evidence-row-delta rows per tick
DELTA_BUCKETS = (64, 256, 1024, 4096, 16384, 65536)
ROW_BUCKETS = (4, 16, 64, 256)

# dense evidence slot-width / pair-width ladders (rca/cuda_backend.py)
WIDTH_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
PAIR_WIDTH_BUCKETS = (4, 8, 16, 32, 64, 128, 256, 512, 1024)
# multi-tenant packed-incident ladder (rca/cuda_backend.py)
PACK_BUCKETS = (8, 32, 128, 512, 2048)

# relation-slice capacity ladder + above-ladder rounding step
# (graph/snapshot.py)
REL_SLICE_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192,
                     16384, 24576, 32768)
REL_SLICE_STEP = 8192

# edge rows per message-pass tile: every relation-slice capacity of the
# ladder above is a multiple of it, which the fused tick requires
# (ops/fused_tick.tiles_align)
EDGE_TILE = 64
# node rows per block in the streamed tick's embed and update
# (config/settings.py gnn_dma_node_block default; kernels/fused_tick)
DMA_NODE_BLOCK = 2048

# snapshot topology ladders (config/settings.py defaults)
NODE_BUCKET_SIZES = (256, 1024, 4096, 16384, 65536, 262144, 524288)
INCIDENT_BUCKET_SIZES = (8, 32, 128, 512)
