// gms.cu — the relation-bucketed message pass of the learned RCA path
// (gather -> per-relation matmul -> ordered dst-segment sum) for Hopper
// (sm_90a).
//
// Replaces, on the JAX package's path: ops/pallas_segment.py::_gms_kernel
// (the Pallas TPU kernel behind pallas_gather_matmul_segment), and with it
// the XLA kernel ops/segment.py::gather_matmul_segment. For each relation
// slice r = [off[r], off[r+1]) of the edge arrays:
//     out[dst[e]] += (h[src[e]] * mask[e]) @ w_rel[r]
// and every out[d] is the sum of its messages in ASCENDING EDGE INDEX,
// starting from 0 — the left fold of the Pallas kernel's per-edge
// accumulate and of the XLA scatter-add.
//
// Why two kernels, and not the Pallas design. On the TPU the grid runs in
// order on one core, so the Pallas kernel carries the [N, K] accumulator
// in VMEM from one edge tile to the next and adds rows in edge order.
// Blocks on Hopper run in parallel and in no order; the only ordered,
// atomic-free way to sum a destination's messages is to let ONE thread
// walk them. A destination recurs across relation slices, so a per-slice
// sorted run is not enough either. Hence:
//   (a) gms_tile_kernel: one block per 64-edge tile (and 64 output
//       columns). The block finds each edge's relation from off[] (a tile
//       may straddle slices when the layout is not 64-aligned; it then
//       runs one pass per relation it holds), gathers the masked h[src]
//       rows into shared memory 32 columns at a time beside the matching
//       32-row chunk of w_rel[r], and forms the [64, H] x [H, K] product in
//       float32 FMA (4x4 outputs a thread). It writes the message rows of
//       the live edges (mask != 0) to msg [E, K]; padding rows are neither
//       computed into msg nor read again.
//   (b) gms_segment_kernel: one warp per destination row walks that row's
//       edges in ascending index through a dst-CSR (perm, rowptr) that the
//       wrapper builds once per forward with a STABLE sort of dst over the
//       live edges and shares across the L layers (the layout does not
//       change between layers). Each lane owns K/32 columns and adds in
//       CSR order, so out is bit-identical from run to run; no
//       floating-point atomics anywhere.
// Skipping mask == 0 edges is exact: their messages are +-0, and adding
// +-0 to a sum that starts at +0 never changes it.
//
// Operands: h / w_rel / mask float32, or bfloat16 (cast once by the
// wrapper, as the JAX kernel casts before its gathers) with the product
// h * mask rounded to bfloat16 as there, then float32 products and sums.
// Any H, K, R and off[] (unaligned slices, zero-width slices, E = 0).
//
// Bound on an H100 at the shapes of the learned path (H = K = 64, float32):
// operations, 2 * live * H * K over the float32 rate outside the tensor
// cores; the bytes (each distinct gathered src row once, 12 B per live
// edge for src, dst and mask, w_rel, and out [N, K] written; gms.py::bound)
// take about a third of that. This first version pays more than both:
// msg [E, K] goes to device memory and back between (a) and (b), and the
// gathers in (a) are dependent index -> row loads with no prefetch.
// Tensor cores (wgmma), TMA and fusing the segment walk into the tile
// kernel are later work.
//
// The device code lives in gms_device.cuh, which fused_tick.cu shares.
// Plain C interface for ctypes: gms_launch returns the cudaGetLastError()
// code after the launches (0 = success).

#include "gms_device.cuh"

// dtype: 0 = float32 operands, 1 = bfloat16 operands
extern "C" int gms_launch(
    int dtype, const void* h, int n_h, int hid, const void* w_rel, int n_rel,
    int k_out, const void* src, const void* mask, const void* off,
    int n_edges, const void* perm, const void* rowptr, int n_seg, void* msg,
    void* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return gms_pass<float, false>(
            (const float*)h, n_h, hid, (const float*)w_rel, n_rel, k_out,
            (const int*)src, (const float*)mask, (const int*)off, n_edges,
            (const int*)perm, (const int*)rowptr, n_seg, (float*)msg,
            (float*)out, s);
    return gms_pass<__nv_bfloat16, false>(
        (const __nv_bfloat16*)h, n_h, hid, (const __nv_bfloat16*)w_rel, n_rel,
        k_out, (const int*)src, (const __nv_bfloat16*)mask, (const int*)off,
        n_edges, (const int*)perm, (const int*)rowptr, n_seg, (float*)msg,
        (float*)out, s);
}

extern "C" const char* gms_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
