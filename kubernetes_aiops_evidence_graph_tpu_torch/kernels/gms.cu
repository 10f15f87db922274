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
//   (a) gms_tile_kernel: one block per RUN of at most 16 64-edge tiles of
//       one relation's slice (and 64 output columns). The wrapper cuts the
//       runs from rel_offsets on the host (gms.py tile_runs, ~2,112 runs,
//       cached per layout), so no tile straddles two relations. The block
//       stages w_rel[r]'s column block once, in shared memory for all of
//       H, and keeps it for the run; it skips tiles without a live edge
//       and pipelines the rest in (tile, 32 h columns) units: cp.async
//       gathers the next unit's h[src] rows while the current one
//       computes. Each thread forms 8 rows x 4 columns of the [64, H] x
//       [H, 64] product in float32 FMA: 32 FMAs per three float4 loads
//       from shared memory (two of the gathered rows, masked, rounded and
//       transposed there; one of w_rel), against one load per two FMAs in
//       the first version. It writes the message rows of the live edges
//       (mask != 0) to msg [E, K]; padding rows are neither computed into
//       msg nor read again.
//   (b) gms_segment_kernel: one block per 16 consecutive destinations
//       walks their edges in ascending index through a dst-CSR (perm,
//       rowptr) that the wrapper builds once per forward with a STABLE
//       sort of dst over the live edges and shares across the L layers
//       (the layout does not change between layers). cp.async stages the
//       next 64 message rows in shared memory while the block adds the
//       current 64, so a destination of in-degree 526 waits for ~9 chunk
//       loads instead of 2 x 526 dependent loads in series, and
//       destinations of degree 0 or 1 share the block's loads. Thread
//       (column c, lane l) holds the sums of destinations l, l + 4, l + 8
//       and l + 12 in registers.
// msg[e][c] is the fmaf chain over h's columns in ascending order from 0,
// and out[d][c] the sum from 0 of d's rows in ascending edge index: the
// same float operations in the same order as the first version of this
// kernel, so the result is bit-identical to it and from run to run; no
// floating-point atomics anywhere. Skipping mask == 0 edges is exact:
// their messages are +-0, and adding +-0 to a sum that starts at +0
// never changes it.
//
// Operands: h / w_rel / mask float32, or bfloat16 (cast once by the
// wrapper, as the JAX kernel casts before its gathers) with the product
// h * mask rounded to bfloat16 as there, then float32 products and sums.
// Any K, R and rel_offsets (unaligned slices, zero-width slices, E = 0);
// H up to 768 (w_rel[r]'s column block lives in shared memory).
//
// Bound on an H100 at the shapes of the learned path (H = K = 64, float32):
// operations, 2 * live * H * K over the float32 rate outside the tensor
// cores (0.0334 ms at config 3); the bytes (each distinct gathered src row
// once, 12 B per live edge for src, dst and mask, w_rel, and out [N, K]
// written; gms.py::bound) take about a third of that. What this version
// still pays above it: msg [E, K] goes to device memory and back between
// (a) and (b), and a hub destination's walk is one warp's chain of round
// trips. Levers left: fusing the walk into the tile kernel (a hub of 526
// edges then puts its whole product on one SM, or its sum is split and
// the bits change), tensor cores in 3xTF32 or bf16 (new bits, held to the
// 1e-5 contract), and a hand-written CSR build (0.12 ms per forward).
//
// The device code lives in gms_device.cuh, which fused_tick.cu shares.
// Plain C interface for ctypes: gms_launch returns the cudaGetLastError()
// code after the launches (0 = success).

#include "gms_device.cuh"

// dtype: 0 = float32 operands, 1 = bfloat16 operands; runs: [n_runs, 3]
// (relation, first edge, end edge), gms.py tile_runs
extern "C" int gms_launch(
    int dtype, const void* h, int n_h, int hid, const void* w_rel, int k_out,
    const void* src, const void* mask, const void* runs, int n_runs,
    const void* perm, const void* rowptr, int n_seg, void* msg, void* out,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return gms_pass<float, false>(
            (const float*)h, n_h, hid, (const float*)w_rel, k_out,
            (const int*)src, (const float*)mask, (const int*)runs, n_runs,
            (const int*)perm, (const int*)rowptr, n_seg, (float*)msg,
            (float*)out, s);
    return gms_pass<__nv_bfloat16, false>(
        (const __nv_bfloat16*)h, n_h, hid, (const __nv_bfloat16*)w_rel, k_out,
        (const int*)src, (const __nv_bfloat16*)mask, (const int*)runs, n_runs,
        (const int*)perm, (const int*)rowptr, n_seg, (float*)msg, (float*)out,
        s);
}

extern "C" const char* gms_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
