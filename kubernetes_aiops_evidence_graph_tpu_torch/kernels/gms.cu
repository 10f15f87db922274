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
// Plain C interface for ctypes: gms_launch returns the cudaGetLastError()
// code after the launches (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 64;    // edges per tile (EDGE_TILE)
constexpr int kTileCols = 64;    // output columns per block
constexpr int kChunk = 32;       // H columns staged per step
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
// h * mask in the operand type (m is the mask value, exact in float):
// float32 as is, rounded to bfloat16 for bfloat16 operands (the JAX
// kernel multiplies in the compute dtype)
__device__ __forceinline__ float mul_round(float a, float m) { return a * m; }
__device__ __forceinline__ float mul_round(__nv_bfloat16 a, float m) {
    return __bfloat162float(__float2bfloat16(__bfloat162float(a) * m));
}

// relation of edge e: the r with off[r] <= e < off[r+1], or -1
__device__ __forceinline__ int relation_of(const int* off, int n_rel, int e) {
    if (n_rel <= 0 || e < off[0] || e >= off[n_rel]) return -1;
    int lo = 0, hi = n_rel;              // off[lo] <= e < off[hi]
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (off[mid] <= e) lo = mid; else hi = mid;
    }
    return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gms_tile_kernel(
    const T* __restrict__ h, int n_h, int hid,
    const T* __restrict__ w_rel, int n_rel, int k_out,
    const int* __restrict__ src, const T* __restrict__ mask,
    const int* __restrict__ off, int n_edges,
    float* __restrict__ msg) {
    __shared__ float g_s[kTileRows][kChunk + 1];
    __shared__ float w_s[kChunk][kTileCols];
    __shared__ int s_src[kTileRows];
    __shared__ int s_rel[kTileRows];
    __shared__ float s_mask[kTileRows];

    const int tid = threadIdx.x;
    const int e0 = blockIdx.x * kTileRows;
    const int k0 = blockIdx.y * kTileCols;
    const int tx = tid % 16;             // columns tx, tx+16, tx+32, tx+48
    const int ty = tid / 16;             // rows ty, ty+16, ty+32, ty+48

    int live = 0;
    if (tid < kTileRows) {
        const int e = e0 + tid;
        int r = -1;
        if (e < n_edges) {
            r = relation_of(off, n_rel, e);
            const float m = to_f(mask[e]);
            if (m == 0.0f) r = -1;        // padding: no message
            s_mask[tid] = m;
            const int s = src[e];
            s_src[tid] = ((unsigned)s < (unsigned)n_h) ? s : -1;
        } else {
            s_src[tid] = -1;
        }
        s_rel[tid] = r;
        live = (r >= 0);
    }
    if (!__syncthreads_or(live)) return;

    // the tile's relations are contiguous: walk from the first live edge's
    // relation to the last one's
    int r_lo = n_rel, r_hi = -1;
    for (int i = 0; i < kTileRows; ++i) {
        const int r = s_rel[i];
        if (r >= 0) { r_lo = min(r_lo, r); r_hi = max(r_hi, r); }
    }

    for (int r = r_lo; r <= r_hi; ++r) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

        const T* w = w_rel + (size_t)r * hid * k_out;
        for (int h0 = 0; h0 < hid; h0 += kChunk) {
            // masked source rows of this relation's live edges; other
            // rows stage zeros (their outputs are not written this pass)
            for (int i = tid; i < kTileRows * kChunk; i += kThreads) {
                const int row = i / kChunk, c = i % kChunk;
                const int s = s_src[row];
                float v = 0.0f;
                if (s_rel[row] == r && s >= 0 && h0 + c < hid)
                    v = mul_round(h[(size_t)s * hid + h0 + c], s_mask[row]);
                g_s[row][c] = v;
            }
            for (int i = tid; i < kChunk * kTileCols; i += kThreads) {
                const int hh = i / kTileCols, c = i % kTileCols;
                float v = 0.0f;
                if (h0 + hh < hid && k0 + c < k_out)
                    v = to_f(w[(size_t)(h0 + hh) * k_out + k0 + c]);
                w_s[hh][c] = v;
            }
            __syncthreads();
            const int depth = min(kChunk, hid - h0);
            for (int hh = 0; hh < depth; ++hh) {
                float a[4], b[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = g_s[ty + 16 * i][hh];
#pragma unroll
                for (int j = 0; j < 4; ++j) b[j] = w_s[hh][tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = ty + 16 * i;
            if (s_rel[row] != r) continue;
            float* out = msg + (size_t)(e0 + row) * k_out;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = k0 + tx + 16 * j;
                if (c < k_out) out[c] = acc[i][j];
            }
        }
    }
}

// one warp per destination row: out[d] = sum of msg[perm[j]] over
// j in [rowptr[d], rowptr[d+1]), in that (ascending edge) order
__global__ void gms_segment_kernel(const float* __restrict__ msg,
                                   const int* __restrict__ perm,
                                   const int* __restrict__ rowptr,
                                   int n_seg, int k_out,
                                   float* __restrict__ out) {
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= n_seg) return;
    const int j0 = rowptr[warp], j1 = rowptr[warp + 1];
    for (int c = lane; c < k_out; c += 32) {
        float acc = 0.0f;
        for (int j = j0; j < j1; ++j)
            acc += msg[(size_t)perm[j] * k_out + c];
        out[(size_t)warp * k_out + c] = acc;
    }
}

}  // namespace

// dtype: 0 = float32 operands, 1 = bfloat16 operands
extern "C" int gms_launch(
    int dtype, const void* h, int n_h, int hid, const void* w_rel, int n_rel,
    int k_out, const void* src, const void* mask, const void* off,
    int n_edges, const void* perm, const void* rowptr, int n_seg, void* msg,
    void* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_edges > 0 && n_rel > 0 && k_out > 0) {
        const dim3 grid((n_edges + kTileRows - 1) / kTileRows,
                        (k_out + kTileCols - 1) / kTileCols);
        if (dtype == 0) {
            gms_tile_kernel<float><<<grid, kThreads, 0, s>>>(
                (const float*)h, n_h, hid, (const float*)w_rel, n_rel, k_out,
                (const int*)src, (const float*)mask, (const int*)off,
                n_edges, (float*)msg);
        } else {
            gms_tile_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
                (const __nv_bfloat16*)h, n_h, hid,
                (const __nv_bfloat16*)w_rel, n_rel, k_out, (const int*)src,
                (const __nv_bfloat16*)mask, (const int*)off, n_edges,
                (float*)msg);
        }
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (n_seg > 0 && k_out > 0) {
        const int threads = 256;
        const int blocks = (int)(((long long)n_seg * 32 + threads - 1) / threads);
        gms_segment_kernel<<<blocks, threads, 0, s>>>(
            (const float*)msg, (const int*)perm, (const int*)rowptr, n_seg,
            k_out, (float*)out);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* gms_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
