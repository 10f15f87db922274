// gms_device.cuh — the device code of the relation-bucketed message pass,
// shared by gms.cu (the message pass on its own) and fused_tick.cu (the
// fused serving tick, which runs it once per layer). See gms.cu for the
// design: a tile kernel writes each live edge's message row, then one warp
// per destination adds that destination's rows in ascending edge index
// over a dst-CSR. No floating-point atomics.
#pragma once

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
__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16(x));
}
// a matmul operand: float32 as is, or rounded to bfloat16 (the JAX
// kernels' compute dtype cast; products and sums stay float32)
template <bool kBf16>
__device__ __forceinline__ float operand(float x) {
    return kBf16 ? round_bf16(x) : x;
}
// h * mask in the operand type (m is the mask value, exact in float):
// float32 as is, rounded to bfloat16 for bfloat16 operands (the JAX
// kernels multiply in the compute dtype, or cast the product to it)
template <bool kBf16>
__device__ __forceinline__ float mul_round(float a, float m) {
    return operand<kBf16>(a * m);
}
template <bool kBf16>
__device__ __forceinline__ float mul_round(__nv_bfloat16 a, float m) {
    return round_bf16(__bfloat162float(a) * m);
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

// T: the storage type of h, w_rel and mask (float or bfloat16); kBf16:
// round float32 operands to bfloat16 as they are staged
template <typename T, bool kBf16>
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
                    v = mul_round<kBf16>(h[(size_t)s * hid + h0 + c],
                                         s_mask[row]);
                g_s[row][c] = v;
            }
            for (int i = tid; i < kChunk * kTileCols; i += kThreads) {
                const int hh = i / kTileCols, c = i % kTileCols;
                float v = 0.0f;
                if (h0 + hh < hid && k0 + c < k_out)
                    v = operand<kBf16>(
                        to_f(w[(size_t)(h0 + hh) * k_out + k0 + c]));
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

// the tile kernel then the segment walk, on stream s; returns the
// cudaGetLastError() code after the launches
template <typename T, bool kBf16>
int gms_pass(const T* h, int n_h, int hid, const T* w_rel, int n_rel,
             int k_out, const int* src, const T* mask, const int* off,
             int n_edges, const int* perm, const int* rowptr, int n_seg,
             float* msg, float* out, cudaStream_t s) {
    if (n_edges > 0 && n_rel > 0 && k_out > 0) {
        const dim3 grid((n_edges + kTileRows - 1) / kTileRows,
                        (k_out + kTileCols - 1) / kTileCols);
        gms_tile_kernel<T, kBf16><<<grid, kThreads, 0, s>>>(
            h, n_h, hid, w_rel, n_rel, k_out, src, mask, off, n_edges, msg);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (n_seg > 0 && k_out > 0) {
        const int threads = 256;
        const int blocks = (int)(((long long)n_seg * 32 + threads - 1) / threads);
        gms_segment_kernel<<<blocks, threads, 0, s>>>(msg, perm, rowptr, n_seg,
                                                      k_out, out);
    }
    return (int)cudaGetLastError();
}

}  // namespace
