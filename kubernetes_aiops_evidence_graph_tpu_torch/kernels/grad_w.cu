// grad_w.cu — the weight gradient of the relation-bucketed message pass,
// for Hopper (sm_90a).
//
// Replaces, on the JAX package's training path:
// ops/pallas_segment.py::_grad_w_kernel (launched by _gms_grad_w, the w_rel
// half of the message pass's custom_vjp). For each relation slice
// r = [off[r], off[r+1]) of the edge arrays:
//     dw[r] = sum over e in slice r of (h[src[e]] * mask[e])^T  g[dst[e]]
// an [H, K] outer-product sum per relation, float32 sums; relations past
// the layout's slices (num_rels > slices) and slices with no live edge get
// exact zeros.
//
// Why two kernels, and not the Pallas design. On the TPU the grid runs in
// order on one core, so the Pallas kernel adds each 64-edge tile's
// [H, 64] x [64, K] product into a VMEM-resident [R, H, K] table. Blocks on
// Hopper run in parallel and in no order, and float atomics would make the
// sum's order, and so its bits, change from run to run. Hence:
//   (a) grad_w_partial_kernel: one block per work item, a run of whole
//       64-edge tiles of ONE relation's slice (the wrapper cuts every slice
//       into items of the same tile count, on the host, from the layout
//       alone), and one 64 x 64 block of the [H, K] output. Per tile the
//       block stages the 64 gathered rows h[src] * mask (64 x 64 floats,
//       16 KB) and the 64 cotangent rows g[dst] (16 KB) in shared memory;
//       each of 256 threads then accumulates its 4 x 4 share of the output
//       in registers, edge by edge in ascending index (f32 FMA), skipping
//       edges with mask 0 (a uniform branch: every thread sees the same
//       edge). The item's partial goes to partial[item, H, K].
//   (b) grad_w_reduce_kernel: one thread per dw element sums its
//       relation's items in item order (that is, edge order) and writes
//       dw[r]; relations with no item get 0.
// Both are the same on every run, bit for bit; no float atomics.
//
// Operands: h float32, or bfloat16 (the compute dtype of the forward: the
// gathered row h * mask is rounded to bfloat16 as the JAX kernel forms it),
// g and mask float32 (mask already rounded to the compute dtype by the
// wrapper), dw float32. Any H, K, R and off[] (unaligned and zero-width
// slices, E = 0).
//
// Bound on an H100 at the learned path's widths (H = K = 64): operations,
// 2 * live * H * K over the float32 rate outside the tensor cores; the bytes
// (each distinct gathered row of h and g once, 12 B per live edge, dw
// written once; grad_w.py::bound) take far less. This first version stages
// through shared memory with plain FMA; wgmma, TMA and fusing with the dh
// pass are later work.
//
// Plain C interface for ctypes: grad_w_launch returns the cudaGetLastError()
// code after the launches (0 = success).

#include "gms_device.cuh"

namespace {

constexpr int kGwEdges = 64;     // edges staged per step (EDGE_TILE)
constexpr int kGwTile = 64;      // output rows (H) and columns (K) per block
constexpr int kGwThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

// items[3 * i + {0, 1, 2}] = relation, first edge, end edge of item i
template <typename T, bool kBf16>
__global__ void __launch_bounds__(kGwThreads) grad_w_partial_kernel(
    const T* __restrict__ h, int n_h, int hid,
    const float* __restrict__ g, int n_g, int k_out,
    const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ mask, const int* __restrict__ items,
    float* __restrict__ partial) {
    __shared__ float a_s[kGwEdges][kGwTile];   // h[src] * mask, this h block
    __shared__ float b_s[kGwEdges][kGwTile];   // g[dst], this k block
    __shared__ int s_src[kGwEdges];
    __shared__ int s_dst[kGwEdges];
    __shared__ float s_mask[kGwEdges];
    __shared__ int s_live[kGwEdges];

    const int tid = threadIdx.x;
    const int item = blockIdx.x;
    const int lo = items[3 * item + 1], hi = items[3 * item + 2];
    const int h0 = blockIdx.y * kGwTile;
    const int k0 = blockIdx.z * kGwTile;
    const int tx = tid % 16;             // columns tx, tx+16, tx+32, tx+48
    const int ty = tid / 16;             // rows ty, ty+16, ty+32, ty+48

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int e0 = lo; e0 < hi; e0 += kGwEdges) {
        __syncthreads();                 // the previous tile is consumed
        if (tid < kGwEdges) {
            const int e = e0 + tid;
            int live = 0, s = -1, d = -1;
            float m = 0.0f;
            if (e < hi) {
                m = mask[e];
                s = src[e];
                d = dst[e];
                live = m != 0.0f && (unsigned)s < (unsigned)n_h
                       && (unsigned)d < (unsigned)n_g;
            }
            s_src[tid] = s;
            s_dst[tid] = d;
            s_mask[tid] = m;
            s_live[tid] = live;
        }
        __syncthreads();
        for (int i = tid; i < kGwEdges * kGwTile; i += kGwThreads) {
            const int row = i / kGwTile, c = i % kGwTile;
            float av = 0.0f, bv = 0.0f;
            if (s_live[row]) {
                if (h0 + c < hid)
                    av = mul_round<kBf16>(h[(size_t)s_src[row] * hid + h0 + c],
                                          s_mask[row]);
                if (k0 + c < k_out)
                    bv = g[(size_t)s_dst[row] * k_out + k0 + c];
            }
            a_s[row][c] = av;
            b_s[row][c] = bv;
        }
        __syncthreads();
        const int n = min(kGwEdges, hi - e0);
        for (int e = 0; e < n; ++e) {
            if (!s_live[e]) continue;    // same edge for every thread
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = a_s[e][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = b_s[e][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    }
    float* out = partial + (size_t)item * hid * k_out;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = h0 + ty + 16 * i;
        if (r >= hid) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = k0 + tx + 16 * j;
            if (c < k_out) out[(size_t)r * k_out + c] = acc[i][j];
        }
    }
}

// dw[r, j] = sum of partial[it, j] for it in [rel_items[r], rel_items[r+1])
// in that order; relations >= n_slices get 0
__global__ void grad_w_reduce_kernel(const float* __restrict__ partial,
                                     const int* __restrict__ rel_items,
                                     int n_slices, int num_rels, int hk,
                                     float* __restrict__ dw) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)num_rels * hk) return;
    const int r = (int)(idx / hk), j = (int)(idx % hk);
    float acc = 0.0f;
    if (r < n_slices)
        for (int it = rel_items[r]; it < rel_items[r + 1]; ++it)
            acc += partial[(size_t)it * hk + j];
    dw[idx] = acc;
}

template <typename T, bool kBf16>
int grad_w_pass(const T* h, int n_h, int hid, const float* g, int n_g,
                int k_out, const int* src, const int* dst, const float* mask,
                const int* items, int n_items, const int* rel_items,
                int n_slices, int num_rels, float* partial, float* dw,
                cudaStream_t s) {
    if (n_items > 0 && hid > 0 && k_out > 0) {
        const dim3 grid(n_items, (hid + kGwTile - 1) / kGwTile,
                        (k_out + kGwTile - 1) / kGwTile);
        grad_w_partial_kernel<T, kBf16><<<grid, kGwThreads, 0, s>>>(
            h, n_h, hid, g, n_g, k_out, src, dst, mask, items, partial);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const long long total = (long long)num_rels * hid * k_out;
    if (total > 0) {
        const int threads = 256;
        const int blocks = (int)((total + threads - 1) / threads);
        grad_w_reduce_kernel<<<blocks, threads, 0, s>>>(
            partial, rel_items, n_slices, num_rels, hid * k_out, dw);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 h, 1 = bfloat16 h
extern "C" int grad_w_launch(
    int dtype, const void* h, int n_h, int hid, const void* g, int n_g,
    int k_out, const void* src, const void* dst, const void* mask,
    const void* items, int n_items, const void* rel_items, int n_slices,
    int num_rels, void* partial, void* dw, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return grad_w_pass<float, false>(
            (const float*)h, n_h, hid, (const float*)g, n_g, k_out,
            (const int*)src, (const int*)dst, (const float*)mask,
            (const int*)items, n_items, (const int*)rel_items, n_slices,
            num_rels, (float*)partial, (float*)dw, s);
    return grad_w_pass<__nv_bfloat16, true>(
        (const __nv_bfloat16*)h, n_h, hid, (const float*)g, n_g, k_out,
        (const int*)src, (const int*)dst, (const float*)mask,
        (const int*)items, n_items, (const int*)rel_items, n_slices,
        num_rels, (float*)partial, (float*)dw, s);
}

extern "C" const char* grad_w_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
