// fused_tick.cu — the GNN serving tick of the learned RCA path for Hopper
// (sm_90a): delta scatter -> degree -> embed -> L x (message pass +
// update) -> readout and masked softmax.
//
// Replaces, on the JAX package's path:
//   B3 ops/pallas_segment.py::_fused_kernel_factory (the fused tick,
//      pallas_fused_gnn_tick), entry point fused_gnn_tick;
//   B4 ops/pallas_segment.py::_dma_kernel_factory (the streamed tick,
//      pallas_fused_gnn_tick_dma, with its bf16/int8 feature tables),
//      entry point fused_gnn_tick_dma.
// Both compute, per tick:
//   scatter the packed aux delta (kind, nmask[, quantized feature rows]) and
//     edge delta (src, dst, rel, mask) into the resident mirrors in place;
//     an index out of range is dropped, a repeated index: the last wins;
//   deg[d] = sum of emask over the edges into d; inv_deg = 1/deg or 0;
//   h = relu(feat @ embed_w + embed_b + kind_emb[kind]) * nmask;
//   per layer: agg = the relation-bucketed message pass (gms_device.cuh),
//     h' = relu(h @ w_self + agg * inv_deg + b) + h;
//   logits = h[inc] @ head_w + head_b; probs = softmax(logits) * inc_mask.
// Products in float32 FMA, or with operands rounded to bfloat16 and float32
// sums (compute_dtype "bfloat16", the Pallas kernels' mm).
//
// Where the activations live, and why. The TPU kernels keep [N, H] in VMEM
// (B3) or stream it through VMEM windows from HBM (B4). A Hopper block has
// at most 227 KB of shared memory and [N, H] at config 4 (N 65,536, H 64)
// is 16.8 MB, so in BOTH entry points the activations live in device
// memory, two [N, H] float32 buffers that fit the 50 MB L2 together:
// layer li reads buffer li % 2 and writes its aggregate, then its output,
// into the other. The tick is a chain of short kernels on the caller's
// stream rather than one persistent kernel with a grid-wide barrier per
// phase: every phase is a different parallel shape (one warp for the
// ordered scatter, 64-row tiles for the products, one warp per
// destination for the ordered sums), and a kernel boundary is the
// barrier. The dst-CSR the ordered sums walk is built between the scatter
// and the forward by the wrapper (kernels/gms.py make_plan, a stable sort
// of the scattered edst), once per tick for all layers.
//
// What separates the entry points is what B4 adds to B3's contract: B3's
// wrapper allocates the two activation buffers per call and blocks the
// embed and update by 64-row tiles; B4 takes the caller's persistent h_a /
// h_b (returned rewritten), node_block rows per block in the embed and
// update, and a float32, bfloat16 or int8 (per-column scale) feature
// table that the scatter updates and the embed dequantizes.
//
// Order and determinism. The scatter runs in ONE warp that walks each
// delta in entry order, 32 entries at a time: equal indices within a
// chunk resolve to the highest lane (__match_any_sync), and __syncwarp()
// orders one chunk's stores before the next one's, so the last entry wins
// exactly. Degree and aggregate sum each destination's edges in ascending
// edge index over the dst-CSR; every product sums its depth in ascending
// order; the softmax reduces with a fixed shuffle tree. No floating-point
// atomics: two launches give the same bits.
//
// Bound on an H100 at config 4's resident shape (Pn 65,536, DIM 48, H 64,
// L 3, 64,014 live edges, Pi 512, 11 classes): operations,
// 2 (Pn DIM H + L (live H H + Pn H H) + Pi H C) = 3.6e9 float32 operations
// = 0.054 ms at 67 TFLOP/s; the bytes the tick must read and write once
// are ~15 MB (0.005 ms). This first version does float32 FMA from shared
// memory, sends msg [E, H] to device memory and back each layer, and
// blocks B4's embed and update by node_block rows (32 blocks at 2048).
// Tensor cores, TMA / cp.async pipelines and fusing the segment walk are
// later work.
//
// Plain C interface for ctypes; each function returns the
// cudaGetLastError() code after its launches (0 = success).

#include <math_constants.h>

#include "gms_device.cuh"

namespace {

constexpr int kRowTile = 64;     // node rows per product tile
constexpr int kColTile = 64;     // output columns per block
constexpr int kDepth = 32;       // depth staged per step

// the rows of a product's left operand
struct F32Table {
    const float* p;
    __device__ float operator()(size_t i, int) const { return p[i]; }
};
struct Bf16Table {
    const __nv_bfloat16* p;
    __device__ float operator()(size_t i, int) const {
        return __bfloat162float(p[i]);
    }
};
struct Int8Table {            // dequantized: q * scale[column]
    const int8_t* p;
    const float* scale;
    __device__ float operator()(size_t i, int col) const {
        return (float)p[i] * scale[col];
    }
};

__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// acc[i][j] = sum over k < depth of A[r0 + ty + 16i][k] * W[k][c0 + tx + 16j]
// for A rows [r0, r0 + nrows) (missing rows read as 0), W [depth, w_cols]
// row-major; operands rounded per kBf16, k in ascending order.
template <bool kBf16, typename Table>
__device__ void row_tile_product(Table a, int r0, int nrows, int depth,
                                 const float* __restrict__ w, int w_cols,
                                 int c0, float (&acc)[4][4],
                                 float (*a_s)[kDepth + 1],
                                 float (*w_s)[kColTile]) {
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < depth; k0 += kDepth) {
        for (int i = tid; i < kRowTile * kDepth; i += kThreads) {
            const int row = i / kDepth, k = i % kDepth;
            float v = 0.0f;
            if (row < nrows && k0 + k < depth)
                v = operand<kBf16>(a((size_t)(r0 + row) * depth + k0 + k,
                                     k0 + k));
            a_s[row][k] = v;
        }
        for (int i = tid; i < kDepth * kColTile; i += kThreads) {
            const int k = i / kColTile, c = i % kColTile;
            float v = 0.0f;
            if (k0 + k < depth && c0 + c < w_cols)
                v = operand<kBf16>(w[(size_t)(k0 + k) * w_cols + c0 + c]);
            w_s[k][c] = v;
        }
        __syncthreads();
        const int steps = min(kDepth, depth - k0);
        for (int k = 0; k < steps; ++k) {
            float x[4], y[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) x[i] = a_s[ty + 16 * i][k];
#pragma unroll
            for (int j = 0; j < 4; ++j) y[j] = w_s[k][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
        }
        __syncthreads();
    }
}

// (a) the delta scatter: warp 0 walks the aux delta, warp 1 the edge delta
__global__ void scatter_kernel(const int* __restrict__ ints, int pk, int ek,
                               int pn, int pe, int* kind, float* nmask,
                               int* esrc, int* edst, int* erel, float* emask,
                               const uint8_t* __restrict__ fq_rows,
                               uint8_t* feat_q, int row_bytes) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp > 1) return;
    const bool aux = warp == 0;
    const int n = aux ? pk : ek;
    const int bound = aux ? pn : pe;
    const int* idx = aux ? ints : ints + 3 * pk;
    const int* e = ints + 3 * pk;
    for (int j0 = 0; j0 < n; j0 += 32) {
        const int j = j0 + lane;
        const int i = j < n ? idx[j] : -1;
        const bool in = j < n && (unsigned)i < (unsigned)bound;
        const unsigned group = __match_any_sync(0xffffffffu, in ? i : -1);
        if (in && 31 - __clz((int)group) == lane) {
            if (aux) {
                kind[i] = ints[pk + j];
                nmask[i] = (float)ints[2 * pk + j];
                if (feat_q != nullptr)
                    for (int b = 0; b < row_bytes; ++b)
                        feat_q[(size_t)i * row_bytes + b] =
                            fq_rows[(size_t)j * row_bytes + b];
            } else {
                esrc[i] = e[ek + j];
                edst[i] = e[2 * ek + j];
                erel[i] = e[3 * ek + j];
                emask[i] = (float)e[4 * ek + j];
            }
        }
        __syncwarp();
    }
}

// (b) inv_deg[d] from the masks of d's edges, in CSR (ascending) order
__global__ void inv_degree_kernel(const int* __restrict__ perm,
                                  const int* __restrict__ rowptr,
                                  const float* __restrict__ emask, int pn,
                                  float* __restrict__ inv_deg) {
    const int d = blockIdx.x * blockDim.x + threadIdx.x;
    if (d >= pn) return;
    float deg = 0.0f;
    for (int j = rowptr[d]; j < rowptr[d + 1]; ++j) deg += emask[perm[j]];
    inv_deg[d] = deg > 0.0f ? 1.0f / fmaxf(deg, 1.0f) : 0.0f;
}

// (c) h = relu(feat @ embed_w + embed_b + kind_emb[kind]) * nmask, for the
// block's rows_per_block rows in 64-row tiles
template <bool kBf16, typename Table>
__global__ void __launch_bounds__(kThreads) embed_kernel(
    Table feat, int dim, int pn, int hid, const float* __restrict__ ew,
    const float* __restrict__ eb, const float* __restrict__ ke, int n_kinds,
    const int* __restrict__ kind, const float* __restrict__ nmask,
    int rows_per_block, float* __restrict__ h) {
    __shared__ float a_s[kRowTile][kDepth + 1];
    __shared__ float w_s[kDepth][kColTile];
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int c0 = blockIdx.y * kColTile;
    const int b0 = blockIdx.x * rows_per_block;
    const int b1 = min(b0 + rows_per_block, pn);
    for (int r0 = b0; r0 < b1; r0 += kRowTile) {
        const int nrows = min(kRowTile, b1 - r0);
        float acc[4][4];
        row_tile_product<kBf16>(feat, r0, nrows, dim, ew, hid, c0, acc, a_s,
                                w_s);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = ty + 16 * i;
            if (row >= nrows) continue;
            const int r = r0 + row;
            const int k = min(max(kind[r], 0), n_kinds - 1);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = c0 + tx + 16 * j;
                if (c >= hid) continue;
                const float v = acc[i][j] + eb[c] + ke[(size_t)k * hid + c];
                h[(size_t)r * hid + c] = relu(v) * nmask[r];
            }
        }
    }
}

// (d) the update, in place on nxt (which holds the aggregate):
// nxt = relu(cur @ w_self + nxt * inv_deg + b) + cur
template <bool kBf16>
__global__ void __launch_bounds__(kThreads) update_kernel(
    const float* __restrict__ cur, float* nxt,
    const float* __restrict__ inv_deg, const float* __restrict__ ws,
    const float* __restrict__ b, int pn, int hid, int rows_per_block) {
    __shared__ float a_s[kRowTile][kDepth + 1];
    __shared__ float w_s[kDepth][kColTile];
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int c0 = blockIdx.y * kColTile;
    const int b0 = blockIdx.x * rows_per_block;
    const int b1 = min(b0 + rows_per_block, pn);
    for (int r0 = b0; r0 < b1; r0 += kRowTile) {
        const int nrows = min(kRowTile, b1 - r0);
        float acc[4][4];
        row_tile_product<kBf16>(F32Table{cur}, r0, nrows, hid, ws, hid, c0,
                                acc, a_s, w_s);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = ty + 16 * i;
            if (row >= nrows) continue;
            const int r = r0 + row;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = c0 + tx + 16 * j;
                if (c >= hid) continue;
                const size_t at = (size_t)r * hid + c;
                // __fmul_rn: no contraction into an FMA, as in the
                // reference's separate product and sum
                const float v = acc[i][j] + __fmul_rn(nxt[at], inv_deg[r])
                                + b[c];
                nxt[at] = relu(v) + cur[at];
            }
        }
    }
}

// (e) one warp per incident row: logits = h[inc] @ head_w + head_b, probs =
// softmax(logits) * inc_mask
template <bool kBf16>
__global__ void readout_kernel(const float* __restrict__ h, int pn, int hid,
                               const int* __restrict__ inc, int pi,
                               const float* __restrict__ hw,
                               const float* __restrict__ hb, int classes,
                               float* __restrict__ logits,
                               float* __restrict__ probs) {
    const int i = blockIdx.x, lane = threadIdx.x;
    const int r = min(max(inc[i], 0), pn - 1);
    const float* hr = h + (size_t)r * hid;
    float* lo = logits + (size_t)i * classes;
    float mx = -CUDART_INF_F;
    for (int c = lane; c < classes; c += 32) {
        float acc = 0.0f;
        for (int k = 0; k < hid; ++k)
            acc = fmaf(operand<kBf16>(hr[k]),
                       operand<kBf16>(hw[(size_t)k * classes + c]), acc);
        lo[c] = acc + hb[c];
        mx = fmaxf(mx, lo[c]);
    }
    for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int c = lane; c < classes; c += 32) sum += expf(lo[c] - mx);
    for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float m = (float)inc[pi + i];
    for (int c = lane; c < classes; c += 32)
        probs[(size_t)i * classes + c] = expf(lo[c] - mx) / sum * m;
}

struct Forward {
    int pn, dim, hid, classes, n_kinds, n_rel, n_layers, pe, pi;
    int rows_per_block;
    const float* const* params;   // embed_w, embed_b, kind_emb, head_w, head_b
    const float* const* layers;   // per layer: w_self, w_rel, b
    const int* kind;
    const float* nmask;
    const int* esrc;
    const float* emask;
    const int* off;
    const int* perm;
    const int* rowptr;
    const int* inc;               // [pi] incident rows, then [pi] masks
    float* inv_deg;
    float* msg;
    float* h_a;
    float* h_b;
    float* logits;
    float* probs;
};

// (b)-(e) on stream s, after the scatter and the dst-CSR
template <bool kBf16, typename Table>
int run_forward(const Forward& f, Table feat, cudaStream_t s) {
    cudaError_t err;
    inv_degree_kernel<<<(f.pn + 255) / 256, 256, 0, s>>>(
        f.perm, f.rowptr, f.emask, f.pn, f.inv_deg);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const dim3 grid((f.pn + f.rows_per_block - 1) / f.rows_per_block,
                    (f.hid + kColTile - 1) / kColTile);
    embed_kernel<kBf16, Table><<<grid, kThreads, 0, s>>>(
        feat, f.dim, f.pn, f.hid, f.params[0], f.params[1], f.params[2],
        f.n_kinds, f.kind, f.nmask, f.rows_per_block, f.h_a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    for (int li = 0; li < f.n_layers; ++li) {
        const float* const* layer = f.layers + 3 * li;
        float* cur = li % 2 ? f.h_b : f.h_a;
        float* nxt = li % 2 ? f.h_a : f.h_b;
        const int rc = gms_pass<float, kBf16>(
            cur, f.pn, f.hid, layer[1], f.n_rel, f.hid, f.esrc, f.emask,
            f.off, f.pe, f.perm, f.rowptr, f.pn, f.msg, nxt, s);
        if (rc != 0) return rc;
        update_kernel<kBf16><<<grid, kThreads, 0, s>>>(
            cur, nxt, f.inv_deg, layer[0], layer[2], f.pn, f.hid,
            f.rows_per_block);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    if (f.pi <= 0) return 0;
    readout_kernel<kBf16><<<f.pi, 32, 0, s>>>(
        f.n_layers % 2 ? f.h_b : f.h_a, f.pn, f.hid, f.inc, f.pi,
        f.params[3], f.params[4], f.classes, f.logits, f.probs);
    return (int)cudaGetLastError();
}

template <typename Table>
int dispatch(int bf16, const Forward& f, Table feat, cudaStream_t s) {
    return bf16 ? run_forward<true>(f, feat, s) : run_forward<false>(f, feat, s);
}

Forward make_forward(int pn, int dim, int hid, int classes, int n_kinds,
                     int n_rel, const void* const* params,
                     const void* const* layers, int n_layers,
                     const void* kind, const void* nmask, const void* esrc,
                     const void* emask, const void* off, int pe,
                     const void* perm, const void* rowptr, const void* inc,
                     int pi, void* inv_deg, void* msg, void* h_a, void* h_b,
                     void* logits, void* probs, int rows_per_block) {
    return Forward{pn, dim, hid, classes, n_kinds, n_rel, n_layers, pe, pi,
                   rows_per_block, (const float* const*)params,
                   (const float* const*)layers, (const int*)kind,
                   (const float*)nmask, (const int*)esrc, (const float*)emask,
                   (const int*)off, (const int*)perm, (const int*)rowptr,
                   (const int*)inc, (float*)inv_deg, (float*)msg,
                   (float*)h_a, (float*)h_b, (float*)logits, (float*)probs};
}

}  // namespace

// (a): the packed delta into the mirrors (and fq_rows into feat_q, when
// given: row_bytes bytes per row)
extern "C" int fused_tick_scatter(
    const void* ints, int pk, int ek, int pn, int pe, void* kind, void* nmask,
    void* esrc, void* edst, void* erel, void* emask, const void* fq_rows,
    void* feat_q, int row_bytes, void* stream) {
    if (pk > 0 || ek > 0)
        scatter_kernel<<<1, 64, 0, (cudaStream_t)stream>>>(
            (const int*)ints, pk, ek, pn, pe, (int*)kind, (float*)nmask,
            (int*)esrc, (int*)edst, (int*)erel, (float*)emask,
            (const uint8_t*)fq_rows, (uint8_t*)feat_q, row_bytes);
    return (int)cudaGetLastError();
}

// B3 (b)-(e): float32 features, 64-row tiles, the wrapper's buffers
extern "C" int fused_gnn_tick(
    int bf16, const void* features, int pn, int dim, int hid, int classes,
    int n_kinds, int n_rel, const void* const* params,
    const void* const* layers, int n_layers, const void* kind,
    const void* nmask, const void* esrc, const void* emask, const void* off,
    int pe, const void* perm, const void* rowptr, const void* inc, int pi,
    void* inv_deg, void* msg, void* h_a, void* h_b, void* logits,
    void* probs, void* stream) {
    const Forward f = make_forward(
        pn, dim, hid, classes, n_kinds, n_rel, params, layers, n_layers, kind,
        nmask, esrc, emask, off, pe, perm, rowptr, inc, pi, inv_deg, msg, h_a,
        h_b, logits, probs, kRowTile);
    return dispatch(bf16, f, F32Table{(const float*)features},
                    (cudaStream_t)stream);
}

// B4 (b)-(e): feat_type 0 = float32, 1 = bfloat16, 2 = int8 (times
// feat_scale per column); node_block rows per block; the caller's h_a/h_b
extern "C" int fused_gnn_tick_dma(
    int bf16, int feat_type, const void* features, const void* feat_scale,
    int node_block, int pn, int dim, int hid, int classes, int n_kinds,
    int n_rel, const void* const* params, const void* const* layers,
    int n_layers, const void* kind, const void* nmask, const void* esrc,
    const void* emask, const void* off, int pe, const void* perm,
    const void* rowptr, const void* inc, int pi, void* inv_deg, void* msg,
    void* h_a, void* h_b, void* logits, void* probs, void* stream) {
    const Forward f = make_forward(
        pn, dim, hid, classes, n_kinds, n_rel, params, layers, n_layers, kind,
        nmask, esrc, emask, off, pe, perm, rowptr, inc, pi, inv_deg, msg, h_a,
        h_b, logits, probs, node_block);
    cudaStream_t s = (cudaStream_t)stream;
    if (feat_type == 1)
        return dispatch(bf16, f,
                        Bf16Table{(const __nv_bfloat16*)features}, s);
    if (feat_type == 2)
        return dispatch(bf16, f,
                        Int8Table{(const int8_t*)features,
                                  (const float*)feat_scale}, s);
    return dispatch(bf16, f, F32Table{(const float*)features}, s);
}

extern "C" const char* fused_tick_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
