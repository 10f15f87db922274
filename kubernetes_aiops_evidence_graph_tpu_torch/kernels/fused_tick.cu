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
// layer li reads buffer li % 2 and writes its output into the other. The
// tick is a chain of short kernels on the caller's stream rather than one
// persistent kernel with a grid-wide barrier per phase: every phase is a
// different parallel shape (one warp for the ordered scatter, 64-row
// tiles for the embed, runs of 64-edge tiles for the messages, blocks of
// 16 destinations for the ordered sums), and a kernel boundary is the
// barrier. The dst-CSR the ordered sums walk is built between the scatter
// and the forward by the wrapper (kernels/gms.py make_plan, a stable sort
// of the scattered edst), once per tick for all layers.
//
// Per layer, two kernels: the message pass's tile kernel writes msg, and
// its segment walk (gms_device.cuh) sums each destination's rows and then,
// in its epilogue, applies the update to the 16 destinations its block
// holds (UpdateEpilogue below): the aggregate never goes to device memory
// and back, and the update is not a launch of its own.
//
// What separates the entry points is what B4 adds to B3's contract: B3's
// wrapper allocates the two activation buffers per call; B4 takes the
// caller's persistent h_a / h_b (returned rewritten) and a float32,
// bfloat16 or int8 (per-column scale) feature table that the scatter
// updates and the embed dequantizes. B4's node_block is the JAX
// schedule's window (node_block rows of HBM streamed through VMEM at a
// time, on one core); the wrapper validates it as the JAX package does,
// and it does not reach this file: a row's result does not depend on the
// block that computes it, so both entry points run on the same grid and
// B4 gives the same bits at every node block.
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
// are ~15 MB (0.005 ms). This version does float32 FMA from shared
// memory (the message pass with w_rel held per run of tiles and its
// gathers in flight by cp.async, gms_device.cuh) and sends msg [E, H] to
// device memory and back each layer; the per-tick dst-CSR is a torch sort.
// Tensor cores, TMA pipelines and a hand-written CSR build are later work.
//
// Plain C interface for ctypes; each function returns the
// cudaGetLastError() code after its launches (0 = success).

#include <math_constants.h>

#include "gms_device.cuh"

namespace {

constexpr int kRowTile = 64;     // node rows per product tile
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
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

// (c) h = relu(feat @ embed_w + embed_b + kind_emb[kind]) * nmask, one
// 64-row tile and 64 columns per block
template <bool kBf16, typename Table>
__global__ void __launch_bounds__(kThreads) embed_kernel(
    Table feat, int dim, int pn, int hid, const float* __restrict__ ew,
    const float* __restrict__ eb, const float* __restrict__ ke, int n_kinds,
    const int* __restrict__ kind, const float* __restrict__ nmask,
    float* __restrict__ h) {
    __shared__ float a_s[kRowTile][kDepth + 1];
    __shared__ float w_s[kDepth][kColTile];
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int c0 = blockIdx.y * kColTile;
    const int r0 = blockIdx.x * kRowTile;
    const int nrows = min(kRowTile, pn - r0);
    float acc[4][4];
    row_tile_product<kBf16>(feat, r0, nrows, dim, ew, hid, c0, acc, a_s, w_s);
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

// (d) the update, around the segment walk (gms_device.cuh's hooks): per
// column pass the block's 16 destinations get
//     out[d][c] = relu(cur[d] @ w_self[:, c] + agg[d][c] * inv_deg[d]
//                      + b[c]) + cur[d][c]
// in place of the aggregate agg. The product is one fmaf chain over
// k = 0 .. hid - 1 from 0 with operands rounded per kBf16, then
// (product + agg * inv_deg) + b, relu, + cur: the float operations of the
// plain version's update, in its order. The product does not need agg,
// so it is formed while the walk's first chunk is in flight: begin()
// sends the first kD depths of w_self's column block (to the walk's
// scratch) and of the 16 cur rows, the 16 inv_deg and the 64 b values (to
// the epilogue's own shared memory) by cp.async; middle() forms the
// product in the registers of the threads that will hold agg (thread
// (col, lane): destinations lane + 4 i at column c0 + col, one w_self
// value and a broadcast float4 of cur per four FMAs); end() adds agg, b
// and the residual and writes out.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <bool kBf16>
struct UpdateEpilogue {
    const float* cur;       // [n_seg, hid], the layer's input
    const float* inv_deg;   // [n_seg]
    const float* ws;        // [hid, k_out], w_self
    const float* b;         // [k_out]
    int hid;

    static constexpr int kD = kSegRows;   // depths staged a step
    static constexpr int kMinBlocks = 4;  // at most 64 registers a thread

    struct State {
        float p[kSegPer];                 // the product, as acc in the walk
    };

    // cur rows [16][kD] (a copy of the input, not rounded), inv_deg [16]
    // and b [64] of the pass
    __device__ static float* region() {
        __shared__ __align__(16) float s[kSegDst * kD + kSegDst + kTileCols];
        return s;
    }

    // depths k0 .. k0 + kD - 1 of w_self's column block into w_s [kD][64]
    // and of the cur rows into region(): 16-byte cp.async pieces, or plain
    // loads where rows are not whole pieces
    __device__ void stage(const SegPass& p, int k0, float* w_s) const {
        float* x_s = region();
        const int depth = min(kD, hid - k0), tid = threadIdx.x;
        const bool vec = ((reinterpret_cast<uintptr_t>(ws) |
                           reinterpret_cast<uintptr_t>(cur)) & 15) == 0 &&
                         (p.k_out & 3) == 0 && (hid & 3) == 0;
        if (vec) {
            for (int i = tid; i < kD * kTileCols / 4; i += kSegThreads) {
                const int k = i / (kTileCols / 4), c = 4 * (i % (kTileCols / 4));
                if (k < depth && c < p.cw)
                    cp_async16(w_s + k * kTileCols + c,
                               ws + (size_t)(k0 + k) * p.k_out + p.c0 + c);
            }
            for (int i = tid; i < kSegDst * kD / 4; i += kSegThreads) {
                const int d = i / (kD / 4), k = 4 * (i % (kD / 4));
                if (d < p.nd && k < depth)
                    cp_async16(x_s + d * kD + k,
                               cur + (size_t)(p.d0 + d) * hid + k0 + k);
            }
        } else {
            for (int i = tid; i < kD * kTileCols; i += kSegThreads) {
                const int k = i / kTileCols, c = i % kTileCols;
                if (k < depth && c < p.cw)
                    w_s[i] = ws[(size_t)(k0 + k) * p.k_out + p.c0 + c];
            }
            for (int i = tid; i < kSegDst * kD; i += kSegThreads) {
                const int d = i / kD, k = i % kD;
                if (d < p.nd && k < depth)
                    x_s[d * kD + k] = cur[(size_t)(p.d0 + d) * hid + k0 + k];
            }
        }
    }

    __device__ void begin(const SegPass& p, State&, float* w_s) const {
        stage(p, 0, w_s);
        float* x_s = region();
        const int tid = threadIdx.x;
        if (tid < p.nd)
            cp_async4(x_s + kSegDst * kD + tid, inv_deg + p.d0 + tid);
        if (tid < p.cw)
            cp_async4(x_s + kSegDst * kD + kSegDst + tid, b + p.c0 + tid);
        cp_async_commit();
    }

    __device__ void middle(const SegPass& p, State& st, float* w_s,
                           bool walk_async) const {
        const float* x_s = region();
#pragma unroll
        for (int i = 0; i < kSegPer; ++i) st.p[i] = 0.0f;
        for (int k0 = 0; k0 < hid; k0 += kD) {
            if (k0 > 0) {
                stage(p, k0, w_s);
                cp_async_commit();
                cp_async_wait_all();
            } else if (walk_async) {
                cp_async_wait_one();   // ours; the walk's chunk flies on
            } else {
                cp_async_wait_all();
            }
            __syncthreads();
            const int depth = min(kD, hid - k0);
            const int quads = depth / 4;
            for (int kq = 0; kq < quads; ++kq) {
                float w[4];
#pragma unroll
                for (int t = 0; t < 4; ++t)
                    w[t] = operand<kBf16>(w_s[(4 * kq + t) * kTileCols + p.col]);
#pragma unroll
                for (int i = 0; i < kSegPer; ++i) {
                    const float4 x = *reinterpret_cast<const float4*>(
                        x_s + (p.lane + i * kSegLanes) * kD + 4 * kq);
                    st.p[i] = fmaf(operand<kBf16>(x.x), w[0], st.p[i]);
                    st.p[i] = fmaf(operand<kBf16>(x.y), w[1], st.p[i]);
                    st.p[i] = fmaf(operand<kBf16>(x.z), w[2], st.p[i]);
                    st.p[i] = fmaf(operand<kBf16>(x.w), w[3], st.p[i]);
                }
            }
            for (int k = 4 * quads; k < depth; ++k) {
                const float w = operand<kBf16>(w_s[k * kTileCols + p.col]);
#pragma unroll
                for (int i = 0; i < kSegPer; ++i)
                    st.p[i] = fmaf(
                        operand<kBf16>(x_s[(p.lane + i * kSegLanes) * kD + k]),
                        w, st.p[i]);
            }
            __syncthreads();   // w_s and the cur rows free again
        }
    }

    __device__ void end(const SegPass& p, const State& st,
                        const float (&agg)[kSegPer],
                        float* __restrict__ out) const {
        const float* x_s = region();
        const float* inv_s = x_s + kSegDst * kD;
        const float* b_s = inv_s + kSegDst;
        // the cur rows region() holds: the last kD depths staged
        const int k_last = (hid - 1) / kD * kD;
        if (p.col < p.cw) {
#pragma unroll
            for (int i = 0; i < kSegPer; ++i) {
                const int d = p.lane + i * kSegLanes;
                if (d >= p.nd) continue;
                const int r = p.d0 + d, c = p.c0 + p.col;
                const float res = c >= k_last && c < k_last + kD
                                      ? x_s[d * kD + c - k_last]
                                      : cur[(size_t)r * hid + c];
                // __fmul_rn: no contraction into an FMA, as in the
                // reference's separate product and sum
                const float v = st.p[i] + __fmul_rn(agg[i], inv_s[d]) +
                                b_s[p.col];
                out[(size_t)r * p.k_out + c] = relu(v) + res;
            }
        }
        __syncthreads();       // region() read: free for the next pass
    }

    static cudaError_t launch(int blocks, cudaStream_t s, const float* msg,
                              const int* perm, const int* rowptr, int n_seg,
                              int k_out, float* out, const UpdateEpilogue& e);
};

// the walk of the tick's layers: its sums become the layer's output
template <bool kBf16>
__global__ void __launch_bounds__(kSegThreads, UpdateEpilogue<kBf16>::kMinBlocks)
update_walk_kernel(const float* __restrict__ msg, const int* __restrict__ perm,
                   const int* __restrict__ rowptr, int n_seg, int k_out,
                   float* __restrict__ out, UpdateEpilogue<kBf16> epilogue) {
    segment_walk(msg, perm, rowptr, n_seg, k_out, out, epilogue);
}

template <bool kBf16>
cudaError_t UpdateEpilogue<kBf16>::launch(int blocks, cudaStream_t s,
                                          const float* msg, const int* perm,
                                          const int* rowptr, int n_seg,
                                          int k_out, float* out,
                                          const UpdateEpilogue& e) {
    update_walk_kernel<kBf16><<<blocks, kSegThreads, 0, s>>>(
        msg, perm, rowptr, n_seg, k_out, out, e);
    return cudaGetLastError();
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
    int pn, dim, hid, classes, n_kinds, n_rel, n_layers, n_runs, pi;
    const float* const* params;   // embed_w, embed_b, kind_emb, head_w, head_b
    const float* const* layers;   // per layer: w_self, w_rel, b
    const int* kind;
    const float* nmask;
    const int* esrc;
    const float* emask;
    const int* runs;              // the message pass's tile runs
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
    const dim3 grid((f.pn + kRowTile - 1) / kRowTile,
                    (f.hid + kColTile - 1) / kColTile);
    embed_kernel<kBf16, Table><<<grid, kThreads, 0, s>>>(
        feat, f.dim, f.pn, f.hid, f.params[0], f.params[1], f.params[2],
        f.n_kinds, f.kind, f.nmask, f.h_a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    for (int li = 0; li < f.n_layers; ++li) {
        const float* const* layer = f.layers + 3 * li;
        float* cur = li % 2 ? f.h_b : f.h_a;
        float* nxt = li % 2 ? f.h_a : f.h_b;
        const int rc = gms_pass<float, kBf16>(
            cur, f.pn, f.hid, layer[1], f.hid, f.esrc, f.emask, f.runs,
            f.n_runs, f.perm, f.rowptr, f.pn, f.msg, nxt, s,
            UpdateEpilogue<kBf16>{cur, f.inv_deg, layer[0], layer[2], f.hid});
        if (rc != 0) return rc;
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
                     const void* emask, const void* runs, int n_runs,
                     const void* perm, const void* rowptr, const void* inc,
                     int pi, void* inv_deg, void* msg, void* h_a, void* h_b,
                     void* logits, void* probs) {
    return Forward{pn, dim, hid, classes, n_kinds, n_rel, n_layers, n_runs,
                   pi, (const float* const*)params,
                   (const float* const*)layers, (const int*)kind,
                   (const float*)nmask, (const int*)esrc, (const float*)emask,
                   (const int*)runs, (const int*)perm, (const int*)rowptr,
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

// B3 (b)-(e): float32 features, the wrapper's buffers
extern "C" int fused_gnn_tick(
    int bf16, const void* features, int pn, int dim, int hid, int classes,
    int n_kinds, int n_rel, const void* const* params,
    const void* const* layers, int n_layers, const void* kind,
    const void* nmask, const void* esrc, const void* emask, const void* runs,
    int n_runs, const void* perm, const void* rowptr, const void* inc, int pi,
    void* inv_deg, void* msg, void* h_a, void* h_b, void* logits,
    void* probs, void* stream) {
    const Forward f = make_forward(
        pn, dim, hid, classes, n_kinds, n_rel, params, layers, n_layers, kind,
        nmask, esrc, emask, runs, n_runs, perm, rowptr, inc, pi, inv_deg, msg,
        h_a, h_b, logits, probs);
    return dispatch(bf16, f, F32Table{(const float*)features},
                    (cudaStream_t)stream);
}

// B4 (b)-(e): feat_type 0 = float32, 1 = bfloat16, 2 = int8 (times
// feat_scale per column); the caller's h_a/h_b
extern "C" int fused_gnn_tick_dma(
    int bf16, int feat_type, const void* features, const void* feat_scale,
    int pn, int dim, int hid, int classes, int n_kinds, int n_rel,
    const void* const* params, const void* const* layers, int n_layers,
    const void* kind, const void* nmask, const void* esrc, const void* emask,
    const void* runs, int n_runs, const void* perm, const void* rowptr,
    const void* inc, int pi, void* inv_deg, void* msg, void* h_a, void* h_b,
    void* logits, void* probs, void* stream) {
    const Forward f = make_forward(
        pn, dim, hid, classes, n_kinds, n_rel, params, layers, n_layers, kind,
        nmask, esrc, emask, runs, n_runs, perm, rowptr, inc, pi, inv_deg, msg,
        h_a, h_b, logits, probs);
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
