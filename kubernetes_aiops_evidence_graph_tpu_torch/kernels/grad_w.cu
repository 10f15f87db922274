// grad_w.cu — the weight gradient of the relation-bucketed message pass,
// for Hopper (sm_90a).
//
// Replaces, on the JAX package's training path:
// ops/pallas_segment.py::_grad_w_kernel (launched by _gms_grad_w, the w_rel
// half of the message pass's custom_vjp). For each relation slice
// r = [off[r], off[r+1]) of the edge arrays:
//     dw[r] = sum over e in slice r of (h[src[e]] * mask[e])^T  g[dst[e]]
// an [H, K] outer-product sum per relation, float32 sums; relations past
// the layout's slices (num_rels > slices) and slices with no work item get
// exact zeros.
//
// Two kernels, and their sums in a fixed order. On the TPU the grid runs
// in order on one core and the Pallas kernel adds each tile's product into
// a VMEM-resident [R, H, K] table. Blocks on Hopper run in parallel and in
// no order, and float atomics would change the order of the sums, and so
// their bits, from run to run. So:
//   * Work items (grad_w.py::work_items, cut on the host from the layout
//     alone): runs of whole 64-edge tiles of ONE relation's slice, the same
//     tile count for every item. The cut reaches the kernel as an argument
//     (GwLayout: the slices, each slice's first item, the item length), so
//     a block knows its edges without a round trip to memory.
//   * grad_w_items_kernel, one block per (item, 64-row block of H, column
//     group of K): a block owns 64 rows x 64/G columns of the item's
//     [H, K] partial, G = 1, 2 or 4 (grad_w.py::col_groups: more blocks,
//     and more threads with fewer outputs each, where the items alone
//     cannot fill the card).
//   * Staging, a ring of kBufs buffers of kStage edges (32 at G = 1, 2;
//     64 at G = 4): threads of the first warps read a stage's src/dst/mask
//     (a live edge has mask != 0 and src, dst in range) and ballot which
//     edges live and which have a mask other than 1; then the block sends
//     each live edge's row of h (its 64 columns) and of g (its column
//     group) to shared memory as 16-byte cp.async pieces, neighbouring
//     threads on neighbouring pieces. Stage t + kBufs - 1 is in flight
//     while stage t computes, and the indices of the stage after it are
//     read meanwhile. A stage's h rows are multiplied by their masks in
//     place (skipped where every mask is 1: h * 1 is h, but for a NaN's
//     payload, which the fmaf makes canonical anyway), or for bfloat16 h
//     converted and rounded to bfloat16 (mul_round<kBf16>, as the JAX
//     kernel forms the operand), and its live edges are listed in
//     ascending order.
//   * Sums: each thread holds a kRm x kCn register tile of the partial
//     (8 x 8 at G = 1, 8 x 4 at G = 2, 4 x 2 at G = 4), fed by float4 (or
//     float2) shared loads; every partial element is one fmaf chain over
//     the item's live edges in ascending order, starting from 0, whatever
//     the tiling or G. A relation's only item writes dw[r] = 0 + its
//     sums; the others write partial[item].
//   * grad_w_sum_kernel, one thread per element of dw: a relation of two
//     or more items gets its partials (read with __ldcg) summed in item
//     order from 0; a relation of no item, or past the layout's slices, 0.
// Every element of dw is therefore formed by the same float operations in
// the same order as the first version's: the same bits on every run, under
// every G. No float atomics. One launch, the relation's last block folding
// its partials behind an integer counter, measured slower than the second
// kernel wherever a relation has many items (PERF.md, Findings): one block
// then reads all of that relation's partials alone.
//
// Bound on an H100 at the learned path's widths (H = K = 64): operations,
// 2 * live * H * K over the float32 rate outside the tensor cores; the
// bytes (each distinct gathered row of h and g once, 12 B per live edge,
// dw written once; grad_w.py::bound) take less. At G = 1 a thread's 64
// FMAs an edge need four float4 shared loads, so the shared-memory pipe
// and the FMA pipe are about equally busy. Left for later: tensor cores
// (wgmma, or 3xTF32 / bf16 products: other bits, to be held to the 1e-5
// contract), a producer warp for the staging, fusing with the dh pass of
// the backward, and CUDA graphs for the host's dispatch of the training
// step.
//
// Plain C interface for ctypes: grad_w_launch returns the cudaGetLastError()
// code after the launches (0 = success).

#include "gms_device.cuh"

namespace {

constexpr int kGwRows = 64;      // rows of H a block
constexpr int kMaxSlices = 32;   // relation slices a layout may have

// the layout's cut into work items, passed by value (no memory round trip
// before a block knows its edges): slice r is offs[r] .. offs[r+1], its
// items rel_items[r] .. rel_items[r+1], runs of per_item edges from offs[r]
struct GwLayout {
    int n_slices, per_item;
    int offs[kMaxSlices + 1];
    int rel_items[kMaxSlices + 1];
};
constexpr int kGwHStride = kGwRows + 4;   // floats a staged h row (+16 B)
constexpr int kSumThreads = 256;

// at G column groups: kRm rows x kCn columns a thread, kThreads threads
// a block, kStage edges a pipeline step, kBufs buffers in the ring, and
// kBlocks blocks an SM holds (shared memory; the register cap). One column
// group feeds 64 FMAs from four float4 shared loads; four column groups
// are for layouts of few items, where the chain of a thread, not the
// card's rate, sets the time: more threads, fewer outputs each, one stage
// a 64-edge tile.
template <int kGroups> struct GwTile;
template <> struct GwTile<1> {
    static constexpr int kRm = 8, kCn = 8, kThreads = 64, kStage = 32,
                         kBufs = 3, kBlocks = 4;
};
template <> struct GwTile<2> {
    static constexpr int kRm = 8, kCn = 4, kThreads = 64, kStage = 32,
                         kBufs = 3, kBlocks = 5;
};
template <> struct GwTile<4> {
    static constexpr int kRm = 4, kCn = 2, kThreads = 128, kStage = 64,
                         kBufs = 2, kBlocks = 4;
};

// a count known at compile time, usable where an int is
template <int N> struct Fixed {
    __host__ __device__ constexpr operator int() const { return N; }
};

__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int kGroups>
struct GwShape {
    static constexpr int kCols = kGwRows / kGroups;       // K columns a block
    static constexpr int kGStride = kCols + 4;            // floats a g row
    static constexpr int kRm = GwTile<kGroups>::kRm;
    static constexpr int kCn = GwTile<kGroups>::kCn;
    static constexpr int kThreads = GwTile<kGroups>::kThreads;
    static constexpr int kTx = kCols / kCn, kTy = kGwRows / kRm;
    static_assert(kTx * kTy == kThreads && kRm % 4 == 0 &&
                      (kCn % 4 == 0 || kCn == 2),
                  "the register tiles cover the block's outputs");
};

// dynamic shared memory, in this order: kBufs h buffers (kStage rows of
// kGwHStride floats, or of 64 + 8 bfloat16), for bfloat16 the converted
// operand ([kStage][kGwHStride] floats), kBufs g buffers ([kStage]
// [kGStride]), then per buffer the stage's sources, destinations, masks,
// live lists, ballots and live counts
template <typename T, int kGroups>
struct GwSmem {
    static constexpr int kGwStage = GwTile<kGroups>::kStage;
    static constexpr int kB = GwTile<kGroups>::kBufs;
    static constexpr int kHRaw = sizeof(T) == 4 ? kGwHStride * 4
                                                : (kGwRows + 8) * 2;
    static constexpr size_t h_buf = kB * (size_t)kGwStage * kHRaw;
    static constexpr size_t a_op = sizeof(T) == 4
        ? 0 : (size_t)kGwStage * kGwHStride * 4;
    static constexpr size_t g_buf =
        kB * (size_t)kGwStage * GwShape<kGroups>::kGStride * 4;
    static constexpr size_t tail = kB * kGwStage * 4 * 4  // src dst mask list
                                   + kB * 4 * 4 + kB * 4; // ballots, counts
    static constexpr size_t bytes = h_buf + a_op + g_buf + tail;
};

// One block per (work item, 64-row block of H, column group of K). A
// relation with one item gets dw[r] = 0 + the block's sums; otherwise the
// sums go to partial[item] for grad_w_sum_kernel.
template <typename T, bool kBf16, int kGroups>
__global__ void __launch_bounds__(GwTile<kGroups>::kThreads,
                                  GwTile<kGroups>::kBlocks)
grad_w_items_kernel(
    const T* __restrict__ h, int n_h, int hid,
    const float* __restrict__ g, int n_g, int k_out,
    const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ mask, const GwLayout layout,
    float* __restrict__ partial, float* __restrict__ dw) {
    using S = GwShape<kGroups>;
    using M = GwSmem<T, kGroups>;
    constexpr int kRm = S::kRm, kCn = S::kCn, kCols = S::kCols;
    constexpr int kGwThreads = S::kThreads;
    constexpr int kGwStage = GwTile<kGroups>::kStage;
    constexpr int kB = GwTile<kGroups>::kBufs, kAhead = kB - 1;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* h_raw = smem;                                // [kB][stage]
    float* a_op = reinterpret_cast<float*>(smem + M::h_buf);    // bf16 only
    float* g_s = reinterpret_cast<float*>(smem + M::h_buf + M::a_op);
    int* s_src = reinterpret_cast<int*>(g_s + kB * kGwStage * S::kGStride);
    int* s_dst = s_src + kB * kGwStage;                         // [kB][stage]
    float* s_mask = reinterpret_cast<float*>(s_dst + kB * kGwStage);
    int* s_list = reinterpret_cast<int*>(s_mask + kB * kGwStage);
    unsigned* s_bal = reinterpret_cast<unsigned*>(s_list + kB * kGwStage);
    int* s_n = reinterpret_cast<int*>(s_bal + 4 * kB);          // [kB]

    const int tid = threadIdx.x;
    const int item = blockIdx.x;
    int rel = 0;
    while (rel + 1 < layout.n_slices && layout.rel_items[rel + 1] <= item)
        ++rel;
    const int lo = layout.offs[rel] +
                   (item - layout.rel_items[rel]) * layout.per_item;
    const int hi = min(layout.offs[rel + 1], lo + layout.per_item);
    const int n_stages = (hi - lo + kGwStage - 1) / kGwStage;
    const int h0 = blockIdx.y * kGwRows;
    const int k0 = blockIdx.z * kCols;
    const int tx = tid % S::kTx, ty = tid / S::kTx;
    // thread (tx, ty): rows 4ty + {0..3} + 4 kTy q, columns 4tx + {0..3} +
    // 4 kTx p (2tx + {0, 1} at kCn = 2), so that a warp's vector loads of
    // a staged row hit distinct banks
    auto row_of = [&](int i) { return (i / 4) * 4 * S::kTy + 4 * ty + i % 4; };
    auto col_of = [&](int j) {
        return kCn == 2 ? 2 * tx + j : (j / 4) * 4 * S::kTx + 4 * tx + j % 4;
    };
    const int h_cols = min(kGwRows, hid - h0);
    const int g_cols = min(kCols, k_out - k0);
    const bool h_vec = (reinterpret_cast<uintptr_t>(h) & 15) == 0 &&
                       (hid * (int)sizeof(T)) % 16 == 0;
    const bool g_vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0 &&
                       k_out % 4 == 0;

    // threads tid < kGwStage: edge `tid` of a stage, read into registers,
    // then into buffer b's index arrays with its warp's ballots: the live
    // edges, and the live edges whose mask is not 1
    int s = 0, d = 0;
    float m = 0.0f;
    auto fetch = [&](int t) {
        const int e = lo + t * kGwStage + tid;
        m = 0.0f;
        if (e < hi) {
            m = mask[e];
            s = src[e];
            d = dst[e];
        }
    };
    auto index = [&](int b) {
        const bool live = m != 0.0f && (unsigned)s < (unsigned)n_h &&
                          (unsigned)d < (unsigned)n_g;
        const unsigned bal = __ballot_sync(0xffffffffu, live);
        const unsigned odd = __ballot_sync(0xffffffffu, live && m != 1.0f);
        if (tid % 32 == 0) {
            s_bal[4 * b + tid / 32] = bal;
            s_bal[4 * b + 2 + tid / 32] = odd;
        }
        s_src[b * kGwStage + tid] = s;
        s_dst[b * kGwStage + tid] = d;
        s_mask[b * kGwStage + tid] = m;
    };
    auto is_live = [&](int b, int row) {
        return (s_bal[4 * b + row / 32] >> (row % 32)) & 1u;
    };
    // buffer b's live rows of h and g: neighbouring threads take
    // neighbouring 16-byte pieces of one row (cp.async, all in flight)
    auto issue = [&](int b) {
        // pieces: a compile-time constant for whole rows, so that the row
        // and piece of i cost a shift
        auto copy_h = [&](auto pieces) {
            for (int i = tid; i < kGwStage * pieces; i += kGwThreads) {
                const int row = i / pieces, p = i % pieces;
                if (!is_live(b, row)) continue;
                cp_async16(h_raw + ((size_t)b * kGwStage + row) * M::kHRaw +
                               16 * p,
                           reinterpret_cast<const unsigned char*>(
                               h + (size_t)s_src[b * kGwStage + row] * hid +
                               h0) + 16 * p);
            }
        };
        auto copy_g = [&](float* gb, auto pieces) {
            for (int i = tid; i < kGwStage * pieces; i += kGwThreads) {
                const int row = i / pieces, p = i % pieces;
                if (!is_live(b, row)) continue;
                cp_async16(gb + row * S::kGStride + 4 * p,
                           g + (size_t)s_dst[b * kGwStage + row] * k_out +
                               k0 + 4 * p);
            }
        };
        if (h_vec && h_cols == kGwRows) {
            copy_h(Fixed<kGwRows * (int)sizeof(T) / 16>{});
        } else if (h_vec) {
            copy_h(h_cols * (int)sizeof(T) / 16);
        } else {
            for (int i = tid; i < kGwStage * h_cols; i += kGwThreads) {
                const int row = i / h_cols, c = i % h_cols;
                if (!is_live(b, row)) continue;
                reinterpret_cast<T*>(h_raw + ((size_t)b * kGwStage + row) *
                                                 M::kHRaw)[c] =
                    h[(size_t)s_src[b * kGwStage + row] * hid + h0 + c];
            }
        }
        float* gb = g_s + (size_t)b * kGwStage * S::kGStride;
        if (g_vec && g_cols == kCols) {
            copy_g(gb, Fixed<kCols / 4>{});
        } else if (g_vec) {
            copy_g(gb, g_cols / 4);
        } else {
            for (int i = tid; i < kGwStage * g_cols; i += kGwThreads) {
                const int row = i / g_cols, c = i % g_cols;
                if (!is_live(b, row)) continue;
                gb[row * S::kGStride + c] =
                    g[(size_t)s_dst[b * kGwStage + row] * k_out + k0 + c];
            }
        }
        cp_async_commit();
    };
    // buffer b's operand: h * mask (bf16: converted and rounded) for the
    // live rows, and the live rows' list in ascending order
    auto prepare = [&](int b) {
        const unsigned b0 = s_bal[4 * b];
        const unsigned b1 = kGwStage > 32 ? s_bal[4 * b + 1] : 0u;
        if (tid < kGwStage) {
            const unsigned mine = tid < 32 ? b0 : b1;
            const int lane = tid % 32;
            if ((mine >> lane) & 1u)
                s_list[b * kGwStage + (tid < 32 ? 0 : __popc(b0)) +
                       __popc(mine & ((1u << lane) - 1u))] = tid;
            if (tid == 0) s_n[b] = __popc(b0) + __popc(b1);
        }
        // float32 h times a mask of 1 is h itself, but for a NaN's payload,
        // and the product's fmaf gives the canonical NaN either way
        if (sizeof(T) == 4 &&
            !(s_bal[4 * b + 2] | (kGwStage > 32 ? s_bal[4 * b + 3] : 0u)))
            return;
        for (int i = tid; i < kGwStage * (kGwRows / 4); i += kGwThreads) {
            const int row = i / (kGwRows / 4), q = i % (kGwRows / 4);
            if (!is_live(b, row) || 4 * q >= h_cols) continue;
            const float mk = s_mask[b * kGwStage + row];
            unsigned char* raw =
                h_raw + ((size_t)b * kGwStage + row) * M::kHRaw;
            T v[4];
            load4(reinterpret_cast<const T*>(raw) + 4 * q, v);
            float4 o;
            o.x = mul_round<kBf16>(v[0], mk);
            o.y = mul_round<kBf16>(v[1], mk);
            o.z = mul_round<kBf16>(v[2], mk);
            o.w = mul_round<kBf16>(v[3], mk);
            float* op = sizeof(T) == 4   // f32: in place
                ? reinterpret_cast<float*>(raw)
                : a_op + (size_t)row * kGwHStride;
            *reinterpret_cast<float4*>(op + 4 * q) = o;
        }
    };
    auto load_ops = [&](const float* ar, const float* gr, int e,
                        float (&a)[kRm], float (&bb)[kCn]) {
        const float* ap = ar + (size_t)e * kGwHStride;
#pragma unroll
        for (int q = 0; q < kRm / 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(
                ap + q * 4 * S::kTy + 4 * ty);
            a[4 * q] = v.x, a[4 * q + 1] = v.y, a[4 * q + 2] = v.z,
            a[4 * q + 3] = v.w;
        }
        const float* bp = gr + (size_t)e * S::kGStride;
        if constexpr (kCn == 2) {
            const float2 v = *reinterpret_cast<const float2*>(bp + 2 * tx);
            bb[0] = v.x, bb[1] = v.y;
        } else {
#pragma unroll
            for (int q = 0; q < kCn / 4; ++q) {
                const float4 v = *reinterpret_cast<const float4*>(
                    bp + q * 4 * S::kTx + 4 * tx);
                bb[4 * q] = v.x, bb[4 * q + 1] = v.y, bb[4 * q + 2] = v.z,
                bb[4 * q + 3] = v.w;
            }
        }
    };
    float acc[kRm][kCn];
#pragma unroll
    for (int i = 0; i < kRm; ++i)
#pragma unroll
        for (int j = 0; j < kCn; ++j) acc[i][j] = 0.0f;
    auto fma_all = [&](const float (&a)[kRm], const float (&bb)[kCn]) {
#pragma unroll
        for (int i = 0; i < kRm; ++i)
#pragma unroll
            for (int j = 0; j < kCn; ++j)
                acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    };

    // kAhead stages' rows in flight ahead of the one that computes, and
    // the indices of the stage after them read meanwhile
    if (tid < kGwStage) fetch(0);
    for (int j = 0; j < kAhead && j < n_stages; ++j) {
        if (tid < kGwStage) {
            index(j);
            if (j + 1 < n_stages) fetch(j + 1);
        }
        __syncthreads();
        issue(j);
    }
    for (int t = 0; t < n_stages; ++t) {
        const int b = t % kB;
        const int next = t + kAhead;     // the stage sent this step
        if (kAhead > 1 && min(next - 1, n_stages - 1) > t)
            cp_async_wait_one();         // stage t has landed, t + 1 flies
        else
            cp_async_wait_all();
        __syncthreads();                 // stage t in buffer b; t - 1's free
        prepare(b);
        if (next < n_stages && tid < kGwStage) {
            index(next % kB);
            if (next + 1 < n_stages) fetch(next + 1);
        }
        __syncthreads();                 // stage t's operand, next's rows
        if (next < n_stages) issue(next % kB);   // in flight from here
        const int n = s_n[b];
        const int* list = s_list + b * kGwStage;
        const float* ar = sizeof(T) == 4
            ? reinterpret_cast<const float*>(h_raw + (size_t)b * kGwStage *
                                                         M::kHRaw)
            : a_op;
        const float* gr = g_s + (size_t)b * kGwStage * S::kGStride;
        // live edges in ascending order, the next edge's operands loaded
        // while this edge's FMAs issue
        if (n > 0) {
            float a0[kRm], b0[kCn], a1[kRm], b1[kCn];
            load_ops(ar, gr, list[0], a0, b0);
            int j = 0;
            for (; j + 2 <= n; j += 2) {
                load_ops(ar, gr, list[j + 1], a1, b1);
                fma_all(a0, b0);
                if (j + 2 < n) load_ops(ar, gr, list[j + 2], a0, b0);
                fma_all(a1, b1);
            }
            if (j < n) fma_all(a0, b0);
        }
    }

    const bool alone = layout.rel_items[rel + 1] - layout.rel_items[rel] == 1;
    float* out = alone ? dw + (size_t)rel * hid * k_out
                       : partial + (size_t)item * hid * k_out;
#pragma unroll
    for (int i = 0; i < kRm; ++i) {
        const int row = h0 + row_of(i);
#pragma unroll
        for (int j = 0; j < kCn; ++j) {
            const int c = k0 + col_of(j);
            // a relation's only item: dw[r] = 0 + its sums, as the sum
            // kernel would form it
            if (row < hid && c < k_out)
                out[(size_t)row * k_out + c] = alone ? 0.0f + acc[i][j]
                                                     : acc[i][j];
        }
    }
}

// dw[r] for the relations of no item or of two or more: 0, or the items'
// partials summed in item order from 0 (one thread an element); relations
// >= n_slices get 0, and relations of one item were written by
// grad_w_items_kernel.
__global__ void __launch_bounds__(kSumThreads) grad_w_sum_kernel(
    const float* __restrict__ partial, const GwLayout layout, int num_rels,
    int hk, float* __restrict__ dw) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)num_rels * hk) return;
    const int r = (int)(idx / hk), j = (int)(idx % hk);
    const bool sliced = r < layout.n_slices;
    const int first = sliced ? layout.rel_items[r] : 0;
    const int n = sliced ? layout.rel_items[r + 1] - first : 0;
    if (n == 1) return;
    float acc = 0.0f;
#pragma unroll 8
    for (int it = first; it < first + n; ++it)
        acc += __ldcg(partial + (size_t)it * hk + j);
    dw[idx] = acc;
}

template <typename T, bool kBf16, int kGroups>
int grad_w_pass(const T* h, int n_h, int hid, const float* g, int n_g,
                int k_out, const int* src, const int* dst, const float* mask,
                const GwLayout& layout, int num_rels, float* partial,
                float* dw, cudaStream_t s) {
    if (hid == 0 || k_out == 0) return (int)cudaSuccess;
    const int n_items = layout.rel_items[layout.n_slices];
    if (n_items > 0) {
        constexpr int kCols = GwShape<kGroups>::kCols;
        const size_t bytes = GwSmem<T, kGroups>::bytes;
        auto kernel = grad_w_items_kernel<T, kBf16, kGroups>;
        if (bytes > 48 * 1024) {
            const cudaError_t err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)bytes);
            if (err != cudaSuccess) return (int)err;
        }
        const dim3 grid(n_items, (hid + kGwRows - 1) / kGwRows,
                        (k_out + kCols - 1) / kCols);
        kernel<<<grid, GwTile<kGroups>::kThreads, bytes, s>>>(
            h, n_h, hid, g, n_g, k_out, src, dst, mask, layout, partial, dw);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const int hk = hid * k_out;
    const long long total = (long long)num_rels * hk;
    if (total > 0)
        grad_w_sum_kernel<<<(int)((total + kSumThreads - 1) / kSumThreads),
                             kSumThreads, 0, s>>>(partial, layout, num_rels,
                                                  hk, dw);
    return (int)cudaGetLastError();
}

template <typename T, bool kBf16>
int grad_w_groups(int col_groups, const T* h, int n_h, int hid,
                  const float* g, int n_g, int k_out, const int* src,
                  const int* dst, const float* mask, const GwLayout& layout,
                  int num_rels, float* partial, float* dw, cudaStream_t s) {
    switch (col_groups) {
        case 1:
            return grad_w_pass<T, kBf16, 1>(h, n_h, hid, g, n_g, k_out, src,
                                            dst, mask, layout, num_rels,
                                            partial, dw, s);
        case 2:
            return grad_w_pass<T, kBf16, 2>(h, n_h, hid, g, n_g, k_out, src,
                                            dst, mask, layout, num_rels,
                                            partial, dw, s);
        case 4:
            return grad_w_pass<T, kBf16, 4>(h, n_h, hid, g, n_g, k_out, src,
                                            dst, mask, layout, num_rels,
                                            partial, dw, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32 h, 1 = bfloat16 h; offs [n_slices + 1] and
// rel_items [n_slices + 1] (host arrays): the layout's slices and each
// slice's first work item, items of per_item edges; col_groups: 1, 2 or 4
extern "C" int grad_w_launch(
    int dtype, const void* h, int n_h, int hid, const void* g, int n_g,
    int k_out, const void* src, const void* dst, const void* mask,
    const int* offs, const int* rel_items, int n_slices, int per_item,
    int num_rels, int col_groups, void* partial, void* dw, void* stream) {
    if (n_slices < 0 || n_slices > kMaxSlices || per_item <= 0)
        return (int)cudaErrorInvalidValue;
    GwLayout layout{};
    layout.n_slices = n_slices;
    layout.per_item = per_item;
    for (int r = 0; r <= n_slices; ++r) {
        layout.offs[r] = offs[r];
        layout.rel_items[r] = rel_items[r];
    }
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return grad_w_groups<float, false>(
            col_groups, (const float*)h, n_h, hid, (const float*)g, n_g,
            k_out, (const int*)src, (const int*)dst, (const float*)mask,
            layout, num_rels, (float*)partial, (float*)dw, s);
    return grad_w_groups<__nv_bfloat16, true>(
        col_groups, (const __nv_bfloat16*)h, n_h, hid, (const float*)g, n_g,
        k_out, (const int*)src, (const int*)dst, (const float*)mask, layout,
        num_rels, (float*)partial, (float*)dw, s);
}

extern "C" const char* grad_w_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
