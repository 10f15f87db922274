// gms_device.cuh — the device code of the relation-bucketed message pass,
// shared by gms.cu (the message pass on its own) and fused_tick.cu (the
// fused serving tick, which runs it once per layer); grad_w.cu takes its
// operand helpers. See gms.cu for the design: a tile kernel writes each
// live edge's message row, walking runs of one relation's tiles with
// w_rel[r] held in shared memory and the next gather in flight (cp.async);
// then a walk adds each destination's rows in ascending edge index over a
// dst-CSR, staging them in shared memory a chunk ahead. No floating-point
// atomics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTileRows = 64;      // edges per tile (EDGE_TILE)
constexpr int kTileCols = 64;      // output columns per block
constexpr int kChunk = 32;         // h columns gathered per pipeline stage
constexpr int kTileThreads = 128;
constexpr int kTileBlocks = 6;     // resident blocks an SM holds at H = 64
constexpr int kRm = 8, kCn = 4;    // outputs a thread: kRm rows x kCn columns
constexpr int kTx = kTileCols / kCn, kTy = kTileRows / kRm;
static_assert(kTx * kTy == kTileThreads && kRm % 4 == 0 && kCn % 4 == 0,
              "the register tile covers the block tile");
constexpr int kRunTiles = 16;      // most tiles in one run (gms.py)
constexpr int kMaxHid = 768;       // w_rel[r]'s column block in shared memory
constexpr int kSegDst = 16;        // destinations per block in the walk
constexpr int kSegRows = 64;       // message rows staged per chunk
constexpr int kSegThreads = 256;   // 64 columns x 4 destination lanes
constexpr int kSegPer = kSegDst / (kSegThreads / kTileCols);  // sums a thread
constexpr int kSegStage = kSegRows * kTileCols / 4 / kSegThreads;  // pieces

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

// bytes of one gathered row chunk in shared memory: kChunk values and a
// 16-byte pad, so that reading one 4-value group of consecutive rows hits
// distinct banks
template <typename T>
__host__ __device__ constexpr int raw_stride() {
    return kChunk * (int)sizeof(T) + 16;
}

// dynamic shared memory of gms_tile_kernel at depth hid
template <typename T>
size_t gms_tile_smem(int hid) {
    return (size_t)hid * kTileCols * 4           // w_s: w_rel[r]'s column block
           + (size_t)kChunk * kTileRows * 4      // a_s: the operand, transposed
           + (size_t)kTileRows * raw_stride<T>() // raw: the gathered chunk
           + 2 * kTileRows * 8                   // src, mask of two tiles
           + (2 * kRunTiles + 1) * 4;            // live flags, tiles, count
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four consecutive values of a staged row (16 B of float, 8 B of bf16)
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };
template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&v)[4]) {
    const typename Vec4<T>::type q =
        *reinterpret_cast<const typename Vec4<T>::type*>(p);
    memcpy(v, &q, sizeof q);
}

// depth step k of a unit: the thread's kRm gathered values (a_s is
// [kChunk][kTileRows]) and kCn weights (w_s row d0 + k), as float4 loads
__device__ __forceinline__ void load_operands(const float* a_s,
                                              const float* w_s, int d0,
                                              int k, int tx, int ty,
                                              float (&a)[kRm],
                                              float (&bb)[kCn]) {
#pragma unroll
    for (int g = 0; g < kRm / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            a_s + k * kTileRows + g * 4 * kTy + 4 * ty);
        a[4 * g] = v.x, a[4 * g + 1] = v.y, a[4 * g + 2] = v.z,
        a[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < kCn / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            w_s + (size_t)(d0 + k) * kTileCols + q * 4 * kTx + 4 * tx);
        bb[4 * q] = v.x, bb[4 * q + 1] = v.y, bb[4 * q + 2] = v.z,
        bb[4 * q + 3] = v.w;
    }
}

// one depth step of every output the thread holds: acc[i][j] += a[i] *
// bb[j] as one fmaf, so each output is an fmaf chain in depth order
__device__ __forceinline__ void fma_step(const float (&a)[kRm],
                                         const float (&bb)[kCn],
                                         float (&acc)[kRm][kCn]) {
#pragma unroll
    for (int i = 0; i < kRm; ++i)
#pragma unroll
        for (int j = 0; j < kCn; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
}

// One block per (run, 64-column block): runs[3 * i + {0, 1, 2}] =
// relation, first edge, end edge of run i, at most kRunTiles 64-edge
// tiles of one relation's slice. The block stages w_rel[r]'s column block
// once for all of H, skips tiles without a live edge, and pipelines the
// rest in units of (tile, kChunk columns of h): while it computes one
// unit, cp.async gathers the next unit's h[src] rows into `raw`. A unit's
// rows are then masked and rounded (mul_round) into a_s, transposed, and
// each thread adds 8 rows x 4 columns of FMAs per depth step from two
// float4 loads of a_s and one of w_s, the next step's loads issued before
// this step's FMAs. At H = 64 an SM holds six blocks (shared memory), and
// the register cap keeps it so. msg[e][c] is the fmaf chain over
// h's columns 0 .. H-1 in ascending order from 0: the bits of the plain
// per-edge product. Only live rows (mask != 0) are written; a live row
// with a source out of range gathers zeros.
template <typename T, bool kBf16>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks) gms_tile_kernel(
    const T* __restrict__ h, int n_h, int hid,
    const T* __restrict__ w_rel, int k_out,
    const int* __restrict__ src, const T* __restrict__ mask,
    const int* __restrict__ runs, float* __restrict__ msg) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* w_s = reinterpret_cast<float*>(smem);            // [hid][64]
    float* a_s = w_s + (size_t)hid * kTileCols;             // [kChunk][64]
    unsigned char* raw = reinterpret_cast<unsigned char*>(
        a_s + kChunk * kTileRows);                          // [64][stride]
    int* s_src = reinterpret_cast<int*>(raw + kTileRows * raw_stride<T>());
    float* s_mask = reinterpret_cast<float*>(s_src + 2 * kTileRows);
    int* s_flag = reinterpret_cast<int*>(s_mask + 2 * kTileRows);
    int* s_tiles = s_flag + kRunTiles;                      // + count

    const int tid = threadIdx.x;
    const int r = runs[3 * blockIdx.x];
    const int lo = runs[3 * blockIdx.x + 1], hi = runs[3 * blockIdx.x + 2];
    const int k0 = blockIdx.y * kTileCols;
    const int n_tiles = (hi - lo + kTileRows - 1) / kTileRows;

    // the run's tiles that hold a live edge, in order
    if (tid < kRunTiles) s_flag[tid] = 0;
    __syncthreads();
    for (int i = tid; i < hi - lo; i += kTileThreads)
        if (to_f(mask[lo + i]) != 0.0f) s_flag[i / kTileRows] = 1;
    __syncthreads();
    if (tid == 0) {
        int n = 0;
        for (int t = 0; t < n_tiles; ++t)
            if (s_flag[t]) s_tiles[n++] = t;
        s_tiles[kRunTiles] = n;
    }
    __syncthreads();
    const int n_live = s_tiles[kRunTiles];
    if (n_live == 0) return;

    // the tile's sources (-1: no gather) and masks, for tiles < 64 threads
    auto fetch = [&](int li, int& s, float& m) {
        const int e = lo + s_tiles[li] * kTileRows + tid;
        s = -1;
        m = 0.0f;
        if (e < hi) {
            m = to_f(mask[e]);
            const int sv = src[e];
            if (m != 0.0f && (unsigned)sv < (unsigned)n_h) s = sv;
        }
    };
    if (tid < kTileRows) {
        int s;
        float m;
        fetch(0, s, m);
        s_src[tid] = s;
        s_mask[tid] = m;
    }
    const T* w = w_rel + (size_t)r * hid * k_out;
    for (int i = tid; i < hid * kTileCols; i += kTileThreads) {
        const int kk = i / kTileCols, c = i % kTileCols;
        w_s[i] = k0 + c < k_out
                     ? operand<kBf16>(to_f(w[(size_t)kk * k_out + k0 + c]))
                     : 0.0f;
    }
    __syncthreads();

    const int n_chunks = hid > 0 ? (hid + kChunk - 1) / kChunk : 1;
    const int n_units = n_live * n_chunks;
    const bool vec = (reinterpret_cast<uintptr_t>(h) & 15) == 0 &&
                     (hid * (int)sizeof(T)) % 16 == 0;

    // gather unit u's rows into raw: 16-byte cp.async pieces, or plain
    // loads where rows are not 16-byte aligned
    auto issue = [&](int u) {
        const int b = (u / n_chunks) & 1, d0 = (u % n_chunks) * kChunk;
        const int steps = max(0, min(kChunk, hid - d0));
        const int* ss = s_src + b * kTileRows;
        if (vec) {
            const int pieces = steps * (int)sizeof(T) / 16;
            for (int i = tid; i < kTileRows * pieces; i += kTileThreads) {
                const int row = i / pieces, p = i % pieces;
                const int s = ss[row];
                if (s >= 0)
                    cp_async16(raw + row * raw_stride<T>() + p * 16,
                               reinterpret_cast<const unsigned char*>(
                                   h + (size_t)s * hid + d0) + p * 16);
            }
            cp_async_commit();
        } else {
            for (int i = tid; i < kTileRows * steps; i += kTileThreads) {
                const int row = i / steps, k = i % steps;
                const int s = ss[row];
                if (s >= 0)
                    reinterpret_cast<T*>(raw + row * raw_stride<T>())[k] =
                        h[(size_t)s * hid + d0 + k];
            }
        }
    };
    issue(0);

    // thread (tx, ty): rows 4ty + {0..3} + 4 kTy g, columns 4tx + {0..3} +
    // 4 kTx q: a warp's float4 loads of a_s and w_s hit distinct banks
    const int tx = tid % kTx, ty = tid / kTx;
    float acc[kRm][kCn];
#pragma unroll
    for (int i = 0; i < kRm; ++i)
#pragma unroll
        for (int j = 0; j < kCn; ++j) acc[i][j] = 0.0f;

    for (int u = 0; u < n_units; ++u) {
        const int li = u / n_chunks, ch = u % n_chunks, b = li & 1;
        const int steps = max(0, min(kChunk, hid - ch * kChunk));
        const int* ss = s_src + b * kTileRows;
        const float* sm = s_mask + b * kTileRows;
        // the next tile's sources and masks, loaded under this unit's wait
        const bool pre = ch == 0 && li + 1 < n_live && tid < kTileRows;
        int ps = -1;
        float pm = 0.0f;
        if (pre) fetch(li + 1, ps, pm);
        cp_async_wait_all();
        __syncthreads();   // raw holds unit u; a_s is free
        if ((steps & 3) == 0) {
            const int quads = steps / 4;
            for (int i = tid; i < kTileRows * quads; i += kTileThreads) {
                const int row = i % kTileRows, q = i / kTileRows;
                const int s = ss[row];
                T v[4];
                if (s >= 0)
                    load4(reinterpret_cast<const T*>(
                              raw + row * raw_stride<T>()) + 4 * q, v);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    a_s[(4 * q + kk) * kTileRows + row] =
                        s >= 0 ? mul_round<kBf16>(v[kk], sm[row]) : 0.0f;
            }
        } else {
            for (int i = tid; i < kTileRows * steps; i += kTileThreads) {
                const int row = i % kTileRows, k = i / kTileRows;
                const int s = ss[row];
                a_s[k * kTileRows + row] =
                    s >= 0 ? mul_round<kBf16>(reinterpret_cast<const T*>(
                                 raw + row * raw_stride<T>())[k], sm[row])
                           : 0.0f;
            }
        }
        if (pre) {
            s_src[(b ^ 1) * kTileRows + tid] = ps;
            s_mask[(b ^ 1) * kTileRows + tid] = pm;
        }
        __syncthreads();   // a_s holds unit u; raw and the next tile's rows
        if (u + 1 < n_units) issue(u + 1);

        // a full chunk runs unrolled, the next step's operands loaded
        // while this step's FMAs issue; a short last chunk step by step
        float a[2][kRm], bb[2][kCn];
        if (steps == kChunk) {
            load_operands(a_s, w_s, ch * kChunk, 0, tx, ty, a[0], bb[0]);
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
                if (k + 1 < kChunk)
                    load_operands(a_s, w_s, ch * kChunk, k + 1, tx, ty,
                                  a[(k + 1) & 1], bb[(k + 1) & 1]);
                fma_step(a[k & 1], bb[k & 1], acc);
            }
        } else {
            for (int k = 0; k < steps; ++k) {
                load_operands(a_s, w_s, ch * kChunk, k, tx, ty, a[0], bb[0]);
                fma_step(a[0], bb[0], acc);
            }
        }

        if (ch == n_chunks - 1) {   // the tile is done: its live rows out
            const int e0 = lo + s_tiles[li] * kTileRows;
#pragma unroll
            for (int i = 0; i < kRm; ++i) {
                const int row = (i / 4) * 4 * kTy + 4 * ty + i % 4;
#pragma unroll
                for (int q = 0; q < kCn / 4; ++q) {
                    const int c = k0 + q * 4 * kTx + 4 * tx;
                    if (sm[row] == 0.0f || c >= k_out) continue;
                    float* o = msg + (size_t)(e0 + row) * k_out + c;
                    if ((k_out & 3) == 0) {
                        *reinterpret_cast<float4*>(o) = make_float4(
                            acc[i][4 * q], acc[i][4 * q + 1],
                            acc[i][4 * q + 2], acc[i][4 * q + 3]);
                    } else {
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            if (c + j < k_out) o[j] = acc[i][4 * q + j];
                    }
                }
#pragma unroll
                for (int j = 0; j < kCn; ++j) acc[i][j] = 0.0f;
            }
        }
    }
}

// One block per kSegDst consecutive destinations d0 .. d0 + 15. Their
// CSR entries perm[rowptr[d0]] .. perm[rowptr[d0 + 16] - 1] are staged in
// chunks of kSegRows message rows: cp.async brings the next chunk's rows
// into shared memory (16-byte pieces, the whole chunk in flight at once)
// while the block adds the current one. Thread (column c, lane l) holds
// the sums of destinations l, l + 4, ... in registers: each starts at 0
// and adds that destination's rows in ascending edge index, chunk after
// chunk. So out[d] = sum of msg[perm[j]] over j in [rowptr[d],
// rowptr[d+1]), in that order; a destination without entries gets 0. A
// hub's rows arrive as fast as anyone's; only its adds stay in series,
// from shared memory.
__global__ void __launch_bounds__(kSegThreads) gms_segment_kernel(
    const float* __restrict__ msg, const int* __restrict__ perm,
    const int* __restrict__ rowptr, int n_seg, int k_out,
    float* __restrict__ out) {
    __shared__ __align__(16) float rows_s[2][kSegRows][kTileCols];
    __shared__ int rp_s[kSegDst + 1];
    const int tid = threadIdx.x;
    const int d0 = blockIdx.x * kSegDst;
    const int nd = min(kSegDst, n_seg - d0);
    if (tid <= nd) rp_s[tid] = rowptr[d0 + tid];
    __syncthreads();
    const int j_begin = rp_s[0], j_end = rp_s[nd];
    const int col = tid % kTileCols, lane = tid / kTileCols;
    const bool vec = (reinterpret_cast<uintptr_t>(msg) & 15) == 0 &&
                     (k_out & 3) == 0;
    for (int c0 = 0; c0 < k_out; c0 += kTileCols) {
        const int cw = min(kTileCols, k_out - c0);
        const int pieces = cw / 4;                  // 16-byte pieces a row
        // this thread's pieces of a chunk: rows tid / pieces + i * step
        const int step = kSegThreads / max(pieces, 1);
        const int prow = tid / max(pieces, 1), ppiece = tid % max(pieces, 1);
        auto stage = [&](int j, int b, const int (&src_row)[kSegStage]) {
            const int n = min(kSegRows, j_end - j);
            if (vec) {
#pragma unroll
                for (int i = 0; i < kSegStage; ++i) {
                    const int row = prow + i * step;
                    if (row < n && prow < step)
                        cp_async16(&rows_s[b][row][4 * ppiece],
                                   msg + (size_t)src_row[i] * k_out + c0 +
                                       4 * ppiece);
                }
                cp_async_commit();
            } else {
                for (int i = tid; i < n * cw; i += kSegThreads) {
                    const int row = i / cw, c = i % cw;
                    rows_s[b][row][c] =
                        msg[(size_t)perm[j + row] * k_out + c0 + c];
                }
            }
        };
        auto rows_of = [&](int j, int (&src_row)[kSegStage]) {
#pragma unroll
            for (int i = 0; i < kSegStage; ++i) {
                const int row = prow + i * step;
                src_row[i] = vec && prow < step && j + row < j_end &&
                                     row < kSegRows
                                 ? perm[j + row]
                                 : 0;
            }
        };
        float acc[kSegPer];
#pragma unroll
        for (int i = 0; i < kSegPer; ++i) acc[i] = 0.0f;
        int rows[kSegStage];
        if (j_begin < j_end) {
            rows_of(j_begin, rows);
            stage(j_begin, 0, rows);
        }
        for (int j = j_begin, b = 0; j < j_end; j += kSegRows, b ^= 1) {
            const bool more = j + kSegRows < j_end;
            if (more) rows_of(j + kSegRows, rows);
            cp_async_wait_all();
            __syncthreads();   // chunk j is in rows_s[b]; rows_s[b ^ 1] free
            if (more) stage(j + kSegRows, b ^ 1, rows);
            const int jn = min(j + kSegRows, j_end);
            if (col < cw) {
#pragma unroll
                for (int i = 0; i < kSegPer; ++i) {
                    const int d = lane + i * (kSegThreads / kTileCols);
                    if (d >= nd) break;
                    const int lo = max(rp_s[d], j), hi = min(rp_s[d + 1], jn);
                    for (int r = lo; r < hi; ++r)
                        acc[i] += rows_s[b][r - j][col];
                }
            }
        }
        __syncthreads();       // the last chunk is added before the next pass
        if (col < cw) {
#pragma unroll
            for (int i = 0; i < kSegPer; ++i) {
                const int d = lane + i * (kSegThreads / kTileCols);
                if (d < nd) out[(size_t)(d0 + d) * k_out + c0 + col] = acc[i];
            }
        }
    }
}

// the tile kernel then the segment walk, on stream s; returns the
// cudaGetLastError() code after the launches (cudaErrorInvalidValue for
// hid > kMaxHid)
template <typename T, bool kBf16>
int gms_pass(const T* h, int n_h, int hid, const T* w_rel, int k_out,
             const int* src, const T* mask, const int* runs, int n_runs,
             const int* perm, const int* rowptr, int n_seg, float* msg,
             float* out, cudaStream_t s) {
    if (hid > kMaxHid) return (int)cudaErrorInvalidValue;
    if (n_runs > 0 && k_out > 0) {
        const size_t bytes = gms_tile_smem<T>(hid);
        if (bytes > 48 * 1024) {
            const cudaError_t err = cudaFuncSetAttribute(
                gms_tile_kernel<T, kBf16>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
            if (err != cudaSuccess) return (int)err;
        }
        const dim3 grid(n_runs, (k_out + kTileCols - 1) / kTileCols);
        gms_tile_kernel<T, kBf16><<<grid, kTileThreads, bytes, s>>>(
            h, n_h, hid, w_rel, k_out, src, mask, runs, msg);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (n_seg > 0 && k_out > 0)
        gms_segment_kernel<<<(n_seg + kSegDst - 1) / kSegDst, kSegThreads, 0,
                             s>>>(msg, perm, rowptr, n_seg, k_out, out);
    return (int)cudaGetLastError();
}

}  // namespace
