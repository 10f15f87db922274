// rules_fold.cu — the evidence fold and the rules tail of the RCA scoring
// pass as ONE kernel for Hopper (sm_90a).
//
// Replaces, on the JAX package's path:
//   * experiments/pallas_rules.py::_rules_kernel (the Pallas rules tail:
//     conditions -> rules -> first-maximal top-1), and
//   * rca/tpu_backend.py::_aggregate (the XLA evidence fold that feeds it:
//     gather of features over the [Pi, W] slot table, masked sum, and the
//     POD_PROBLEM pair one-hot contraction down to per_row_max),
// with the comparisons of rca/tpu_backend.py::finish_scores (`> 0`,
// `>= NETWORK_ERRORS_THRESHOLD`, `>= MULTIPLE_PODS_THRESHOLD`,
// NO_RECENT_DEPLOY = !(HAS_RECENT_DEPLOY > 0)).
//
// Design (one thread block per padded incident row i, 64 threads):
//   * one round trip brings everything the row needs before its gathers:
//     ev_cnt[i], chain[i], the first 64 slots of ev_idx and ev_pair_slot
//     (read whatever ev_cnt says, one coalesced load each), and, into the
//     lanes of warp 0, the condition and rule tables of the tail;
//   * the row's live slots w < ev_cnt[i] are then taken in chunks of 64:
//     the chunk's indices and pair ids go to shared memory (the next
//     chunk's read after the current one is done), and threads 0..47, one
//     feature column each, issue the gathers of all the chunk's slots
//     into registers before adding any of them; the 48 threads of a slot
//     read one contiguous 192-byte feature row, and an invalid id (outside
//     [0, Pn)) is neither read nor added;
//   * each column's count is the sum of its values in slot order, from 0;
//     the POD_PROBLEM column also leaves each slot's value in shared
//     memory, and the pair histogram is then added bin by bin: thread t
//     owns bins t, t + 64, ..., and adds into each the values of the slots
//     whose pair id is that bin, in slot order (ids outside
//     [0, pair_width) are the "no node" sentinel and drop out). These are
//     the float operations, in the order, of the first version, in which
//     one thread added every slot into a shared histogram;
//   * warp 0 then takes the max of the histogram (per_row_max), evaluates
//     one condition per lane from the condition table, ANDs conditions into
//     rules with a ballot, and reduces the first-maximal rule score with
//     shuffles.
// No floating-point atomics anywhere and every sum runs in a fixed order,
// so results are bit-identical from run to run.
//
// Bound on an H100: bytes. Per pass the function must move each distinct
// feature row the live slots gather (192 B a row; incidents sharing an
// entity share its row), the index and pair id of each live slot (8 B),
// ev_cnt and chain, and its outputs (rules_fold.py::bound_bytes); the
// arithmetic is a few adds per gathered value. A pass is far from that
// bound: its floor is a launch and two dependent round trips to memory
// (the row's indices, then its feature rows), however few bytes it moves.
// Left for later: CUDA graphs for the host's dispatch of a tick, which
// costs far more than the pass (PERF.md).
//
// Two more entries share this device code (fold_row, rules_tail_warp) for
// the graph-sharded paths, where the fold of each node block is followed by
// a sum over the mesh's graph axis before the tail runs:
//   * rules_fold_partial_launch: the fold of one block [lo, lo + nps) of
//     the feature table, one block of 64 threads a row as above, writing
//     the row's count columns and pair histogram (no chain, no tail);
//   * rules_tail_launch: one warp a row, counts + min(chain, 0), the max of
//     the pair counts, then the tail above.
// Slots outside a block add nothing, so for integer-valued features the
// tail of the partials' sum in block order equals one rules_fold_kernel
// pass bit for bit (the count and histogram sums are exact).
//
// Plain C interface for ctypes: each *_launch returns the
// cudaGetLastError() code after the launch (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDim = 48;          // graph/schema.DIM
constexpr int kThreads = 64;
constexpr int kSlots = kThreads;  // live slots staged and gathered a chunk
constexpr int kPerRowMaxBit = kDim;  // condition-mask bit for per_row_max
// NaN-propagating max (jnp.max semantics)
__device__ __forceinline__ float nan_max(float a, float b) {
    return (isnan(a) || a >= b) ? a : b;
}

// per_row_max: the max over a row's pair histogram, reduced across warp 0
// (every lane returns it)
__device__ __forceinline__ float row_max(const float* hist, int pair_width,
                                         int t) {
    float prm = -INFINITY;
    for (int r = t; r < pair_width; r += 32) prm = nan_max(hist[r], prm);
    for (int off = 16; off > 0; off >>= 1)
        prm = nan_max(__shfl_xor_sync(0xffffffffu, prm, off), prm);
    return prm;
}

// The rules tail of row i, run by warp 0 (lane t): one condition per lane
// from the condition table over counts[0..kDim) and per_row_max, ANDed
// into rules with a ballot, then the first-maximal rule score by
// shuffles. Lane t < n_conds holds condition t's table entry (cm, cth,
// cop) and lane t < n_rules rule t's (rm, rs, rc). Shared by
// rules_fold_kernel and rules_tail_kernel.
__device__ __forceinline__ void rules_tail_warp(
    int i, int t, const float* counts, float prm,
    unsigned long long cm, float cth, int cop, int n_conds,
    unsigned rm, float rs, float rc, int n_rules,
    float unknown_conf, float unknown_score,
    uint8_t* __restrict__ conds_out, uint8_t* __restrict__ matched_out,
    float* __restrict__ scores_out, int* __restrict__ top_idx_out,
    uint8_t* __restrict__ any_out, float* __restrict__ top_conf_out,
    float* __restrict__ top_score_out) {
    const unsigned full = 0xffffffffu;

    // one condition per lane: the selected counts summed in ascending
    // feature order (finish_scores' left-to-right sums), then compared
    bool cv = false;
    if (t < n_conds) {
        float s = 0.0f;
        bool first = true;
        for (unsigned long long bits = cm; bits; bits &= bits - 1) {
            const int f = __ffsll((long long)bits) - 1;   // ascending
            const float x = (f == kPerRowMaxBit) ? prm : counts[f];
            s = first ? x : s + x;
            first = false;
        }
        bool r = (cop & 1) ? (s >= cth) : (s > cth);
        if (cop & 2) r = !r;
        cv = r;
        conds_out[(size_t)i * n_conds + t] = cv ? 1 : 0;
    }
    const unsigned bits = __ballot_sync(full, cv);

    // one rule per lane: matched when every required condition holds
    bool mv = false;
    float sc = 0.0f;
    if (t < n_rules) {
        mv = (bits & rm) == rm;
        sc = mv ? rs : 0.0f;
        matched_out[(size_t)i * n_rules + t] = mv ? 1 : 0;
        scores_out[(size_t)i * n_rules + t] = sc;
    }
    const bool any = __ballot_sync(full, mv) != 0u;

    // first-maximal score (argmax tie-break: the lowest rule index)
    float best = (t < n_rules) ? sc : -INFINITY;
    int bi = t;
    for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_down_sync(full, best, off);
        const int oi = __shfl_down_sync(full, bi, off);
        if (ob > best || (ob == best && oi < bi)) {
            best = ob;
            bi = oi;
        }
    }
    const float conf = __shfl_sync(full, rc, bi & 31);   // rule_conf[bi]
    if (t == 0) {
        top_idx_out[i] = bi;
        any_out[i] = any ? 1 : 0;
        top_score_out[i] = any ? best : unknown_score;
        top_conf_out[i] = any ? conf : unknown_conf;
    }
}

// The evidence fold of one row over the slots whose node id lies in the
// block [lo, lo + nps) of the feature table (``features`` points at the
// block's first row; the whole table is the block lo = 0, nps = Pn): the
// row's live slots are taken in chunks of 64, each chunk's gathers issued
// before its adds, and each feature column summed in slot order from 0
// (thread t < kDim returns column t's sum). Slots outside the block add
// nothing, neither to the counts nor to the pair histogram ``hist``
// (shared, [pair_width], bin b owned by thread b % kThreads). n_next and
// p_next hold slot t's id and pair id (read by the caller in its first
// round trip). Shared by rules_fold_kernel and rules_fold_partial_kernel.
__device__ __forceinline__ float fold_row(
    const float* __restrict__ features, int lo, int nps,
    const int* __restrict__ idx, const int* __restrict__ slot, int cnt,
    int width, int pair_width, int pod_problem, int t, int n_next,
    int p_next, float* hist, int* idx_s, int* bin_s, float* pod_s) {
    for (int r = t; r < pair_width; r += kThreads) hist[r] = 0.0f;
    cnt = cnt < 0 ? 0 : (cnt > width ? width : cnt);

    float acc = 0.0f;
    for (int c0 = 0; c0 < cnt; c0 += kSlots) {
        const int n = min(kSlots, cnt - c0);
        if (c0 > 0) {
            __syncthreads();                 // the last chunk is consumed
            if (t < n) {
                n_next = idx[c0 + t];
                p_next = slot[c0 + t];
            }
        }
        if (t < n) {
            const unsigned local = (unsigned)n_next - (unsigned)lo;
            const bool valid = local < (unsigned)nps;
            idx_s[t] = valid ? (int)local : -1;
            bin_s[t] = valid && p_next >= 0 && p_next < pair_width ? p_next
                                                                   : -1;
        }
        __syncthreads();
        if (t < kDim) {
            // every gather of the chunk in flight, then the adds in slot
            // order; the POD_PROBLEM column keeps its values for the pairs
            float v[kSlots];
#pragma unroll
            for (int k = 0; k < kSlots; ++k) {
                const int nk = k < n ? idx_s[k] : -1;
                v[k] = nk >= 0 ? features[(size_t)nk * kDim + t] : 0.0f;
            }
#pragma unroll
            for (int k = 0; k < kSlots; ++k)
                if (k < n && idx_s[k] >= 0) acc += v[k];
            if (t == pod_problem) {
#pragma unroll
                for (int k = 0; k < kSlots; ++k)
                    if (k < n) pod_s[k] = v[k];
            }
        }
        __syncthreads();
        // the pair histogram, bin by bin, each bin's slots in slot order
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
            const int b = bin_s[k];
            if (b >= 0 && b % kThreads == t) hist[b] += pod_s[k];
        }
    }
    return acc;
}

__global__ void __launch_bounds__(kThreads) rules_fold_kernel(
    const float* __restrict__ features, int pn,
    const int* __restrict__ ev_idx, const int* __restrict__ ev_cnt,
    const int* __restrict__ ev_pair, const float* __restrict__ chain,
    int width, int pair_width, int pod_problem,
    const unsigned long long* __restrict__ cond_mask,
    const float* __restrict__ cond_thresh, const int* __restrict__ cond_op,
    int n_conds,
    const unsigned int* __restrict__ rule_mask,
    const float* __restrict__ rule_score, const float* __restrict__ rule_conf,
    int n_rules, float unknown_conf, float unknown_score,
    uint8_t* __restrict__ conds_out, uint8_t* __restrict__ matched_out,
    float* __restrict__ scores_out, int* __restrict__ top_idx_out,
    uint8_t* __restrict__ any_out, float* __restrict__ top_conf_out,
    float* __restrict__ top_score_out) {
    extern __shared__ float hist[];          // [pair_width]
    __shared__ float counts[kDim];
    __shared__ int idx_s[kSlots];            // the chunk's rows (-1: invalid)
    __shared__ int bin_s[kSlots];            // their pair bins (-1: none)
    __shared__ float pod_s[kSlots];          // their POD_PROBLEM values

    const int i = blockIdx.x;
    const int t = threadIdx.x;
    const int* idx = ev_idx + (size_t)i * width;
    const int* slot = ev_pair + (size_t)i * width;

    // one round trip: the row's count, chain, first chunk and the tables
    int cnt = ev_cnt[i];
    const float c = chain[i];
    int n_next = 0, p_next = -1;
    if (t < width) {
        n_next = idx[t];
        p_next = slot[t];
    }
    unsigned long long cm = 0ull;
    float cth = 0.0f, rs = 0.0f, rc = 0.0f;
    int cop = 0;
    unsigned rm = 0u;
    if (t < n_conds) {
        cm = cond_mask[t];
        cth = cond_thresh[t];
        cop = cond_op[t];
    }
    if (t < n_rules) {
        rm = rule_mask[t];
        rs = rule_score[t];
        rc = rule_conf[t];
    }
    const float acc = fold_row(features, 0, pn, idx, slot, cnt, width,
                               pair_width, pod_problem, t, n_next, p_next,
                               hist, idx_s, bin_s, pod_s);
    if (t < kDim) counts[t] = acc + (c > 0.0f ? 0.0f : c);   // min(chain, 0)
    __syncthreads();

    if (t >= 32) return;
    rules_tail_warp(i, t, counts, row_max(hist, pair_width, t), cm, cth, cop,
                    n_conds, rm, rs, rc, n_rules, unknown_conf,
                    unknown_score, conds_out, matched_out, scores_out,
                    top_idx_out, any_out, top_conf_out, top_score_out);
}

// B1's fold of one node block, for the graph-sharded paths: row i's
// count columns and pair histogram over only the slots whose GLOBAL node
// id lies in [lo, lo + nps), written to out[i, 0..kDim) and
// out[i, kDim..kDim + pair_width). Summed over the blocks in block order,
// the partials of integer-valued features equal the whole fold's sums.
__global__ void __launch_bounds__(kThreads) rules_fold_partial_kernel(
    const float* __restrict__ features_blk, int lo, int nps,
    const int* __restrict__ ev_idx, const int* __restrict__ ev_cnt,
    const int* __restrict__ ev_pair, int width, int pair_width,
    int pod_problem, float* __restrict__ out, int ld_out) {
    extern __shared__ float hist[];          // [pair_width]
    __shared__ int idx_s[kSlots];
    __shared__ int bin_s[kSlots];
    __shared__ float pod_s[kSlots];

    const int i = blockIdx.x;
    const int t = threadIdx.x;
    const int* idx = ev_idx + (size_t)i * width;
    const int* slot = ev_pair + (size_t)i * width;
    const int cnt = ev_cnt[i];
    int n_next = 0, p_next = -1;
    if (t < width) {
        n_next = idx[t];
        p_next = slot[t];
    }
    const float acc = fold_row(features_blk, lo, nps, idx, slot, cnt, width,
                               pair_width, pod_problem, t, n_next, p_next,
                               hist, idx_s, bin_s, pod_s);
    float* o = out + (size_t)i * ld_out;
    if (t < kDim) o[t] = acc;
    // bins t, t + 64, ...: the ones this thread added into
    for (int r = t; r < pair_width; r += kThreads) o[kDim + r] = hist[r];
}

// B1's tail alone, after the graph axis's sum of the partials: row i's
// counts plus min(chain, 0), per_row_max of its pair counts, then the
// conditions, rules and first-maximal top-1 of rules_fold_kernel. One
// warp a row; counts and pair counts may be views with row strides.
__global__ void __launch_bounds__(32) rules_tail_kernel(
    const float* __restrict__ counts, int ld_c,
    const float* __restrict__ pair, int ld_p,
    const float* __restrict__ chain, int pair_width,
    const unsigned long long* __restrict__ cond_mask,
    const float* __restrict__ cond_thresh, const int* __restrict__ cond_op,
    int n_conds,
    const unsigned int* __restrict__ rule_mask,
    const float* __restrict__ rule_score, const float* __restrict__ rule_conf,
    int n_rules, float unknown_conf, float unknown_score,
    uint8_t* __restrict__ conds_out, uint8_t* __restrict__ matched_out,
    float* __restrict__ scores_out, int* __restrict__ top_idx_out,
    uint8_t* __restrict__ any_out, float* __restrict__ top_conf_out,
    float* __restrict__ top_score_out) {
    __shared__ float cs[kDim];
    const int i = blockIdx.x;
    const int t = threadIdx.x;
    const float c = chain[i];
    unsigned long long cm = 0ull;
    float cth = 0.0f, rs = 0.0f, rc = 0.0f;
    int cop = 0;
    unsigned rm = 0u;
    if (t < n_conds) {
        cm = cond_mask[t];
        cth = cond_thresh[t];
        cop = cond_op[t];
    }
    if (t < n_rules) {
        rm = rule_mask[t];
        rs = rule_score[t];
        rc = rule_conf[t];
    }
    for (int f = t; f < kDim; f += 32)
        cs[f] = counts[(size_t)i * ld_c + f] + (c > 0.0f ? 0.0f : c);
    __syncwarp();
    rules_tail_warp(i, t, cs, row_max(pair + (size_t)i * ld_p, pair_width, t),
                    cm, cth, cop, n_conds, rm, rs, rc, n_rules, unknown_conf,
                    unknown_score, conds_out, matched_out, scores_out,
                    top_idx_out, any_out, top_conf_out, top_score_out);
}
}  // namespace

extern "C" int rules_fold_launch(
    const void* features, int pn, const void* ev_idx, const void* ev_cnt,
    const void* ev_pair, const void* chain, int pi, int width, int pair_width,
    int pod_problem, const void* cond_mask, const void* cond_thresh,
    const void* cond_op, int n_conds, const void* rule_mask,
    const void* rule_score, const void* rule_conf, int n_rules,
    float unknown_conf, float unknown_score, void* conds_out,
    void* matched_out, void* scores_out, void* top_idx_out, void* any_out,
    void* top_conf_out, void* top_score_out, void* stream) {
    if (pi <= 0) return (int)cudaSuccess;
    const size_t smem = (size_t)pair_width * sizeof(float);
    rules_fold_kernel<<<pi, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)features, pn, (const int*)ev_idx, (const int*)ev_cnt,
        (const int*)ev_pair, (const float*)chain, width, pair_width,
        pod_problem, (const unsigned long long*)cond_mask,
        (const float*)cond_thresh, (const int*)cond_op, n_conds,
        (const unsigned int*)rule_mask, (const float*)rule_score,
        (const float*)rule_conf, n_rules, unknown_conf, unknown_score,
        (uint8_t*)conds_out, (uint8_t*)matched_out, (float*)scores_out,
        (int*)top_idx_out, (uint8_t*)any_out, (float*)top_conf_out,
        (float*)top_score_out);
    return (int)cudaGetLastError();
}

extern "C" int rules_fold_partial_launch(
    const void* features_blk, int lo, int nps, const void* ev_idx,
    const void* ev_cnt, const void* ev_pair, int rows, int width,
    int pair_width, int pod_problem, void* out, int ld_out, void* stream) {
    if (rows <= 0) return (int)cudaSuccess;
    const size_t smem = (size_t)pair_width * sizeof(float);
    rules_fold_partial_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)features_blk, lo, nps, (const int*)ev_idx,
        (const int*)ev_cnt, (const int*)ev_pair, width, pair_width,
        pod_problem, (float*)out, ld_out);
    return (int)cudaGetLastError();
}

extern "C" int rules_tail_launch(
    const void* counts, int ld_c, const void* pair, int ld_p,
    const void* chain, int rows, int pair_width, const void* cond_mask,
    const void* cond_thresh, const void* cond_op, int n_conds,
    const void* rule_mask, const void* rule_score, const void* rule_conf,
    int n_rules, float unknown_conf, float unknown_score, void* conds_out,
    void* matched_out, void* scores_out, void* top_idx_out, void* any_out,
    void* top_conf_out, void* top_score_out, void* stream) {
    if (rows <= 0) return (int)cudaSuccess;
    rules_tail_kernel<<<rows, 32, 0, (cudaStream_t)stream>>>(
        (const float*)counts, ld_c, (const float*)pair, ld_p,
        (const float*)chain, pair_width,
        (const unsigned long long*)cond_mask, (const float*)cond_thresh,
        (const int*)cond_op, n_conds, (const unsigned int*)rule_mask,
        (const float*)rule_score, (const float*)rule_conf, n_rules,
        unknown_conf, unknown_score, (uint8_t*)conds_out,
        (uint8_t*)matched_out, (float*)scores_out, (int*)top_idx_out,
        (uint8_t*)any_out, (float*)top_conf_out, (float*)top_score_out);
    return (int)cudaGetLastError();
}

extern "C" const char* rules_fold_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
