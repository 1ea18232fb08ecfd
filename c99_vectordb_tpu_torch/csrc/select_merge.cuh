// select_merge.cuh: the block-level top-K selection shared by the IVF and
// ADC select kernels (ivf_scan.cu, adc_scan.cu): a running sorted list,
// the merge of one tile's admitted candidates into it, and the exact merge
// of per-probe-group partial lists into the final (B, K) result; and the
// tile walk and cp.async helpers that the select and dense kernels share.
//
// Keys are (d, t) pairs in lexicographic order: t is the tie-break of the
// kernel's contract (IVF: the id, INT_MAX for padding; ADC: the candidate's
// position p * pad + s in (probe rank, slot) order). Among real candidates
// the keys are unique; the only repeated key is the empty entry (inf,
// INT_MAX), which never enters a list and sorts last.
//
// Why the split is exact. Let the probes of a query be cut into contiguous
// groups and each group keep the K smallest keys of its own candidates.
// With a total order on unique keys, every key among the K smallest of the
// union is among the K smallest of its own group (fewer than K keys of the
// union, hence of its group, lie below it). So the K smallest of the union
// of the partial lists are the K smallest of all candidates: the merge of
// the partial lists gives the single pass's answer, whatever the grouping.
//
// Tile merge (merge_tile). A tile's admitted candidates (each below the
// list's K-th entry) are compacted, ranked among themselves by counting
// (unique keys: distinct ranks) and written sorted; each candidate's place
// in the merged list is its rank plus the count of list entries below it,
// each list entry's place its index plus the count of candidates below it
// (binary searches). Entries placed at or past K drop out. The result goes
// to a second buffer (ping-pong), so no entry is overwritten before it is
// read. (Merging only the suffix a tile's candidates reach, and buffering
// candidates over several tiles behind a bitonic sort, both measured
// slower on the H100: PERF.md.)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Diagnostic builds only (tools/select_breakdown.py): SEL_NO_SCORE=1 skips
// the scoring of each tile (IVF products, ADC table lookups), SEL_NO_SELECT=1
// the admission, compaction and merges (the scores are kept live by a
// store). Shipped builds define neither.
#ifndef SEL_NO_SCORE
#define SEL_NO_SCORE 0
#endif
#ifndef SEL_NO_SELECT
#define SEL_NO_SELECT 0
#endif

namespace sel {

constexpr unsigned FULL = 0xffffffffu;
constexpr int INT_MAXV = 0x7fffffff;
constexpr int MERGE_NT = 256;           // threads of the partial-list merge kernel

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool lex_less(float ad, int at, float bd, int bt) {
    return ad < bd || (ad == bd && at < bt);
}

// Entries of the sorted (kd, kt)[0, n) strictly below (d, t).
__device__ __forceinline__ int count_below(const float* kd, const int* kt, int n, float d, int t) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (lex_less(kd[mid], kt[mid], d, t)) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Entries of the sorted (kd, kt)[0, n) at or below (d, t).
__device__ __forceinline__ int count_not_above(const float* kd, const int* kt, int n, float d,
                                               int t) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (!lex_less(d, t, kd[mid], kt[mid])) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// 16-byte global -> shared copy, asynchronous (cp.async.cg: L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A block's walk over the tiles of its probe group: probe rank p, first
// slot s0 of the tile, n = the slots of list probes[p] to scan (its
// high-water mark, clamped to pad; pad without marks), base = list * pad.
// The walk is over when p reaches the group's end p1.
struct ListTile {
    int p;
    int s0;
    int n;
    int64_t base;
};

// Advance by `step` slots; past a list's n, on to the next probed list of
// the group with a slot at or past `first` to scan, at slot `first` (a
// dense kernel's row split starts there; the select kernels at 0).
// ListTile{p0 - 1, 0, 0, 0} advanced by 0 is the first tile.
__device__ __forceinline__ void next_tile(ListTile& it, int step, int p1, const int* prb,
                                          const int* hwm, int pad, int first = 0) {
    it.s0 += step;
    while (it.s0 >= it.n && ++it.p < p1) {
        const int l = prb[it.p];
        it.n = hwm ? min(max(hwm[l], 0), pad) : pad;
        it.base = (int64_t)l * pad;
        it.s0 = first;
    }
}

// A running list of K sorted keys (d, t) and the buffer (od, ot) the next
// merge writes. Either both live in shared memory or both in global
// scratch (large K);
// the pointers are plain (not read-only cached): other threads of the
// block write them between __syncthreads.
struct Lists {
    float* d;
    int* t;
    float* od;
    int* ot;
    __device__ void swap() {
        float* fd = d; d = od; od = fd;
        int* it = t; t = ot; ot = it;
    }
};

template <int NT>
__device__ __forceinline__ void list_init(Lists& L, int K) {
    for (int i = threadIdx.x; i < K; i += NT) { L.d[i] = inf_f(); L.t[i] = INT_MAXV; }
}

// Compact the admitted (d, t) of every thread into cd/ct[0, total);
// returns total. s_cnt holds NT / 32 ints. Every thread calls it.
template <int NT>
__device__ __forceinline__ int compact(bool admit, float d, int t, float* cd, int* ct, int* s_cnt) {
    constexpr int NW = NT / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned m = __ballot_sync(FULL, admit);
    if (lane == 0) s_cnt[warp] = __popc(m);
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
        const int n = s_cnt[w];
        off += w < warp ? n : 0;
        total += n;
    }
    if (admit) {
        const int i = off + __popc(m & ((1u << lane) - 1u));
        cd[i] = d;
        ct[i] = t;
    }
    __syncthreads();
    return total;
}

// Merge the c compacted candidates cd/ct (unique keys, each below the
// list's K-th entry) into L; sd/st hold c sorted candidates as scratch.
// Every thread calls it (c is uniform).
template <int NT>
__device__ void merge_tile(Lists& L, int K, const float* cd, const int* ct, int c, float* sd,
                           int* st) {
    for (int j = threadIdx.x; j < c; j += NT) {
        const float d = cd[j];
        const int t = ct[j];
        int r = 0;
        for (int i = 0; i < c; ++i) r += lex_less(cd[i], ct[i], d, t) ? 1 : 0;
        sd[r] = d;
        st[r] = t;
        const int pos = r + count_below(L.d, L.t, K, d, t);
        if (pos < K) { L.od[pos] = d; L.ot[pos] = t; }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < K; i += NT) {
        const float d = L.d[i];
        const int t = L.t[i];
        const int pos = i + count_below(sd, st, c, d, t);
        if (pos < K) { L.od[pos] = d; L.ot[pos] = t; }
    }
    __syncthreads();
    L.swap();
}

// Probe groups of `per` = ceil(nprobe / G) ranks each: G must be the count
// such groups give, and a grid dimension.
inline bool valid_groups(int nprobe, int G) {
    if (G < 1 || G > nprobe || G > 65535) return false;
    const int per = (nprobe + G - 1) / G;
    return (nprobe + per - 1) / per == G;
}

// Shared memory of merge_groups for G partial lists of K: the tree's two
// level buffers (none when G <= 2: the first level is the last).
__host__ __device__ __forceinline__ size_t merge_smem_bytes(int G, int K) {
    if (G <= 2) return 0;
    return (size_t)((G + 1) / 2 + (G + 3) / 4) * K * (sizeof(float) + sizeof(int));
}

// The most probe groups (a grid dimension, so at most 65535) whose merge
// fits in `limit` bytes of shared memory; at least 2, which need none.
inline int max_merge_groups(int K, size_t limit) {
    int lo = 2, hi = 65535;              // merge_smem_bytes grows with G
    while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (merge_smem_bytes(mid, K) <= limit) lo = mid; else hi = mid - 1;
    }
    return lo;
}

// One query's exact merge of its G sorted partial lists (pd/pt, G x K) by
// a tree of pairwise merges; the last level hands each of the K smallest
// keys to fin(i, d, t) in order. Of a pair (a, b), a's entry i goes to i +
// (b's entries below it), b's entry j to j + (a's entries at or below it):
// a stable merge, exact also among repeated empty keys. Every thread of
// the block (MERGE_NT) calls it.
template <typename Fin>
__device__ void merge_groups(const float* pd, const int* pt, int G, int K, unsigned char* smem,
                             Fin fin) {
    float* bd[2];
    int* bt[2];
    const int cap0 = (G + 1) / 2;
    bd[0] = reinterpret_cast<float*>(smem);
    bt[0] = reinterpret_cast<int*>(bd[0] + (size_t)cap0 * K);
    bd[1] = reinterpret_cast<float*>(bt[0] + (size_t)cap0 * K);
    bt[1] = reinterpret_cast<int*>(bd[1] + (size_t)((G + 3) / 4) * K);
    const float* sd = pd;
    const int* st = pt;
    int n = G, lvl = 0;
    while (n > 1) {
        const int m = (n + 1) / 2;
        const bool last = m == 1;
        float* dd = bd[lvl & 1];
        int* dt = bt[lvl & 1];
        const int items = n * K;            // every entry of every list of this level
        for (int x = threadIdx.x; x < items; x += MERGE_NT) {
            const int li = x / K, i = x - li * K;
            const int pair = li >> 1;
            const float d = sd[x];
            const int t = st[x];
            int pos = i;
            const int other = li ^ 1;
            if (other < n) {
                const float* od = sd + (size_t)other * K;
                const int* ot = st + (size_t)other * K;
                pos += (li & 1) ? count_not_above(od, ot, K, d, t) : count_below(od, ot, K, d, t);
            }
            if (pos < K) {
                if (last) fin(pos, d, t);
                else { dd[(size_t)pair * K + pos] = d; dt[(size_t)pair * K + pos] = t; }
            }
        }
        __syncthreads();
        sd = dd;
        st = dt;
        n = m;
        ++lvl;
    }
}

}  // namespace sel
