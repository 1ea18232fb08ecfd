// fused_l2_topk: fused squared-L2 key + per-query top-k over a streamed
// store, for Hopper (sm_90a). Plain C interface, loaded with ctypes by
// ops/topk_cuda.py.
//
// Replaces c99_vectordb_tpu/ops/topk_pallas.py::_fused_kernel (driven by
// fused_topk). It computes that kernel's result contract, not its Mosaic
// mechanics (no 128-lane slate, no roll-based insertion):
//
//   key(q, row) = norms[row] + dot(q_staged[q], x[row])          f32 / bf16
//   key(q, row) = float(dot_i32(q8[q], x8[row])) * rs[q] + norms[row]  int8
//   key(q, row) = norms[row] + dot(q_bf16[q], bf16(x8[row]))     int8 codes,
//                                                                 bf16 queries
//
// with f32 accumulation (int8: an exact int32 dot, s8 tensor-core
// products with s32 accumulators, so the key rounds only in its product
// and its sum, as the plain version's does). The last
// mode is the Pallas kernel's q_int8=False branch (topk_pallas.py:76-80):
// SQ8 codes decode to bf16 (exactly: |code| <= 127) against bf16 queries
// staged as (-2 q).to(bf16); each product is exact in f32. For every
// query the k smallest keys are kept, ordered by (key, position): ties go
// to the lowest position, and a +inf key (padding or a masked row) never
// enters, so unfilled slots stay (inf, INT32_MAX). Rows at or past N count
// as +inf. The wrapper stages the queries (x -2, store dtype; int8 row
// quantisation) and applies the epilogue (+ ||q||^2, clamp, ids).
//
// Design. Pass 1 runs on a grid of (query tiles, splits of N); each block
// streams its split's rows in row tiles, forms the keys tile in shared
// memory, and then each warp merges its queries' tile keys into sorted
// per-query lists (a ballot against the list's last key, then the
// admitted candidates in position order; mode 0 screens the keys against
// the lists' last keys in registers first, below). Lists live in shared
// memory when they fit (k <= SMEM_LIST_MAX) and in the partial-output
// buffer otherwise.
// The query tile is the fastest grid axis, so the blocks that share a split
// run together and read the store through L2 once. Pass 2
// (merge_splits_kernel): one warp per query merges the per-split sorted
// lists by (key, position) into the final k. The wrapper sizes the grid
// (ops/topk_cuda.launch_plan) from fused_l2_topk_shape: blocks per SM,
// queries a block, rows a tile.
//
// Pass 1 forms the keys on the tensor cores in every mode.
//   - scan_topk_mma_kernel<MODE> (modes 1-3): mma.sync fed by ldmatrix from
//     a ring of 16-byte cp.async.cg copies, so the next chunks load while
//     the current one multiplies. Rows that are not 16-byte aligned (D % 8
//     != 0 for bf16, D % 16 != 0 for int8, or an unaligned base) take a
//     plain zero-filling loader into the same layout. A is the row-major
//     queries, B the store rows, which a row-major (N, D) store already lays
//     out as the "col" operand (nothing is transposed). Chunk rows are
//     padded by 16 bytes to 16 mod 128 bytes, which keeps every ldmatrix
//     phase on distinct banks. 64 queries x 64 rows a tile, two blocks of
//     8 warps per SM, each warp a 16-query x 32-row piece: bf16 x bf16 ->
//     f32 (mode 1, bf16 store; mode 3, int8 codes with bf16 queries) and
//     int8 x int8 -> int32 (mode 2, int8 store and queries, the JAX
//     kernel's int8_q branch, topk_pallas.py:338-346). Store tiles arrive
//     in chunks of 64 bf16 or 128 int8 columns through a STAGES-deep ring.
//     The block's queries stay resident in shared memory for the whole
//     split (64 x 392 bf16 = 49 KB at D = 384, 64 x 400 int8 = 25.6 KB;
//     above ~1,340 bf16 columns they come through the ring beside the store
//     instead). Mode 3 copies the raw int8 codes (half of bf16's bytes) and
//     one cooperative pass decodes each chunk once into a bf16 tile in
//     shared memory (exact), so modes 1 and 3 share one product path.
//     bf16: mma.sync.m16n8k16 bf16 -> f32 (every product exact in f32).
//     int8: mma.sync.m16n8k32 s8 -> s32. A 32-value s8 k step is 32 bytes,
//     as a bf16 k16 step, and its A and B fragments hold the bytes that
//     ldmatrix.b16 hands each lane (row lane / 4, bytes 4 (lane % 4) .. + 3
//     of an 8 x 16-byte matrix), so mode 2 shares the bf16 addressing
//     (tests/test_torch_s8_fragments.py emulates it). The exact int32 dot
//     becomes the key as float(dot) * rs (rounded), + norm (rounded).
//   - scan_topk_f32_wgmma_kernel<NQ> for f32 x f32 (mode 0: MemoDB's default
//     store, FlatIndex's f32 scan): 3xTF32 on wgmma.mma_async m64nNk8 tf32
//     -> f32, with the store rows on M and the queries on N: a tile is 128
//     store rows (64 per consumer warpgroup, wgmma's A, from registers) by
//     the block's NQ queries (wgmma's B, from shared memory). The wrapper
//     picks NQ from B: the smallest multiple of 8 that holds the batch's
//     share of ceil(B / 128) query tiles (B = 1: 8, so no padded products;
//     B <= 128: one tile, so every store row is read from L2 once a call).
//     Every multiple of 8 is built: above N = 16 pass 1's time grows with N
//     nearly in step, so padding to the next power of two costs 17-34% at
//     B = 40, 72, 100 and 200 (1M x 768 and 131,072 x 384; PERF.md).
//     Each element x splits into hi = tf32(x) and lo = tf32(x - hi), both
//     rounded to nearest with ties away from zero (cvt.rna's rounding, done
//     with an integer add and a mask), and each 8-column k step adds
//     x_hi.q_lo, x_lo.q_hi, then x_hi.q_hi, always in that order
//     (deterministic; lo.lo, below f32's rounding, is dropped). One TF32
//     pass keeps 11 significant bits and errs past the 1e-4 tolerance of the
//     keys; three keep f32's accuracy (tests/test_torch_tf32_split.py
//     emulates both, and this kernel's arithmetic). The queries split once a
//     call (stage_f32_queries_kernel, before pass 1) into hi and lo parts
//     laid out as K-major B operands: 8-query x 16-byte core matrices, no
//     swizzle, 128 bytes apart along the queries and 16 NQ bytes along K. The
//     store is never copied or pre-split. Warp specialisation: one producer
//     warp keeps TMA boxes of the store (128 rows x 16 columns, 64-byte rows,
//     two a stage; zeros past N and D) and one bulk copy of the stage's
//     staged queries in flight through an mbarrier ring (full and empty
//     barriers; the producer warpgroup's other three warps leave at once,
//     and setmaxnreg moves its registers to the consumers: without it
//     ptxas holds every warp to the 168 that 384 threads leave, NQ 112 and
//     128 spill, and pass 1 runs 13-24% slower at B = 128, PERF.md).
//     Each consumer lane reads one float4 of each of its two
//     rows a box (a quarter-warp covers 128 contiguous bytes: no bank
//     conflict) and splits it in registers into two k steps' A fragments
//     (wgmma's tf32 register layout: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3
//     (g+8, t+4); g = lane / 4, t = lane % 4; the queries are staged in the
//     matching column order, fw_perm), so each store element is split once
//     per query tile. The three products of each k step go into a fresh
//     accumulator (scale-d 0 on the first), and one f32 add (round to
//     nearest) folds it into the key's sum: the tensor cores do not round
//     their adds into an accumulator to nearest, and on the card a fresh
//     accumulator over two k steps (16 columns) already drifted keys of
//     rows that mix magnitudes of 1e-3 to 1e3 past the tolerance (the
//     mixed_magnitudes case at B = 1024 of tests/test_torch_cuda.py), where
//     one per k step holds, as PR 17's mma.sync kernel found. Two fresh
//     accumulators alternate (NQ <= 64: one per k step; above, queries 0-63
//     and the rest, two groups a k step), so that a fold waits only for an
//     older group (wgmma.wait_group 1) while a newer one runs, and the
//     tensor cores hold work through the folds. A finished tile's keys
//     (norm + sum, +inf past the split) are screened where they are, in the
//     accumulator registers, once its last groups are folded: a key is a
//     candidate only when it is below its query's threshold, one float a
//     query in shared memory: the last key of the query's list (+inf until
//     the list is full, -inf past B), lowered to the successor of the
//     query's cut when that is below. The cut is the least last key that
//     any split's list of the query has published (an atomicMin on an
//     ordered int, B of them after the staged queries, set to +inf by the
//     staging kernel), read from L2 once a tile: a key above another
//     split's k-th key has k keys below it and cannot be in the result, and
//     one equal to it may still win on position, hence the successor. So a
//     split's list may leave out keys that no output keeps; the outputs are
//     those of a selection that holds every key against its list. A
//     threshold may also be stale (a selection of the tile before still
//     running): a list's last key and the cut only fall, so a stale
//     threshold passes a superset, and the selection holds every candidate
//     against the list itself. One barrier (bar.red.popc) with the selectors
//     waits for every selection of the tile before and counts the consumer
//     lanes that hold a candidate; with none, the tile ends there: no keys
//     are written and nothing is selected (a query admits about k / t keys
//     of its t-th tile). Otherwise each warp with a candidate screens again
//     against the current thresholds and writes its survivors' keys into
//     their slots of a keys tile in shared memory (stride 132:
//     conflict-free writes from the accumulators) and, for each query, a
//     16-bit mask of its 16 rows that survived (the warp's own slot of the
//     query's eight, so no atomics). A tile with few candidate lanes (at
//     most FW_SEL_LANES a ring stage of the tile, k <= 32) goes to the
//     selectors, the producer warpgroup's three other warps, which select
//     it while the consumers run the next tile's products; the consumers
//     select a busier tile themselves during the next tile's first k step.
//     The selection reads a query's eight masks as one uint4 (an empty one
//     costs that read) and takes the candidates by position: a warp takes
//     its queries G at a time (the consumers four, the selectors, on the
//     producer warpgroup's 40 registers, one), their lists (k <= 32) in
//     registers, one entry a lane, one candidate of each a round with no
//     branch, so G chains of dependent shuffles overlap, and every 4 rounds
//     the candidates left are held against the lists' last keys again (a
//     list's first tile admits all 128 keys); deeper lists take
//     warp_insert. A store whose rows are not 16-byte aligned (D % 4 != 0
//     or an unaligned base) takes a plain copy by the producer warp instead
//     of TMA. tests/test_torch_f32_tiles.py emulates the fragments, the
//     descriptors, the keys tile, the screen, the masks, the selection and
//     the cut across splits.
//
// Bound on the NVIDIA H100 80GB HBM3 (the SXM part; published at 700 W:
// 3.35 TB/s; tensor cores 495 TFLOP/s TF32, 989 TFLOP/s bf16, 1,979 TOP/s
// int8). The f32 scan only builds the shortlist that the exact f32 rerank
// corrects, so TF32 tensor cores are admissible for it and its bound takes
// the TF32 rate; 3xTF32 runs three TF32 products, so its own floor is three
// times that operation bound. At N = 1,048,576 rows of D = 384: bytes, the
// store once plus its norms (f32 1.61 GB -> 0.48 ms, bf16 0.81 GB -> 0.24
// ms, int8 0.41 GB -> 0.12 ms); operations 2*B*N*D (B = 128: 0.103 TFLOP
// -> f32 0.21 ms (3xTF32: 0.62 ms), bf16 0.10 ms, int8 0.05 ms; B = 1024:
// 0.82 TFLOP -> f32 1.67 ms (3xTF32: 5.0 ms), bf16 0.83 ms, int8 0.42 ms).
// At the benchmark's 1,000,000 x 768 f32: 3.07 GB -> 0.92 ms; B = 128:
// 0.197 TFLOP -> 0.40 ms, 3xTF32 1.19 ms, so the f32 scan's own floor there
// is its products, 1.3x its bytes; B = 1: the bytes alone. So every store
// is bound by bytes at B = 128 and by operations at B = 1024 (the f32
// mode's 3xTF32 floor by operations at B = 128 and D = 768 too). What holds
// the kernels back is in PERF.md, measured with tools/flat_mma_breakdown.py
// (its profile build counts the f32 kernel's producer and consumer cycles
// by phase). The f32 kernel's L2 traffic is the store once plus, for every
// 128-row tile, the block's staged queries (hi and lo: 2 x NQ x D x 4
// bytes), 9.2 GB a call at the benchmark's B = 128. Modes 1-3: at B = 128
// the warp selection, which runs between the tiles' products, takes about
// half of the bf16 modes' time and 60% of mode 2's; at B = 1024 every one of
// the 16 query tiles reads the store again from L2. Two blocks of 8 warps
// share an SM at small k (about 105 KB of shared memory each for bf16, 78 KB
// for int8, at k = 20), and the split count keeps the grid to one wave.
// Mode 2 reads half of bf16's bytes and has no decode pass, so at B = 128
// the warp selection is the larger part of its time. Its chunks are 128
// columns: at 64 (64 bytes a row) a row tile took six ring steps and
// barriers for half of bf16's bytes, 20-25% slower. chip_smoke.py computes
// the bound for each run's shapes and times every mode beside it.
// Registers (ptxas -v of the shipped build, printed by chip_smoke.py):
// scan_topk_f32_wgmma_kernel<NQ> 168 at launch for every NQ (384 threads,
// one block per SM; the consumers take 232 after setmaxnreg; NQ 8, 64, 112
// and 128 spill nothing), scan_topk_mma_kernel<1>, <2> and <3> 127 each
// (the launch bounds cap them at 128 for two blocks per SM),
// merge_splits_kernel 26, stage_f32_queries_kernel 32.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>
#include <type_traits>

// Build-time switches of the tensor-core path, for tools/flat_mma_breakdown.py
// only (the shipped build takes these defaults): the ring's shape (FL2_DK
// bf16 columns per chunk, twice that in int8, FL2_STAGES deep) and two
// diagnostic cuts that skip the products or the selection (results wrong).
#ifndef FL2_DK
#define FL2_DK 64
#endif
#ifndef FL2_STAGES
#define FL2_STAGES 3
#endif
#ifndef FL2_NO_MMA
#define FL2_NO_MMA 0
#endif
#ifndef FL2_NO_SELECT
#define FL2_NO_SELECT 0
#endif

namespace {

constexpr int QT = 64;            // queries per block
constexpr int RT = 64;            // store rows per tile
constexpr int NT = 256;           // threads per block (8 warps)
constexpr int SMEM_LIST_MAX = 128;
constexpr int MAX_SPLITS = 128;   // 4 per lane in the merge pass
constexpr unsigned FULL = 0xffffffffu;
constexpr int INT_MAXV = 0x7fffffff;
static_assert(QT == RT, "the chunk loader stages RT rows of the queries too");

// The tensor-core path.
constexpr int STAGES = FL2_STAGES;           // ring depth
constexpr size_t SMEM_MAX = 232448;          // dynamic shared memory a block may use

// Per-mode shapes of scan_topk_mma_kernel (modes 1-3). T: the product
// operand's element (bf16 bits for modes 1 and 3, whose int8 codes decode
// to bf16; int8 for mode 2); Acc: the accumulator (int32 for mode 2, else
// f32); DKC: feature columns per ring chunk (FL2_DK bf16 or 2 * FL2_DK int8
// columns: the same bytes a row); V: elements per 16 bytes; SK: the padded
// chunk row, DKC + V elements (16 mod 128 bytes).
template <int MODE>
struct Op {
    static_assert(MODE >= 1 && MODE <= 3, "mode 0 has its own kernel, scan_topk_f32_wgmma_kernel");
    using T = typename std::conditional<MODE == 2, int8_t, uint16_t>::type;
    using Acc = typename std::conditional<MODE == 2, int, float>::type;
    static constexpr int DKC = MODE == 2 ? 2 * FL2_DK : FL2_DK;
    static constexpr int V = 16 / (int)sizeof(T);
    static constexpr int SK = DKC + V;
    static_assert((RT * DKC / V) % NT == 0, "whole 16-byte copies per thread per chunk");
    static_assert(DKC % (2 * V) == 0, "whole 32-byte k steps per chunk");
};
static_assert((RT * FL2_DK / 16) % NT == 0, "whole 16-byte int8 copies per thread per chunk");

// -- sorted per-query lists and their selection (every mode) ------------------

// Insert (key, pos) into the warp's sorted list lk/lp of length K. The
// caller guarantees pos exceeds every position already in the list, so
// the insertion point is the count of entries with key' <= key.
__device__ __forceinline__ void warp_insert(float* lk, int* lp, int K, float key, int pos, int lane) {
    if (!(key < lk[K - 1])) return;                 // warp-uniform
    int cnt = 0;
    for (int j = lane; j < K; j += 32) cnt += (lk[j] <= key) ? 1 : 0;
    const int p = __reduce_add_sync(FULL, cnt);     // insertion index, < K
    // Shift [p, K-2] up by one, highest chunk first.
    for (int base = ((K - 2) / 32) * 32; K >= 2 && base >= 0; base -= 32) {
        const int j = base + lane;
        const bool act = j >= p && j <= K - 2;
        float vk = 0.f;
        int vp = 0;
        if (act) { vk = lk[j]; vp = lp[j]; }
        __syncwarp();
        if (act) { lk[j + 1] = vk; lp[j + 1] = vp; }
        __syncwarp();
        if (base <= p) break;
    }
    if (lane == 0) { lk[p] = key; lp[p] = pos; }
    __syncwarp();
}

// A block's (split, query tile) lists: in shared memory, or directly in the
// partial-output buffer.
struct Lists {
    float* sk;
    int* sp;
    float* pk;
    int* pp;
    int64_t part0;   // (split * B + q0) * K
    int K;
    bool smem;
    __device__ float* k(int qi) const { return smem ? sk + qi * K : pk + part0 + (int64_t)qi * K; }
    __device__ int* p(int qi) const { return smem ? sp + qi * K : pp + part0 + (int64_t)qi * K; }
};

// The lists of the block's nq queries, warp `warp` of `warps` taking
// queries warp, warp + warps, ...: every entry (inf, INT32_MAX).
__device__ __forceinline__ void lists_init(const Lists& L, int B, int q0, int nq, int warp, int warps) {
    const int lane = threadIdx.x & 31;
    for (int qi = warp; qi < nq; qi += warps) {
        if (q0 + qi >= B) continue;
        float* lk = L.k(qi);
        int* lp = L.p(qi);
        for (int j = lane; j < L.K; j += 32) { lk[j] = __int_as_float(0x7f800000); lp[j] = INT_MAXV; }
    }
}

// Selection of one keys tile (QT x RT, stride RT + 1) whose first row is
// r0: warp w owns queries w, w + 8, ...; lane l looks at columns l and
// l + 32, candidates are taken in ascending column (= position) order.
__device__ __forceinline__ void select_tile(const Lists& L, const float* keys_s, int r0, int B, int q0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int K = L.K;
    for (int qi = warp; qi < QT; qi += NT / 32) {
        if (q0 + qi >= B) continue;
        float* lk = L.k(qi);
        int* lp = L.p(qi);
        const float thr = lk[K - 1];
        const float k0 = keys_s[qi * (RT + 1) + lane];
        const float k1 = keys_s[qi * (RT + 1) + lane + 32];
        unsigned m0 = __ballot_sync(FULL, k0 < thr);
        unsigned m1 = __ballot_sync(FULL, k1 < thr);
        while (m0) {
            const int src = __ffs(m0) - 1;
            m0 &= m0 - 1;
            warp_insert(lk, lp, K, __shfl_sync(FULL, k0, src), r0 + src, lane);
        }
        while (m1) {
            const int src = __ffs(m1) - 1;
            m1 &= m1 - 1;
            warp_insert(lk, lp, K, __shfl_sync(FULL, k1, src), r0 + 32 + src, lane);
        }
    }
}

// Copy lists kept in shared memory out to the partial-output buffer (the
// queries as lists_init splits them).
__device__ __forceinline__ void lists_flush(const Lists& L, int B, int q0, int nq, int warp, int warps) {
    if (!L.smem) return;
    const int lane = threadIdx.x & 31;
    for (int qi = warp; qi < nq; qi += warps) {
        if (q0 + qi >= B) continue;
        const int64_t o = L.part0 + (int64_t)qi * L.K;
        for (int j = lane; j < L.K; j += 32) {
            L.pk[o + j] = L.sk[qi * L.K + j];
            L.pp[o + j] = L.sp[qi * L.K + j];
        }
    }
}

// -- tensor-core pass 1 (every mode) ---------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills when !ok (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)) : "memory");
}

// d += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32 s8, row) . b (32x8 s8, col), s32 accumulators (exact; no
// .satfinite: |sum| <= 128 * 128 * D stays far inside int32). The fragments
// are the bf16 m16n8k16 ones read as bytes (PTX ISA, m16n8k32 .s8: a_i of
// register r holds row g + 8 (r & 1), column 16 (r >> 1) + 4 t + i; b_i of
// register r column g, row 16 r + 4 t + i), so ldmatrix.b16 loads them alike.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (10 stored mantissa bits): to nearest, ties away from
// zero, as cvt.rna.tf32.f32 rounds a finite x; the low 13 bits are zero.
__device__ __forceinline__ float tf32_rna(float x) {
    return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// x = hi + lo + (below f32's rounding), hi and lo exact TF32 values.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(__fsub_rn(x, hi));
}

// Shared-memory layout of scan_topk_mma_kernel<MODE>, computed alike on the
// host (to size the launch) and in the kernel (to place its buffers).
struct MmaLayout {
    int x_bytes;       // the store chunk of a stage
    int stage_bytes;   // the store chunk, then (streamed queries) the query chunk
    int dqs;           // row stride of the resident queries (elements)
    size_t ring;       // STAGES stages
    size_t aux;        // mode 3: the decoded bf16 chunk
    size_t qs, keys, lists, total;
};

template <int MODE>
__host__ __device__ inline MmaLayout mma_layout(int D, int K, bool q_res, bool smem_lists) {
    using O = Op<MODE>;
    constexpr int es = sizeof(typename O::T);
    MmaLayout L;
    L.x_bytes = MODE == 3 ? RT * O::DKC : RT * O::SK * es;
    L.stage_bytes = L.x_bytes + (q_res ? 0 : QT * O::SK * es);
    L.dqs = (D + O::DKC - 1) / O::DKC * O::DKC + O::V;   // 16 mod 128 bytes, as SK
    size_t o = 0;
    L.ring = o; o += (size_t)STAGES * L.stage_bytes;
    L.aux = o; o += MODE == 3 ? RT * O::SK * 2 : 0;
    L.qs = o; o += q_res ? (size_t)QT * L.dqs * es : 0;
    L.keys = o; o += sizeof(float) * QT * (RT + 1);
    L.lists = o; o += smem_lists ? (size_t)QT * K * (sizeof(float) + sizeof(int)) : 0;
    L.total = o;
    return L;
}

// Where the launch puts the queries and the lists: resident queries when
// they fit, then the lists in shared memory when they fit beside them.
struct MmaPlan {
    bool q_res, smem_lists;
    size_t smem;
};

template <int MODE>
MmaPlan mma_plan(int D, int K) {
    const bool q_res = mma_layout<MODE>(D, K, true, false).total <= SMEM_MAX;
    const bool smem_lists = K <= SMEM_LIST_MAX && mma_layout<MODE>(D, K, q_res, true).total <= SMEM_MAX;
    return {q_res, smem_lists, mma_layout<MODE>(D, K, q_res, smem_lists).total};
}

// One DKC-column chunk of ROWS rows [row0, row_lim) of a row-major (., D)
// f32, bf16 or int8 matrix into dst (stride SK), zero past row_lim and D:
// 16-byte cp.async when rows are aligned, else a plain loader.
template <typename T, int DKC, int SK, int ROWS = RT>
__device__ __forceinline__ void load_chunk(const T* __restrict__ src, int row0, int row_lim, int D,
                                           int c0, T* dst, bool async) {
    constexpr int V = 16 / (int)sizeof(T);
    static_assert((ROWS * DKC / V) % NT == 0, "whole 16-byte copies per thread per chunk");
    if (async) {
#pragma unroll
        for (int i = 0; i < (ROWS * DKC / V) / NT; ++i) {
            const int idx = threadIdx.x + NT * i;
            const int r = idx / (DKC / V), c = (idx % (DKC / V)) * V;
            const bool ok = row0 + r < row_lim && c0 + c < D;
            cp_async16(dst + r * SK + c, ok ? src + (int64_t)(row0 + r) * D + c0 + c : src, ok);
        }
    } else {
        for (int idx = threadIdx.x; idx < ROWS * DKC; idx += NT) {
            const int r = idx / DKC, c = idx % DKC;
            const bool ok = row0 + r < row_lim && c0 + c < D;
            dst[r * SK + c] = ok ? src[(int64_t)(row0 + r) * D + c0 + c] : T(0);
        }
    }
}

// The same for mode 3's raw int8 codes into dst (stride FL2_DK bytes: the
// decode reads them by rows, ldmatrix never does).
__device__ __forceinline__ void load_chunk_i8(const int8_t* __restrict__ src, int row0, int row_lim,
                                              int D, int c0, int8_t* dst, bool async) {
    constexpr int DK = FL2_DK;
    if (async) {
#pragma unroll
        for (int i = 0; i < (RT * DK / 16) / NT; ++i) {
            const int idx = threadIdx.x + NT * i;
            const int r = idx / (DK / 16), c = (idx % (DK / 16)) * 16;
            const bool ok = row0 + r < row_lim && c0 + c < D;
            cp_async16(dst + r * DK + c, ok ? src + (int64_t)(row0 + r) * D + c0 + c : src, ok);
        }
    } else {
        for (int idx = threadIdx.x; idx < RT * DK; idx += NT) {
            const int r = idx / DK, c = idx % DK;
            const bool ok = row0 + r < row_lim && c0 + c < D;
            dst[r * DK + c] = ok ? src[(int64_t)(row0 + r) * D + c0 + c] : (int8_t)0;
        }
    }
}

// Decode a raw int8 chunk to bf16 (stride Op<3>::SK), exactly: 16 codes per copy.
__device__ __forceinline__ void decode_chunk(const int8_t* raw, uint16_t* dec) {
    constexpr int DK = FL2_DK;
#pragma unroll
    for (int i = 0; i < (RT * DK / 16) / NT; ++i) {
        const int idx = threadIdx.x + NT * i;
        const int r = idx / (DK / 16), c = (idx % (DK / 16)) * 16;
        const int4 w = *reinterpret_cast<const int4*>(raw + r * DK + c);
        const int wv[4] = {w.x, w.y, w.z, w.w};
        unsigned out[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const unsigned v = (unsigned)wv[j];   // bytes in address order from the low end
            const __nv_bfloat162 lo = __floats2bfloat162_rn((float)((int)(v << 24) >> 24),
                                                            (float)((int)(v << 16) >> 24));
            const __nv_bfloat162 hi = __floats2bfloat162_rn((float)((int)(v << 8) >> 24),
                                                            (float)((int)v >> 24));
            out[2 * j] = *reinterpret_cast<const unsigned*>(&lo);
            out[2 * j + 1] = *reinterpret_cast<const unsigned*>(&hi);
        }
        uint4* d = reinterpret_cast<uint4*>(dec + r * Op<3>::SK + c);
        d[0] = make_uint4(out[0], out[1], out[2], out[3]);
        d[1] = make_uint4(out[4], out[5], out[6], out[7]);
    }
}

// MODE 1: bf16 store; 2: int8 store and int8 queries with per-query scales
// rs (s8 products, exact int32 dots); 3: int8 codes (decoded to bf16) with
// bf16 queries. q_res: the query tile is resident (else it streams through
// the ring); smem_lists: the lists are in shared memory; x_async / q_async:
// rows are 16-byte aligned and load with cp.async.
template <int MODE>
__global__ void __launch_bounds__(NT, 2)
scan_topk_mma_kernel(const void* __restrict__ qv, const void* __restrict__ xv,
                     const float* __restrict__ norms, const float* __restrict__ rs,
                     int B, int N, int D, int K,
                     int rows_per_split, int q_res, int smem_lists, int x_async, int q_async,
                     float* __restrict__ part_k, int* __restrict__ part_p) {
    using O = Op<MODE>;
    using T = typename O::T;
    extern __shared__ __align__(16) unsigned char smem[];
    const MmaLayout L = mma_layout<MODE>(D, K, q_res, smem_lists);
    const T* q = static_cast<const T*>(qv);
    float* keys_s = reinterpret_cast<float*>(smem + L.keys);
    float* list_base_k = reinterpret_cast<float*>(smem + L.lists);
    T* qs = reinterpret_cast<T*>(smem + L.qs);
    T* aux = reinterpret_cast<T*>(smem + L.aux);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = blockIdx.x * QT;
    const int split = blockIdx.y;
    const int row_begin = split * rows_per_split;
    const int row_end = min(N, row_begin + rows_per_split);
    const int n_chunks = (D + O::DKC - 1) / O::DKC;
    const int n_tiles = row_end > row_begin ? (row_end - row_begin + RT - 1) / RT : 0;
    const int total = n_tiles * n_chunks;   // ring steps: (tile, chunk) in order

    const Lists lists{list_base_k, reinterpret_cast<int*>(list_base_k + QT * K), part_k, part_p,
                      ((int64_t)split * B + q0) * K, K, smem_lists != 0};
    lists_init(lists, B, q0, QT, warp, NT / 32);
    if (q_res) {
        const int dqp = L.dqs - O::V;
        for (int idx = tid; idx < QT * dqp; idx += NT) {
            const int r = idx / dqp, c = idx % dqp;
            qs[r * L.dqs + c] = (q0 + r < B && c < D) ? q[(int64_t)(q0 + r) * D + c] : T(0);
        }
    }

    auto issue = [&](int step) {
        unsigned char* st = smem + L.ring + (size_t)(step % STAGES) * L.stage_bytes;
        const int r0 = row_begin + (step / n_chunks) * RT;
        const int c0 = (step % n_chunks) * O::DKC;
        if constexpr (MODE == 3)
            load_chunk_i8(static_cast<const int8_t*>(xv), r0, row_end, D, c0,
                          reinterpret_cast<int8_t*>(st), x_async);
        else
            load_chunk<T, O::DKC, O::SK>(static_cast<const T*>(xv), r0, row_end, D, c0,
                                         reinterpret_cast<T*>(st), x_async);
        if (!q_res)
            load_chunk<T, O::DKC, O::SK>(q, q0, B, D, c0, reinterpret_cast<T*>(st + L.x_bytes),
                                         q_async);
    };

    // Warp (wq, wr) owns queries wq*16 .. +15 and tile rows wr*32 .. +31:
    // four n8 pieces. Fragment lanes: g = lane / 4, t = lane % 4.
    const int wq = warp & 3, wr = warp >> 2;
    const int g = lane >> 2, t4 = lane & 3;
    typename O::Acc acc[4][4];
    float nrm[4][2];
    float qscale[2] = {0.f, 0.f};   // mode 2: rs of this thread's queries g and g + 8
    if constexpr (MODE == 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int qi = q0 + wq * 16 + g + 8 * h;
            qscale[h] = qi < B ? rs[qi] : 0.f;
        }
    }

#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        if (i < total) issue(i);
        cp_async_commit();
    }
    for (int s = 0; s < total; ++s) {
        cp_async_wait<STAGES - 2>();     // this thread's copies of step s landed
        __syncthreads();                 // everyone's; and step s-1's stage is free
        if (s + STAGES - 1 < total) issue(s + STAGES - 1);
        cp_async_commit();

        const int chunk = s % n_chunks;
        const int r0 = row_begin + (s / n_chunks) * RT;
        const unsigned char* st = smem + L.ring + (size_t)(s % STAGES) * L.stage_bytes;
        if (chunk == 0) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int row = r0 + wr * 32 + nt * 8 + 2 * t4 + e;
                    nrm[nt][e] = row < row_end ? norms[row] : 0.f;
                }
            }
        }
        const T* bt = reinterpret_cast<const T*>(st);
        const T* at = q_res ? qs + chunk * O::DKC : reinterpret_cast<const T*>(st + L.x_bytes);
        if constexpr (MODE == 3) {
            decode_chunk(reinterpret_cast<const int8_t*>(st), aux);
            __syncthreads();
            bt = aux;
        }
        const int as = q_res ? L.dqs : O::SK;
        const int kw = min(O::DKC, D - chunk * O::DKC);
        // ldmatrix row addresses, 16 bytes each: A's four pieces are (rows
        // 0-7 | 8-15) x (bytes 0-15 | 16-31) of a 32-byte k step; B's are
        // (n 0-7, bytes 0-15), (n 0-7, bytes 16-31), then n 8-15 alike.
        // bf16 reads them as 8x8 b16 matrices (k16), int8 as 8x16 s8 (k32).
        const int a_off = (wq * 16 + (lane & 15)) * as + (lane >> 4) * O::V;
        const int b_off = (wr * 32 + (lane >> 4) * 8 + (lane & 7)) * O::SK + ((lane >> 3) & 1) * O::V;
        // One 32-byte k step of the warp's four pieces.
        auto k_step = [&](int kk) {
            if constexpr (MODE == 2) {
                unsigned a[4], b01[4], b23[4];
                ldmatrix_x4(a, at + a_off + kk);
                ldmatrix_x4(b01, bt + b_off + kk);
                ldmatrix_x4(b23, bt + b_off + 16 * O::SK + kk);
                mma_s8(acc[0], a, b01[0], b01[1]);
                mma_s8(acc[1], a, b01[2], b01[3]);
                mma_s8(acc[2], a, b23[0], b23[1]);
                mma_s8(acc[3], a, b23[2], b23[3]);
            } else {
                unsigned a[4], b01[4], b23[4];
                ldmatrix_x4(a, at + a_off + kk);
                ldmatrix_x4(b01, bt + b_off + kk);
                ldmatrix_x4(b23, bt + b_off + 16 * O::SK + kk);
                mma_bf16(acc[0], a, b01[0], b01[1]);
                mma_bf16(acc[1], a, b01[2], b01[3]);
                mma_bf16(acc[2], a, b23[0], b23[1]);
                mma_bf16(acc[3], a, b23[2], b23[3]);
            }
        };
        if (FL2_NO_MMA) {
        } else {
#pragma unroll
            for (int kk = 0; kk < O::DKC; kk += 2 * O::V)
                if (kk < kw) k_step(kk);
        }

        if (chunk == n_chunks - 1) {
            // Keys of this tile: accumulator (h, e) of piece nt is query
            // g + 8h, tile row nt*8 + 2t + e. Mode 2 rounds twice (product,
            // then sum) exactly as the plain version, never fused.
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = wr * 32 + nt * 8 + 2 * t4 + e;
                        float key;
                        if constexpr (MODE == 2)
                            key = __fadd_rn(__fmul_rn((float)acc[nt][2 * h + e], qscale[h]), nrm[nt][e]);
                        else
                            key = __fadd_rn(nrm[nt][e], acc[nt][2 * h + e]);
                        keys_s[(wq * 16 + g + 8 * h) * (RT + 1) + col] =
                            r0 + col < row_end ? key : __int_as_float(0x7f800000);
                    }
            __syncthreads();
            // The next write of keys_s comes after the next step's barrier.
            if (!FL2_NO_SELECT) select_tile(lists, keys_s, r0, B, q0);
        }
    }
    cp_async_wait<0>();
    lists_flush(lists, B, q0, QT, warp, NT / 32);
}

// -- the f32 pass (mode 0) ------------------------------------------------------------

// FL2_PROFILE 1: scan_topk_f32_wgmma_kernel counts its warps' clock cycles
// by role and phase into fl2_prof (fused_l2_topk_profile reads and clears
// them): the producer's waits for a free stage and its issue of the copies;
// each consumer warp's waits for a full stage, its loads and splits of the
// store, its wgmma issue, its waits on the products, its folds and stage
// releases, the screen with the keys tile and its barriers, and the
// selection; then two counts, the keys the screen compared (rows before
// the split's end, queries before B) and the keys it passed.
#ifndef FL2_PROFILE
#define FL2_PROFILE 0
#endif
#if FL2_PROFILE
constexpr int FL2_PHASES = 9;
constexpr int FL2_SLOTS = FL2_PHASES + 2;        // the phases, keys screened, keys passed
__device__ unsigned long long fl2_prof[FL2_SLOTS];
// Lane 0 of each warp adds the cycles since its last mark to its warp's
// counter of phase i, in shared memory. The marks still cost registers: at
// query tiles near 128 this build spills and ptxas serializes its wgmmas,
// so there its shares locate the time and its times run slow.
#define FL2_MARK(i)                                                   \
    do {                                                              \
        if (lane == 0) {                                              \
            const unsigned now_ = (unsigned)clock();                  \
            prof_s_[warp * FL2_SLOTS + (i)] += now_ - prof_t_;        \
            prof_t_ = now_;                                           \
        }                                                             \
    } while (0)
#else
#define FL2_MARK(i) \
    do {            \
    } while (0)
#endif

// scan_topk_f32_wgmma_kernel's shapes: a tile of FW_R store rows (64 a
// consumer warpgroup, wgmma's M) by the block's NQ queries (wgmma's N, a
// multiple of 8 up to FW_QMAX); ring stages of FW_SC f32 columns: FW_BOXES
// store boxes [FW_R][FW_DK] as TMA lands them (64-byte rows), then for each
// box the queries' hi and lo parts as wgmma's K-major B operands; the keys
// tile [NQ][FW_KS] for the selection, with each query's survivor masks
// [NQ][FW_CONSUMER_WARPS] (16 bits a warp: its 16 rows of the tile) and
// threshold [NQ].
constexpr int FW_R = 128;
constexpr int FW_DK = 16;                        // f32 columns a box: two k steps
constexpr int FW_BOXES = 2;                      // boxes a stage
constexpr int FW_SC = FW_DK * FW_BOXES;          // f32 columns a stage
constexpr int FW_QMAX = 128;
constexpr int FW_KS = FW_R + 4;                  // conflict-free writes from the accumulators
constexpr int FW_THREADS = 384;                  // producer warpgroup + two consumer warpgroups
constexpr int FW_CONSUMER_WARPS = 8;
constexpr int FW_SELECTORS = 3;                  // the producer warpgroup's other warps
constexpr int FW_SCREEN_THREADS = 32 * (FW_CONSUMER_WARPS + FW_SELECTORS);
// Named barriers (0 is __syncthreads): each tile's screen, consumers and
// selectors (FW_BAR_TILE); its survivors written, for the selectors
// (FW_BAR_KEYS) or for the consumers alone (FW_BAR_OWN); the split done
// (FW_BAR_DONE).
constexpr int FW_BAR_TILE = 1, FW_BAR_KEYS = 2, FW_BAR_OWN = 3, FW_BAR_DONE = 4;
// The selectors take a tile whose candidates sit in at most this many
// consumer lanes for each ring stage of the tile (so in about the time of
// the next tile's products); the consumers select a busier tile themselves.
constexpr int FW_SEL_LANES = 8;
constexpr int FW_MAX_STAGES = 8;
constexpr int FW_MIN_STAGES = 4;                 // the lists leave shared memory before the ring shrinks below
constexpr int FW_BOX_BYTES = FW_R * FW_DK * 4;   // a store box
constexpr int FW_X_BYTES = FW_BOXES * FW_BOX_BYTES;   // the store chunk of a stage
static_assert(FW_R == 2 * 64 && FW_DK == 16, "two m64 warpgroups; a float4 a lane gives two k steps");

// The staged queries of a stage: for each box, the hi then the lo part.
__host__ __device__ constexpr int fw_q_bytes(int nq) { return FW_BOXES * 2 * nq * FW_DK * 4; }
__host__ __device__ constexpr int fw_stage_bytes(int nq) { return FW_X_BYTES + fw_q_bytes(nq); }

// Logical column kappa (0-15) of a box's B operand: the query column it
// holds. A lane's float4 of a store row holds columns 4t .. 4t + 3, which
// are its A fragment's (k t, k t + 4) of k step 0, then of k step 1
// (wgmma m64nNk8 tf32: a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3
// (g + 8, t + 4)); the queries are staged in that order.
__host__ __device__ constexpr int fw_perm(int kappa) {
    return 4 * (kappa & 3) + 2 * (kappa >> 3) + ((kappa >> 2) & 1);
}

// Shared memory of scan_topk_f32_wgmma_kernel<NQ>: the ring, the keys tile,
// the survivor masks (16-byte aligned: a query's eight are read as one
// uint4) and the thresholds, the lists when they are kept there, the
// ring's barriers.
struct FwLayout {
    int stages;
    bool smem_lists;
    size_t keys, masks, thr, lists, bars, total;
};

__host__ __device__ inline FwLayout fw_layout(int nq, int K, int stages, bool smem_lists) {
    FwLayout L;
    L.stages = stages;
    L.smem_lists = smem_lists;
    size_t o = (size_t)stages * fw_stage_bytes(nq);
    L.keys = o; o += sizeof(float) * nq * FW_KS;
    L.masks = o; o += sizeof(uint16_t) * nq * FW_CONSUMER_WARPS;
    L.thr = o; o += sizeof(float) * nq;
    L.lists = o; o += smem_lists ? (size_t)nq * K * (sizeof(float) + sizeof(int)) : 0;
    o = (o + 7) / 8 * 8;
    L.bars = o; o += 2 * FW_MAX_STAGES * sizeof(uint64_t);
    L.total = o;
    return L;
}

// The deepest ring (at most FW_MAX_STAGES) that fits; the lists stay in
// shared memory when they fit beside a ring of FW_MIN_STAGES or more.
inline FwLayout fw_plan(int nq, int K) {
    constexpr size_t budget = SMEM_MAX - (FL2_PROFILE ? 1024 : 0);   // the profile's counters
    auto deepest = [&](bool sl) {
        int s = FW_MAX_STAGES;
        while (s > 2 && fw_layout(nq, K, s, sl).total > budget) --s;
        return s;
    };
    const bool sl = K <= SMEM_LIST_MAX && deepest(true) >= FW_MIN_STAGES &&
                    fw_layout(nq, K, deepest(true), true).total <= budget;
    return fw_layout(nq, K, deepest(sl), sl);
}

// -- mbarriers, TMA and wgmma ----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const unsigned a = smem_addr(bar);
    for (;;) {
        unsigned ok;
        asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(ok) : "r"(a), "r"(parity) : "memory");
        if (ok) return;
    }
}
// A 2-D TMA box (columns c0.., rows r0..; zeros past the tensor) into dst.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int r0,
                                            uint64_t* bar) {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%3, %4}], [%2];\n"
                 :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
                    "r"(c0), "r"(r0) : "memory");
}
// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into dst.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
// bar.sync that also returns the number of the threads in which `pred` held.
__device__ __forceinline__ int bar_red_popc(int id, int threads, bool pred) {
    int n;
    asm volatile("{\n.reg .pred q;\nsetp.ne.u32 q, %1, 0;\nbar.red.popc.u32 %0, %2, %3, q;\n}\n"
                 : "=r"(n) : "r"((unsigned)pred), "r"(id), "r"(threads) : "memory");
    return n;
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Wait until at most N committed groups of this warpgroup are still running.
template <int N>
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory"); }
// Keep the compiler from moving or reusing registers that wgmma reads or
// writes asynchronously, across the points where they are fenced.
template <int R>
__device__ __forceinline__ void keep(float (&r)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ void keep(unsigned (&r)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}
template <int F>
__device__ __forceinline__ void keep(unsigned (&r)[F][4]) {
#pragma unroll
    for (int j = 0; j < F; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[j][i]) :: "memory");
}

// A K-major B operand in shared memory, no swizzle: 8-query x 16-byte core
// matrices, `lbo` bytes apart along K, 128 bytes apart along the queries.
__device__ __forceinline__ uint64_t wg_desc(const void* p, unsigned lbo) {
    return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)(128 >> 4) << 32);
}

// d (+)= a (64 x 8 tf32, registers) . b (8 x N tf32, K-major in shared
// memory): wgmma.mma_async m64nNk8, f32 accumulators; acc = 0 drops d's
// earlier value (a fresh accumulator). d[4 j + 2 h + e] is row g + 8 h of
// the warp's 16, query 8 j + 2 t + e. One macro writes it for every N:
// d's asm registers (FL2_DS_N: %0 .. %(N / 2 - 1)) and constraints
// (FL2_OP_N) grow four at a time; a[0..3], b and acc follow them.
#define FL2_S(a, b, c, d) "%" #a ", %" #b ", %" #c ", %" #d
#define FL2_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FL2_DS_8 FL2_S(0, 1, 2, 3)
#define FL2_OP_8 FL2_D4(0)
#define FL2_DS_16 FL2_DS_8 ", " FL2_S(4, 5, 6, 7)
#define FL2_OP_16 FL2_OP_8, FL2_D4(4)
#define FL2_DS_24 FL2_DS_16 ", " FL2_S(8, 9, 10, 11)
#define FL2_OP_24 FL2_OP_16, FL2_D4(8)
#define FL2_DS_32 FL2_DS_24 ", " FL2_S(12, 13, 14, 15)
#define FL2_OP_32 FL2_OP_24, FL2_D4(12)
#define FL2_DS_40 FL2_DS_32 ", " FL2_S(16, 17, 18, 19)
#define FL2_OP_40 FL2_OP_32, FL2_D4(16)
#define FL2_DS_48 FL2_DS_40 ", " FL2_S(20, 21, 22, 23)
#define FL2_OP_48 FL2_OP_40, FL2_D4(20)
#define FL2_DS_56 FL2_DS_48 ", " FL2_S(24, 25, 26, 27)
#define FL2_OP_56 FL2_OP_48, FL2_D4(24)
#define FL2_DS_64 FL2_DS_56 ", " FL2_S(28, 29, 30, 31)
#define FL2_OP_64 FL2_OP_56, FL2_D4(28)
#define FL2_DS_72 FL2_DS_64 ", " FL2_S(32, 33, 34, 35)
#define FL2_OP_72 FL2_OP_64, FL2_D4(32)
#define FL2_DS_80 FL2_DS_72 ", " FL2_S(36, 37, 38, 39)
#define FL2_OP_80 FL2_OP_72, FL2_D4(36)
#define FL2_DS_88 FL2_DS_80 ", " FL2_S(40, 41, 42, 43)
#define FL2_OP_88 FL2_OP_80, FL2_D4(40)
#define FL2_DS_96 FL2_DS_88 ", " FL2_S(44, 45, 46, 47)
#define FL2_OP_96 FL2_OP_88, FL2_D4(44)
#define FL2_DS_104 FL2_DS_96 ", " FL2_S(48, 49, 50, 51)
#define FL2_OP_104 FL2_OP_96, FL2_D4(48)
#define FL2_DS_112 FL2_DS_104 ", " FL2_S(52, 53, 54, 55)
#define FL2_OP_112 FL2_OP_104, FL2_D4(52)
#define FL2_DS_120 FL2_DS_112 ", " FL2_S(56, 57, 58, 59)
#define FL2_OP_120 FL2_OP_112, FL2_D4(56)
#define FL2_DS_128 FL2_DS_120 ", " FL2_S(60, 61, 62, 63)
#define FL2_OP_128 FL2_OP_120, FL2_D4(60)
#define FL2_WGMMA(N, A0, A1, A2, A3, B, P)                                                  \
    template <>                                                                             \
    __device__ __forceinline__ void wgmma_tf32<N>(float (&d)[N / 2], const unsigned (&a)[4], \
                                                  uint64_t b, int acc) {                  \
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                          \
                     "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" FL2_DS_##N   \
                     "}, {" FL2_S(A0, A1, A2, A3) "}, %" #B ", p, 1, 1;\n}\n"                  \
                     : FL2_OP_##N                                                         \
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));    \
    }
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const unsigned (&a)[4], uint64_t b, int acc);
FL2_WGMMA(8, 4, 5, 6, 7, 8, 9)
FL2_WGMMA(16, 8, 9, 10, 11, 12, 13)
FL2_WGMMA(24, 12, 13, 14, 15, 16, 17)
FL2_WGMMA(32, 16, 17, 18, 19, 20, 21)
FL2_WGMMA(40, 20, 21, 22, 23, 24, 25)
FL2_WGMMA(48, 24, 25, 26, 27, 28, 29)
FL2_WGMMA(56, 28, 29, 30, 31, 32, 33)
FL2_WGMMA(64, 32, 33, 34, 35, 36, 37)
FL2_WGMMA(72, 36, 37, 38, 39, 40, 41)
FL2_WGMMA(80, 40, 41, 42, 43, 44, 45)
FL2_WGMMA(88, 44, 45, 46, 47, 48, 49)
FL2_WGMMA(96, 48, 49, 50, 51, 52, 53)
FL2_WGMMA(104, 52, 53, 54, 55, 56, 57)
FL2_WGMMA(112, 56, 57, 58, 59, 60, 61)
FL2_WGMMA(120, 60, 61, 62, 63, 64, 65)
FL2_WGMMA(128, 64, 65, 66, 67, 68, 69)
#undef FL2_WGMMA
#undef FL2_D4
#undef FL2_S

// -- the keys' selection --------------------------------------------------------------

// Selection of an NQ x FW_R keys tile (stride FW_KS) whose first row is r0,
// from the survivors that the screen left: warp w of `warps` owns queries
// w, w + warps, ...; a query's eight 16-bit masks, read as one uint4, are its
// candidates by column (bit b of word j: column 32 j + b), and lane l holds
// the keys of columns l + 32 j (j < C) of a query that has one. Candidates go
// in by ascending column (= position), each after every entry of key <= its
// own (select_tile's order). A candidate that the list has passed since the
// screen (its key >= the list's last) finds k entries of key' <= key and
// stays out, so a stale threshold changes no list. A warp takes its queries
// G at a time, so that G chains of dependent shuffles overlap (the
// consumers take 4; the selectors, on the producer warpgroup's few
// registers, 1, and only k <= 32): for lists of k <= 32 held in registers
// (lane j: entry j), one candidate of each of the G queries a round,
// branch-free. A candidate is in when fewer than k entries have key' <=
// key; every F_PRUNE rounds the candidates left are held against the lists'
// last keys again (a list's first tile admits every key, and most fall
// behind). Deeper lists take warp_insert, one at a time. A query whose list
// changed gets its new last key as its threshold and offers it to the cut,
// and its masks go back to zero.
constexpr int F_PRUNE = 4;

// A key as an int that orders like the key (for atomicMin), and back.
__device__ __forceinline__ int key_ord(float f) {
    const int i = __float_as_int(f);
    return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float ord_key(int i) { return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff); }
constexpr int ORD_INF = 0x7f800000;   // key_ord(+inf)

template <int G>   // queries a group: w + warps (G g + u), u < G
__device__ __forceinline__ void select_tile_f32(const Lists& L, const float* keys_s, uint16_t* masks,
                                                float* thr_s, int* cut, int r0, int B, int q0, int nq,
                                                int warp, int warps) {
    constexpr int C = FW_R / 32;
    constexpr int W = FW_CONSUMER_WARPS;   // a query's masks: one slot a consumer warp
    static_assert(C == 4 && W == 8, "a query's masks are one uint4: word j is warps 2 j and 2 j + 1");
    const int lane = threadIdx.x & 31;
    const int K = L.K;
    const float INF = __int_as_float(0x7f800000);
    for (int base = warp; base < nq && q0 + base < B; base += G * warps) {
        float kc[G][C];
        unsigned mc[G][C];
        bool has[G];   // query u has a candidate: its list is read and rewritten
        unsigned any = 0;
#pragma unroll
        for (int u = 0; u < G; ++u) {
            const int qi = base + u * warps;
            // A query past B or past the tile has no list and no candidate.
            const bool live = qi < nq && q0 + qi < B;
            const uint4 m = live ? *reinterpret_cast<const uint4*>(masks + qi * W) : make_uint4(0, 0, 0, 0);
            mc[u][0] = m.x;
            mc[u][1] = m.y;
            mc[u][2] = m.z;
            mc[u][3] = m.w;
            has[u] = (m.x | m.y | m.z | m.w) != 0;
            any |= m.x | m.y | m.z | m.w;
#pragma unroll
            for (int j = 0; j < C; ++j) kc[u][j] = has[u] ? keys_s[qi * FW_KS + 32 * j + lane] : INF;
        }
        if (!any) continue;
        if (G > 1 && K > 32) {   // the selectors take only k <= 32
#pragma unroll
            for (int u = 0; u < G; ++u) {
                const int qi = base + u * warps;
#pragma unroll
                for (int j = 0; j < C; ++j)
                    for (unsigned m = mc[u][j]; m; m &= m - 1) {
                        const int src = __ffs(m) - 1;
                        warp_insert(L.k(qi), L.p(qi), K, __shfl_sync(FULL, kc[u][j], src),
                                    r0 + 32 * j + src, lane);
                    }
                if (has[u] && lane == 0) {
                    const float last = L.k(qi)[K - 1];
                    thr_s[qi] = last;
                    if (last < __int_as_float(ORD_INF)) atomicMin(cut + q0 + qi, key_ord(last));
                    *reinterpret_cast<uint4*>(masks + qi * W) = make_uint4(0, 0, 0, 0);
                }
            }
            __syncwarp();
            continue;
        }
        float vk[G];
        int vp[G];
#pragma unroll
        for (int u = 0; u < G; ++u) {
            const int qi = base + u * warps;
            vk[u] = has[u] && lane < K ? L.k(qi)[lane] : INF;
            vp[u] = has[u] && lane < K ? L.p(qi)[lane] : INT_MAXV;
        }
        for (int round = 1; any; ++round) {
            if (round % F_PRUNE == 0) {
                // Drop the candidates that the lists have since passed.
                any = 0;
#pragma unroll
                for (int u = 0; u < G; ++u) {
                    const float thr = __shfl_sync(FULL, vk[u], K - 1);
#pragma unroll
                    for (int j = 0; j < C; ++j) {
                        mc[u][j] &= __ballot_sync(FULL, kc[u][j] < thr);
                        any |= mc[u][j];
                    }
                }
                if (!any) break;
            }
            any = 0;
#pragma unroll
            for (int u = 0; u < G; ++u) {
                // The next candidate of query u: the lowest bit of its first
                // non-empty ballot (+inf once it has none left).
                int js = C;
                unsigned m = 0;
                float kv = 0.f;
#pragma unroll
                for (int j = C - 1; j >= 0; --j)
                    if (mc[u][j]) { js = j; m = mc[u][j]; kv = kc[u][j]; }
                const int src = __ffs(m) - 1;
                const float ks = __shfl_sync(FULL, kv, src & 31);
                const float key = m ? ks : INF;
                const int pos = r0 + 32 * js + src;
#pragma unroll
                for (int j = 0; j < C; ++j) {
                    mc[u][j] = j == js ? m & (m - 1) : mc[u][j];
                    any |= mc[u][j];
                }
                // Insert after every entry of key' <= key (its position is
                // higher than theirs): at is that count, and the candidate is
                // in when at < k (lanes past k hold +inf).
                const int at = __popc(__ballot_sync(FULL, vk[u] <= key));
                const float uk = __shfl_up_sync(FULL, vk[u], 1);
                const int up = __shfl_up_sync(FULL, vp[u], 1);
                const bool in = at < K;
                const bool put = in && lane == at, shift = in && lane > at && lane < K;
                vk[u] = put ? key : shift ? uk : vk[u];
                vp[u] = put ? pos : shift ? up : vp[u];
            }
        }
#pragma unroll
        for (int u = 0; u < G; ++u) {
            const int qi = base + u * warps;
            if (has[u] && lane < K) {
                L.k(qi)[lane] = vk[u];
                L.p(qi)[lane] = vp[u];
                if (lane == K - 1) {
                    thr_s[qi] = vk[u];
                    if (vk[u] < INF) atomicMin(cut + q0 + qi, key_ord(vk[u]));
                }
                if (lane == 0) *reinterpret_cast<uint4*>(masks + qi * W) = make_uint4(0, 0, 0, 0);
            }
        }
        __syncwarp();
    }
}

// -- the queries' staging -------------------------------------------------------------

// The queries of every query tile, split once: out holds, for query tile qt
// and box c (columns 16 c ..; whole stages), the hi then the lo part of its
// NQ queries as wgmma's B operand (see wg_desc): [qt][c][part][k unit 4]
// [query group NQ/8][query 8][4 floats], logical column 4 (k unit) + float
// of the box holding query column 16 c + fw_perm(.); zero past B and D.
// ops/topk_cuda.stage_f32_plain is its plain version.
__global__ void stage_f32_queries_kernel(const float* __restrict__ q, int B, int D, int nq,
                                         int n_chunks, int64_t total, float* __restrict__ out,
                                         int* __restrict__ cut) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; cut && i < B; i += gridDim.x * blockDim.x)
        cut[i] = ORD_INF;
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
         i += (int64_t)gridDim.x * blockDim.x) {
        int64_t rem = i;
        const int kk = (int)(rem & 3); rem >>= 2;
        const int r = (int)(rem & 7); rem >>= 3;
        const int ng = (int)(rem % (nq / 8)); rem /= nq / 8;
        const int ku = (int)(rem & 3); rem >>= 2;
        const int part = (int)(rem & 1); rem >>= 1;
        const int c = (int)(rem % n_chunks);
        const int qt = (int)(rem / n_chunks);
        const int n = qt * nq + ng * 8 + r;
        const int col = c * FW_DK + fw_perm(ku * 4 + kk);
        const float v = n < B && col < D ? q[(int64_t)n * D + col] : 0.f;
        float hi, lo;
        split_tf32(v, hi, lo);
        out[i] = part ? lo : hi;
    }
}

// -- pass 1 of mode 0 -----------------------------------------------------------------

// The screen of a finished tile, in the accumulator registers: the key of
// (query 8 j + 2 t4 + e, tile row row_a + 8 h) is nrm[h] + kacc[4 j + 2 h + e]
// (nrm +inf past the split, so the key is too), and it is a candidate only
// when key < thr[query], the last key of the query's list (+inf while the
// list is unfilled, -inf past B). screen_any: whether any of this lane's
// keys is a candidate, against thresholds that may be stale (a selection of
// the tile before may still be running: a list's last key only falls, so a
// stale threshold passes a superset).
template <int NQ>
__device__ __forceinline__ bool screen_any(const float* thr_s, const float (&kacc)[NQ / 2],
                                           const float (&nrm)[2], int t4) {
    bool cand = false;
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
        const float2 thr = *reinterpret_cast<const float2*>(thr_s + 8 * j + 2 * t4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            cand |= __fadd_rn(nrm[h], kacc[4 * j + 2 * h]) < thr.x;
            cand |= __fadd_rn(nrm[h], kacc[4 * j + 2 * h + 1]) < thr.y;
        }
    }
    return cand;
}

// screen_write, once every selection of the tile before is done (every
// threshold current; the keys tile and the masks free), in a warp with a
// candidate (warp-uniform): the screen again, each survivor's key into its
// keys-tile slot and, for each query, the 16-bit mask of the warp's rows that
// survived (bit g + 8 h: tile row 16 v + g + 8 h; the warp's own slot, so no
// atomics). The masks are left zero by the selection that reads them.
// Returns this lane's survivors.
template <int NQ>
__device__ __forceinline__ int screen_write(float* keys_s, uint16_t* masks, const float* thr_s,
                                            const float (&kacc)[NQ / 2], const float (&nrm)[2],
                                            int row_a, int t4, int v) {
    const int g = (threadIdx.x & 31) >> 2;
    int passed = 0;
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
        const float2 thr = *reinterpret_cast<const float2*>(thr_s + 8 * j + 2 * t4);
        float key[4];   // [2 h + e]
        unsigned b = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            key[i] = __fadd_rn(nrm[i >> 1], kacc[4 * j + i]);
            b |= (unsigned)(key[i] < ((i & 1) ? thr.y : thr.x)) << i;
        }
        if (!__any_sync(FULL, b)) continue;
        passed += __popc(b);
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if (b >> i & 1) keys_s[(8 * j + 2 * t4 + (i & 1)) * FW_KS + row_a + 8 * (i >> 1)] = key[i];
        // Query 8 j + 2 t4 in the low half, + 1 in the high half; the OR
        // over the eight lanes of this t4 gathers the warp's 16 rows.
        unsigned w = (b & 1u) << g | (b >> 2 & 1u) << (g + 8) | (b >> 1 & 1u) << (g + 16) |
                     (b >> 3 & 1u) << (g + 24);
        w |= __shfl_xor_sync(FULL, w, 4);
        w |= __shfl_xor_sync(FULL, w, 8);
        w |= __shfl_xor_sync(FULL, w, 16);
        if (g < 2) masks[(8 * j + 2 * t4 + g) * FW_CONSUMER_WARPS + v] = (uint16_t)(w >> (16 * g));
    }
    return passed;
}

// kacc[o + i] = first ? f[i] : kacc[o + i] + f[i] (round to nearest): the fold
// of a fresh accumulator into the key's sum.
template <int NR, int W>
__device__ __forceinline__ void fold(float (&kacc)[NR], const float (&f)[W], int o, bool first) {
#pragma unroll
    for (int i = 0; i < W; ++i) kacc[o + i] = first ? f[i] : __fadd_rn(kacc[o + i], f[i]);
}

// One group: the three products of a k step into the fresh accumulator
// acc (W queries of the B operands that the descriptors dh, dl address: the
// queries' hi and lo parts), then its commit.
template <int W>
__device__ __forceinline__ void issue_group(float (&acc)[W / 2], const unsigned (&xh)[4],
                                            const unsigned (&xl)[4], uint64_t dh, uint64_t dl) {
    keep(acc);
    wg_fence();
    wgmma_tf32<W>(acc, xh, dl, 0);   // x_hi . q_lo, into a fresh accumulator
    wgmma_tf32<W>(acc, xl, dh, 1);   // x_lo . q_hi
    wgmma_tf32<W>(acc, xh, dh, 1);   // x_hi . q_hi
    wg_commit();
}

// A lane's k step e (0, 1) of a box from its float4s of rows row_a and
// row_a + 8, split once into wgmma's hi and lo A fragments (fw_perm).
__device__ __forceinline__ void split_step(const float4& x0, const float4& x1, int e,
                                           unsigned (&xh)[4], unsigned (&xl)[4]) {
    const float a[4] = {e ? x0.z : x0.x, e ? x1.z : x1.x, e ? x0.w : x0.y, e ? x1.w : x1.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float hi, lo;
        split_tf32(a[i], hi, lo);
        xh[i] = __float_as_uint(hi);
        xl[i] = __float_as_uint(lo);
    }
}

// Mode 0's pass 1: the f32 store against NQ queries in 3xTF32 on wgmma, a
// block per (query tile, split of the rows). Warpgroup 0 is the producer:
// one warp keeps the ring full, FW_BOXES TMA boxes of the store a stage (or,
// for a store whose rows are not 16-byte aligned, x_tma = 0, a plain copy)
// and one bulk copy of the stage's staged queries, each stage completed on
// its `full` barrier. Warpgroups 1 and 2 are the consumers, rows 0-63 and
// 64-127 of each tile: every k step, a lane's float4 of a store row splits
// in registers into wgmma's A fragments (hi and lo), and a group of three
// wgmmas adds x_hi . q_lo, x_lo . q_hi, then x_hi . q_hi into a fresh
// accumulator (scale-d 0 on the first), which one round-to-nearest add
// folds into the key's sum. Two fresh accumulators alternate (NQ <= 64:
// one per k step, odd and even; above: queries 0-63 and the rest, two
// groups a k step), so that a fold waits only for the group before the one
// just issued (wgmma.wait_group 1) and the tensor cores always hold work. A
// stage goes back to the producer (its `empty` barrier, one arrive a
// consumer warp) once every group that read it is done. The keys of a tile
// are screened against the lists' thresholds once its last groups are
// folded, and its survivors are selected while the next tile's first
// groups run. rows_per_split is a multiple of FW_R; qst: stage_f32_queries_kernel's
// output; smem_lists: the lists are in shared memory.
template <int NQ>
__global__ void __launch_bounds__(FW_THREADS, 1)
scan_topk_f32_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ x,
                           const float* __restrict__ qst, const float* __restrict__ norms, int B,
                           int N, int D, int K, int rows_per_split, int stages, int smem_lists,
                           int x_tma, int* __restrict__ cut, float* __restrict__ part_k,
                           int* __restrict__ part_p) {
    static_assert(NQ % 8 == 0 && NQ >= 8 && NQ <= FW_QMAX, "wgmma N");
    // TMA boxes land 128-byte aligned; 1024 keeps that past the profile
    // build's static counters.
    extern __shared__ __align__(1024) unsigned char fw_smem[];
    unsigned char* smem = fw_smem;
    const FwLayout L = fw_layout(NQ, K, stages, smem_lists != 0);
    float* keys_s = reinterpret_cast<float*>(smem + L.keys);
    uint16_t* masks = reinterpret_cast<uint16_t*>(smem + L.masks);
    float* thr_s = reinterpret_cast<float*>(smem + L.thr);
    float* list_k = reinterpret_cast<float*>(smem + L.lists);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
    uint64_t* empty = full + FW_MAX_STAGES;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = blockIdx.x * NQ;
    const int split = blockIdx.y;
    const int row_begin = split * rows_per_split;
    const int row_end = min(N, row_begin + rows_per_split);
    const int spt = (D + FW_SC - 1) / FW_SC;   // stages a tile
    const int n_tiles = row_end > row_begin ? (row_end - row_begin + FW_R - 1) / FW_R : 0;
    const int total = n_tiles * spt;           // ring steps: (tile, stage) in order
    const Lists lists{list_k, reinterpret_cast<int*>(list_k + NQ * K), part_k, part_p,
                      ((int64_t)split * B + q0) * K, K, smem_lists != 0};
#if FL2_PROFILE
    __shared__ unsigned prof_s_[FW_THREADS / 32 * FL2_SLOTS];   // 32 bits: one block's counts
    for (int i = tid; i < FW_THREADS / 32 * FL2_SLOTS; i += FW_THREADS) prof_s_[i] = 0;
    unsigned prof_t_ = (unsigned)clock();
#endif

    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], FW_CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (warp >= 4) {
        lists_init(lists, B, q0, NQ, warp - 4, FW_CONSUMER_WARPS);
        // Thresholds +inf (every finite key passes until a list fills),
        // -inf past B (nothing passes); no survivors.
        const float INF = __int_as_float(0x7f800000);
        for (int i = tid - 128; i < NQ; i += 32 * FW_CONSUMER_WARPS) thr_s[i] = q0 + i < B ? INF : -INF;
        for (int i = tid - 128; i < NQ * FW_CONSUMER_WARPS / 8; i += 32 * FW_CONSUMER_WARPS)
            reinterpret_cast<uint4*>(masks)[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();

    const int sel_lanes = K <= 32 ? FW_SEL_LANES * spt : 0;   // a tile the selectors take
    if (warp < 4) {
        // The producer warpgroup: warp 0 runs the ring, warps 1-3 are the
        // selectors; the rest of its registers go to the consumers.
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (warp != 0) {
            // Each tile's screen tells how many consumer lanes hold a
            // candidate (this barrier also says that the selection of the
            // tile before is done); a tile with few is selected here while
            // the consumers run the next tile's products.
            for (int tile = 0; tile < n_tiles; ++tile) {
                const int lanes = bar_red_popc(FW_BAR_TILE, FW_SCREEN_THREADS, false);
                if (FL2_NO_SELECT || lanes == 0 || lanes > sel_lanes) continue;
                bar_sync(FW_BAR_KEYS, FW_SCREEN_THREADS);
                select_tile_f32<1>(lists, keys_s, masks, thr_s, cut, row_begin + tile * FW_R, B, q0,
                                   NQ, warp - 1, FW_SELECTORS);
            }
            bar_sync(FW_BAR_DONE, FW_SCREEN_THREADS);
            return;
        }
        const float* qbase = qst + (size_t)blockIdx.x * spt * fw_q_bytes(NQ) / sizeof(float);
        for (int s = 0, st = 0, round = 0; s < total; ++s) {
            if (s >= stages) mbar_wait(&empty[st], (round - 1) & 1);
            FL2_MARK(0);
            unsigned char* buf = smem + (size_t)st * fw_stage_bytes(NQ);
            const int tile = s / spt, c = s - tile * spt;
            const int r0 = row_begin + tile * FW_R, c0 = c * FW_SC;
            const float* qsrc = qbase + (size_t)c * fw_q_bytes(NQ) / sizeof(float);
            if (x_tma) {
                if (lane == 0) {
                    mbar_arrive_tx(&full[st], FW_X_BYTES + fw_q_bytes(NQ));
#pragma unroll
                    for (int b = 0; b < FW_BOXES; ++b)
                        tma_load_2d(buf + b * FW_BOX_BYTES, &xmap, c0 + b * FW_DK, r0, &full[st]);
                    bulk_load(buf + FW_X_BYTES, qsrc, fw_q_bytes(NQ), &full[st]);
                }
            } else {
                float* xs = reinterpret_cast<float*>(buf);
                for (int i = lane; i < FW_R * FW_SC; i += 32) {
                    const int b = i / (FW_R * FW_DK), r = i / FW_DK % FW_R, cc = c0 + b * FW_DK + i % FW_DK;
                    xs[i] = r0 + r < N && cc < D ? x[(int64_t)(r0 + r) * D + cc] : 0.f;
                }
                __threadfence_block();
                __syncwarp();
                if (lane == 0) {
                    mbar_arrive_tx(&full[st], fw_q_bytes(NQ));
                    bulk_load(buf + FW_X_BYTES, qsrc, fw_q_bytes(NQ), &full[st]);
                }
            }
            if (++st == stages) { st = 0; ++round; }
            FL2_MARK(1);
        }
        // Leave once the consumers have released every stage (no copy in flight).
        for (int s = max(0, total - stages); s < total; ++s) mbar_wait(&empty[s % stages], (s / stages) & 1);
        FL2_MARK(0);
#if FL2_PROFILE
        if (lane == 0)
            for (int i = 0; i < 2; ++i)
                atomicAdd(&fl2_prof[i], (unsigned long long)prof_s_[warp * FL2_SLOTS + i]);
#endif
        return;
    }

    // The consumers: warpgroup cw holds tile rows 64 cw .. + 63, warp wq of
    // it rows 16 wq .. + 15 (wgmma's layout): this lane's rows are row_a and
    // row_a + 8; g = lane / 4, t4 = lane % 4.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = (warp >> 2) - 1, v = warp - 4, wq = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const int row_a = 64 * cw + 16 * wq + g;
    constexpr int NR = NQ / 2;
    constexpr bool TWO = NQ > 64;              // two groups a k step (queries 0-63, 64 - NQ)
    constexpr int WA = TWO ? 64 : NQ;          // queries of accumulator fa
    constexpr int WB = TWO ? NQ - 64 : NQ;     // queries of accumulator fb
    constexpr int OB = TWO ? WA / 2 : 0;       // fb's first register of kacc
    float kacc[NR], fa[WA / 2], fb[WB / 2];
#pragma unroll
    for (int i = 0; i < NR; ++i) kacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < WA / 2; ++i) fa[i] = 0.f;
#pragma unroll
    for (int i = 0; i < WB / 2; ++i) fb[i] = 0.f;
    unsigned xh[2][4], xl[2][4];               // A fragments of the last two k steps
    int prev_r0 = -1;                          // the last tile's first row
    bool pending = false;                      // its survivors await their selection
    int st = 0, round = 0, held = -1;          // ring position; the stage to hand back next
#if FL2_PROFILE
    prof_t_ = (unsigned)clock();
#endif

    // A finished tile (first row r0; its sums complete in kacc, no group in
    // flight, nrm its norms): the screen of its keys. One barrier with the
    // selectors waits for every selection of the tile before and counts the
    // lanes with a candidate; if any, each warp with one writes its
    // survivors, and the selectors take them (the consumers go on at once) or,
    // for a busier tile, the consumers select them themselves during the
    // next tile's first k step (`pending`).
    auto screen_tile = [&](int r0, const float (&nrm)[2]) {
        const bool cand = screen_any<NQ>(thr_s, kacc, nrm, t4);
        const int lanes = bar_red_popc(FW_BAR_TILE, FW_SCREEN_THREADS, cand);
        int passed = 0;
        pending = false;
        if (!FL2_NO_SELECT && lanes > 0) {
            if (__any_sync(FULL, cand))
                passed = screen_write<NQ>(keys_s, masks, thr_s, kacc, nrm, row_a, t4, v);
            if (lanes <= sel_lanes) {
                bar_arrive(FW_BAR_KEYS, FW_SCREEN_THREADS);
            } else {
                bar_sync(FW_BAR_OWN, 32 * FW_CONSUMER_WARPS);
                pending = true;
            }
        }
#if FL2_PROFILE
        passed = __reduce_add_sync(FULL, passed);
        if (lane == 0) {
            const int rows = max(0, min(16, row_end - (r0 + 16 * v)));
            prof_s_[warp * FL2_SLOTS + FL2_PHASES] += rows * min(NQ, B - q0);
            prof_s_[warp * FL2_SLOTS + FL2_PHASES + 1] += passed;
        }
#endif
        FL2_MARK(7);
    };

    // One stage of a tile: FW_BOXES boxes of two k steps each. Two groups
    // stay in flight: NQ <= 64, the groups of k steps ks - 1 and ks (fa on
    // even steps, fb on odd ones), each folded when step ks + 2 needs its
    // accumulator; NQ > 64, a k step's groups A (fa) and B (fb), each folded
    // before the next step reissues it. FIRST: the tile's first stage, whose
    // first k step has no group before it, folds into kacc by assignment,
    // and runs the selection of the last tile's survivors once its groups are issued.
    auto stage = [&](auto first_stage) {
        constexpr bool FIRST = decltype(first_stage)::value;
        mbar_wait(&full[st], round & 1);
        FL2_MARK(2);
        const unsigned char* buf = smem + (size_t)st * fw_stage_bytes(NQ);
        const uint64_t q_desc = wg_desc(buf + FW_X_BYTES, 16 * NQ);
#pragma unroll
        for (int b = 0; b < FW_BOXES; ++b) {
            const float* xs = reinterpret_cast<const float*>(buf + b * FW_BOX_BYTES);
            const float4 x0 = *reinterpret_cast<const float4*>(xs + row_a * FW_DK + 4 * t4);
            const float4 x1 = *reinterpret_cast<const float4*>(xs + (row_a + 8) * FW_DK + 4 * t4);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const bool first = FIRST && b == 0 && e == 0;       // the tile's k step 0
                const bool second = FIRST && b == 0 && e == 1;      // its k step 1
                // Box b's hi part, k units 2e and 2e + 1 (16 NQ bytes each);
                // its lo part NQ * 64 bytes on (descriptor units of 16 bytes).
                const uint64_t dh = q_desc + (uint64_t)((b * fw_q_bytes(NQ) / FW_BOXES + e * 32 * NQ) >> 4);
                const uint64_t dl = dh + (uint64_t)((NQ * FW_DK * 4) >> 4);
                if constexpr (TWO) {
                    split_step(x0, x1, e, xh[e], xl[e]);
                    FL2_MARK(3);
                    if (!first) {
                        if (!FL2_NO_MMA) {
                            wg_wait<1>();   // group A of step ks - 1
                            keep(fa);
                        }
                        FL2_MARK(5);
                        fold(kacc, fa, 0, second);
                        FL2_MARK(6);
                    }
                    if (!FL2_NO_MMA) issue_group<WA>(fa, xh[e], xl[e], dh, dl);
                    FL2_MARK(4);
                    if (!first) {
                        if (!FL2_NO_MMA) {
                            wg_wait<1>();   // group B of step ks - 1
                            keep(fb);
                            keep(xh[1 - e]);
                            keep(xl[1 - e]);
                        }
                        FL2_MARK(5);
                        fold(kacc, fb, OB, second);
                        FL2_MARK(6);
                    }
                    // Group B: queries 64 .. NQ - 1, from the ninth core matrix on.
                    if (!FL2_NO_MMA) issue_group<WB>(fb, xh[e], xl[e], dh + (1024 >> 4), dl + (1024 >> 4));
                    FL2_MARK(4);
                } else {
                    // Step ks takes accumulator e: fold its group of step ks - 2
                    // (into kacc by assignment when ks - 2 is the tile's step 0).
                    float (&acc)[WA / 2] = e ? fb : fa;
                    const bool refold = !(FIRST && b == 0);   // step ks - 2 exists
                    const bool assign = FIRST && b == 1 && e == 0;   // step ks - 2 is the tile's step 0
                    if (refold && !FL2_NO_MMA) {
                        wg_wait<1>();
                        keep(acc);
                        keep(xh[e]);
                        keep(xl[e]);
                    }
                    FL2_MARK(5);
                    if (refold) fold(kacc, acc, 0, assign);
                    FL2_MARK(6);
                    split_step(x0, x1, e, xh[e], xl[e]);
                    FL2_MARK(3);
                    if (!FL2_NO_MMA) issue_group<WA>(acc, xh[e], xl[e], dh, dl);
                    FL2_MARK(4);
                }
                if (first && pending) {
                    // The last tile's survivors, while this step's groups run.
                    select_tile_f32<4>(lists, keys_s, masks, thr_s, cut, prev_r0, B, q0, NQ, v,
                                       FW_CONSUMER_WARPS);
                    FL2_MARK(8);
                }
            }
        }
        // Every group of the stage before is done: hand it back.
        if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
        held = st;
        if (++st == stages) { st = 0; ++round; }
    };

    // Consumer thread ci (< NQ) keeps query ci's cut fresh: read at the start
    // of each tile (from L2: other blocks lower it), folded into the
    // threshold at its end.
    const int ci = 32 * v + lane;
    const bool cuts = ci < NQ && q0 + ci < B;
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int r0 = row_begin + tile * FW_R;
        const int shared_cut = cuts ? __ldcg(cut + q0 + ci) : ORD_INF;
        float nrm[2];   // this tile's norms of the lane's rows, +inf past the split
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = r0 + row_a + 8 * h;
            nrm[h] = row < row_end ? norms[row] : __int_as_float(0x7f800000);
        }
        held = -1;
        stage(std::true_type{});
        for (int c = 1; c < spt; ++c) stage(std::false_type{});
        // Drain: the groups still running (NQ <= 64: the last two steps'; else
        // the last step's A and B), folded in order; hand back the last stage.
        if (!FL2_NO_MMA) {
            wg_wait<0>();
            keep(fa);
            keep(fb);
            keep(xh);
            keep(xl);
        }
        FL2_MARK(5);
        if constexpr (TWO) {
            fold(kacc, fa, 0, false);
            fold(kacc, fb, OB, false);
        } else {
            fold(kacc, fa, 0, false);   // step n_ks - 2 (even)
            fold(kacc, fb, 0, false);   // step n_ks - 1
        }
        if (lane == 0) mbar_arrive(&empty[held]);
        FL2_MARK(6);
        if (cuts) {
            // Another split's k-th key T: a key above it has k keys below it
            // and is out of the query's result; one equal to T may still be
            // in (by position), so the threshold is T's successor.
            const float c = nextafterf(ord_key(shared_cut), __int_as_float(0x7f800000));
            if (c < thr_s[ci]) thr_s[ci] = c;
        }
        screen_tile(r0, nrm);
        prev_r0 = r0;
    }
    if (pending)
        select_tile_f32<4>(lists, keys_s, masks, thr_s, cut, prev_r0, B, q0, NQ, v, FW_CONSUMER_WARPS);
    bar_sync(FW_BAR_DONE, FW_SCREEN_THREADS);   // the selectors' last tile
    FL2_MARK(8);
    lists_flush(lists, B, q0, NQ, v, FW_CONSUMER_WARPS);
#if FL2_PROFILE
    if (lane == 0)
        for (int i = 2; i < FL2_SLOTS; ++i)
            atomicAdd(&fl2_prof[i], (unsigned long long)prof_s_[warp * FL2_SLOTS + i]);
#endif
}

// -- pass 2 -------------------------------------------------------------------------

__device__ __forceinline__ bool lex_less(float ak, int ap, float bk, int bp) {
    return ak < bk || (ak == bk && ap < bp);
}

// One warp per query: merge S sorted lists of K by (key, position).
__global__ void __launch_bounds__(NT)
merge_splits_kernel(const float* __restrict__ part_k, const int* __restrict__ part_p,
                    int S, int B, int K, float* __restrict__ out_k, int* __restrict__ out_p) {
    const int lane = threadIdx.x & 31;
    const int qg = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
    if (qg >= B) return;
    int head[MAX_SPLITS / 32];
#pragma unroll
    for (int m = 0; m < MAX_SPLITS / 32; ++m) head[m] = 0;
    const float INF = __int_as_float(0x7f800000);
    for (int o = 0; o < K; ++o) {
        float bk = INF;
        int bp = INT_MAXV, bm = -1;
#pragma unroll
        for (int m = 0; m < MAX_SPLITS / 32; ++m) {
            const int s = lane + 32 * m;
            if (s < S && head[m] < K) {
                const int64_t at = ((int64_t)s * B + qg) * K + head[m];
                const float kk = part_k[at];
                const int pp = part_p[at];
                if (bm < 0 || lex_less(kk, pp, bk, bp)) { bk = kk; bp = pp; bm = m; }
            }
        }
        float wk = bk;
        int wp = bp;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ok = __shfl_xor_sync(FULL, wk, off);
            const int op = __shfl_xor_sync(FULL, wp, off);
            if (lex_less(ok, op, wk, wp)) { wk = ok; wp = op; }
        }
#pragma unroll
        for (int m = 0; m < MAX_SPLITS / 32; ++m)
            if (bm == m && bk == wk && bp == wp) head[m] += 1;
        if (lane == 0) {
            out_k[(int64_t)qg * K + o] = wk;
            out_p[(int64_t)qg * K + o] = wp;
        }
    }
}

// Rows of a split: ceil(N / S) rounded up to whole tiles of `rt` rows.
int rows_per_split(int N, int S, int rt) { return ((N + S - 1) / S + rt - 1) / rt * rt; }

// Let a pass-1 kernel (slot: MODE for scan_topk_mma_kernel<MODE>, 3 + NQ / 8
// for scan_topk_f32_wgmma_kernel<NQ>) take the most dynamic shared memory a
// block may use: once per kernel and device, not on every launch.
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_SLOTS = 4 + FW_QMAX / 8;

cudaError_t allow_smem(const void* kernel, int slot) {
    static bool done[SMEM_SLOTS][MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && done[slot][dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_MAX - (FL2_PROFILE ? 1024 : 0));
    if (err == cudaSuccess && dev < MAX_DEVICES) done[slot][dev] = true;
    return err;
}

template <int MODE>
cudaError_t launch_scan_mma(const void* q, const void* x, const float* norms, const float* rs,
                            int B, int N, int D, int K, int S, float* part_k, int* part_p,
                            cudaStream_t stream) {
    const MmaPlan plan = mma_plan<MODE>(D, K);
    if (plan.smem > SMEM_MAX) return cudaErrorInvalidValue;
    const int x_vec = MODE == 3 ? 16 : Op<MODE>::V;   // elements per 16-byte copy
    const bool x_async = reinterpret_cast<uintptr_t>(x) % 16 == 0 && D % x_vec == 0;
    const bool q_async = reinterpret_cast<uintptr_t>(q) % 16 == 0 && D % Op<MODE>::V == 0;
    cudaError_t err = allow_smem(reinterpret_cast<const void*>(&scan_topk_mma_kernel<MODE>), MODE);
    if (err != cudaSuccess) return err;
    dim3 grid((B + QT - 1) / QT, S);
    scan_topk_mma_kernel<MODE><<<grid, NT, plan.smem, stream>>>(
        q, x, norms, rs, B, N, D, K, rows_per_split(N, S, RT), plan.q_res, plan.smem_lists, x_async,
        q_async, part_k, part_p);
    return cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver that the process has loaded (no
// link against libcuda); null when there is none.
typedef CUresult (*TensorMapEncode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                    const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                    const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

TensorMapEncode tensor_map_encode() {
    static const TensorMapEncode fn = [] {
        void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
        if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
        return h ? reinterpret_cast<TensorMapEncode>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
    }();
    return fn;
}

// 16-column boxes of the staged queries of width D: whole stages.
int f32_boxes(int D) { return (D + FW_SC - 1) / FW_SC * FW_BOXES; }

// Floats of stage_f32_queries_kernel's output for B queries of width D in
// tiles of nq.
int64_t f32_stage_floats(int B, int D, int nq) {
    return (int64_t)((B + nq - 1) / nq) * f32_boxes(D) * 2 * nq * FW_DK;
}

cudaError_t stage_f32(const float* q, int B, int D, int nq, float* qst, cudaStream_t stream,
                      int* cut = nullptr) {
    const int64_t total = f32_stage_floats(B, D, nq);
    const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
    stage_f32_queries_kernel<<<blocks, 256, 0, stream>>>(q, B, D, nq, f32_boxes(D), total, qst, cut);
    return cudaGetLastError();
}

// Mode 0: the queries' staging, then pass 1 on (B / NQ query tiles, S splits).
template <int NQ>
cudaError_t launch_scan_f32(const float* q, const float* x, const float* norms, int B, int N, int D,
                            int K, int S, float* qst, float* part_k, int* part_p, cudaStream_t stream) {
    const FwLayout L = fw_plan(NQ, K);
    if (L.total > SMEM_MAX - (FL2_PROFILE ? 1024 : 0)) return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(reinterpret_cast<const void*>(&scan_topk_f32_wgmma_kernel<NQ>), 3 + NQ / 8);
    if (err != cudaSuccess) return err;
    // The queries' cuts follow their staged parts (B ints; see the kernel).
    int* cut = reinterpret_cast<int*>(qst + f32_stage_floats(B, D, NQ));
    err = stage_f32(q, B, D, NQ, qst, stream, cut);
    if (err != cudaSuccess) return err;
    // The store through TMA when its rows are 16-byte aligned (the tensor
    // map's strides must be), else through the producer's plain copy.
    CUtensorMap map;
    memset(&map, 0, sizeof map);
    const bool x_tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 && D % 4 == 0;
    if (x_tma) {
        const TensorMapEncode encode = tensor_map_encode();
        if (encode == nullptr) return cudaErrorNotSupported;
        const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)N};
        const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(float)};
        const cuuint32_t box[2] = {FW_DK, FW_R};
        const cuuint32_t step[2] = {1, 1};
        if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims, strides, box,
                   step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
            return cudaErrorInvalidValue;
    }
    scan_topk_f32_wgmma_kernel<NQ><<<dim3((B + NQ - 1) / NQ, S), FW_THREADS, L.total, stream>>>(
        map, x, qst, norms, B, N, D, K, rows_per_split(N, S, FW_R), L.stages, L.smem_lists, x_tma,
        cut, part_k, part_p);
    return cudaGetLastError();
}

cudaError_t launch_scan_f32_n(int nq, const float* q, const float* x, const float* norms, int B, int N,
                              int D, int K, int S, float* qst, float* part_k, int* part_p,
                              cudaStream_t stream) {
    switch (nq) {
#define FL2_CASE(n) \
    case n: return launch_scan_f32<n>(q, x, norms, B, N, D, K, S, qst, part_k, part_p, stream);
        FL2_CASE(8) FL2_CASE(16) FL2_CASE(24) FL2_CASE(32) FL2_CASE(40) FL2_CASE(48) FL2_CASE(56)
        FL2_CASE(64) FL2_CASE(72) FL2_CASE(80) FL2_CASE(88) FL2_CASE(96) FL2_CASE(104) FL2_CASE(112)
        FL2_CASE(120) FL2_CASE(128)
#undef FL2_CASE
    }
    return cudaErrorInvalidValue;
}

// Blocks of `kernel` (allow_smem slot `slot`) that fit on one SM with `smem`
// bytes of dynamic shared memory (the CUDA occupancy query; 1 if it fails).
int occupancy(const void* kernel, int slot, size_t smem) {
    int per_sm = 1;
    if (allow_smem(kernel, slot) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem) != cudaSuccess ||
        per_sm < 1)
        per_sm = 1;
    return per_sm;
}

}  // namespace

extern "C" {

int fused_l2_topk_abi_version() { return 8; }

// Pass 1's shape in mode `dtype` at (D, K), into out: [0] the blocks that
// fit on one SM (modes 1 and 3 count two, the bf16 layout at small k; mode
// 2 as many as the CUDA occupancy query reports for its shared memory: two
// at k = 20, one where lists in shared memory leave no room for a second;
// mode 0 one, its 384 threads taking the SM's registers), [1] the most
// queries a block takes (mode 0: its query tile is the wrapper's choice, a
// multiple of 8 up to this), [2] the store rows a tile (a split's rows are
// a whole number of them), [3] the most splits pass 2 merges (MAX_SPLITS;
// fused_l2_topk refuses more). The wrapper asks once per (device, mode, D,
// K) and sizes the grid from it (ops/topk_cuda.launch_plan). Returns 0.
int fused_l2_topk_shape(int dtype, int D, int K, int* out) {
    out[1] = dtype == 0 ? FW_QMAX : QT;
    out[3] = MAX_SPLITS;
    out[2] = dtype == 0 ? FW_R : RT;
    if (dtype == 0)
        out[0] = 1;
    else if (dtype == 2)
        out[0] = occupancy(reinterpret_cast<const void*>(&scan_topk_mma_kernel<2>), 2,
                           mma_plan<2>(D, K).smem);
    else
        out[0] = 2;
    return 0;
}

#if FL2_PROFILE
// Diagnostic builds: the phase cycles of scan_topk_f32_wgmma_kernel's warps,
// then the keys its screen compared and passed, summed since the last call
// (see FL2_PROFILE) into out[FL2_SLOTS], then cleared.
int fused_l2_topk_profile(unsigned long long* out) {
    cudaError_t err = cudaMemcpyFromSymbol(out, fl2_prof, sizeof(fl2_prof));
    if (err != cudaSuccess) return (int)err;
    const unsigned long long zero[FL2_SLOTS] = {};
    return (int)cudaMemcpyToSymbol(fl2_prof, zero, sizeof(zero));
}
#endif

// Mode 0's queries as pass 1 reads them (stage_f32_queries_kernel): q (B, D)
// f32 into qst (f32_stage_floats(B, D, nq) floats). For the tests; the
// launch stages them itself. Returns the CUDA error code.
int fused_l2_topk_stage_f32(const void* q, int B, int D, int nq, void* qst, void* stream) {
    if (B <= 0 || D <= 0 || nq < 8 || nq > FW_QMAX || nq % 8 != 0) return (int)cudaErrorInvalidValue;
    return (int)stage_f32(static_cast<const float*>(q), B, D, nq, static_cast<float*>(qst),
                          static_cast<cudaStream_t>(stream));
}

// dtype: 0 = f32, 1 = bf16, 2 = int8 (queries int8 with per-row scales rs),
// 3 = int8 store with bf16 queries (rs unused).
// q (B, D) and x (N, D) row-major in the store dtype; norms (N,) f32;
// part_k/part_p (S, B, K) scratch, S at most MAX_SPLITS (the wrapper's
// launch plan); out_k/out_p (B, K). Mode 0 also takes its query tile nq (a
// multiple of 8 up to FW_QMAX) and qst, 16-byte aligned scratch of
// f32_stage_floats(B, D, nq) floats for the staged queries and B more for
// the queries' cuts; the other modes ignore both. Returns the CUDA error code of the launches (0 on success).
int fused_l2_topk(int dtype, const void* q, const void* x, const void* norms, const void* rs,
                  int B, int N, int D, int K, int S, int nq, void* qst, void* part_k, void* part_p,
                  void* out_k, void* out_p, void* stream) {
    if (B <= 0 || N <= 0 || D <= 0 || K <= 0 || S <= 0 || S > MAX_SPLITS)
        return (int)cudaErrorInvalidValue;
    if (dtype == 2 && D % 4 != 0) return (int)cudaErrorInvalidValue;
    if (dtype == 0 && (qst == nullptr || reinterpret_cast<uintptr_t>(qst) % 16 != 0))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* nr = static_cast<const float*>(norms);
    float* pk = static_cast<float*>(part_k);
    int* pp = static_cast<int*>(part_p);
    cudaError_t err;
    const float* r = static_cast<const float*>(rs);
    if (dtype == 0)
        err = launch_scan_f32_n(nq, static_cast<const float*>(q), static_cast<const float*>(x), nr, B,
                                N, D, K, S, static_cast<float*>(qst), pk, pp, st);
    else if (dtype == 1)
        err = launch_scan_mma<1>(q, x, nr, r, B, N, D, K, S, pk, pp, st);
    else if (dtype == 2)
        err = launch_scan_mma<2>(q, x, nr, r, B, N, D, K, S, pk, pp, st);
    else if (dtype == 3)
        err = launch_scan_mma<3>(q, x, nr, r, B, N, D, K, S, pk, pp, st);
    else
        return (int)cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
    merge_splits_kernel<<<(B + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
        pk, pp, S, B, K, static_cast<float*>(out_k), static_cast<int*>(out_p));
    return (int)cudaGetLastError();
}

}  // extern "C"
