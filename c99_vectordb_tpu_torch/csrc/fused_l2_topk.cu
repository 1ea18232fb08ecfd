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
// Design. Pass 1 runs on a grid of (query tiles of QT, splits of N); each
// block streams its split's rows in RT-row tiles, forms the QT x RT keys
// tile in shared memory, and then each warp merges its queries' tile keys
// into sorted per-query lists (a ballot against the list's last key, then
// one warp-wide insertion per admitted candidate in position order). Lists
// live in shared memory when they fit (k <= SMEM_LIST_MAX) and in the
// partial-output buffer otherwise. The query tile is the fastest grid axis,
// so the blocks that share a split run together and read the store through
// L2 once. Pass 2 (merge_splits_kernel): one warp per query merges the
// per-split sorted lists by (key, position) into the final k.
//
// Pass 1 forms the keys on the tensor cores in every mode:
//   - scan_topk_mma_kernel<MODE> for f32 x f32 (mode 0, the default store),
//     bf16 x bf16 -> f32 (mode 1, bf16 store; mode 3, int8 codes with bf16
//     queries) and int8 x int8 -> int32 (mode 2, int8 store and queries,
//     the JAX kernel's int8_q branch, topk_pallas.py:338-346). Store tiles
//     arrive in DK-column chunks (64 bf16, 128 int8 or 32 f32 columns)
//     through a STAGES-deep ring of 16-byte cp.async.cg copies, so the next
//     chunks load while the current one multiplies. Modes 1-3 stage the
//     block's queries once and keep them resident in shared memory for the
//     whole split (64 x 392 bf16 = 49 KB at D = 384, 64 x 400 int8 = 25.6
//     KB; above ~1,340 bf16 columns they come through the ring beside the
//     store instead). Modes 0, 1 and 2 copy their rows as they are; mode 3 copies
//     the raw int8 codes (half of bf16's bytes, a quarter of f32's) and one
//     cooperative pass decodes each chunk once into a bf16 tile in shared
//     memory (exact), so modes 1 and 3 share one product path. Rows
//     that are not 16-byte aligned (D % 4 != 0 for f32, D % 8 != 0 for
//     bf16, D % 16 != 0 for int8, or an unaligned base) take a plain
//     zero-filling loader into the same layout. Each warp owns a 16-query x
//     32-row piece of the tile and loads its fragments with ldmatrix: A is
//     the row-major queries, B the store rows, which a row-major (N, D)
//     store already lays out as the "col" operand (nothing is transposed).
//     Chunk rows are padded by 16 bytes to 16 mod 128 bytes, which keeps
//     every ldmatrix phase on distinct banks.
//     bf16: mma.sync.m16n8k16 bf16 -> f32 (every product exact in f32).
//     int8: mma.sync.m16n8k32 s8 -> s32. A 32-value s8 k step is 32 bytes,
//     as a bf16 k16 step, and its A and B fragments hold the bytes that
//     ldmatrix.b16 hands each lane (row lane / 4, bytes 4 (lane % 4) .. + 3
//     of an 8 x 16-byte matrix), so mode 2 shares the bf16 addressing
//     (tests/test_torch_s8_fragments.py emulates it). The exact int32 dot
//     becomes the key as float(dot) * rs (rounded), + norm (rounded).
//     f32: 3xTF32 on mma.sync.m16n8k8 tf32 -> f32. Each element x splits
//     into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with
//     ties away from zero (cvt.rna's rounding, done with an integer add and
//     a mask, which measured 5% faster than cvt), and each fragment pair adds
//     lo.hi, hi.lo, then hi.hi, always in that order (deterministic; lo.lo,
//     below f32's rounding, is dropped). One TF32 pass keeps 11 significant
//     bits and errs past the 1e-4 tolerance of the keys; three keep f32's
//     accuracy (tests/test_torch_tf32_split.py emulates both). The three
//     products of each 8-column k step go into a fresh accumulator, and one
//     f32 add (round to nearest) takes its sum into the key's: mma.sync does
//     not round its adds into an accumulator to nearest, and a chain over
//     all of D drifted the keys of rows that mix magnitudes of 1e-3 to 1e3
//     past the tolerance on the card (the mixed_magnitudes case of
//     tests/test_torch_cuda.py). Once a
//     chunk of the store and of the queries has landed, one cooperative pass
//     rewrites it in place as its hi parts and writes its lo parts beside
//     it, so every element is split once per block, not once per warp that
//     reads it; the k steps then load hi and lo fragments with
//     ldmatrix.b16, whose 32-bit pairs are exactly the tf32 m16n8k8
//     fragments (A: (g, t), (g+8, t), (g, t+4), (g+8, t+4); B: (k t, n g),
//     (k t+4, n g); g = lane / 4, t = lane % 4), so the f32 tiles load like
//     the bf16 ones, 32 bytes of k per step. The f32 queries stream through
//     the ring beside the store (64 x 384 f32 = 99 KB would leave room for
//     one block per SM): 3 stages of 32-column chunks, their lo parts, the
//     keys tile and the lists take 98 KB at k = 20, so two blocks of 8 warps
//     share an SM, which measured 10-12% faster than resident queries at
//     one block per SM, although every query tile is read again from L2 for
//     each row tile. A chunk with no ragged edge runs its k steps with no
//     guard between them, so the steps' mma.sync chains overlap.
//
// Bound on the NVIDIA H100 80GB HBM3 (the SXM part; published at 700 W:
// 3.35 TB/s; tensor cores 495 TFLOP/s TF32, 989 TFLOP/s bf16, 1,979 TOP/s
// int8) at N = 1,048,576 rows of D = 384. The f32 scan only builds the
// shortlist that the exact f32 rerank corrects, so TF32 tensor cores are
// admissible for it and its bound takes the TF32 rate; 3xTF32 runs three
// TF32 products, so its own floor is three times that operation bound.
// Bytes: the store once plus its norms (f32 1.61 GB -> 0.48 ms,
// bf16 0.81 GB -> 0.24 ms, int8 0.41 GB -> 0.12 ms). Operations: 2*B*N*D
// (B = 128: 0.103 TFLOP -> f32 0.21 ms, bf16 0.10 ms, int8 0.05 ms;
// B = 1024: 0.82 TFLOP -> f32 1.67 ms (3xTF32: 5.0 ms), bf16 0.83 ms, int8
// 0.42 ms). So every store is bound by bytes at B = 128 and by operations
// at B = 1024. The mma.sync path moves the products off the CUDA cores and
// overlaps loads with products, which is what B = 128 needs; at B = 1024
// the full tensor-core rate needs wgmma fed by TMA, a later step. What
// holds the mma.sync path back (PERF.md, measured with
// tools/flat_mma_breakdown.py): at B = 128 the warp selection, which runs
// between the tiles' products, takes about half of the bf16 modes' time;
// at B = 1024 every one of the 16 query tiles reads the store again from
// L2. The f32 mode, with three products per fragment pair, spends most of
// its time in mma.sync. Two blocks of 8 warps share an SM at small k
// (about 105 KB of shared memory each for bf16, 98 KB for f32, 78 KB for
// int8, at k = 20), and the split count keeps the grid to one wave. Mode 2
// reads half of bf16's bytes and has no decode pass, so at B = 128 the warp
// selection is the larger part of its time (60%). Its chunks are 128
// columns: at 64 (64 bytes a row) a row tile took six ring steps and
// barriers for half of bf16's bytes, 20-25% slower. chip_smoke.py computes
// the bound for each run's shapes and times every mode beside it.
// Registers (ptxas -v of the shipped build, printed by chip_smoke.py):
// scan_topk_mma_kernel<0> 128, <1>, <2> and <3> 127 each (the launch
// bounds cap them at 128 for two blocks per SM), merge_splits_kernel 26;
// nothing spills.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
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
constexpr int F32_DK = 32;                   // f32 columns per ring chunk

// Per-mode shapes of the tensor-core path. T: the product operand's element
// (f32 for mode 0; bf16 bits for modes 1 and 3, whose int8 codes decode to
// bf16; int8 for mode 2); Acc: the accumulator (int32 for mode 2, else
// f32); DKC: feature columns per ring chunk (FL2_DK bf16 or 2 * FL2_DK int8
// columns: the same bytes a row); V: elements per 16 bytes; SK: the padded
// chunk row, DKC + V elements (16 mod 128 bytes).
template <int MODE>
struct Op {
    using T = typename std::conditional<
        MODE == 0, float, typename std::conditional<MODE == 2, int8_t, uint16_t>::type>::type;
    using Acc = typename std::conditional<MODE == 2, int, float>::type;
    static constexpr int DKC = MODE == 0 ? F32_DK : MODE == 2 ? 2 * FL2_DK : FL2_DK;
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

__device__ __forceinline__ void lists_init(const Lists& L, int B, int q0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int qi = warp; qi < QT; qi += NT / 32) {
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

// Copy lists kept in shared memory out to the partial-output buffer.
__device__ __forceinline__ void lists_flush(const Lists& L, int B, int q0) {
    if (!L.smem) return;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int qi = warp; qi < QT; qi += NT / 32) {
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

// d += a (16x8 tf32, row) . b (8x8 tf32, col), f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
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

// Split a landed f32 chunk (64 rows, stride Op<0>::SK) in place into its
// hi parts, its lo parts going to lo (same layout), 4 elements per copy.
__device__ __forceinline__ void split_chunk(float* t, float* lo) {
    constexpr int DKC = F32_DK, SK = DKC + 4;
#pragma unroll
    for (int i = 0; i < (RT * DKC / 4) / NT; ++i) {
        const int idx = threadIdx.x + NT * i;
        const int o = idx / (DKC / 4) * SK + (idx % (DKC / 4)) * 4;
        float4 v = *reinterpret_cast<const float4*>(t + o), l;
        split_tf32(v.x, v.x, l.x);
        split_tf32(v.y, v.y, l.y);
        split_tf32(v.z, v.z, l.z);
        split_tf32(v.w, v.w, l.w);
        *reinterpret_cast<float4*>(t + o) = v;
        *reinterpret_cast<float4*>(lo + o) = l;
    }
}

// acc[p] += a . b of piece p (b01: pieces 0 and 1, b23: 2 and 3) in 3xTF32
// from split fragments: lo.hi, hi.lo, then hi.hi, in this order for every
// piece, into a fresh accumulator, whose sum one f32 add (round to nearest)
// puts into acc. The tensor cores do not round their adds into an
// accumulator to nearest, so a chain of mma.sync over all of D drifts with
// the running sum's magnitude.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4][4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], const unsigned (&bh01)[4],
                                           const unsigned (&bh23)[4], const unsigned (&bl01)[4],
                                           const unsigned (&bl23)[4]) {
    const unsigned bh[8] = {bh01[0], bh01[1], bh01[2], bh01[3], bh23[0], bh23[1], bh23[2], bh23[3]};
    const unsigned bl[8] = {bl01[0], bl01[1], bl01[2], bl01[3], bl23[0], bl23[1], bl23[2], bl23[3]};
    float step[4][4] = {};
#pragma unroll
    for (int p = 0; p < 4; ++p) mma_tf32(step[p], al, bh[2 * p], bh[2 * p + 1]);
#pragma unroll
    for (int p = 0; p < 4; ++p) mma_tf32(step[p], ah, bl[2 * p], bl[2 * p + 1]);
#pragma unroll
    for (int p = 0; p < 4; ++p) mma_tf32(step[p], ah, bh[2 * p], bh[2 * p + 1]);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][e] = __fadd_rn(acc[p][e], step[p][e]);
}

// Shared-memory layout of scan_topk_mma_kernel<MODE>, computed alike on the
// host (to size the launch) and in the kernel (to place its buffers).
struct MmaLayout {
    int x_bytes;       // the store chunk of a stage
    int stage_bytes;   // the store chunk, then (streamed queries) the query chunk
    int dqs;           // row stride of the resident queries (elements)
    size_t ring;       // STAGES stages
    size_t aux;        // mode 3: the decoded bf16 chunk; mode 0: the lo parts of
                       // the split store chunk, then of the query chunk
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
    L.aux = o; o += MODE == 3 ? RT * O::SK * 2 : MODE == 0 ? (RT + QT) * O::SK * es : 0;
    L.qs = o; o += q_res ? (size_t)QT * L.dqs * es : 0;
    L.keys = o; o += sizeof(float) * QT * (RT + 1);
    L.lists = o; o += smem_lists ? (size_t)QT * K * (sizeof(float) + sizeof(int)) : 0;
    L.total = o;
    return L;
}

// Where the launch puts the queries and the lists: resident queries when
// they fit (bf16 and int8; f32 queries always stream through the ring), then
// the lists in shared memory when they fit beside them.
struct MmaPlan {
    bool q_res, smem_lists;
    size_t smem;
};

template <int MODE>
MmaPlan mma_plan(int D, int K) {
    const bool q_res = MODE != 0 && mma_layout<MODE>(D, K, true, false).total <= SMEM_MAX;
    const bool smem_lists = K <= SMEM_LIST_MAX && mma_layout<MODE>(D, K, q_res, true).total <= SMEM_MAX;
    return {q_res, smem_lists, mma_layout<MODE>(D, K, q_res, smem_lists).total};
}

// One DKC-column chunk of 64 rows [row0, row_lim) of a row-major (., D)
// f32, bf16 or int8 matrix into dst (stride SK), zero past row_lim and D:
// 16-byte cp.async when rows are aligned, else a plain loader.
template <int MODE>
__device__ __forceinline__ void load_chunk(const typename Op<MODE>::T* __restrict__ src, int row0,
                                           int row_lim, int D, int c0, typename Op<MODE>::T* dst,
                                           bool async) {
    using O = Op<MODE>;
    if (async) {
#pragma unroll
        for (int i = 0; i < (RT * O::DKC / O::V) / NT; ++i) {
            const int idx = threadIdx.x + NT * i;
            const int r = idx / (O::DKC / O::V), c = (idx % (O::DKC / O::V)) * O::V;
            const bool ok = row0 + r < row_lim && c0 + c < D;
            cp_async16(dst + r * O::SK + c, ok ? src + (int64_t)(row0 + r) * D + c0 + c : src, ok);
        }
    } else {
        for (int idx = threadIdx.x; idx < RT * O::DKC; idx += NT) {
            const int r = idx / O::DKC, c = idx % O::DKC;
            const bool ok = row0 + r < row_lim && c0 + c < D;
            dst[r * O::SK + c] = ok ? src[(int64_t)(row0 + r) * D + c0 + c] : typename O::T(0);
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

// MODE 0: f32 store and queries (3xTF32); 1: bf16 store; 2: int8 store and
// int8 queries with per-query scales rs (s8 products, exact int32 dots); 3:
// int8 codes (decoded to bf16) with bf16 queries. q_res: the query tile is
// resident (else it streams through the ring; always for mode 0);
// smem_lists: the lists are in shared memory; x_async / q_async: rows are
// 16-byte aligned and load with cp.async.
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
    lists_init(lists, B, q0);
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
            load_chunk<MODE>(static_cast<const T*>(xv), r0, row_end, D, c0,
                             reinterpret_cast<T*>(st), x_async);
        if (!q_res)
            load_chunk<MODE>(q, q0, B, D, c0, reinterpret_cast<T*>(st + L.x_bytes), q_async);
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
        if constexpr (MODE == 0) {
            // Split the store chunk and the query chunk once for the
            // block: hi in place, lo into aux.
            split_chunk(const_cast<float*>(bt), aux);
            split_chunk(const_cast<float*>(at), aux + RT * O::SK);
            __syncthreads();
        }
        const int as = q_res ? L.dqs : O::SK;
        const int kw = min(O::DKC, D - chunk * O::DKC);
        // ldmatrix row addresses, 16 bytes each: A's four pieces are (rows
        // 0-7 | 8-15) x (bytes 0-15 | 16-31) of a 32-byte k step; B's are
        // (n 0-7, bytes 0-15), (n 0-7, bytes 16-31), then n 8-15 alike.
        // bf16 reads them as 8x8 b16 matrices (k16), f32 as 8x4 f32 (k8),
        // int8 as 8x16 s8 (k32).
        const int a_off = (wq * 16 + (lane & 15)) * as + (lane >> 4) * O::V;
        const int b_off = (wr * 32 + (lane >> 4) * 8 + (lane & 7)) * O::SK + ((lane >> 3) & 1) * O::V;
        // One 32-byte k step of the warp's four pieces.
        auto k_step = [&](int kk) {
            if constexpr (MODE == 0) {
                unsigned ah[4], al[4], bh01[4], bh23[4], bl01[4], bl23[4];
                ldmatrix_x4(ah, at + a_off + kk);
                ldmatrix_x4(al, aux + RT * O::SK + a_off + kk);
                ldmatrix_x4(bh01, bt + b_off + kk);
                ldmatrix_x4(bh23, bt + b_off + 16 * O::SK + kk);
                ldmatrix_x4(bl01, aux + b_off + kk);
                ldmatrix_x4(bl23, aux + b_off + 16 * O::SK + kk);
                mma_3xtf32(acc, ah, al, bh01, bh23, bl01, bl23);
            } else if constexpr (MODE == 2) {
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
        } else if (MODE == 0 && kw == O::DKC) {
            // A whole chunk, with no guard between its k steps, so that they
            // overlap (each f32 k step is a chain of three mma.sync).
#pragma unroll
            for (int kk = 0; kk < O::DKC; kk += 2 * O::V) k_step(kk);
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
    lists_flush(lists, B, q0);
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

int rows_per_split(int N, int S) { return ((N + S - 1) / S + RT - 1) / RT * RT; }

template <int MODE>
cudaError_t launch_scan_mma(const void* q, const void* x, const float* norms, const float* rs,
                            int B, int N, int D, int K, int S, float* part_k, int* part_p,
                            cudaStream_t stream) {
    const MmaPlan plan = mma_plan<MODE>(D, K);
    if (plan.smem > SMEM_MAX) return cudaErrorInvalidValue;
    const int x_vec = MODE == 3 ? 16 : Op<MODE>::V;   // elements per 16-byte copy
    const bool x_async = reinterpret_cast<uintptr_t>(x) % 16 == 0 && D % x_vec == 0;
    const bool q_async = reinterpret_cast<uintptr_t>(q) % 16 == 0 && D % Op<MODE>::V == 0;
    cudaError_t err = cudaFuncSetAttribute(scan_topk_mma_kernel<MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)plan.smem);
    if (err != cudaSuccess) return err;
    dim3 grid((B + QT - 1) / QT, S);
    scan_topk_mma_kernel<MODE><<<grid, NT, plan.smem, stream>>>(
        q, x, norms, rs, B, N, D, K, rows_per_split(N, S), plan.q_res, plan.smem_lists, x_async,
        q_async, part_k, part_p);
    return cudaGetLastError();
}

// Pass-1 blocks of mode MODE that fit on one SM at (D, K) (the CUDA
// occupancy query; 1 if it fails).
template <int MODE>
int blocks_per_sm(int D, int K) {
    const size_t smem = mma_plan<MODE>(D, K).smem;
    int per_sm = 1;
    if (cudaFuncSetAttribute(scan_topk_mma_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_topk_mma_kernel<MODE>, NT, smem) !=
            cudaSuccess ||
        per_sm < 1)
        per_sm = 1;
    return per_sm;
}

}  // namespace

extern "C" {

int fused_l2_topk_abi_version() { return 5; }

// The number S of splits of the store for B queries over N rows of D
// columns at depth K, in mode `dtype`, on a card of `sms` multiprocessors:
// (query tiles x splits) fills each SM with as many pass-1 blocks as fit
// on it at once, so the grid is one wave with no tail, with at least one
// row tile per split. Modes 1 and 3 count two blocks per SM (the bf16
// layout at small k); modes 0 and 2 as many as the CUDA occupancy query
// reports for their shared memory at (D, K): two at k = 20 (the launch
// bounds cap the registers there), one where lists in shared memory leave
// no room for a second.
int fused_l2_topk_splits(int dtype, int B, int N, int D, int K, int sms) {
    const int per_sm = dtype == 0 ? blocks_per_sm<0>(D, K) : dtype == 2 ? blocks_per_sm<2>(D, K) : 2;
    const int q_tiles = (B + QT - 1) / QT;
    const int row_tiles = (N + RT - 1) / RT;
    int s = per_sm * sms / q_tiles;
    if (s > row_tiles) s = row_tiles;
    if (s > MAX_SPLITS) s = MAX_SPLITS;
    return s < 1 ? 1 : s;
}

// dtype: 0 = f32, 1 = bf16, 2 = int8 (queries int8 with per-row scales rs),
// 3 = int8 store with bf16 queries (rs unused).
// q (B, D) and x (N, D) row-major in the store dtype; norms (N,) f32;
// part_k/part_p (S, B, K) scratch, S from fused_l2_topk_splits; out_k/out_p
// (B, K). Returns the CUDA error code of the launches (0 on success).
int fused_l2_topk(int dtype, const void* q, const void* x, const void* norms, const void* rs,
                  int B, int N, int D, int K, int S, void* part_k, void* part_p,
                  void* out_k, void* out_p, void* stream) {
    if (B <= 0 || N <= 0 || D <= 0 || K <= 0 || S <= 0 || S > MAX_SPLITS)
        return (int)cudaErrorInvalidValue;
    if (dtype == 2 && D % 4 != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* nr = static_cast<const float*>(norms);
    float* pk = static_cast<float*>(part_k);
    int* pp = static_cast<int*>(part_p);
    cudaError_t err;
    const float* r = static_cast<const float*>(rs);
    if (dtype == 0)
        err = launch_scan_mma<0>(q, x, nr, r, B, N, D, K, S, pk, pp, st);
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
