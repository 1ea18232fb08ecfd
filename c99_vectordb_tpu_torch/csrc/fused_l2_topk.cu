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
// admitted candidates in position order). Lists live in shared memory when
// they fit (k <= SMEM_LIST_MAX) and in the partial-output buffer otherwise.
// The query tile is the fastest grid axis, so the blocks that share a split
// run together and read the store through L2 once. Pass 2
// (merge_splits_kernel): one warp per query merges the per-split sorted
// lists by (key, position) into the final k. The wrapper sizes the grid
// (ops/topk_cuda.launch_plan) from fused_l2_topk_shape: blocks per SM,
// queries a block, rows a tile.
//
// Pass 1 forms the keys on the tensor cores in every mode, with mma.sync
// fed by ldmatrix from a ring of 16-byte cp.async.cg copies, so the next
// chunks load while the current one multiplies. Rows that are not 16-byte
// aligned (D % 4 != 0 for f32, D % 8 != 0 for bf16, D % 16 != 0 for int8,
// or an unaligned base) take a plain zero-filling loader into the same
// layout. A is the row-major queries, B the store rows, which a row-major
// (N, D) store already lays out as the "col" operand (nothing is
// transposed). Chunk rows are padded by 16 bytes to 16 mod 128 bytes, which
// keeps every ldmatrix phase on distinct banks.
//   - scan_topk_mma_kernel<MODE>, 64 queries x 64 rows a tile, two blocks of
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
//   - scan_topk_f32_kernel for f32 x f32 (mode 0, MemoDB's default
//     store): 3xTF32 on mma.sync.m16n8k8 tf32 -> f32. Each element x splits
//     into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with
//     ties away from zero (cvt.rna's rounding, done with an integer add and
//     a mask), and each fragment pair adds lo.hi, hi.lo, then hi.hi, always
//     in that order (deterministic; lo.lo, below f32's rounding, is
//     dropped). One TF32 pass keeps 11 significant bits and errs past the
//     1e-4 tolerance of the keys; three keep f32's accuracy
//     (tests/test_torch_tf32_split.py emulates both). The three products of
//     each 8-column k step go into a fresh accumulator, and one f32 add
//     (round to nearest) takes its sum into the key's: mma.sync does not
//     round its adds into an accumulator to nearest, and a chain over all of
//     D drifted the keys of rows that mix magnitudes of 1e-3 to 1e3 past the
//     tolerance on the card (the mixed_magnitudes case of
//     tests/test_torch_cuda.py). A block holds 64 queries and takes the
//     store in tiles of 128 rows; one block of 8 warps per SM, each warp a
//     32-query x 32-row piece: two m16 tiles by four n8 pieces, eight
//     independent accumulator chains, each B fragment serving two m16
//     tiles. Store and
//     query chunks of 64 columns (68 floats a row) come through a 3-stage
//     ring as they are; every warp splits the fragments it loads in
//     registers (ldmatrix.b16's 32-bit pairs are exactly the tf32 m16n8k8
//     fragments: A (g, t), (g+8, t), (g, t+4), (g+8, t+4); B (k t, n g),
//     (k t+4, n g); g = lane / 4, t = lane % 4), so nothing is split in
//     shared memory and no barrier waits on a split. The k steps of a whole
//     chunk run unguarded, four unrolled at a time. The selection takes a
//     warp's queries four at a time: their ballots together, then their
//     lists (k <= 32) in registers, one entry a lane, one candidate of each
//     of the four a round with no branch, so four chains of dependent
//     shuffles overlap, and every 4 rounds the candidates left are held
//     against the lists' last keys again (a list's first tile admits all
//     128 keys); deeper lists take warp_insert. tests/test_torch_f32_tiles.py
//     emulates the fragments, the keys tile and the selection.
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
// tools/flat_mma_breakdown.py, whose profile build counts the f32 warps'
// cycles by phase, on an NVIDIA H100 80GB HBM3 at 700.00 W): at B = 128 the warp selection, which runs between the
// tiles' products, takes about half of the bf16 modes' time and 60% of
// mode 2's; at B = 1024 every one of the 16 query tiles reads the store
// again from L2. The f32 mode at MemoDB's 131,072 rows, B = 128, spends
// about a third of its warps' cycles in the selection, 43% in the products
// and a fifth issuing the ring's copies, which L2 holds back: every row
// tile reads the block's queries again (the pre-split queries of an earlier
// build, hi and lo, doubled those bytes and were slower). At 1M rows the
// products take 60-65%. A 128-query tile (one store read per call at B <=
// 128) measured slower at every shape: it halves the splits' lengths, and
// with them the selection's work grows (B x splits x about k (1 + ln(rows
// a split / k)) insertions). Selecting a tile over the next tile's ring
// steps, and merging many candidates at once by rank, measured slower too.
// Modes 1-3: two blocks of 8 warps share an SM at small k (about 105 KB of
// shared memory each for bf16, 78 KB for int8, at k = 20), and the split
// count keeps the grid to one wave. Mode 2 reads half of bf16's bytes and
// has no decode pass, so at B = 128 the warp selection is the larger part
// of its time. Its chunks are 128 columns: at 64 (64 bytes a row) a row
// tile took six ring steps and barriers for half of bf16's bytes, 20-25%
// slower. chip_smoke.py computes the bound for each run's shapes and times
// every mode beside it.
// Registers (ptxas -v of the shipped build, printed by chip_smoke.py):
// scan_topk_f32_kernel 253 (one block per SM), scan_topk_mma_kernel<1>,
// <2> and <3> 127 each (the launch bounds cap them at 128 for two blocks
// per SM), merge_splits_kernel 26; nothing spills.

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

// Per-mode shapes of scan_topk_mma_kernel (modes 1-3). T: the product
// operand's element (bf16 bits for modes 1 and 3, whose int8 codes decode
// to bf16; int8 for mode 2); Acc: the accumulator (int32 for mode 2, else
// f32); DKC: feature columns per ring chunk (FL2_DK bf16 or 2 * FL2_DK int8
// columns: the same bytes a row); V: elements per 16 bytes; SK: the padded
// chunk row, DKC + V elements (16 mod 128 bytes).
template <int MODE>
struct Op {
    static_assert(MODE >= 1 && MODE <= 3, "mode 0 has its own kernel, scan_topk_f32_kernel");
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
    lists_flush(lists, B, q0);
}

// -- the f32 pass (mode 0) ------------------------------------------------------------

// FL2_PROFILE 1: the warps of scan_topk_f32_kernel count their clock cycles
// by phase into fl2_prof (fused_l2_topk_profile reads and clears them): the
// wait and barrier at the top of a ring step, issuing the next copies, the
// products, the keys tile and its barrier, the selection.
#ifndef FL2_PROFILE
#define FL2_PROFILE 0
#endif
#if FL2_PROFILE
__device__ unsigned long long fl2_prof[5];
#define FL2_MARK(i)                                    \
    do {                                               \
        const unsigned long long now_ = clock64();     \
        prof_[i] += now_ - prof_t_;                    \
        prof_t_ = now_;                                \
    } while (0)
#else
#define FL2_MARK(i) \
    do {            \
    } while (0)
#endif

// scan_topk_f32_kernel's shapes: F_Q queries x F_R store rows a tile, 8
// warps of 32 queries x 32 rows; ring chunks of FDK f32 columns of the store
// and of the queries, their rows padded to FSK floats (16 mod 128 bytes),
// F_STAGES deep.
constexpr int F_Q = QT;                      // queries a block (the lists' query tile)
constexpr int F_R = 128;                     // store rows a tile
constexpr int F_WR = F_R / 32;               // warps along the rows
constexpr int F_COLS = F_R / 32;             // keys a lane per query in the selection
constexpr int FDK = 64;
constexpr int FSK = FDK + 4;
constexpr int F_STAGES = 3;
constexpr int F_STAGE = (F_R + F_Q) * FSK * (int)sizeof(float);   // bytes of a ring stage
constexpr int F_KEYS = F_Q * (F_R + 1);      // floats of the keys tile
constexpr int F_KUNROLL = 4;   // k steps unrolled together: all 8 of a chunk spill registers
constexpr int F_PRUNE = 4;     // selection rounds between two prunings of the candidates left
static_assert(FDK % 8 == 0 && (FSK * 4) % 128 == 16, "whole k steps; conflict-free ldmatrix rows");
static_assert((F_Q / 32) * F_WR == NT / 32, "8 warps of 32 x 32");

// Shared memory of scan_topk_f32_kernel at depth K: the ring, the keys
// tile, and the lists when they are kept there.
__host__ __device__ constexpr size_t f32_smem(int K, bool smem_lists) {
    return (size_t)F_STAGES * F_STAGE + sizeof(float) * F_KEYS +
           (smem_lists ? (size_t)F_Q * K * (sizeof(float) + sizeof(int)) : 0);
}

bool f32_smem_lists(int K) { return K <= SMEM_LIST_MAX && f32_smem(K, true) <= SMEM_MAX; }

// Split four fragment registers of f32 values into their hi and lo parts.
__device__ __forceinline__ void split_frag(const unsigned (&x)[4], unsigned (&hi)[4],
                                           unsigned (&lo)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        float h, l;
        split_tf32(__uint_as_float(x[j]), h, l);
        hi[j] = __float_as_uint(h);
        lo[j] = __float_as_uint(l);
    }
}

// One 8-column k step of a warp's 32 x 32 piece in 3xTF32. The A fragments
// (two m16 tiles of queries) and the B fragments (four n8 pieces of store
// rows) arrive as they are and split here into hi and lo parts (split_tf32;
// the split costs registers, not shared memory or its bandwidth, which the
// ring is short of). Each of the eight (m16, n8) products adds lo.hi,
// hi.lo, then hi.hi into a fresh accumulator, whose sum one f32 add (round
// to nearest) folds into acc: the tensor cores do not round their adds into
// an accumulator to nearest, so a chain of mma.sync over all of D drifts
// with the running sum's magnitude. The eight chains are independent of
// each other.
__device__ __forceinline__ void f32_k_step(float (&acc)[2][4][4], const float* qs, const float* xs) {
    unsigned ax[2][4], ah[2][4], al[2][4], bx[2][4], bh[2][4], bl[2][4];
    ldmatrix_x4(ax[0], qs);
    ldmatrix_x4(ax[1], qs + 16 * FSK);
    split_frag(ax[0], ah[0], al[0]);
    split_frag(ax[1], ah[1], al[1]);
    ldmatrix_x4(bx[0], xs);
    ldmatrix_x4(bx[1], xs + 16 * FSK);
    split_frag(bx[0], bh[0], bl[0]);
    split_frag(bx[1], bh[1], bl[1]);
    // n8 piece p: registers (2p, 2p + 1) of the pair (bh[p / 2], its halves).
    float step[2][4][4] = {};
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int p = 0; p < 4; ++p)
            mma_tf32(step[m][p], al[m], bh[p >> 1][2 * (p & 1)], bh[p >> 1][2 * (p & 1) + 1]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int p = 0; p < 4; ++p)
            mma_tf32(step[m][p], ah[m], bl[p >> 1][2 * (p & 1)], bl[p >> 1][2 * (p & 1) + 1]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int p = 0; p < 4; ++p)
            mma_tf32(step[m][p], ah[m], bh[p >> 1][2 * (p & 1)], bh[p >> 1][2 * (p & 1) + 1]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][p][e] = __fadd_rn(acc[m][p][e], step[m][p][e]);
}

// Selection of a Q x R keys tile (stride R + 1) whose first row is r0: warp
// w owns queries w, w + 8, ...; lane l holds columns l + 32 j (j < COLS),
// and candidates (key < the list's last) go in by ascending column (=
// position), each after every entry of key <= its own (select_tile's
// order). The selection runs on the 8 warps of one block per SM, where a
// chain of dependent shuffles per candidate would leave the SM waiting, so
// a warp takes its queries G at a time: their keys, thresholds and ballots
// together, then, for lists of k <= 32 held in registers (lane j: entry j),
// one candidate of each of the G queries a round, branch-free, so the G
// insertion chains overlap. A candidate is in when fewer than k entries
// have key' <= key; every F_PRUNE rounds the candidates left are held
// against the lists' last keys again. Deeper lists take warp_insert, one at a time.
__device__ __forceinline__ void select_tile_f32(const Lists& L, const float* keys_s, int r0, int B,
                                                int q0) {
    constexpr int C = F_COLS;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int K = L.K;
    const float INF = __int_as_float(0x7f800000);
    constexpr int G = 4;   // queries a group: w + 8 (G g + u), u < G
    for (int base = warp; base < F_Q && q0 + base < B; base += G * (NT / 32)) {
        float kc[G][C];
        unsigned mc[G][C];
        unsigned any = 0;
#pragma unroll
        for (int u = 0; u < G; ++u) {
            const int qi = base + u * (NT / 32);
            // A query past B has no list: nothing is admitted.
            const float thr = q0 + qi < B ? L.k(qi)[K - 1] : -INF;
#pragma unroll
            for (int j = 0; j < C; ++j) kc[u][j] = keys_s[qi * (F_R + 1) + 32 * j + lane];
#pragma unroll
            for (int j = 0; j < C; ++j) {
                mc[u][j] = __ballot_sync(FULL, kc[u][j] < thr);
                any |= mc[u][j];
            }
        }
        if (!any) continue;
        if (K > 32) {
#pragma unroll
            for (int u = 0; u < G; ++u) {
                const int qi = base + u * (NT / 32);
#pragma unroll
                for (int j = 0; j < C; ++j)
                    for (unsigned m = mc[u][j]; m; m &= m - 1) {
                        const int src = __ffs(m) - 1;
                        warp_insert(L.k(qi), L.p(qi), K, __shfl_sync(FULL, kc[u][j], src),
                                    r0 + 32 * j + src, lane);
                    }
            }
            continue;
        }
        float vk[G];
        int vp[G];
        bool has[G];   // query u admitted a candidate: its list is read and rewritten
#pragma unroll
        for (int u = 0; u < G; ++u) {
            const int qi = base + u * (NT / 32);
            unsigned m = 0;
#pragma unroll
            for (int j = 0; j < C; ++j) m |= mc[u][j];
            has[u] = m != 0;
            vk[u] = has[u] && lane < K ? L.k(qi)[lane] : INF;
            vp[u] = has[u] && lane < K ? L.p(qi)[lane] : INT_MAXV;
        }
        for (int round = 1; any; ++round) {
            if (round % F_PRUNE == 0) {
                // Drop the candidates that the lists have since passed (a
                // list's first tile admits every key, and most fall behind).
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
            const int qi = base + u * (NT / 32);
            if (has[u] && lane < K) {
                L.k(qi)[lane] = vk[u];
                L.p(qi)[lane] = vp[u];
            }
        }
        __syncwarp();
    }
}

// Mode 0's pass 1: f32 store and queries in 3xTF32 on mma.sync.m16n8k8, on
// tiles of F_Q queries x F_R rows. rows_per_split is a multiple of F_R;
// smem_lists: the lists are in shared memory; x_async / q_async:
// the store's / the queries' rows are 16-byte aligned and load with
// cp.async.
__global__ void __launch_bounds__(NT, 1)
scan_topk_f32_kernel(const float* __restrict__ q, const float* __restrict__ x,
                     const float* __restrict__ norms, int B, int N, int D, int K,
                     int rows_per_split, int smem_lists, int x_async, int q_async,
                     float* __restrict__ part_k, int* __restrict__ part_p) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* keys_s = reinterpret_cast<float*>(smem + (size_t)F_STAGES * F_STAGE);
    float* list_k = keys_s + F_KEYS;
    const float INF = __int_as_float(0x7f800000);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = blockIdx.x * F_Q;
    const int split = blockIdx.y;
    const int row_begin = split * rows_per_split;
    const int row_end = min(N, row_begin + rows_per_split);
    const int n_chunks = (D + FDK - 1) / FDK;
    const int n_tiles = row_end > row_begin ? (row_end - row_begin + F_R - 1) / F_R : 0;
    const int total = n_tiles * n_chunks;   // ring steps: (tile, chunk) in order

    const Lists lists{list_k, reinterpret_cast<int*>(list_k + F_Q * K), part_k, part_p,
                      ((int64_t)split * B + q0) * K, K, smem_lists != 0};
    lists_init(lists, B, q0);

    // A stage: the store chunk [R][FSK], then the queries' [Q][FSK].
    auto issue = [&](int step) {
        float* st = reinterpret_cast<float*>(smem + (size_t)(step % F_STAGES) * F_STAGE);
        const int r0 = row_begin + (step / n_chunks) * F_R;
        const int c0 = (step % n_chunks) * FDK;
        load_chunk<float, FDK, FSK, F_R>(x, r0, row_end, D, c0, st, x_async);
        load_chunk<float, FDK, FSK, F_Q>(q, q0, B, D, c0, st + F_R * FSK, q_async);
    };

    // Warp (wq, wr) owns queries wq*32 .. +31 and tile rows wr*32 .. +31:
    // two m16 tiles by four n8 pieces. The first warps, on different
    // sub-partitions of the SM, share the first queries, so a small B still
    // spreads over them; warps whose queries all lie past B skip the
    // products.
    const int wq = warp / F_WR, wr = warp % F_WR;
    const bool active = q0 + wq * 32 < B;
    const int g = lane >> 2, t4 = lane & 3;
    // ldmatrix row addresses, 16 bytes each: A's four pieces are (rows 0-7 |
    // 8-15) x (k 0-3 | 4-7); B's are (n 0-7, k 0-3), (n 0-7, k 4-7), then n
    // 8-15 alike (8x4 f32 matrices read as 8x8 b16).
    const int a_off = (F_R + wq * 32 + (lane & 15)) * FSK + (lane >> 4) * 4;
    const int b_off = (wr * 32 + (lane >> 4) * 8 + (lane & 7)) * FSK + ((lane >> 3) & 1) * 4;
#if FL2_PROFILE
    unsigned long long prof_[5] = {}, prof_t_ = clock64();
#endif

#pragma unroll
    for (int i = 0; i < F_STAGES - 1; ++i) {
        if (i < total) issue(i);
        cp_async_commit();
    }
    // Tiles, then their chunks (ring step s = tile * n_chunks + chunk): the
    // accumulators live within a tile, not across its selection.
    for (int tile = 0, s = 0; tile < n_tiles; ++tile) {
        const int r0 = row_begin + tile * F_R;
        float acc[2][4][4] = {};
        float nrm[4][2];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int row = r0 + wr * 32 + p * 8 + 2 * t4 + e;
                nrm[p][e] = row < row_end ? norms[row] : 0.f;
            }
        for (int chunk = 0; chunk < n_chunks; ++chunk, ++s) {
            cp_async_wait<F_STAGES - 2>();   // this thread's copies of step s landed
            __syncthreads();                 // everyone's; and step s-1's stage is free
            FL2_MARK(0);
            if (s + F_STAGES - 1 < total) issue(s + F_STAGES - 1);
            cp_async_commit();
            FL2_MARK(1);

            const float* st =
                reinterpret_cast<const float*>(smem + (size_t)(s % F_STAGES) * F_STAGE);
            const int kw = min(FDK, D - chunk * FDK);
            if (FL2_NO_MMA || !active) {
            } else if (kw == FDK) {
                // A whole chunk, with no guard between its k steps, so that
                // they overlap (F_KUNROLL at a time: more spill registers).
#pragma unroll (F_KUNROLL)
                for (int kk = 0; kk < FDK; kk += 8)
                    f32_k_step(acc, st + a_off + kk, st + b_off + kk);
            } else {
#pragma unroll
                for (int kk = 0; kk < FDK; kk += 8)
                    if (kk < kw) f32_k_step(acc, st + a_off + kk, st + b_off + kk);
            }
            FL2_MARK(2);
        }

        // Keys of this tile: accumulator (h, e) of (m, p) is query
        // wq*32 + m*16 + g + 8h, tile row wr*32 + p*8 + 2t + e.
        if (active) {
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int p = 0; p < 4; ++p)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int col = wr * 32 + p * 8 + 2 * t4 + e;
                            keys_s[(wq * 32 + m * 16 + g + 8 * h) * (F_R + 1) + col] =
                                r0 + col < row_end ? __fadd_rn(nrm[p][e], acc[m][p][2 * h + e])
                                                   : INF;
                        }
        }
        __syncthreads();
        FL2_MARK(3);
        // The next write of keys_s comes after the next tile's first barrier.
        if (!FL2_NO_SELECT) select_tile_f32(lists, keys_s, r0, B, q0);
        FL2_MARK(4);
    }
    cp_async_wait<0>();
    lists_flush(lists, B, q0);
#if FL2_PROFILE
    if (lane == 0)
        for (int i = 0; i < 5; ++i) atomicAdd(&fl2_prof[i], prof_[i]);
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

// Let a pass-1 kernel (slot: 0 for mode 0's, MODE for scan_topk_mma_kernel<MODE>)
// take the most dynamic shared memory a block may use: once per kernel and
// device, not on every launch.
constexpr int MAX_DEVICES = 64;

cudaError_t allow_smem(const void* kernel, int slot) {
    static bool done[4][MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && done[slot][dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
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

cudaError_t launch_scan_f32(const float* q, const float* x, const float* norms, int B, int N, int D,
                            int K, int S, float* part_k, int* part_p, cudaStream_t stream) {
    const bool smem_lists = f32_smem_lists(K);
    const size_t smem = f32_smem(K, smem_lists);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(reinterpret_cast<const void*>(&scan_topk_f32_kernel), 0);
    if (err != cudaSuccess) return err;
    const bool x_async = reinterpret_cast<uintptr_t>(x) % 16 == 0 && D % 4 == 0;
    const bool q_async = reinterpret_cast<uintptr_t>(q) % 16 == 0 && D % 4 == 0;
    scan_topk_f32_kernel<<<dim3((B + F_Q - 1) / F_Q, S), NT, smem, stream>>>(
        q, x, norms, B, N, D, K, rows_per_split(N, S, F_R), smem_lists, x_async, q_async, part_k,
        part_p);
    return cudaGetLastError();
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

int fused_l2_topk_abi_version() { return 6; }

// Pass 1's shape in mode `dtype` at (D, K), into out: [0] the blocks that
// fit on one SM (modes 1 and 3 count two, the bf16 layout at small k; modes
// 0 and 2 as many as the CUDA occupancy query reports for their shared
// memory: mode 0 one, mode 2 two at k = 20 and one where lists in shared
// memory leave no room for a second), [1] the queries a block, [2] the
// store rows a tile (a split's rows are a whole number of them), [3] the
// most splits pass 2 merges (MAX_SPLITS; fused_l2_topk refuses more). The
// wrapper asks once per (device, mode, D, K) and sizes the grid from it
// (ops/topk_cuda.launch_plan). Returns 0.
int fused_l2_topk_shape(int dtype, int D, int K, int* out) {
    out[1] = QT;
    out[3] = MAX_SPLITS;
    out[2] = dtype == 0 ? F_R : RT;
    if (dtype == 0)
        out[0] = occupancy(reinterpret_cast<const void*>(&scan_topk_f32_kernel), 0,
                           f32_smem(K, f32_smem_lists(K)));
    else if (dtype == 2)
        out[0] = occupancy(reinterpret_cast<const void*>(&scan_topk_mma_kernel<2>), 2,
                           mma_plan<2>(D, K).smem);
    else
        out[0] = 2;
    return 0;
}

#if FL2_PROFILE
// Diagnostic builds: the phase cycles of scan_topk_f32_kernel's warps summed
// since the last call (see FL2_PROFILE) into out[5], then cleared.
int fused_l2_topk_profile(unsigned long long* out) {
    cudaError_t err = cudaMemcpyFromSymbol(out, fl2_prof, sizeof(fl2_prof));
    if (err != cudaSuccess) return (int)err;
    const unsigned long long zero[5] = {};
    return (int)cudaMemcpyToSymbol(fl2_prof, zero, sizeof(zero));
}
#endif

// dtype: 0 = f32, 1 = bf16, 2 = int8 (queries int8 with per-row scales rs),
// 3 = int8 store with bf16 queries (rs unused).
// q (B, D) and x (N, D) row-major in the store dtype; norms (N,) f32;
// part_k/part_p (S, B, K) scratch, S at most MAX_SPLITS (the wrapper's
// launch plan); out_k/out_p (B, K). Returns the CUDA error code of the
// launches (0 on success).
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
        err = launch_scan_f32(static_cast<const float*>(q), static_cast<const float*>(x), nr, B, N,
                              D, K, S, pk, pp, st);
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
