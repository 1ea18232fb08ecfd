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
// with f32 accumulation (int8: an exact int32 dot via __dp4a). The last
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
// How pass 1 forms the keys depends on the product's type:
//   - bf16 x bf16 -> f32 (mode 1, bf16 store; mode 3, int8 codes with bf16
//     queries): tensor cores, scan_topk_mma_kernel. The block's queries are
//     staged once as bf16 and stay resident in shared memory for the whole
//     split (64 x 392 bf16 = 49 KB at D = 384; above ~1,340 columns they
//     no longer fit and come through the ring beside the store instead).
//     Store tiles arrive in DK-column chunks through a STAGES-deep ring of
//     16-byte cp.async.cg copies, so the next chunks load while the
//     current one multiplies. Mode 1 copies bf16 rows; mode 3 copies the
//     raw int8 codes (half of bf16's bytes, a quarter of f32's) and one
//     cooperative pass decodes each chunk once into a bf16 tile in shared
//     memory (exact), so both modes share one product path. Rows that are
//     not 16-byte aligned (D % 8 != 0 for bf16, D % 16 != 0 for int8, or
//     an unaligned base) take a plain zero-filling loader into the same
//     layout. Each warp owns a 16-query x 32-row piece of the tile and runs
//     mma.sync.m16n8k16 bf16 -> f32 on fragments loaded with ldmatrix: A is
//     the row-major queries, B the store rows, which a row-major (N, D)
//     store already lays out as the "col" operand (nothing is transposed).
//     Padded 144-byte chunk rows keep every ldmatrix phase on distinct banks.
//   - f32 (mode 0) and int8 x int8 (mode 2): CUDA cores, scan_topk_kernel:
//     DK-wide slices of both operands are loaded synchronously into
//     transposed shared tiles and a 4x4 register micro-tile per thread runs
//     FMA (f32) or __dp4a (int8, exact int32).
//
// Bound on the NVIDIA H100 80GB HBM3 (the SXM part; published at 700 W:
// 3.35 TB/s; tensor cores 495 TFLOP/s TF32, 989 TFLOP/s bf16, 1,979 TOP/s
// int8) at N = 1,048,576 rows of D = 384. The f32 scan only builds the
// shortlist that the exact f32 rerank corrects, so TF32 tensor cores are
// admissible for it and its bound takes the TF32 rate.
// Bytes: the store once plus its norms (f32 1.61 GB -> 0.48 ms,
// bf16 0.81 GB -> 0.24 ms, int8 0.41 GB -> 0.12 ms). Operations: 2*B*N*D
// (B = 128: 0.103 TFLOP -> f32 0.21 ms, bf16 0.10 ms, int8 0.05 ms;
// B = 1024: 0.82 TFLOP -> f32 1.67 ms, bf16 0.83 ms, int8 0.42 ms). So every
// store is bound by bytes at B = 128 and by operations at B = 1024. The
// mma.sync path moves the bf16 products off the CUDA cores (where they ran
// at ~15 TFLOP/s) and overlaps loads with products, which is what B = 128
// needs; at B = 1024 the full tensor-core rate needs wgmma fed by TMA, a
// later step. What holds the mma.sync path back now (PERF.md, measured with
// tools/flat_mma_breakdown.py): at B = 128 the warp selection, which runs
// between the tiles' products, takes about half of the time; at B = 1024
// every one of the 16 query tiles reads the store again from L2. Two
// blocks of 8 warps share an SM at small k (about 105 KB of shared memory
// each at k = 20), and the split count keeps the grid to one wave. Modes 0
// and 2 still run on the CUDA cores (mma.sync TF32 or 3xTF32, and m16n8k32
// s8, are their next step). chip_smoke.py computes the bound for each
// run's shapes and times every mode beside it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// Build-time switches of the tensor-core path, for tools/flat_mma_breakdown.py
// only (the shipped build takes these defaults): the ring's shape, and two
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
constexpr int DKF = 32;           // feature slice, f32 elements (mode 0)
constexpr int DKW = 16;           // feature slice, int8 as 4-byte words (64 values)
constexpr int TS = QT + 4;        // padded tile stride (keeps 16-byte rows)
constexpr int SMEM_LIST_MAX = 128;
constexpr int MAX_SPLITS = 128;   // 4 per lane in the merge pass
constexpr unsigned FULL = 0xffffffffu;
constexpr int INT_MAXV = 0x7fffffff;
static_assert(QT == RT, "the slice loaders stage QT rows for both operands");

// The tensor-core path (modes 1 and 3).
constexpr int DK = FL2_DK;        // feature columns per ring stage
constexpr int SKP = DK + 8;       // padded bf16 chunk row (144 bytes at DK = 64)
constexpr int STAGES = FL2_STAGES;   // ring depth
constexpr size_t SMEM_MAX = 232448;   // dynamic shared memory a block may use
static_assert((RT * DK / 16) % NT == 0, "whole 16-byte int8 copies per thread per chunk");

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

// -- CUDA-core pass 1 (modes 0 and 2) ------------------------------------------

// Stage a (rows x DKF) slice of a row-major (n_rows, D) matrix into the
// transposed float tile t[DKF][TS]; out-of-range entries are 0.
__device__ __forceinline__ void load_slice_f(const float* __restrict__ src, int row0, int n_rows,
                                             int D, int c0, float* t) {
#pragma unroll
    for (int i = 0; i < (QT * DKF) / NT; ++i) {
        int idx = threadIdx.x + NT * i;
        int r = idx / DKF, c = idx % DKF;
        float v = 0.f;
        if (row0 + r < n_rows && c0 + c < D)
            v = src[(int64_t)(row0 + r) * D + c0 + c];
        t[c * TS + r] = v;
    }
}

// Same for int8 rows read as packed 4-byte words (D % 4 == 0).
__device__ __forceinline__ void load_slice_w(const int8_t* __restrict__ src, int row0, int n_rows,
                                             int DW, int w0, int* t) {
#pragma unroll
    for (int i = 0; i < (QT * DKW) / NT; ++i) {
        int idx = threadIdx.x + NT * i;
        int r = idx / DKW, w = idx % DKW;
        int v = 0;
        if (row0 + r < n_rows && w0 + w < DW)
            v = reinterpret_cast<const int*>(src + (int64_t)(row0 + r) * DW * 4)[w0 + w];
        t[w * TS + r] = v;
    }
}

// MODE 0: f32 store, 2: int8 store with int8 queries. TQ / T: query / store
// element types.
template <int MODE, typename TQ, typename T>
__global__ void __launch_bounds__(NT)
scan_topk_kernel(const TQ* __restrict__ q, const T* __restrict__ x,
                 const float* __restrict__ norms, const float* __restrict__ rs,
                 int B, int N, int D, int K, int rows_per_split,
                 float* __restrict__ part_k, int* __restrict__ part_p) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* keys_s = reinterpret_cast<float*>(smem);                 // [QT][RT + 1]
    float* tq = keys_s + QT * (RT + 1);                              // [DKF][TS]
    float* tx = tq + DKF * TS;                                       // [DKF][TS]
    float* list_base_k = tx + DKF * TS;

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * QT;
    const int split = blockIdx.y;
    const int row_begin = split * rows_per_split;
    const int row_end = min(N, row_begin + rows_per_split);
    const int tx4 = (tid % 16) * 4;   // this thread's 4 rows of the tile
    const int ty4 = (tid / 16) * 4;   // this thread's 4 queries of the tile

    const Lists lists{list_base_k, reinterpret_cast<int*>(list_base_k + QT * K), part_k, part_p,
                      ((int64_t)split * B + q0) * K, K, K <= SMEM_LIST_MAX};
    lists_init(lists, B, q0);
    float qscale[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (MODE == 2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qscale[i] = (q0 + ty4 + i < B) ? rs[q0 + ty4 + i] : 0.f;
    }
    __syncthreads();

    for (int r0 = row_begin; r0 < row_end; r0 += RT) {
        float accf[4][4];
        int acci[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) { accf[i][j] = 0.f; acci[i][j] = 0; }

        if constexpr (MODE == 2) {
            const int DW = D / 4;
            int* tqi = reinterpret_cast<int*>(tq);
            int* txi = reinterpret_cast<int*>(tx);
            for (int w0 = 0; w0 < DW; w0 += DKW) {
                load_slice_w(reinterpret_cast<const int8_t*>(q), q0, B, DW, w0, tqi);
                load_slice_w(reinterpret_cast<const int8_t*>(x), r0, row_end, DW, w0, txi);
                __syncthreads();
#pragma unroll 4
                for (int w = 0; w < DKW; ++w) {
                    const int4 a = *reinterpret_cast<const int4*>(tqi + w * TS + ty4);
                    const int4 b = *reinterpret_cast<const int4*>(txi + w * TS + tx4);
                    const int av[4] = {a.x, a.y, a.z, a.w};
                    const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int j = 0; j < 4; ++j) acci[i][j] = __dp4a(av[i], bv[j], acci[i][j]);
                }
                __syncthreads();
            }
        } else {
            for (int c0 = 0; c0 < D; c0 += DKF) {
                load_slice_f(q, q0, B, D, c0, tq);
                load_slice_f(x, r0, row_end, D, c0, tx);
                __syncthreads();
#pragma unroll 8
                for (int c = 0; c < DKF; ++c) {
                    const float4 a = *reinterpret_cast<const float4*>(tq + c * TS + ty4);
                    const float4 b = *reinterpret_cast<const float4*>(tx + c * TS + tx4);
                    const float av[4] = {a.x, a.y, a.z, a.w};
                    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int j = 0; j < 4; ++j) accf[i][j] = fmaf(av[i], bv[j], accf[i][j]);
                }
                __syncthreads();
            }
        }

        // Keys of this tile. The int8 key is rounded twice (product, then
        // sum) exactly as the plain version computes it, never fused.
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int row = r0 + tx4 + j;
            const bool live = row < row_end;
            const float nrm = live ? norms[row] : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float key;
                if constexpr (MODE == 2) key = __fadd_rn(__fmul_rn((float)acci[i][j], qscale[i]), nrm);
                else key = __fadd_rn(nrm, accf[i][j]);
                keys_s[(ty4 + i) * (RT + 1) + tx4 + j] = live ? key : __int_as_float(0x7f800000);
            }
        }
        __syncthreads();
        select_tile(lists, keys_s, r0, B, q0);
        __syncthreads();
    }
    lists_flush(lists, B, q0);
}

// -- tensor-core pass 1 (modes 1 and 3) ------------------------------------------

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

// Shared-memory layout of scan_topk_mma_kernel, computed alike on the host
// (to size the launch) and in the kernel (to place its buffers).
struct MmaLayout {
    int x_bytes;       // the store chunk of a stage
    int stage_bytes;   // the store chunk, then (streamed queries) the query chunk
    int dqs;           // row stride of the resident queries (elements)
    size_t ring, dec, qs, keys, lists, total;
};

__host__ __device__ inline MmaLayout mma_layout(int mode, int D, int K, bool q_res, bool smem_lists) {
    MmaLayout L;
    L.x_bytes = mode == 1 ? RT * SKP * 2 : RT * DK;
    L.stage_bytes = L.x_bytes + (q_res ? 0 : QT * SKP * 2);
    L.dqs = (D + DK - 1) / DK * DK + 8;   // 16 mod 128 bytes: ldmatrix rows on distinct banks
    size_t o = 0;
    L.ring = o; o += (size_t)STAGES * L.stage_bytes;
    L.dec = o; o += mode == 3 ? RT * SKP * 2 : 0;
    L.qs = o; o += q_res ? (size_t)QT * L.dqs * 2 : 0;
    L.keys = o; o += sizeof(float) * QT * (RT + 1);
    L.lists = o; o += smem_lists ? (size_t)QT * K * (sizeof(float) + sizeof(int)) : 0;
    L.total = o;
    return L;
}

// One DK-column chunk of 64 bf16 rows [row0, row_lim) into dst (stride
// SKP), zero past row_lim and D: 16-byte cp.async when rows are aligned,
// else a plain loader.
__device__ __forceinline__ void load_chunk_bf16(const uint16_t* __restrict__ src, int row0,
                                                int row_lim, int D, int c0, uint16_t* dst,
                                                bool async) {
    if (async) {
#pragma unroll
        for (int i = 0; i < (RT * DK / 8) / NT; ++i) {
            const int idx = threadIdx.x + NT * i;
            const int r = idx / (DK / 8), c = (idx % (DK / 8)) * 8;
            const bool ok = row0 + r < row_lim && c0 + c < D;
            cp_async16(dst + r * SKP + c, ok ? src + (int64_t)(row0 + r) * D + c0 + c : src, ok);
        }
    } else {
        for (int idx = threadIdx.x; idx < RT * DK; idx += NT) {
            const int r = idx / DK, c = idx % DK;
            const bool ok = row0 + r < row_lim && c0 + c < D;
            dst[r * SKP + c] = ok ? src[(int64_t)(row0 + r) * D + c0 + c] : (uint16_t)0;
        }
    }
}

// The same for raw int8 codes into dst (stride DK bytes).
__device__ __forceinline__ void load_chunk_i8(const int8_t* __restrict__ src, int row0, int row_lim,
                                              int D, int c0, int8_t* dst, bool async) {
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

// Decode a raw int8 chunk to bf16 (stride SKP), exactly: 16 codes per copy.
__device__ __forceinline__ void decode_chunk(const int8_t* raw, uint16_t* dec) {
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
        uint4* d = reinterpret_cast<uint4*>(dec + r * SKP + c);
        d[0] = make_uint4(out[0], out[1], out[2], out[3]);
        d[1] = make_uint4(out[4], out[5], out[6], out[7]);
    }
}

// MODE 1: bf16 store; 3: int8 codes (decoded to bf16). Queries are bf16.
// q_res: the query tile is resident (else it streams through the ring);
// smem_lists: the lists are in shared memory; x_async / q_async: rows are
// 16-byte aligned and load with cp.async.
template <int MODE>
__global__ void __launch_bounds__(NT, 2)
scan_topk_mma_kernel(const uint16_t* __restrict__ q, const void* __restrict__ xv,
                     const float* __restrict__ norms, int B, int N, int D, int K,
                     int rows_per_split, int q_res, int smem_lists, int x_async, int q_async,
                     float* __restrict__ part_k, int* __restrict__ part_p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const MmaLayout L = mma_layout(MODE, D, K, q_res, smem_lists);
    float* keys_s = reinterpret_cast<float*>(smem + L.keys);
    float* list_base_k = reinterpret_cast<float*>(smem + L.lists);
    uint16_t* qs = reinterpret_cast<uint16_t*>(smem + L.qs);
    uint16_t* dec = reinterpret_cast<uint16_t*>(smem + L.dec);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = blockIdx.x * QT;
    const int split = blockIdx.y;
    const int row_begin = split * rows_per_split;
    const int row_end = min(N, row_begin + rows_per_split);
    const int n_chunks = (D + DK - 1) / DK;
    const int n_tiles = row_end > row_begin ? (row_end - row_begin + RT - 1) / RT : 0;
    const int total = n_tiles * n_chunks;   // ring steps: (tile, chunk) in order

    const Lists lists{list_base_k, reinterpret_cast<int*>(list_base_k + QT * K), part_k, part_p,
                      ((int64_t)split * B + q0) * K, K, smem_lists != 0};
    lists_init(lists, B, q0);
    if (q_res) {
        const int dqp = L.dqs - 8;
        for (int idx = tid; idx < QT * dqp; idx += NT) {
            const int r = idx / dqp, c = idx % dqp;
            qs[r * L.dqs + c] = (q0 + r < B && c < D) ? q[(int64_t)(q0 + r) * D + c] : (uint16_t)0;
        }
    }

    auto issue = [&](int step) {
        unsigned char* st = smem + L.ring + (size_t)(step % STAGES) * L.stage_bytes;
        const int r0 = row_begin + (step / n_chunks) * RT;
        const int c0 = (step % n_chunks) * DK;
        if constexpr (MODE == 1)
            load_chunk_bf16(static_cast<const uint16_t*>(xv), r0, row_end, D, c0,
                            reinterpret_cast<uint16_t*>(st), x_async);
        else
            load_chunk_i8(static_cast<const int8_t*>(xv), r0, row_end, D, c0,
                          reinterpret_cast<int8_t*>(st), x_async);
        if (!q_res)
            load_chunk_bf16(q, q0, B, D, c0, reinterpret_cast<uint16_t*>(st + L.x_bytes), q_async);
    };

    // Warp (wq, wr) owns queries wq*16 .. +15 and tile rows wr*32 .. +31:
    // four n8 pieces. Fragment lanes: g = lane / 4, t = lane % 4.
    const int wq = warp & 3, wr = warp >> 2;
    const int g = lane >> 2, t4 = lane & 3;
    float acc[4][4];
    float nrm[4][2];

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
                for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int row = r0 + wr * 32 + nt * 8 + 2 * t4 + e;
                    nrm[nt][e] = row < row_end ? norms[row] : 0.f;
                }
            }
        }
        const uint16_t* bt = reinterpret_cast<const uint16_t*>(st);
        if constexpr (MODE == 3) {
            decode_chunk(reinterpret_cast<const int8_t*>(st), dec);
            __syncthreads();
            bt = dec;
        }
        const uint16_t* at = q_res ? qs + chunk * DK : reinterpret_cast<const uint16_t*>(st + L.x_bytes);
        const int as = q_res ? L.dqs : SKP;
        const int kw = min(DK, D - chunk * DK);
        // ldmatrix row addresses: A's four 8x8 pieces are (rows 0-7 | 8-15) x
        // (k 0-7 | 8-15); B's are (n 0-7, k 0-7), (n 0-7, k 8-15), then n 8-15.
        const uint16_t* a_ptr = at + (wq * 16 + (lane & 15)) * as + (lane >> 4) * 8;
        const uint16_t* b_ptr = bt + (wr * 32 + (lane >> 4) * 8 + (lane & 7)) * SKP + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < DK; kk += 16) {
            if (kk < kw && !FL2_NO_MMA) {
                unsigned a[4], b01[4], b23[4];
                ldmatrix_x4(a, a_ptr + kk);
                ldmatrix_x4(b01, b_ptr + kk);
                ldmatrix_x4(b23, b_ptr + 16 * SKP + kk);
                mma_bf16(acc[0], a, b01[0], b01[1]);
                mma_bf16(acc[1], a, b01[2], b01[3]);
                mma_bf16(acc[2], a, b23[0], b23[1]);
                mma_bf16(acc[3], a, b23[2], b23[3]);
            }
        }

        if (chunk == n_chunks - 1) {
            // Keys of this tile: accumulator (h, e) of piece nt is query
            // g + 8h, tile row nt*8 + 2t + e.
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = wr * 32 + nt * 8 + 2 * t4 + e;
                        const float key = r0 + col < row_end ? __fadd_rn(nrm[nt][e], acc[nt][2 * h + e])
                                                             : __int_as_float(0x7f800000);
                        keys_s[(wq * 16 + g + 8 * h) * (RT + 1) + col] = key;
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

template <int MODE, typename TQ, typename T>
cudaError_t launch_scan(const void* q, const void* x, const float* norms, const float* rs,
                        int B, int N, int D, int K, int S, float* part_k, int* part_p,
                        cudaStream_t stream) {
    size_t smem = sizeof(float) * (QT * (RT + 1) + 2 * DKF * TS);
    if (K <= SMEM_LIST_MAX) smem += (sizeof(float) + sizeof(int)) * (size_t)QT * K;
    cudaError_t err = cudaFuncSetAttribute(scan_topk_kernel<MODE, TQ, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((B + QT - 1) / QT, S);
    scan_topk_kernel<MODE, TQ, T><<<grid, NT, smem, stream>>>(
        static_cast<const TQ*>(q), static_cast<const T*>(x), norms, rs, B, N, D, K,
        rows_per_split(N, S), part_k, part_p);
    return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_scan_mma(const void* q, const void* x, const float* norms, int B, int N, int D,
                            int K, int S, float* part_k, int* part_p, cudaStream_t stream) {
    // Resident queries when they fit; then the lists in shared memory when
    // they fit beside them.
    const bool q_res = mma_layout(MODE, D, K, true, false).total <= SMEM_MAX;
    const bool smem_lists = K <= SMEM_LIST_MAX && mma_layout(MODE, D, K, q_res, true).total <= SMEM_MAX;
    const size_t smem = mma_layout(MODE, D, K, q_res, smem_lists).total;
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    const int vec = MODE == 1 ? 8 : 16;   // elements per 16-byte copy
    const bool x_async = reinterpret_cast<uintptr_t>(x) % 16 == 0 && D % vec == 0;
    const bool q_async = reinterpret_cast<uintptr_t>(q) % 16 == 0 && D % 8 == 0;
    cudaError_t err = cudaFuncSetAttribute(scan_topk_mma_kernel<MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((B + QT - 1) / QT, S);
    scan_topk_mma_kernel<MODE><<<grid, NT, smem, stream>>>(
        static_cast<const uint16_t*>(q), x, norms, B, N, D, K, rows_per_split(N, S), q_res,
        smem_lists, x_async, q_async, part_k, part_p);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_l2_topk_abi_version() { return 4; }

// The number S of splits of the store for B queries over N rows on a card
// of `sms` multiprocessors: (query tiles x splits) fills the card at most
// twice over (the tensor-core pass holds two blocks per SM at small k, so
// the grid is one wave with no tail), with at least one row tile per split.
int fused_l2_topk_splits(int B, int N, int sms) {
    const int q_tiles = (B + QT - 1) / QT;
    const int row_tiles = (N + RT - 1) / RT;
    int s = 2 * sms / q_tiles;
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
    const float* r = static_cast<const float*>(rs);
    float* pk = static_cast<float*>(part_k);
    int* pp = static_cast<int*>(part_p);
    cudaError_t err;
    if (dtype == 0)
        err = launch_scan<0, float, float>(q, x, nr, r, B, N, D, K, S, pk, pp, st);
    else if (dtype == 1)
        err = launch_scan_mma<1>(q, x, nr, B, N, D, K, S, pk, pp, st);
    else if (dtype == 2)
        err = launch_scan<2, int8_t, int8_t>(q, x, nr, r, B, N, D, K, S, pk, pp, st);
    else if (dtype == 3)
        err = launch_scan_mma<3>(q, x, nr, B, N, D, K, S, pk, pp, st);
    else
        return (int)cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
    merge_splits_kernel<<<(B + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
        pk, pp, S, B, K, static_cast<float*>(out_k), static_cast<int*>(out_p));
    return (int)cudaGetLastError();
}

}  // extern "C"
