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
// Design (simple and right first):
//   pass 1 (scan_topk_kernel): grid = (query tiles of QT, splits of N).
//     Each block streams its split's rows in RT-row tiles through shared
//     memory in DK-wide slices of the feature axis, computes the QT x RT
//     keys with a 4x4 register micro-tile per thread (FMA, or __dp4a for
//     int8), then each warp merges its queries' tile keys into sorted
//     per-query lists. Lists live in shared memory when they fit
//     (k <= SMEM_LIST_MAX) and in the partial-output buffer otherwise.
//     The query tile is the fastest grid axis, so the blocks that share a
//     split run together and read the store through L2 once.
//   pass 2 (merge_splits_kernel): one warp per query merges the per-split
//     sorted lists by (key, position) into the final k.
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
// store is bound by bytes at B = 128 and by operations at B = 1024. This
// first version runs its products on the CUDA cores (FMA, __dp4a), far
// from the tensor-core rates; wgmma tiles fed by TMA are the next step.
// chip_smoke.py computes the bound for each run's shapes and times it
// (PERF.md: f32 at B = 128 takes 5.58 ms, 11.6x its 0.48 ms bound).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;            // queries per block
constexpr int RT = 64;            // store rows per tile
constexpr int NT = 256;           // threads per block (8 warps)
constexpr int DKF = 32;           // feature slice, f32/bf16 elements
constexpr int DKW = 16;           // feature slice, int8 as 4-byte words (64 values)
constexpr int TS = QT + 4;        // padded tile stride (keeps 16-byte rows)
constexpr int SMEM_LIST_MAX = 128;
constexpr int MAX_SPLITS = 128;   // 4 per lane in the merge pass
constexpr unsigned FULL = 0xffffffffu;
constexpr int INT_MAXV = 0x7fffffff;
static_assert(QT == RT, "the slice loaders stage QT rows for both operands");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// Stage a (rows x DKF) slice of a row-major (n_rows, D) matrix into the
// transposed float tile t[DKF][TS]; out-of-range entries are 0.
template <typename T>
__device__ __forceinline__ void load_slice_f(const T* __restrict__ src, int row0, int n_rows,
                                             int D, int c0, float* t) {
#pragma unroll
    for (int i = 0; i < (QT * DKF) / NT; ++i) {
        int idx = threadIdx.x + NT * i;
        int r = idx / DKF, c = idx % DKF;
        float v = 0.f;
        if (row0 + r < n_rows && c0 + c < D)
            v = to_f32(src[(int64_t)(row0 + r) * D + c0 + c]);
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

// MODE 0: f32 store, 1: bf16 store, 2: int8 store with int8 queries,
// 3: int8 store with bf16 queries. TQ / T: query / store element types.
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
    const bool smem_lists = K <= SMEM_LIST_MAX;
    float* list_base_k = tx + DKF * TS;
    int* list_base_p = reinterpret_cast<int*>(list_base_k + QT * K);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = blockIdx.x * QT;
    const int split = blockIdx.y;
    const int row_begin = split * rows_per_split;
    const int row_end = min(N, row_begin + rows_per_split);
    const int tx4 = (tid % 16) * 4;   // this thread's 4 rows of the tile
    const int ty4 = (tid / 16) * 4;   // this thread's 4 queries of the tile

    // Each block owns its (split, query tile) lists: in shared memory, or
    // directly in the partial-output buffer.
    auto list_k = [&](int qi) -> float* {
        return smem_lists ? list_base_k + qi * K
                          : part_k + ((int64_t)split * B + q0 + qi) * K;
    };
    auto list_p = [&](int qi) -> int* {
        return smem_lists ? list_base_p + qi * K
                          : part_p + ((int64_t)split * B + q0 + qi) * K;
    };
    for (int qi = warp; qi < QT; qi += NT / 32) {
        if (q0 + qi >= B) continue;
        float* lk = list_k(qi);
        int* lp = list_p(qi);
        for (int j = lane; j < K; j += 32) { lk[j] = __int_as_float(0x7f800000); lp[j] = INT_MAXV; }
    }
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

        // Selection: warp w owns queries w, w + 8, ...; lane l looks at
        // columns l and l + 32, candidates are taken in ascending column
        // (= position) order.
        for (int qi = warp; qi < QT; qi += NT / 32) {
            if (q0 + qi >= B) continue;
            float* lk = list_k(qi);
            int* lp = list_p(qi);
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
        __syncthreads();
    }

    if (smem_lists) {
        for (int qi = warp; qi < QT; qi += NT / 32) {
            if (q0 + qi >= B) continue;
            const int64_t o = ((int64_t)split * B + q0 + qi) * K;
            for (int j = lane; j < K; j += 32) {
                part_k[o + j] = list_base_k[qi * K + j];
                part_p[o + j] = list_base_p[qi * K + j];
            }
        }
    }
}

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

template <int MODE, typename TQ, typename T>
cudaError_t launch_scan(const void* q, const void* x, const float* norms, const float* rs,
                        int B, int N, int D, int K, int S, float* part_k, int* part_p,
                        cudaStream_t stream) {
    const int rows_per_split = ((N + S - 1) / S + RT - 1) / RT * RT;
    size_t smem = sizeof(float) * (QT * (RT + 1) + 2 * DKF * TS);
    if (K <= SMEM_LIST_MAX) smem += (sizeof(float) + sizeof(int)) * (size_t)QT * K;
    cudaError_t err = cudaFuncSetAttribute(scan_topk_kernel<MODE, TQ, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((B + QT - 1) / QT, S);
    scan_topk_kernel<MODE, TQ, T><<<grid, NT, smem, stream>>>(
        static_cast<const TQ*>(q), static_cast<const T*>(x), norms, rs, B, N, D, K,
        rows_per_split, part_k, part_p);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_l2_topk_abi_version() { return 3; }

// The number S of splits of the store for B queries over N rows on a card
// of `sms` multiprocessors: (query tiles x splits) fills the card about
// twice over, with at least one row tile per split.
int fused_l2_topk_splits(int B, int N, int sms) {
    const int q_tiles = (B + QT - 1) / QT;
    const int row_tiles = (N + RT - 1) / RT;
    int s = (2 * sms + q_tiles - 1) / q_tiles;
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
        err = launch_scan<1, __nv_bfloat16, __nv_bfloat16>(q, x, nr, r, B, N, D, K, S, pk, pp, st);
    else if (dtype == 2)
        err = launch_scan<2, int8_t, int8_t>(q, x, nr, r, B, N, D, K, S, pk, pp, st);
    else if (dtype == 3)
        err = launch_scan<3, __nv_bfloat16, int8_t>(q, x, nr, r, B, N, D, K, S, pk, pp, st);
    else
        return (int)cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
    merge_splits_kernel<<<(B + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
        pk, pp, S, B, K, static_cast<float*>(out_k), static_cast<int*>(out_p));
    return (int)cudaGetLastError();
}

}  // extern "C"
