// ivf_scan: the IVF inverted-list scans for Hopper (sm_90a). Plain C
// interface, loaded with ctypes by ops/ivf_scan_cuda.py.
//
// Three kernels replace the five Pallas kernels of
// c99_vectordb_tpu/ops/ivf_scan_pallas.py. The TPU variants that differ
// only in how many queries a grid step carries become one kernel each,
// with queries per block as a parameter:
//
//   ivf_select_kernel      <- _ivf_scan_kernel (:113) and
//   (+ ivf_merge_kernel)      _ivf_scan_kernel_multi (:202)
//   ivf_dense_kernel       <- _ivf_scan_kernel_dense (:362)
//   ivf_dense_int8_kernel  <- _ivf_scan_kernel_dense_int8 (:462) and
//                             _ivf_scan_kernel_dense_int8_multi (:496)
//
// Contract (the Pallas kernels' results, not their Mosaic mechanics). For
// query b and each of its nprobe probed lists l = probes[b, p], every slot
// s of the list gives
//
//   f32 / bf16:  dist = max((q_sq[b] + sqn[l, s]) - 2 * dot(q[b], x[l, s]), 0)
//   int8:        key  = float(dot_i32(q8[b], x8[l, s])) * rs[b] + sqn[l, s]
//
// and +inf where ids[l, s] < 0. The bf16 store scores the query rounded to
// bf16 (products exact in f32, f32 accumulation), as the Pallas kernels
// cast the query to the store dtype. `exact=True` in the JAX package means
// true f32 products: here every f32 product is an FMA on the CUDA cores,
// never TF32. The int8 key is rounded twice (product, then sum) with
// __fmul_rn/__fadd_rn, so nvcc cannot contract it into one FMA and the
// keys are bit-equal to the plain version's.
//
//   ivf_dense*:  write every (dist or key, raw id) at column p * pad + s
//                of (B, nprobe * pad); the selection is the caller's. With
//                a high-water mark hwm the slots past it are written as
//                (+inf, -1) without a read: they hold id -1, so this is the
//                plain output (below the mark a masked row keeps its real
//                id beside its dist).
//   ivf_select:  keep, per query, the k smallest candidates ordered by
//                (dist, id') with id' = id, or INT_MAX for padding: the
//                lowest id wins every tie, the k-th boundary included,
//                whatever the slot order inside a list (so rows appended
//                unsorted by a tail fold change nothing). Padding (inf,
//                INT_MAX) never enters; a masked row (inf norm, real id)
//                may fill an underfilled list, as in the Pallas kernel.
//                Unfilled slots come back as (inf, -1). An optional
//                (nlist,) high-water mark hwm (one past each list's last
//                occupied slot, models/devbuild.py list_hwm) stops the scan
//                of every list there: the slots past it hold id -1, which
//                never enters, so results do not depend on it.
//
// Every f32/bf16 distance is (q_sq + sqn) - 2 * ip, clamped at 0
// (l2_dist), with ip summed per row as four contiguous quarters of D, FMAs
// in index order, added ((p0 + p1) + p2) + p3: the select and dense routes
// return bit-identical distances.
//
// Bound on the NVIDIA H100 80GB HBM3 (published at 700 W: 3.35 TB/s;
// tensor cores 495 TFLOP/s TF32, 989 TFLOP/s bf16, 1,979 TOP/s int8; 67
// TFLOP/s f32 on the CUDA cores). The work is a (1, D) x (D, rows) product
// per (query, probe): 2 * D operations per row for D * itemsize bytes, so
// every variant is bound by the bytes of the live rows it reads, counted
// once per unique probed list. At 1M x 384, nlist 4096, B = 128, nprobe
// 16, the live rows of the 1,591 unique lists hold 0.6 GB of f32 -> 0.18
// ms (chip_smoke.py computes the bound of each run).
//
// Select design (what held the first version back, and the answer):
//   - One block per query walked all 16 probed lists, so at B = 128 the
//     grid was one block per SM. Now the grid is (query groups of qpb,
//     probe groups of G): each block scans a contiguous range of the
//     query's probes and writes its own sorted top-K to a (B, G, K)
//     scratch; ivf_merge_kernel merges each query's G lists exactly
//     (select_merge.cuh states why the split is exact). The wrapper sizes
//     G from the occupancy query (ops/ivf_scan_cuda.py probe_groups).
//   - Each list was walked to `pad`, 4.8x its live rows at 1M. Now the
//     block stops at the list's high-water mark.
//   - Each 64-row tile was loaded synchronously, then scored. Now 32-row
//     tiles stream through two shared-memory buffers with 16-byte
//     cp.async (the next tile but one is in flight while a tile is scored
//     and selected); a row's smem stride is D plus 16 bytes, so rows stay
//     aligned and eight consecutive rows' 16-byte reads hit distinct
//     banks. 128 threads: warp p sums quarter p of all 32 rows of a tile,
//     lane r one row, so f32 at D = 384 takes 102 KB and two blocks fit on
//     an SM.
//   - Warp 0 inserted candidates one at a time while seven warps waited.
//     Now a tile's admitted candidates are compacted, ranked and merged
//     into the running list by every thread (select_merge.cuh merge_tile).
//   Rows that are not 16-byte aligned (D % 16 for f32, D % 32 for bf16)
//   take a synchronous loader and scalar reads with the same arithmetic.
//
// Dense design: the select kernel's pipeline without the selection. The
// first version gave each block one (query group, probe, 64-row tile),
// loaded each tile synchronously, widened it to f32 at stride D + 1 (98.5
// KB at D = 384, nothing in flight while it computed) and walked every
// list to `pad` (0.21 of the slots live at 1M). Now the grid is (query,
// probe group of G, row split of S): block (b, g, s) takes the contiguous
// probe ranks of group g and, of each list, the 32-row tiles s, s + S, ...
// below the list's mark, streamed through the select kernel's two cp.async
// buffers (issue_tile, sel::next_tile). There is no merge, so G goes up to
// nprobe; S splits each list's rows across blocks, so that the longest
// lists (list lengths are skewed) do not hold the grid's tail and small
// batches fill the card (ops/select_common.py row_splits).
// f32/bf16 rows are scored by part_dot and l2_dist as in the select kernel
// (bit-identical distances); int8 rows are read as 4-byte words, 16 bytes
// at a time, by __dp4a (exact integer partial sums, any split). The int8
// work is a (1, D) x (D, rows) product per (query, probe), bound by bytes:
// tensor cores would not shorten it. After its tiles each block writes its
// share of the (+inf, -1) slots from each list's mark to pad.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "select_merge.cuh"

namespace {

constexpr int SNT = 128;             // threads per block (4 warps)
constexpr int SRT = 32;              // list rows per tile, one per lane
constexpr int PARTS = SNT / SRT;     // warps per row's dot product: warp p sums quarter p
constexpr int SMEM_K_MAX = 1024;     // select lists in shared memory up to this k
// Blocks per SM the dense kernels' launch bounds promise: f32 tiles at D =
// 384 leave room for two. Stating it keeps ptxas from trading registers
// for spills to reach a higher occupancy step of 128-thread blocks, one
// that shared memory would not allow anyway (with maxThreadsPerBlock
// alone, it spilled the bf16 and int8 kernels to 40 registers).
constexpr int DENSE_MIN_BLOCKS = 2;
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB per block on sm_90

// The query as the store dtype scores it: f32 as is, bf16 rounded.
__device__ __forceinline__ float q_as_store(float v, const float*) { return v; }
__device__ __forceinline__ float q_as_store(float v, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// The distance of one row from its summed dot product ip: each operation
// rounded on its own, so nvcc contracts nothing and every kernel that
// calls it returns the same bits.
__device__ __forceinline__ float l2_dist(float q_sq, float sqn, float ip) {
    return fmaxf(__fsub_rn(__fadd_rn(q_sq, sqn), __fmul_rn(2.0f, ip)), 0.0f);
}

// -- the row tiles and their products --------------------------------------------------

// Smem row stride (elements) of a tile: D plus 16 bytes.
template <typename T>
__host__ __device__ __forceinline__ int tile_stride(int D) {
    return D + 16 / (int)sizeof(T);
}

// Rows load with 16-byte cp.async and are read 16 bytes at a time when
// every quarter of D is a whole number of 16-byte steps.
template <typename T>
__host__ __device__ __forceinline__ bool vec_rows(int D) {
    return D % (4 * (16 / (int)sizeof(T))) == 0;
}

// Copy `rows` consecutive list rows from src into the tile dst (stride
// tile_stride): 16-byte cp.async, or a plain synchronous loader.
template <typename T, bool VEC>
__device__ __forceinline__ void issue_tile(const T* __restrict__ src, int rows, int D, T* dst) {
    const int SD = tile_stride<T>(D);
    if (VEC) {
        constexpr int V = 16 / (int)sizeof(T);
        const int cpr = D / V;
        const int total = rows * cpr;
        for (int i = threadIdx.x; i < total; i += SNT) {
            const int r = i / cpr, c = (i - r * cpr) * V;
            sel::cp_async16(dst + r * SD + c, src + (int64_t)r * D + c);
        }
    } else {
        const int total = rows * D;
        for (int i = threadIdx.x; i < total; i += SNT) {
            const int r = i / D, c = i - r * D;
            dst[r * SD + c] = src[i];
        }
    }
}

__device__ __forceinline__ void unpack16(const uint4& raw, float (&x)[4]) {
    x[0] = __uint_as_float(raw.x); x[1] = __uint_as_float(raw.y);
    x[2] = __uint_as_float(raw.z); x[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float (&x)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        x[2 * j] = f.x;
        x[2 * j + 1] = f.y;
    }
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// One quarter of a row's dot product: FMAs over [c0, c1) in index order,
// from acc = 0; l2_dist adds the quarters ((p0 + p1) + p2) + p3.
template <typename T, bool VEC>
__device__ __forceinline__ float part_dot(const T* xr, const float* qs, int c0, int c1) {
    float acc = 0.f;
    if (VEC) {
        constexpr int V = 16 / (int)sizeof(T);
#pragma unroll 2
        for (int c = c0; c < c1; c += V) {
            float x[V], qv[V];
            unpack16(*reinterpret_cast<const uint4*>(xr + c), x);
#pragma unroll
            for (int e = 0; e < V; e += 4) {
                const float4 f = *reinterpret_cast<const float4*>(qs + c + e);
                qv[e] = f.x; qv[e + 1] = f.y; qv[e + 2] = f.z; qv[e + 3] = f.w;
            }
#pragma unroll
            for (int e = 0; e < V; ++e) acc = fmaf(qv[e], x[e], acc);
        }
    } else {
        for (int c = c0; c < c1; ++c) acc = fmaf(qs[c], to_f(xr[c]), acc);
    }
    return acc;
}

// A row's int8 dot product with the query over words [w0, w1) (four int8
// each): __dp4a, 16 bytes at a time when VEC. Integer sums: exact in any
// order.
template <bool VEC>
__device__ __forceinline__ int part_dot_i8(const int* xr, const int* qs, int w0, int w1) {
    int acc = 0;
    if (VEC) {
#pragma unroll 2
        for (int w = w0; w < w1; w += 4) {
            const int4 x = *reinterpret_cast<const int4*>(xr + w);
            const int4 qv = *reinterpret_cast<const int4*>(qs + w);
            acc = __dp4a(x.x, qv.x, acc);
            acc = __dp4a(x.y, qv.y, acc);
            acc = __dp4a(x.z, qv.z, acc);
            acc = __dp4a(x.w, qv.w, acc);
        }
    } else {
        for (int w = w0; w < w1; ++w) acc = __dp4a(xr[w], qs[w], acc);
    }
    return acc;
}

// Shared memory of the select kernel at (D, K): two row tiles, the query,
// the partial sums, the candidates and (when they fit) the two lists.
struct SelectPlan {
    size_t smem;
    bool lists_in_smem;
};

template <typename T>
SelectPlan select_plan(int D, int K) {
    const size_t fixed = 2 * (size_t)SRT * tile_stride<T>(D) * sizeof(T) +
                         sizeof(float) * ((size_t)((D + 3) / 4 * 4) + PARTS * SRT + 4 * SRT + 4);
    const size_t lists = 2 * (size_t)K * (sizeof(float) + sizeof(int));
    const bool in = K <= SMEM_K_MAX && fixed + lists <= SMEM_LIMIT;
    return {fixed + (in ? lists : 0), in};
}

// grid (ceil(B / qpb), G). Block (qg, g) takes queries qg * qpb + j in
// turn and, for each, the probe ranks [g * per, (g + 1) * per) of it;
// it leaves the query's K best of those in part (B, G, K) as (dist, id'),
// or, when G == 1, the final (dist, id) in out. Lists past SMEM_K_MAX
// live in part and work (B, G, K) instead of shared memory.
template <typename T, bool VEC>
__global__ void __launch_bounds__(SNT)
ivf_select_kernel(const int* __restrict__ probes, const float* __restrict__ q,
                  const float* __restrict__ q_sq, const T* __restrict__ lists,
                  const float* __restrict__ sqn, const int* __restrict__ ids,
                  const int* __restrict__ hwm, int B, int nprobe, int pad, int D, int K, int qpb,
                  int G, int per, int smem_lists, float* part_d, int* part_t, float* work_d,
                  int* work_t, float* out_d, int* out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int SD = tile_stride<T>(D);
    T* xb0 = reinterpret_cast<T*>(smem);
    T* xb1 = xb0 + SRT * SD;
    float* qs = reinterpret_cast<float*>(xb1 + SRT * SD);   // [D], 16-byte aligned
    float* part = qs + (D + 3) / 4 * 4;                      // [PARTS][SRT]
    float* cd = part + PARTS * SRT;                          // admitted candidates
    int* ct = reinterpret_cast<int*>(cd + SRT);
    float* sd = reinterpret_cast<float*>(ct + SRT);          // ... sorted
    int* st = reinterpret_cast<int*>(sd + SRT);
    int* s_cnt = st + SRT;                                   // [4]
    float* l0d = reinterpret_cast<float*>(s_cnt + 4);        // [K] x 4 when smem_lists
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = blockIdx.y;
    const int p0 = g * per, p1 = min(nprobe, p0 + per);
    const int chunk = (D + PARTS - 1) / PARTS;
    const int c0 = warp * chunk, c1 = min(D, c0 + chunk);

    for (int j = 0; j < qpb; ++j) {
        const int b = blockIdx.x * qpb + j;
        if (b >= B) break;
        const int64_t slot = ((int64_t)b * G + g) * K;
        sel::Lists L;
        if (smem_lists) {
            L = {l0d, reinterpret_cast<int*>(l0d + K), l0d + 2 * K,
                 reinterpret_cast<int*>(l0d + 3 * K)};
        } else {
            L = {part_d + slot, part_t + slot, work_d + slot, work_t + slot};
        }
        sel::list_init<SNT>(L, K);
        for (int c = threadIdx.x; c < D; c += SNT) qs[c] = q_as_store(q[(int64_t)b * D + c], lists);
        const float qsq = q_sq[b];
        const int* prb = probes + (int64_t)b * nprobe;
        __syncthreads();

        sel::ListTile cur{p0 - 1, 0, 0, 0};
        sel::next_tile(cur, 0, p1, prb, hwm, pad);
        sel::ListTile ld = cur;
        for (int s = 0; s < 2; ++s) {          // two tiles in flight
            if (ld.p < p1) {
                issue_tile<T, VEC>(lists + (ld.base + ld.s0) * D, min(SRT, ld.n - ld.s0), D,
                                   s ? xb1 : xb0);
                sel::next_tile(ld, SRT, p1, prb, hwm, pad);
            }
            sel::cp_async_commit();
        }
        int buf = 0;
        while (cur.p < p1) {
            sel::cp_async_wait<1>();
            __syncthreads();
            T* xb = buf ? xb1 : xb0;
            const int rows = min(SRT, cur.n - cur.s0);
            part[warp * SRT + lane] =
                lane < rows && !SEL_NO_SCORE ? part_dot<T, VEC>(xb + lane * SD, qs, c0, c1) : 0.f;
            __syncthreads();                   // the tile is read: refill it
            if (ld.p < p1) {
                issue_tile<T, VEC>(lists + (ld.base + ld.s0) * D, min(SRT, ld.n - ld.s0), D, xb);
                sel::next_tile(ld, SRT, p1, prb, hwm, pad);
            }
            sel::cp_async_commit();
            bool admit = false;
            float d = sel::inf_f();
            int t = sel::INT_MAXV;
            if (threadIdx.x < rows) {
                float ip = part[lane];
#pragma unroll
                for (int k = 1; k < PARTS; ++k) ip = __fadd_rn(ip, part[k * SRT + lane]);
                const int64_t row = cur.base + cur.s0 + lane;
                const int id = ids[row];
                if (id >= 0) {
                    d = l2_dist(qsq, sqn[row], ip);
                    t = id;
                }
                admit = sel::lex_less(d, t, L.d[K - 1], L.t[K - 1]);
            }
            if (SEL_NO_SELECT) {
                if (admit) cd[lane] = d;
            } else {
                const int c = sel::compact<SNT>(admit, d, t, cd, ct, s_cnt);
                if (c > 0) sel::merge_tile<SNT>(L, K, cd, ct, c, sd, st);
            }
            sel::next_tile(cur, SRT, p1, prb, hwm, pad);
            buf ^= 1;
        }
        sel::cp_async_wait<0>();
        for (int i = threadIdx.x; i < K; i += SNT) {
            const float d = L.d[i];
            const int t = L.t[i];
            if (G == 1) {
                out_d[(int64_t)b * K + i] = d;
                out_i[(int64_t)b * K + i] = t == sel::INT_MAXV ? -1 : t;
            } else {
                part_d[slot + i] = d;
                part_t[slot + i] = t;
            }
        }
        __syncthreads();
    }
}

// One block per query: the exact merge of its G partial lists.
__global__ void __launch_bounds__(sel::MERGE_NT)
ivf_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_t, int G, int K,
                 float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int64_t b = blockIdx.x;
    float* od = out_d + b * K;
    int* oi = out_i + b * K;
    sel::merge_groups(part_d + b * G * K, part_t + b * G * K, G, K, smem,
                      [=](int i, float d, int t) {
                          od[i] = d;
                          oi[i] = t == sel::INT_MAXV ? -1 : t;
                      });
}

// -- the dense kernels ------------------------------------------------------------------------

// Shared memory of a dense kernel whose rows are W elements of T (f32 or
// bf16 values, or the 4-byte words of int8 codes): two row tiles, the
// query (W elements of 4 bytes, 16-byte aligned), the partial sums.
template <typename T>
size_t dense_smem(int W) {
    return 2 * (size_t)SRT * tile_stride<T>(W) * sizeof(T) +
           4 * ((size_t)((W + 3) / 4 * 4) + PARTS * SRT);
}

// The slots of this block's lists from each list's mark to pad, as (+inf,
// -1) without a read: block split s of S writes the 128-slot runs s, s + S,
// ... of each tail. Called after the tile loop: in front of it, its loop
// keeps a register live across the tiles (the ADC dense kernel spilled).
__device__ __forceinline__ void dense_tail(const int* prb, const int* hwm, int p0, int p1,
                                           int pad, float* od, int* oi) {
    if (hwm == nullptr) return;
    for (int p = p0; p < p1; ++p) {
        const int n = min(max(hwm[prb[p]], 0), pad);
        for (int s = n + blockIdx.z * SNT + threadIdx.x; s < pad; s += gridDim.z * SNT) {
            od[(int64_t)p * pad + s] = sel::inf_f();
            oi[(int64_t)p * pad + s] = -1;
        }
    }
}

// grid (B, G, S). Block (b, g, s) scores probe ranks [g * per, (g + 1) *
// per) of query b: of each list, the row tiles s, s + S, ... below its
// mark (pad without marks), through the select kernel's pipeline, each
// slot's (dist, raw id) at column p * pad + slot of out (B, nprobe * pad);
// then its share of each list's tail (dense_tail).
template <typename T, bool VEC>
__global__ void __launch_bounds__(SNT, DENSE_MIN_BLOCKS)
ivf_dense_kernel(const int* __restrict__ probes, const float* __restrict__ q,
                 const float* __restrict__ q_sq, const T* __restrict__ lists,
                 const float* __restrict__ sqn, const int* __restrict__ ids,
                 const int* __restrict__ hwm, int nprobe, int pad, int D, int per,
                 float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int SD = tile_stride<T>(D);
    T* xb0 = reinterpret_cast<T*>(smem);
    T* xb1 = xb0 + SRT * SD;
    float* qs = reinterpret_cast<float*>(xb1 + SRT * SD);   // [D], 16-byte aligned
    float* part = qs + (D + 3) / 4 * 4;                      // [PARTS][SRT]
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int b = blockIdx.x, g = blockIdx.y;
    const int p0 = g * per, p1 = min(nprobe, p0 + per);
    const int first = blockIdx.z * SRT, step = gridDim.z * SRT;
    const int chunk = (D + PARTS - 1) / PARTS;
    const int c0 = warp * chunk, c1 = min(D, c0 + chunk);
    const int* prb = probes + (int64_t)b * nprobe;
    float* od = out_d + (int64_t)b * nprobe * pad;
    int* oi = out_i + (int64_t)b * nprobe * pad;

    for (int c = threadIdx.x; c < D; c += SNT) qs[c] = q_as_store(q[(int64_t)b * D + c], lists);
    const float qsq = q_sq[b];
    sel::ListTile cur{p0 - 1, 0, 0, 0};
    sel::next_tile(cur, 0, p1, prb, hwm, pad, first);
    sel::ListTile ld = cur;
    for (int s = 0; s < 2; ++s) {              // two tiles in flight
        if (ld.p < p1) {
            issue_tile<T, VEC>(lists + (ld.base + ld.s0) * D, min(SRT, ld.n - ld.s0), D,
                               s ? xb1 : xb0);
            sel::next_tile(ld, step, p1, prb, hwm, pad, first);
        }
        sel::cp_async_commit();
    }
    int buf = 0;
    while (cur.p < p1) {
        sel::cp_async_wait<1>();
        __syncthreads();
        T* xb = buf ? xb1 : xb0;
        const int rows = min(SRT, cur.n - cur.s0);
        part[warp * SRT + lane] =
            lane < rows && !SEL_NO_SCORE ? part_dot<T, VEC>(xb + lane * SD, qs, c0, c1) : 0.f;
        __syncthreads();                       // the tile is read: refill it
        if (ld.p < p1) {
            issue_tile<T, VEC>(lists + (ld.base + ld.s0) * D, min(SRT, ld.n - ld.s0), D, xb);
            sel::next_tile(ld, step, p1, prb, hwm, pad, first);
        }
        sel::cp_async_commit();
        if (threadIdx.x < rows) {
            float ip = part[lane];
#pragma unroll
            for (int k = 1; k < PARTS; ++k) ip = __fadd_rn(ip, part[k * SRT + lane]);
            const int64_t row = cur.base + cur.s0 + lane;
            const int64_t col = (int64_t)cur.p * pad + cur.s0 + lane;
            const int id = ids[row];
            od[col] = id >= 0 ? l2_dist(qsq, sqn[row], ip) : sel::inf_f();
            oi[col] = id;
        }
        sel::next_tile(cur, step, p1, prb, hwm, pad, first);
        buf ^= 1;
    }
    dense_tail(prb, hwm, p0, p1, pad, od, oi);
    sel::cp_async_wait<0>();
}

// As ivf_dense_kernel for int8 lists (SQ8 codes, rows of DW = D / 4 words)
// against int8 queries: key = float(ip) * rs[b] + dec_sqn, each rounded on
// its own (the plain version's bits). Warp p sums its share of the words.
template <bool VEC>
__global__ void __launch_bounds__(SNT, DENSE_MIN_BLOCKS)
ivf_dense_int8_kernel(const int* __restrict__ probes, const int8_t* __restrict__ q8,
                      const float* __restrict__ rs, const int* __restrict__ codes,
                      const float* __restrict__ dec_sqn, const int* __restrict__ ids,
                      const int* __restrict__ hwm, int nprobe, int pad, int DW, int per,
                      float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int SW = tile_stride<int>(DW);
    int* xb0 = reinterpret_cast<int*>(smem);
    int* xb1 = xb0 + SRT * SW;
    int* qs = xb1 + SRT * SW;                                // [DW], 16-byte aligned
    int* part = qs + (DW + 3) / 4 * 4;                       // [PARTS][SRT]
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int b = blockIdx.x, g = blockIdx.y;
    const int p0 = g * per, p1 = min(nprobe, p0 + per);
    const int first = blockIdx.z * SRT, step = gridDim.z * SRT;
    const int chunk = VEC ? (DW / 4 + PARTS - 1) / PARTS * 4 : (DW + PARTS - 1) / PARTS;
    const int w0 = min(DW, warp * chunk), w1 = min(DW, w0 + chunk);
    const int* prb = probes + (int64_t)b * nprobe;
    float* od = out_d + (int64_t)b * nprobe * pad;
    int* oi = out_i + (int64_t)b * nprobe * pad;

    const int* qw = reinterpret_cast<const int*>(q8 + (int64_t)b * DW * 4);
    for (int w = threadIdx.x; w < DW; w += SNT) qs[w] = qw[w];
    const float scale = rs[b];
    sel::ListTile cur{p0 - 1, 0, 0, 0};
    sel::next_tile(cur, 0, p1, prb, hwm, pad, first);
    sel::ListTile ld = cur;
    for (int s = 0; s < 2; ++s) {              // two tiles in flight
        if (ld.p < p1) {
            issue_tile<int, VEC>(codes + (ld.base + ld.s0) * DW, min(SRT, ld.n - ld.s0), DW,
                                 s ? xb1 : xb0);
            sel::next_tile(ld, step, p1, prb, hwm, pad, first);
        }
        sel::cp_async_commit();
    }
    int buf = 0;
    while (cur.p < p1) {
        sel::cp_async_wait<1>();
        __syncthreads();
        int* xb = buf ? xb1 : xb0;
        const int rows = min(SRT, cur.n - cur.s0);
        part[warp * SRT + lane] =
            lane < rows && !SEL_NO_SCORE ? part_dot_i8<VEC>(xb + lane * SW, qs, w0, w1) : 0;
        __syncthreads();                       // the tile is read: refill it
        if (ld.p < p1) {
            issue_tile<int, VEC>(codes + (ld.base + ld.s0) * DW, min(SRT, ld.n - ld.s0), DW, xb);
            sel::next_tile(ld, step, p1, prb, hwm, pad, first);
        }
        sel::cp_async_commit();
        if (threadIdx.x < rows) {
            int ip = part[lane];
#pragma unroll
            for (int k = 1; k < PARTS; ++k) ip += part[k * SRT + lane];
            const int64_t row = cur.base + cur.s0 + lane;
            const int64_t col = (int64_t)cur.p * pad + cur.s0 + lane;
            const int id = ids[row];
            od[col] = id >= 0 ? __fadd_rn(__fmul_rn((float)ip, scale), dec_sqn[row]) : sel::inf_f();
            oi[col] = id;
        }
        sel::next_tile(cur, step, p1, prb, hwm, pad, first);
        buf ^= 1;
    }
    dense_tail(prb, hwm, p0, p1, pad, od, oi);
    sel::cp_async_wait<0>();
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
    if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The grid of a dense launch: B queries, G probe groups, S row splits.
bool valid_dense_grid(int B, int nprobe, int pad, int G, int S) {
    return B > 0 && pad > 0 && sel::valid_groups(nprobe, G) && S >= 1 && S <= 65535;
}

// Blocks per SM of a dense kernel at its shared memory, into out[0].
template <typename Kern>
cudaError_t dense_occupancy(Kern kernel, size_t smem, int* out) {
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, SNT, smem);
}

template <typename T, bool VEC>
cudaError_t launch_dense(const void* probes, const void* q, const void* q_sq, const void* lists,
                         const void* sqn, const void* ids, const void* hwm, int B, int nprobe,
                         int pad, int D, int G, int S, void* out_d, void* out_i,
                         cudaStream_t st) {
    const size_t smem = dense_smem<T>(D);
    cudaError_t err = set_smem(ivf_dense_kernel<T, VEC>, smem);
    if (err != cudaSuccess) return err;
    ivf_dense_kernel<T, VEC><<<dim3(B, G, S), SNT, smem, st>>>(
        static_cast<const int*>(probes), static_cast<const float*>(q),
        static_cast<const float*>(q_sq), static_cast<const T*>(lists),
        static_cast<const float*>(sqn), static_cast<const int*>(ids),
        static_cast<const int*>(hwm), nprobe, pad, D, (nprobe + G - 1) / G,
        static_cast<float*>(out_d), static_cast<int*>(out_i));
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dense(bool vec, const void* probes, const void* q, const void* q_sq,
                           const void* lists, const void* sqn, const void* ids, const void* hwm,
                           int B, int nprobe, int pad, int D, int G, int S, void* out_d,
                           void* out_i, cudaStream_t st) {
    if (vec)
        return launch_dense<T, true>(probes, q, q_sq, lists, sqn, ids, hwm, B, nprobe, pad, D, G,
                                     S, out_d, out_i, st);
    return launch_dense<T, false>(probes, q, q_sq, lists, sqn, ids, hwm, B, nprobe, pad, D, G, S,
                                  out_d, out_i, st);
}

template <bool VEC>
cudaError_t launch_dense_int8(const void* probes, const void* q8, const void* rs,
                              const void* codes, const void* dec_sqn, const void* ids,
                              const void* hwm, int B, int nprobe, int pad, int DW, int G, int S,
                              void* out_d, void* out_i, cudaStream_t st) {
    const size_t smem = dense_smem<int>(DW);
    cudaError_t err = set_smem(ivf_dense_int8_kernel<VEC>, smem);
    if (err != cudaSuccess) return err;
    ivf_dense_int8_kernel<VEC><<<dim3(B, G, S), SNT, smem, st>>>(
        static_cast<const int*>(probes), static_cast<const int8_t*>(q8),
        static_cast<const float*>(rs), static_cast<const int*>(codes),
        static_cast<const float*>(dec_sqn), static_cast<const int*>(ids),
        static_cast<const int*>(hwm), nprobe, pad, DW, (nprobe + G - 1) / G,
        static_cast<float*>(out_d), static_cast<int*>(out_i));
    return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_select(const void* probes, const void* q, const void* q_sq, const void* lists,
                          const void* sqn, const void* ids, const void* hwm, int B, int nprobe,
                          int pad, int D, int K, int qpb, int G, void* part_d, void* part_t,
                          void* work_d, void* work_t, void* out_d, void* out_i, cudaStream_t st) {
    const SelectPlan plan = select_plan<T>(D, K);
    if (!plan.lists_in_smem && (work_d == nullptr || work_t == nullptr))
        return cudaErrorInvalidValue;
    if (G > 1 && (part_d == nullptr || part_t == nullptr)) return cudaErrorInvalidValue;
    cudaError_t err = set_smem(ivf_select_kernel<T, VEC>, plan.smem);
    if (err != cudaSuccess) return err;
    const size_t msmem = sel::merge_smem_bytes(G, K);
    if (G > 1 && (err = set_smem(ivf_merge_kernel, msmem)) != cudaSuccess) return err;
    // With one group the kernel's lists and results live in out.
    float* pd = static_cast<float*>(G > 1 ? part_d : out_d);
    int* pt = static_cast<int*>(G > 1 ? part_t : out_i);
    const dim3 grid((B + qpb - 1) / qpb, G);
    ivf_select_kernel<T, VEC><<<grid, SNT, plan.smem, st>>>(
        static_cast<const int*>(probes), static_cast<const float*>(q),
        static_cast<const float*>(q_sq), static_cast<const T*>(lists),
        static_cast<const float*>(sqn), static_cast<const int*>(ids),
        static_cast<const int*>(hwm), B, nprobe, pad, D, K, qpb, G, (nprobe + G - 1) / G,
        plan.lists_in_smem ? 1 : 0, pd, pt, static_cast<float*>(work_d),
        static_cast<int*>(work_t), static_cast<float*>(out_d), static_cast<int*>(out_i));
    if ((err = cudaGetLastError()) != cudaSuccess || G == 1) return err;
    ivf_merge_kernel<<<B, sel::MERGE_NT, msmem, st>>>(pd, pt, G, K, static_cast<float*>(out_d),
                                                        static_cast<int*>(out_i));
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_select(const void* lists, int D, bool vec, const void* probes, const void* q,
                            const void* q_sq, const void* sqn, const void* ids, const void* hwm,
                            int B, int nprobe, int pad, int K, int qpb, int G, void* part_d,
                            void* part_t, void* work_d, void* work_t, void* out_d, void* out_i,
                            cudaStream_t st) {
    if (vec)
        return launch_select<T, true>(probes, q, q_sq, lists, sqn, ids, hwm, B, nprobe, pad, D, K,
                                      qpb, G, part_d, part_t, work_d, work_t, out_d, out_i, st);
    return launch_select<T, false>(probes, q, q_sq, lists, sqn, ids, hwm, B, nprobe, pad, D, K,
                                   qpb, G, part_d, part_t, work_d, work_t, out_d, out_i, st);
}

template <typename T>
cudaError_t select_occupancy(int D, int K, int* out) {
    const SelectPlan plan = select_plan<T>(D, K);
    cudaError_t err;
    if (vec_rows<T>(D)) {
        if ((err = set_smem(ivf_select_kernel<T, true>, plan.smem)) != cudaSuccess) return err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], ivf_select_kernel<T, true>,
                                                            SNT, plan.smem);
    } else {
        if ((err = set_smem(ivf_select_kernel<T, false>, plan.smem)) != cudaSuccess) return err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], ivf_select_kernel<T, false>,
                                                            SNT, plan.smem);
    }
    out[1] = plan.lists_in_smem ? 1 : 0;
    out[2] = sel::max_merge_groups(K, SMEM_LIMIT);
    return err;
}

}  // namespace

extern "C" {

int ivf_scan_abi_version() { return 3; }

// The select kernel's residency at (dtype, D, K): out[0] = blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] = 1 when its
// lists live in shared memory (else the launch needs work scratch),
// out[2] = the most probe groups its merge holds. Returns the CUDA error
// code.
int ivf_select_occupancy(int dtype, int D, int K, int* out) {
    if (D <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return (int)select_occupancy<float>(D, K, out);
    if (dtype == 1) return (int)select_occupancy<__nv_bfloat16>(D, K, out);
    return (int)cudaErrorInvalidValue;
}

// dtype: 0 = f32 lists, 1 = bf16 lists. probes (B, nprobe) int32; q (B, D)
// f32 (unstaged); q_sq (B,) f32; lists (nlist, pad, D); sqn/ids (nlist,
// pad) f32/int32; hwm (nlist,) int32 or null (= pad); G probe groups
// (G = ceil(nprobe / ceil(nprobe / G))); part_d/part_t (B, G, K) scratch
// when G > 1; work_d/work_t (B, G, K) scratch when the lists do not fit
// in shared memory (ivf_select_occupancy); out_d/out_i (B, K). Launches
// the select kernel, then (G > 1) the merge. Returns the CUDA error code
// (0 on success).
int ivf_scan_select(int dtype, const void* probes, const void* q, const void* q_sq,
                    const void* lists, const void* sqn, const void* ids, const void* hwm, int B,
                    int nprobe, int pad, int D, int K, int qpb, int G, void* part_d,
                    void* part_t, void* work_d, void* work_t, void* out_d, void* out_i,
                    void* stream) {
    if (B <= 0 || nprobe <= 0 || pad <= 0 || D <= 0 || K <= 0 || qpb <= 0 ||
        !sel::valid_groups(nprobe, G))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool aligned = (reinterpret_cast<uintptr_t>(lists) & 15) == 0;
    if (dtype == 0)
        return (int)dispatch_select<float>(lists, D, aligned && vec_rows<float>(D), probes, q,
                                           q_sq, sqn, ids, hwm, B, nprobe, pad, K, qpb, G,
                                           part_d, part_t, work_d, work_t, out_d, out_i, st);
    if (dtype == 1)
        return (int)dispatch_select<__nv_bfloat16>(
            lists, D, aligned && vec_rows<__nv_bfloat16>(D), probes, q, q_sq, sqn, ids, hwm, B,
            nprobe, pad, K, qpb, G, part_d, part_t, work_d, work_t, out_d, out_i, st);
    return (int)cudaErrorInvalidValue;
}

// A dense kernel's blocks per SM at (dtype, D) into out[0]: dtype 0 =
// f32 lists, 1 = bf16, 2 = int8 codes (D % 4 == 0). Returns the CUDA
// error code.
int ivf_dense_occupancy(int dtype, int D, int* out) {
    if (D <= 0) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return (int)(vec_rows<float>(D)
                         ? dense_occupancy(ivf_dense_kernel<float, true>, dense_smem<float>(D), out)
                         : dense_occupancy(ivf_dense_kernel<float, false>, dense_smem<float>(D),
                                           out));
    if (dtype == 1)
        return (int)(vec_rows<__nv_bfloat16>(D)
                         ? dense_occupancy(ivf_dense_kernel<__nv_bfloat16, true>,
                                           dense_smem<__nv_bfloat16>(D), out)
                         : dense_occupancy(ivf_dense_kernel<__nv_bfloat16, false>,
                                           dense_smem<__nv_bfloat16>(D), out));
    if (dtype == 2 && D % 4 == 0)
        return (int)(D % 16 == 0
                         ? dense_occupancy(ivf_dense_int8_kernel<true>, dense_smem<int>(D / 4), out)
                         : dense_occupancy(ivf_dense_int8_kernel<false>, dense_smem<int>(D / 4),
                                           out));
    return (int)cudaErrorInvalidValue;
}

// As ivf_scan_select, without selection, on a (B, G, S) grid (G probe
// groups, S row splits): out_d/out_i (B, nprobe * pad) hold every slot's
// distance and raw id, (+inf, -1) from each list's mark to pad.
int ivf_scan_dense(int dtype, const void* probes, const void* q, const void* q_sq,
                   const void* lists, const void* sqn, const void* ids, const void* hwm, int B,
                   int nprobe, int pad, int D, int G, int S, void* out_d, void* out_i,
                   void* stream) {
    if (D <= 0 || !valid_dense_grid(B, nprobe, pad, G, S)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool aligned = (reinterpret_cast<uintptr_t>(lists) & 15) == 0;
    if (dtype == 0)
        return (int)dispatch_dense<float>(aligned && vec_rows<float>(D), probes, q, q_sq, lists,
                                          sqn, ids, hwm, B, nprobe, pad, D, G, S, out_d, out_i,
                                          st);
    if (dtype == 1)
        return (int)dispatch_dense<__nv_bfloat16>(aligned && vec_rows<__nv_bfloat16>(D), probes,
                                                  q, q_sq, lists, sqn, ids, hwm, B, nprobe, pad,
                                                  D, G, S, out_d, out_i, st);
    return (int)cudaErrorInvalidValue;
}

// q8 (B, D) int8 with per-row scales rs (B,) f32; codes (nlist, pad, D)
// int8 (D % 4 == 0, 4-byte aligned; cp.async when D % 16 == 0 and 16-byte
// aligned); dec_sqn/ids (nlist, pad); hwm (nlist,) int32 or null (= pad);
// out_d/out_i (B, nprobe * pad) keys and raw ids, on a (B, G, S) grid.
int ivf_scan_dense_int8(const void* probes, const void* q8, const void* rs, const void* codes,
                        const void* dec_sqn, const void* ids, const void* hwm, int B, int nprobe,
                        int pad, int D, int G, int S, void* out_d, void* out_i, void* stream) {
    if (D <= 0 || D % 4 != 0 || !valid_dense_grid(B, nprobe, pad, G, S))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (D % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0)
        return (int)launch_dense_int8<true>(probes, q8, rs, codes, dec_sqn, ids, hwm, B, nprobe,
                                            pad, D / 4, G, S, out_d, out_i, st);
    return (int)launch_dense_int8<false>(probes, q8, rs, codes, dec_sqn, ids, hwm, B, nprobe, pad,
                                         D / 4, G, S, out_d, out_i, st);
}

}  // extern "C"
