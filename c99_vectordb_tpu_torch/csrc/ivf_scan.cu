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
//   ivf_dense*:  write every (dist or key, raw id) densely as
//                (B, nprobe * pad); the selection is the caller's.
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
// The dense kernels give each block one (query group, probe, row tile):
// a block of 256 threads streams its 64-row tile through shared memory
// and scores each row by four threads (tile_dists).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "select_merge.cuh"

namespace {

constexpr int NT = 256;            // threads per block (8 warps)
constexpr int RT = 64;             // list rows per tile
constexpr int PARTS = NT / RT;     // threads per row's dot product
constexpr int SMEM_K_MAX = 1024;   // select lists in shared memory up to this k
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB per block on sm_90

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// The query as the store dtype scores it: f32 as is, bf16 rounded.
__device__ __forceinline__ float q_as_store(float v, const float*) { return v; }
__device__ __forceinline__ float q_as_store(float v, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// Stage `rows` consecutive list rows (one contiguous block starting at
// src) into xs[r * (D + 1) + c] as f32.
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int rows, int D,
                                          float* xs) {
    if ((D & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const int D4 = D >> 2;
        const int total = rows * D4;
        const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
        for (int i = threadIdx.x; i < total; i += NT) {
            const int r = i / D4, c = (i - r * D4) * 4;
            const float4 v = __ldg(s4 + i);
            float* dst = xs + r * (D + 1) + c;
            dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
        }
    } else {
        const int total = rows * D;
        for (int i = threadIdx.x; i < total; i += NT) {
            const int r = i / D, c = i - r * D;
            xs[r * (D + 1) + c] = __ldg(src + i);
        }
    }
}

__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src, int rows, int D,
                                          float* xs) {
    if ((D & 7) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const int D8 = D >> 3;
        const int total = rows * D8;
        const uint4* s8 = reinterpret_cast<const uint4*>(src);
#pragma unroll 4
        for (int i = threadIdx.x; i < total; i += NT) {
            const int r = i / D8, c = (i - r * D8) * 8;
            const uint4 v = __ldg(s8 + i);
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
            float* dst = xs + r * (D + 1) + c;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float2 f = __bfloat1622float2(h[j]);
                dst[2 * j] = f.x;
                dst[2 * j + 1] = f.y;
            }
        }
    } else {
        const int total = rows * D;
        for (int i = threadIdx.x; i < total; i += NT) {
            const int r = i / D, c = i - r * D;
            xs[r * (D + 1) + c] = __bfloat162float(src[i]);
        }
    }
}

// The distance of one row from its summed dot product ip: each operation
// rounded on its own, so nvcc contracts nothing and every kernel that
// calls it returns the same bits.
__device__ __forceinline__ float l2_dist(float q_sq, float sqn, float ip) {
    return fmaxf(__fsub_rn(__fadd_rn(q_sq, sqn), __fmul_rn(2.0f, ip)), 0.0f);
}

// The shared distance routine of the f32/bf16 kernels. Scores the `rows`
// list rows starting at flat row `row0` of (nlist * pad, D) `lists`
// against the staged query qs (D floats) and writes dist/raw id of row r
// to td[r], ti[r] for r < rows. Per row, thread part p (of PARTS) sums
// its contiguous quarter of D with FMAs in index order; the partial sums
// are added (((p0 + p1) + p2) + p3). Contains __syncthreads; every
// thread of the block must call it.
template <typename T>
__device__ void tile_dists(const T* __restrict__ lists, int64_t row0, int rows, int D,
                           const float* qs, float q_sq, const float* __restrict__ sqn,
                           const int* __restrict__ ids, float* xs, float* part,
                           float* td, int* ti) {
    load_tile(lists + row0 * D, rows, D, xs);
    __syncthreads();
    const int r = threadIdx.x % RT, p = threadIdx.x / RT;
    const int chunk = (D + PARTS - 1) / PARTS;
    const int c0 = p * chunk, c1 = min(D, c0 + chunk);
    float acc = 0.f;
    if (r < rows) {
        const float* xr = xs + r * (D + 1);
        for (int c = c0; c < c1; ++c) acc = fmaf(qs[c], xr[c], acc);
    }
    part[p * RT + r] = acc;
    __syncthreads();
    if (threadIdx.x < rows) {
        float ip = part[r];
#pragma unroll
        for (int j = 1; j < PARTS; ++j) ip = __fadd_rn(ip, part[j * RT + r]);
        const int64_t row = row0 + r;
        const int id = ids[row];
        td[r] = id >= 0 ? l2_dist(q_sq, sqn[row], ip) : inf_f();
        ti[r] = id;
    }
    __syncthreads();
}

// -- the select kernel and its merge ------------------------------------------------------

constexpr int SNT = 128;             // select: threads per block (4 warps)
constexpr int SRT = 32;              // select: list rows per tile, one per lane
static_assert(SNT / SRT == PARTS, "the select kernel splits each row as tile_dists does");

// Smem row stride (elements) of a select tile: D plus 16 bytes.
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
// from acc = 0 (tile_dists' order).
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

template <typename T>
__global__ void __launch_bounds__(NT)
ivf_dense_kernel(const int* __restrict__ probes, const float* __restrict__ q,
                 const float* __restrict__ q_sq, const T* __restrict__ lists,
                 const float* __restrict__ sqn, const int* __restrict__ ids,
                 int B, int nprobe, int pad, int D, int tiles,
                 float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* xs = reinterpret_cast<float*>(smem);
    float* qs = xs + RT * (D + 1);
    float* part = qs + D;
    float* td = part + PARTS * RT;
    int* ti = reinterpret_cast<int*>(td + RT);
    const int t = blockIdx.x % tiles;
    const int bp = blockIdx.x / tiles;               // b * nprobe + p
    const int b = bp / nprobe;
    const int s0 = t * RT, rows = min(RT, pad - s0);
    for (int c = threadIdx.x; c < D; c += NT) qs[c] = q_as_store(q[(int64_t)b * D + c], lists);
    __syncthreads();
    const int64_t base = (int64_t)probes[bp] * pad;
    tile_dists(lists, base + s0, rows, D, qs, q_sq[b], sqn, ids, xs, part, td, ti);
    if (threadIdx.x < rows) {
        const int64_t o = (int64_t)bp * pad + s0 + threadIdx.x;
        out_d[o] = td[threadIdx.x];
        out_i[o] = ti[threadIdx.x];
    }
}

// int8 lists (SQ8 codes) against int8 queries: exact int32 dots by
// __dp4a over packed 4-byte words (D % 4 == 0); the integer partial sums
// are exact, so their order does not matter.
__global__ void __launch_bounds__(NT)
ivf_dense_int8_kernel(const int* __restrict__ probes, const int8_t* __restrict__ q8,
                      const float* __restrict__ rs, const int8_t* __restrict__ codes,
                      const float* __restrict__ dec_sqn, const int* __restrict__ ids,
                      int B, int nprobe, int pad, int D, int tiles, int qpb,
                      float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int DW = D >> 2;
    int* xs = reinterpret_cast<int*>(smem);           // [RT][DW + 1]
    int* qs = xs + RT * (DW + 1);                     // [DW]
    int* part = qs + DW;                              // [PARTS][RT]
    const int t = blockIdx.x % tiles;
    const int gp = blockIdx.x / tiles;                // group * nprobe + p
    const int g = gp / nprobe, p = gp % nprobe;
    const int s0 = t * RT, rows = min(RT, pad - s0);
    const int r = threadIdx.x % RT, pt = threadIdx.x / RT;
    const int chunk = (DW + PARTS - 1) / PARTS;
    const int w0 = pt * chunk, w1 = min(DW, w0 + chunk);
    for (int j = 0; j < qpb; ++j) {
        const int b = g * qpb + j;
        if (b >= B) break;
        const int* qw = reinterpret_cast<const int*>(q8 + (int64_t)b * D);
        for (int w = threadIdx.x; w < DW; w += NT) qs[w] = qw[w];
        const int64_t row0 = (int64_t)probes[(int64_t)b * nprobe + p] * pad + s0;
        const int* src = reinterpret_cast<const int*>(codes + row0 * D);
        const int total = rows * DW;
#pragma unroll 4
        for (int i = threadIdx.x; i < total; i += NT) {
            const int rr = i / DW, w = i - rr * DW;
            xs[rr * (DW + 1) + w] = __ldg(src + i);
        }
        __syncthreads();
        int acc = 0;
        if (r < rows) {
            const int* xr = xs + r * (DW + 1);
            for (int w = w0; w < w1; ++w) acc = __dp4a(qs[w], xr[w], acc);
        }
        part[pt * RT + r] = acc;
        __syncthreads();
        if (threadIdx.x < rows) {
            int ip = 0;
#pragma unroll
            for (int k = 0; k < PARTS; ++k) ip += part[k * RT + r];
            const int64_t row = row0 + r;
            const int id = ids[row];
            const float key = __fadd_rn(__fmul_rn((float)ip, rs[b]), dec_sqn[row]);
            const int64_t o = ((int64_t)b * nprobe + p) * pad + s0 + r;
            out_d[o] = id >= 0 ? key : inf_f();
            out_i[o] = id;
        }
        __syncthreads();
    }
}

size_t f_smem(int D) {
    return sizeof(float) * ((size_t)RT * (D + 1) + D + PARTS * RT + RT) + sizeof(int) * RT;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
    if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t launch_dense(const void* probes, const void* q, const void* q_sq, const void* lists,
                         const void* sqn, const void* ids, int B, int nprobe, int pad, int D,
                         void* out_d, void* out_i, cudaStream_t st) {
    const size_t smem = f_smem(D);
    cudaError_t err = set_smem(ivf_dense_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    const int tiles = (pad + RT - 1) / RT;
    const int64_t blocks = (int64_t)tiles * nprobe * B;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    ivf_dense_kernel<T><<<(unsigned)blocks, NT, smem, st>>>(
        static_cast<const int*>(probes), static_cast<const float*>(q),
        static_cast<const float*>(q_sq), static_cast<const T*>(lists),
        static_cast<const float*>(sqn), static_cast<const int*>(ids), B, nprobe, pad, D, tiles,
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

int ivf_scan_abi_version() { return 2; }

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

// As ivf_scan_select, without selection: out_d/out_i (B, nprobe * pad)
// hold every slot's distance and raw id.
int ivf_scan_dense(int dtype, const void* probes, const void* q, const void* q_sq,
                   const void* lists, const void* sqn, const void* ids, int B, int nprobe,
                   int pad, int D, void* out_d, void* out_i, void* stream) {
    if (B <= 0 || nprobe <= 0 || pad <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)launch_dense<float>(probes, q, q_sq, lists, sqn, ids, B, nprobe, pad, D,
                                        out_d, out_i, st);
    if (dtype == 1)
        return (int)launch_dense<__nv_bfloat16>(probes, q, q_sq, lists, sqn, ids, B, nprobe, pad,
                                                D, out_d, out_i, st);
    return (int)cudaErrorInvalidValue;
}

// q8 (B, D) int8 with per-row scales rs (B,) f32; codes (nlist, pad, D)
// int8 (D % 4 == 0); dec_sqn/ids (nlist, pad); out_d/out_i (B, nprobe *
// pad) keys and raw ids; qpb queries per block.
int ivf_scan_dense_int8(const void* probes, const void* q8, const void* rs, const void* codes,
                        const void* dec_sqn, const void* ids, int B, int nprobe, int pad, int D,
                        int qpb, void* out_d, void* out_i, void* stream) {
    if (B <= 0 || nprobe <= 0 || pad <= 0 || D <= 0 || D % 4 != 0 || qpb <= 0)
        return (int)cudaErrorInvalidValue;
    const int DW = D / 4;
    const size_t smem = sizeof(int) * ((size_t)RT * (DW + 1) + DW + PARTS * RT);
    cudaError_t err = set_smem(ivf_dense_int8_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (pad + RT - 1) / RT;
    const int64_t blocks = (int64_t)tiles * nprobe * ((B + qpb - 1) / qpb);
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    ivf_dense_int8_kernel<<<(unsigned)blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(probes), static_cast<const int8_t*>(q8),
        static_cast<const float*>(rs), static_cast<const int8_t*>(codes),
        static_cast<const float*>(dec_sqn), static_cast<const int*>(ids), B, nprobe, pad, D,
        tiles, qpb, static_cast<float*>(out_d), static_cast<int*>(out_i));
    return (int)cudaGetLastError();
}

}  // extern "C"
