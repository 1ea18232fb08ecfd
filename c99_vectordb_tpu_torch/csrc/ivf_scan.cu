// ivf_scan: the IVF inverted-list scans for Hopper (sm_90a). Plain C
// interface, loaded with ctypes by ops/ivf_scan_cuda.py.
//
// Three kernels replace the five Pallas kernels of
// c99_vectordb_tpu/ops/ivf_scan_pallas.py. The TPU variants that differ
// only in how many queries a grid step carries become one kernel each,
// with queries per block as a parameter:
//
//   ivf_select_kernel      <- _ivf_scan_kernel (:113) and
//                             _ivf_scan_kernel_multi (:202)
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
//                Unfilled slots come back as (inf, -1).
//
// The distance of one (query, row) pair is computed by ONE device routine
// (tile_dists) for both f32/bf16 kernels, with the same per-row summation
// order, so the select and dense routes return bit-identical distances.
//
// Design (simple and right first). A block of 256 threads streams a list
// in tiles of RT = 64 rows through shared memory (one contiguous block of
// rows, 16-byte loads, converted to f32 for bf16); each row's dot product
// is split over 4 threads, each a contiguous quarter of D, and the four
// partial sums are added in a fixed order. The select kernel gives each
// block `qpb` queries in turn and walks each query's nprobe lists in a
// loop inside the block (the TPU's sequential probe axis; there is no
// scalar prefetch on Hopper, so the block reads its own probe ids); warp 0
// merges each tile into the query's sorted list, in shared memory for
// k <= 1024 and in the output rows otherwise. The dense kernels give each
// block one (query group, probe, row tile).
//
// Bound on the NVIDIA H100 80GB HBM3 (published at 700 W: 3.35 TB/s;
// tensor cores 495 TFLOP/s TF32, 989 TFLOP/s bf16, 1,979 TOP/s int8). The
// work is a (1, D) x (D, pad) product per (query, probe): 2 * pad * D
// operations for pad * D * itemsize bytes, so every variant is bound by
// the bytes of the lists it reads, counted on the unique probed lists (a
// list probed by several queries of a batch need only be read once). At
// 1M x 384, nlist 4096, pad 1152, B = 128, nprobe 16, the 1,591 unique
// lists hold 2.8 GB of f32 -> 0.85 ms. This first version keeps every
// product on the CUDA cores and reads each probed list once per query
// that probes it; chip_smoke.py times it against the bound (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block (8 warps)
constexpr int RT = 64;             // list rows per tile
constexpr int PARTS = NT / RT;     // threads per row's dot product
constexpr int SMEM_K_MAX = 1024;   // select lists in shared memory up to this k
constexpr unsigned FULL = 0xffffffffu;
constexpr int INT_MAXV = 0x7fffffff;
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
        float d = __fsub_rn(__fadd_rn(q_sq, sqn[row]), __fmul_rn(2.0f, ip));
        d = fmaxf(d, 0.0f);
        td[r] = id >= 0 ? d : inf_f();
        ti[r] = id;
    }
    __syncthreads();
}

__device__ __forceinline__ bool lex_less(float ad, int ai, float bd, int bi) {
    return ad < bd || (ad == bd && ai < bi);
}

// Insert (d, id) into the warp's lex-sorted list lk/lp of length K if it
// beats the last entry. Ids are unique, so the insertion point is the
// count of entries lex-below the candidate.
__device__ __forceinline__ void warp_insert(float* lk, int* lp, int K, float d, int id, int lane) {
    if (!lex_less(d, id, lk[K - 1], lp[K - 1])) return;   // warp-uniform
    int cnt = 0;
    for (int j = lane; j < K; j += 32) cnt += lex_less(lk[j], lp[j], d, id) ? 1 : 0;
    const int at = __reduce_add_sync(FULL, cnt);
    for (int base = ((K - 2) / 32) * 32; K >= 2 && base >= 0; base -= 32) {
        const int j = base + lane;
        const bool act = j >= at && j <= K - 2;
        float vk = 0.f;
        int vp = 0;
        if (act) { vk = lk[j]; vp = lp[j]; }
        __syncwarp();
        if (act) { lk[j + 1] = vk; lp[j + 1] = vp; }
        __syncwarp();
        if (base <= at) break;
    }
    if (lane == 0) { lk[at] = d; lp[at] = id; }
    __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(NT)
ivf_select_kernel(const int* __restrict__ probes, const float* __restrict__ q,
                  const float* __restrict__ q_sq, const T* __restrict__ lists,
                  const float* __restrict__ sqn, const int* __restrict__ ids,
                  int B, int nprobe, int pad, int D, int K, int qpb,
                  float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* xs = reinterpret_cast<float*>(smem);        // [RT][D + 1]
    float* qs = xs + RT * (D + 1);                      // [D]
    float* part = qs + D;                               // [PARTS][RT]
    float* td = part + PARTS * RT;                      // [RT]
    int* ti = reinterpret_cast<int*>(td + RT);          // [RT]
    float* sk = reinterpret_cast<float*>(ti + RT);      // [K] when K <= SMEM_K_MAX
    int* sp = reinterpret_cast<int*>(sk + K);
    const bool smem_list = K <= SMEM_K_MAX;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    for (int j = 0; j < qpb; ++j) {
        const int b = blockIdx.x * qpb + j;
        if (b >= B) break;
        float* lk = smem_list ? sk : out_d + (int64_t)b * K;
        int* lp = smem_list ? sp : out_i + (int64_t)b * K;
        for (int i = threadIdx.x; i < K; i += NT) { lk[i] = inf_f(); lp[i] = INT_MAXV; }
        for (int c = threadIdx.x; c < D; c += NT) qs[c] = q_as_store(q[(int64_t)b * D + c], lists);
        const float qsq = q_sq[b];
        __syncthreads();
        for (int p = 0; p < nprobe; ++p) {
            const int64_t base = (int64_t)probes[(int64_t)b * nprobe + p] * pad;
            for (int s0 = 0; s0 < pad; s0 += RT) {
                const int rows = min(RT, pad - s0);
                tile_dists(lists, base + s0, rows, D, qs, qsq, sqn, ids, xs, part, td, ti);
                if (warp == 0) {
#pragma unroll
                    for (int h = 0; h < RT / 32; ++h) {
                        const int r = lane + 32 * h;
                        const float d = r < rows ? td[r] : inf_f();
                        const int id = (r < rows && ti[r] >= 0) ? ti[r] : INT_MAXV;
                        unsigned m = __ballot_sync(FULL, lex_less(d, id, lk[K - 1], lp[K - 1]));
                        while (m) {
                            const int src = __ffs(m) - 1;
                            m &= m - 1;
                            warp_insert(lk, lp, K, __shfl_sync(FULL, d, src),
                                        __shfl_sync(FULL, id, src), lane);
                        }
                    }
                }
                __syncthreads();
            }
        }
        for (int i = threadIdx.x; i < K; i += NT) {
            const int id = lp[i];
            out_d[(int64_t)b * K + i] = lk[i];
            out_i[(int64_t)b * K + i] = id == INT_MAXV ? -1 : id;
        }
        __syncthreads();
    }
}

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
cudaError_t launch_select(const void* probes, const void* q, const void* q_sq, const void* lists,
                          const void* sqn, const void* ids, int B, int nprobe, int pad, int D,
                          int K, int qpb, void* out_d, void* out_i, cudaStream_t st) {
    size_t smem = f_smem(D);
    if (K <= SMEM_K_MAX) smem += (sizeof(float) + sizeof(int)) * (size_t)K;
    cudaError_t err = set_smem(ivf_select_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    ivf_select_kernel<T><<<(B + qpb - 1) / qpb, NT, smem, st>>>(
        static_cast<const int*>(probes), static_cast<const float*>(q),
        static_cast<const float*>(q_sq), static_cast<const T*>(lists),
        static_cast<const float*>(sqn), static_cast<const int*>(ids), B, nprobe, pad, D, K, qpb,
        static_cast<float*>(out_d), static_cast<int*>(out_i));
    return cudaGetLastError();
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

}  // namespace

extern "C" {

int ivf_scan_abi_version() { return 1; }

// dtype: 0 = f32 lists, 1 = bf16 lists. probes (B, nprobe) int32; q (B, D)
// f32 (unstaged); q_sq (B,) f32; lists (nlist, pad, D); sqn/ids (nlist,
// pad) f32/int32; out_d/out_i (B, K). Returns the CUDA error code (0 on
// success).
int ivf_scan_select(int dtype, const void* probes, const void* q, const void* q_sq,
                    const void* lists, const void* sqn, const void* ids, int B, int nprobe,
                    int pad, int D, int K, int qpb, void* out_d, void* out_i, void* stream) {
    if (B <= 0 || nprobe <= 0 || pad <= 0 || D <= 0 || K <= 0 || qpb <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)launch_select<float>(probes, q, q_sq, lists, sqn, ids, B, nprobe, pad, D, K,
                                         qpb, out_d, out_i, st);
    if (dtype == 1)
        return (int)launch_select<__nv_bfloat16>(probes, q, q_sq, lists, sqn, ids, B, nprobe, pad,
                                                 D, K, qpb, out_d, out_i, st);
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
