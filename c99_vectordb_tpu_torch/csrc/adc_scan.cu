// adc_scan: the IVF-PQ ADC (asymmetric distance computation) scans for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// ops/adc_cuda.py.
//
// Two kernels replace the three Pallas kernels of
// c99_vectordb_tpu/ops/adc_pallas.py:
//
//   adc_select_kernel  <- _adc_kernel (:201)
//   adc_dense_kernel   <- _adc_dense_kernel (:349) and
//                         _adc_dense_kernel_multi (:368); queries per
//                         block is a parameter (1 or 8 from the wrapper)
//
// Contract (the Pallas kernels' results, not their Mosaic mechanics). For
// query b, probe rank p, list l = probes[b, p] and slot s of that list:
//
//   qdot = sum_{j = 0..m-1} QD[b, j, code_j(l, s)]   (f32, in subspace order)
//   dist = max((coarse[b, p] - 2 * qdot) + const[l, s], 0)
//
// and +inf where ids[l, s] < 0. Each operation rounds on its own
// (__fadd_rn / __fsub_rn / __fmul_rn), so nvcc cannot contract anything
// into an FMA and the distances are bit-equal to the plain version's
// (ops/adc.py), which adds the subspaces in the same order.
//
//   adc_dense:   write every (dist, raw id) at column p * pad + s of
//                (B, nprobe * pad); the selection is the caller's.
//   adc_select:  keep, per query, the first K of a STABLE sort by dist of
//                its candidates in (probe rank, slot) order: a candidate
//                enters only below the current K-th (an equal one does
//                not), goes after every equal entry, and +inf never enters;
//                unfilled slots come back as (inf, -1). This is the Pallas
//                kernel's insertion rule (adc_pallas.py:242-259): on exact
//                ties the earlier probe wins, not the lower id.
//
// Code layouts. codes is (nlist, rows, pad) uint8, subspace-major, so the
// threads of a warp, on neighbouring slots, read neighbouring bytes:
//   byte:    rows = m, one code per byte (any ksub <= 256: 8-bit codes and
//            the unpacked "flat" mode);
//   packed:  rows = m / 2 (ksub 16, even m), subspace 2j in the low nibble
//            of row j and 2j + 1 in the high nibble.
// One lookup routine (qdot) serves both. It replaces the Mosaic kernel's
// one-hot matmul "gathers" (_qdot_hilo, _qdot_nibble, _qdot_onehot): a
// Hopper thread reads QD[j, code] straight from shared memory.
//
// Design (simple and right first). The query's QD table (m * ksub f32: 96
// KB at m = 96, ksub = 256; dynamic shared memory above 48 KB) is staged
// in shared memory when it fits beside the block's other buffers, and read
// from global memory (through L1) otherwise. A select block owns one query
// and walks its probes in rank order (the TPU's sequential nprobe grid
// axis becomes a loop); each thread scores one slot of a 256-slot tile,
// then warp 0 inserts the tile's admitted candidates in slot order into
// the query's sorted list in shared memory. A dense block owns (a group
// of qpb queries, one probe rank) and scores every slot of each query's
// list in turn, restaging QD per query.
//
// Bound on the NVIDIA H100 80GB HBM3 (published at 700 W: 3.35 TB/s;
// 132 SMs, each 32 four-byte shared-memory lookups per clock, at the
// 1.98 GHz boost clock 8.4e12 lookups/s). Bytes: the codes of the live
// rows of the unique probed lists (m bytes each, m/2 packed), the
// constants and ids of all their slots, the QD tables, the outputs. Work:
// m table lookups per live row per (query, probe). At 1M x 384, nlist
// 4096, m = 96, B = 128, nprobe 16 the bytes take ~20 us and the lookups
// ~6 us, so the scan is bound by bytes; chip_smoke.py computes both for
// each run. This first version reads every slot of a list once per query
// that probes it (the TPU kernels did too), padding included, and a dense
// block restages a query's table for every probe; sharing lists across
// the queries that probe them is the next step (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                // threads per block; slots per tile
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB per block on sm_90

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// The ADC estimate of slot s of one list (its canvas rows `lc`; the slot's
// constant `cst` and id) against the table `tab` (m x ksub).
__device__ __forceinline__ float adc_dist(const float* tab, const uint8_t* __restrict__ lc,
                                          int pad, int m, int ksub, bool packed, float coarse,
                                          float cst, int id, int s) {
    float acc = 0.f;
    if (packed) {
        for (int r = 0; r < (m >> 1); ++r) {
            const int c = __ldg(lc + (int64_t)r * pad + s);
            acc = __fadd_rn(acc, tab[(2 * r) * 16 + (c & 15)]);
            acc = __fadd_rn(acc, tab[(2 * r + 1) * 16 + (c >> 4)]);
        }
    } else {
        for (int j = 0; j < m; ++j) {
            const int c = __ldg(lc + (int64_t)j * pad + s);
            acc = __fadd_rn(acc, tab[j * ksub + c]);
        }
    }
    const float d = __fadd_rn(__fsub_rn(coarse, __fmul_rn(2.0f, acc)), cst);
    return id >= 0 ? fmaxf(d, 0.0f) : inf_f();
}

// Stage query b's table into shared memory when it fits; returns the
// table to read (shared or global). Every thread must call it.
__device__ __forceinline__ const float* stage_table(const float* __restrict__ qd, int b, int mk,
                                                    bool in_smem, float* s_tab) {
    const float* g = qd + (int64_t)b * mk;
    if (!in_smem) return g;
    for (int i = threadIdx.x; i < mk; i += NT) s_tab[i] = __ldg(g + i);
    __syncthreads();
    return s_tab;
}

// Insert (d, id) into the warp's sorted list lk/lp of length K when d is
// below the last entry, after every entry <= d (the stable rule).
__device__ __forceinline__ void warp_insert(float* lk, int* lp, int K, float d, int id, int lane) {
    if (!(d < lk[K - 1])) return;                  // warp-uniform
    int cnt = 0;
    for (int j = lane; j < K; j += 32) cnt += (lk[j] <= d) ? 1 : 0;
    const int at = __reduce_add_sync(FULL, cnt);   // < K
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

__global__ void __launch_bounds__(NT)
adc_select_kernel(const int* __restrict__ probes, const float* __restrict__ probe_coarse,
                  const float* __restrict__ qd, const uint8_t* __restrict__ codes,
                  const float* __restrict__ item_const, const int* __restrict__ ids,
                  int nprobe, int pad, int m, int ksub, int packed, int K, int tab_in_smem,
                  float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* lk = reinterpret_cast<float*>(smem);          // [K]
    int* lp = reinterpret_cast<int*>(lk + K);            // [K]
    float* td = reinterpret_cast<float*>(lp + K);        // [NT]
    int* ti = reinterpret_cast<int*>(td + NT);           // [NT]
    float* s_tab = reinterpret_cast<float*>(ti + NT);    // [m * ksub] when staged
    const int b = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int rows = packed ? (m >> 1) : m;

    for (int i = threadIdx.x; i < K; i += NT) { lk[i] = inf_f(); lp[i] = -1; }
    const float* tab = stage_table(qd, b, m * ksub, tab_in_smem != 0, s_tab);
    __syncthreads();

    for (int p = 0; p < nprobe; ++p) {
        const int64_t l = probes[(int64_t)b * nprobe + p];
        const float coarse = probe_coarse[(int64_t)b * nprobe + p];
        const uint8_t* lc = codes + l * rows * pad;
        for (int s0 = 0; s0 < pad; s0 += NT) {
            const int s = s0 + threadIdx.x;
            float d = inf_f();
            int id = -1;
            if (s < pad) {
                id = ids[l * pad + s];
                d = adc_dist(tab, lc, pad, m, ksub, packed != 0, coarse, item_const[l * pad + s],
                             id, s);
            }
            td[threadIdx.x] = d;
            ti[threadIdx.x] = id;
            __syncthreads();
            if (warp == 0) {
                for (int h = 0; h < NT / 32; ++h) {
                    const float dh = td[h * 32 + lane];
                    const int ih = ti[h * 32 + lane];
                    unsigned mask = __ballot_sync(FULL, dh < lk[K - 1]);
                    while (mask) {
                        const int src = __ffs(mask) - 1;
                        mask &= mask - 1;
                        warp_insert(lk, lp, K, __shfl_sync(FULL, dh, src),
                                    __shfl_sync(FULL, ih, src), lane);
                    }
                }
            }
            __syncthreads();
        }
    }
    for (int i = threadIdx.x; i < K; i += NT) {
        out_d[(int64_t)b * K + i] = lk[i];
        out_i[(int64_t)b * K + i] = lp[i];
    }
}

__global__ void __launch_bounds__(NT)
adc_dense_kernel(const int* __restrict__ probes, const float* __restrict__ probe_coarse,
                 const float* __restrict__ qd, const uint8_t* __restrict__ codes,
                 const float* __restrict__ item_const, const int* __restrict__ ids,
                 int B, int nprobe, int pad, int m, int ksub, int packed, int qpb,
                 int tab_in_smem, float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* s_tab = reinterpret_cast<float*>(smem);
    const int g = blockIdx.x / nprobe, p = blockIdx.x % nprobe;
    const int rows = packed ? (m >> 1) : m;
    for (int j = 0; j < qpb; ++j) {
        const int b = g * qpb + j;
        if (b >= B) break;
        const float* tab = stage_table(qd, b, m * ksub, tab_in_smem != 0, s_tab);
        const int64_t bp = (int64_t)b * nprobe + p;
        const int64_t l = probes[bp];
        const float coarse = probe_coarse[bp];
        const uint8_t* lc = codes + l * rows * pad;
        for (int s = threadIdx.x; s < pad; s += NT) {
            const int id = ids[l * pad + s];
            out_d[bp * pad + s] = adc_dist(tab, lc, pad, m, ksub, packed != 0, coarse,
                                           item_const[l * pad + s], id, s);
            out_i[bp * pad + s] = id;
        }
        __syncthreads();   // the next query restages the table
    }
}

bool valid_args(int B, int nprobe, int pad, int m, int ksub, int packed) {
    if (B <= 0 || nprobe <= 0 || pad <= 0 || m <= 0 || ksub <= 0 || ksub > 256) return false;
    return !packed || (ksub == 16 && m % 2 == 0);
}

template <typename Kern>
cudaError_t set_smem(Kern kernel, size_t smem) {
    if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

int adc_scan_abi_version() { return 1; }

// probes (B, nprobe) int32; probe_coarse (B, nprobe) f32; qd (B, m, ksub)
// f32; codes (nlist, m or m/2, pad) uint8; item_const (nlist, pad) f32;
// ids (nlist, pad) int32; out_d/out_i (B, K). Returns the CUDA error code
// (0 on success).
int adc_scan_select(const void* probes, const void* probe_coarse, const void* qd,
                    const void* codes, const void* item_const, const void* ids, int B,
                    int nprobe, int pad, int m, int ksub, int packed, int K, void* out_d,
                    void* out_i, void* stream) {
    if (!valid_args(B, nprobe, pad, m, ksub, packed) || K <= 0) return (int)cudaErrorInvalidValue;
    const size_t base = (sizeof(float) + sizeof(int)) * ((size_t)K + NT);
    const size_t table = sizeof(float) * (size_t)m * ksub;
    const int in_smem = base + table <= SMEM_LIMIT ? 1 : 0;
    const size_t smem = base + (in_smem ? table : 0);
    cudaError_t err = set_smem(adc_select_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    adc_select_kernel<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(probes), static_cast<const float*>(probe_coarse),
        static_cast<const float*>(qd), static_cast<const uint8_t*>(codes),
        static_cast<const float*>(item_const), static_cast<const int*>(ids), nprobe, pad, m,
        ksub, packed, K, in_smem, static_cast<float*>(out_d), static_cast<int*>(out_i));
    return (int)cudaGetLastError();
}

// As adc_scan_select, without selection: out_d/out_i (B, nprobe * pad);
// qpb queries per block.
int adc_scan_dense(const void* probes, const void* probe_coarse, const void* qd,
                   const void* codes, const void* item_const, const void* ids, int B, int nprobe,
                   int pad, int m, int ksub, int packed, int qpb, void* out_d, void* out_i,
                   void* stream) {
    if (!valid_args(B, nprobe, pad, m, ksub, packed) || qpb <= 0) return (int)cudaErrorInvalidValue;
    const size_t table = sizeof(float) * (size_t)m * ksub;
    const int in_smem = table <= SMEM_LIMIT ? 1 : 0;
    const size_t smem = in_smem ? table : 0;
    cudaError_t err = set_smem(adc_dense_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (int64_t)((B + qpb - 1) / qpb) * nprobe;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    adc_dense_kernel<<<(unsigned)blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(probes), static_cast<const float*>(probe_coarse),
        static_cast<const float*>(qd), static_cast<const uint8_t*>(codes),
        static_cast<const float*>(item_const), static_cast<const int*>(ids), B, nprobe, pad, m,
        ksub, packed, qpb, in_smem, static_cast<float*>(out_d), static_cast<int*>(out_i));
    return (int)cudaGetLastError();
}

}  // extern "C"
