// adc_scan: the IVF-PQ ADC (asymmetric distance computation) scans for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// ops/adc_cuda.py.
//
// Two kernels (and the select kernel's merge) replace the three Pallas
// kernels of c99_vectordb_tpu/ops/adc_pallas.py:
//
//   adc_select_kernel  <- _adc_kernel (:201)
//   (+ adc_merge_kernel)
//   adc_dense_kernel   <- _adc_dense_kernel (:349) and
//                         _adc_dense_kernel_multi (:368); the JAX
//                         package's queries per grid step (qps_step, 1 or
//                         8) stays a keyword of the wrapper, which counts
//                         launches by it; the kernel's grid ignores it
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
//                (B, nprobe * pad); the selection is the caller's. With a
//                high-water mark hwm the slots past it are written as
//                (+inf, -1) without a read: they hold id -1, so this is
//                the plain output (below the mark a masked row keeps its
//                real id beside its +inf estimate).
//   adc_select:  keep, per query, the first K of a STABLE sort by dist of
//                its candidates in (probe rank, slot) order: a candidate
//                enters only below the current K-th (an equal one does
//                not), goes after every equal entry, and +inf never enters;
//                unfilled slots come back as (inf, -1). This is the Pallas
//                kernel's insertion rule (adc_pallas.py:242-259): on exact
//                ties the earlier probe wins, not the lower id. It is the
//                order of the keys (dist, p * pad + s), unique per query,
//                which is what the kernel selects on. An optional (nlist,)
//                high-water mark hwm stops each list's scan there (the
//                slots past it hold id -1 and never enter).
//
// Code layouts. codes is (nlist, rows, pad) uint8, subspace-major, so the
// threads of a warp, on neighbouring slots, read neighbouring bytes:
//   byte:    rows = m, one code per byte (any ksub <= 256: 8-bit codes and
//            the unpacked "flat" mode);
//   packed:  rows = m / 2 (ksub 16, even m), subspace 2j in the low nibble
//            of row j and 2j + 1 in the high nibble.
// It replaces the Mosaic kernel's one-hot matmul "gathers" (_qdot_hilo,
// _qdot_nibble, _qdot_onehot): a Hopper thread reads QD[j, code] straight
// from shared memory.
//
// Bound on the NVIDIA H100 80GB HBM3 (published at 700 W: 3.35 TB/s;
// 132 SMs, each 32 four-byte shared-memory lookups per clock, at the
// 1.98 GHz boost clock 8.4e12 lookups/s). Bytes: the codes of the live
// rows of the unique probed lists (m bytes each, m/2 packed), the
// constants and ids of their slots, the QD tables, the outputs. Work: m
// table lookups per live row per (query, probe). At 1M x 384, nlist 4096,
// m = 96, B = 128, nprobe 16 the bytes take ~20 us (select) or ~25 us
// (dense, whose (B, nprobe * pad) outputs add 19 MB) and the lookups ~6
// us, so the scans are bound by bytes; chip_smoke.py computes both for
// each run.
//
// Select design (what held the first version back, and the answer):
//   - One block per query walked all its probes: 128 blocks at B = 128.
//     Now the grid is (query, probe group of G): each block stages its
//     query's table (m * ksub f32, 96 KB at m = 96, ksub = 256) once,
//     scans a contiguous range of probe ranks and writes its sorted top-K
//     to a (B, G, K) scratch; adc_merge_kernel merges each query's G
//     lists exactly (select_merge.cuh). Contiguous rank groups keep the
//     keys (dist, p * pad + s) of the single pass, so the merge is the
//     stable rule. G comes from the occupancy query (ops/adc_cuda.py);
//     fewer, larger groups restage the table less often.
//   - Every list was walked to `pad` (4.8x its live rows at 1M). Now the
//     block stops at the list's high-water mark.
//   - Each thread read its slot's m code bytes from global memory one
//     byte at a time, in a loop the compiler could not unroll. Now each
//     64-slot tile's codes (rows x 64 bytes) stream into shared memory
//     through two buffers with 16-byte cp.async, and a thread reads its
//     column in steps of 8 subspaces (4 packed rows): the code bytes,
//     then the table entries, then the adds in subspace order.
//   - Warp 0 inserted each admitted candidate into the K-deep list in
//     turn while the other warps waited. Now a tile's candidates are
//     compacted, ranked and merged by every thread (merge_tile).
//   64 threads per block, one per slot of a tile: at m = 96 the table,
//   two code tiles and the K = 200 lists take 112 KB, so two blocks fit on
//   an SM. A table too large for shared memory is read from global memory
//   (through L1); unaligned code rows (pad % 16) load synchronously.
//
// Dense design. The first version gave each block (qpb queries, one probe
// rank), restaged the query's 96 KB table for every (query, probe), walked
// every list to pad and read each slot's m code bytes one at a time from
// global memory: 27-34x its bound. It now runs the select kernel's
// pipeline without the selection: the (query, probe group) grid with G
// from the occupancy query (ops/select_common.probe_groups), the table
// staged once per block, 64-slot code tiles through two cp.async buffers,
// each list stopped at its mark, and qdot_tile + adc_finish, so the dense
// kernel, the select kernel and the plain version add the subspaces in one
// order. Each thread writes its slot's (estimate, id) where the select
// kernel would admit it; after its scan a block writes the (+inf, -1) tail
// of each of its lists. At m = 96 the table and two code tiles take 108 KB:
// two blocks per SM (40 registers, no spill).

#include <cuda_runtime.h>
#include <stdint.h>

#include "select_merge.cuh"

namespace {

constexpr size_t SMEM_LIMIT = 232448;  // 227 KB per block on sm_90

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// The estimate from a slot's summed table entries acc: each operation
// rounded on its own, so every kernel that calls it returns the same bits.
__device__ __forceinline__ float adc_finish(float coarse, float acc, float cst, int id) {
    const float d = __fadd_rn(__fsub_rn(coarse, __fmul_rn(2.0f, acc)), cst);
    return id >= 0 ? fmaxf(d, 0.0f) : inf_f();
}

// -- the tile pipeline the select and dense kernels share ------------------------------------

constexpr int ANT = 64;                // threads per block = slots per tile
constexpr int SMEM_K_MAX = 1024;       // select lists in shared memory up to this k

// The sum of one slot's table entries in subspace order, from its column
// `col` of a shared-memory code tile (row stride ANT): the code bytes of
// a step first, then its table entries, then the adds in order.
__device__ __forceinline__ float qdot_tile(const float* tab, const uint8_t* col, int rows,
                                           int ksub, bool packed) {
    float acc = 0.f;
    int r = 0;
    if (packed) {
        for (; r + 4 <= rows; r += 4) {
            int c[4];
            float v[8];
#pragma unroll
            for (int u = 0; u < 4; ++u) c[u] = col[(r + u) * ANT];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                v[2 * u] = tab[(2 * (r + u)) * 16 + (c[u] & 15)];
                v[2 * u + 1] = tab[(2 * (r + u) + 1) * 16 + (c[u] >> 4)];
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) acc = __fadd_rn(acc, v[e]);
        }
        for (; r < rows; ++r) {
            const int c = col[r * ANT];
            acc = __fadd_rn(acc, tab[(2 * r) * 16 + (c & 15)]);
            acc = __fadd_rn(acc, tab[(2 * r + 1) * 16 + (c >> 4)]);
        }
    } else {
        for (; r + 8 <= rows; r += 8) {
            int c[8];
            float v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) c[u] = col[(r + u) * ANT];
#pragma unroll
            for (int u = 0; u < 8; ++u) v[u] = tab[(r + u) * ksub + c[u]];
#pragma unroll
            for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, v[u]);
        }
        for (; r < rows; ++r) acc = __fadd_rn(acc, tab[r * ksub + col[r * ANT]]);
    }
    return acc;
}

// Copy bytes [c0, c0 + n) of each of the rows of slots starting at s0
// (canvas rows at lc) into the tile dst (rows x ANT bytes), one at a time.
__device__ __forceinline__ void copy_codes(const uint8_t* __restrict__ lc, int rows, int pad,
                                           int s0, int c0, int n, uint8_t* dst) {
    const int total = rows * n;
    for (int i = threadIdx.x; i < total; i += ANT) {
        const int r = i / n, c = c0 + i - r * n;
        dst[r * ANT + c] = lc[(int64_t)r * pad + s0 + c];
    }
}

// Copy the codes of slots [s0, s0 + cnt) of one list into the tile dst:
// when pad is a multiple of 16, the whole 16-byte chunks with cp.async
// and the last cnt % 16 bytes of each row plainly, so no byte at or past
// s0 + cnt (the list's high-water mark on its last tile) is read; else
// every byte plainly.
__device__ __forceinline__ void issue_codes(const uint8_t* __restrict__ lc, int rows, int pad,
                                            int s0, int cnt, bool vec, uint8_t* dst) {
    if (!vec) {
        copy_codes(lc, rows, pad, s0, 0, cnt, dst);
        return;
    }
    const int cpr = cnt >> 4;
    for (int i = threadIdx.x; i < rows * cpr; i += ANT) {
        const int r = i / cpr, c = (i - r * cpr) * 16;
        sel::cp_async16(dst + r * ANT + c, lc + (int64_t)r * pad + s0 + c);
    }
    if (cnt & 15) copy_codes(lc, rows, pad, s0, cpr * 16, cnt & 15, dst);
}

// Query b's table (m * ksub f32 at qd) into s_tab when it fits in shared
// memory (tab_in_smem), with 16-byte cp.async when aligned (tab_vec: the
// caller commits it with its first code tile); returns the table to read.
__device__ __forceinline__ const float* stage_table(const float* __restrict__ qd, int64_t b,
                                                    int mk, int tab_in_smem, int tab_vec,
                                                    float* s_tab) {
    const float* tab = qd + b * mk;
    if (!tab_in_smem) return tab;
    if (tab_vec) {
        for (int i = threadIdx.x * 4; i < mk; i += ANT * 4) sel::cp_async16(s_tab + i, tab + i);
    } else {
        for (int i = threadIdx.x; i < mk; i += ANT) s_tab[i] = tab[i];
    }
    return s_tab;
}

// The table's bytes in shared memory, rounded up to 16 (the code tiles follow).
__host__ __device__ inline size_t table_bytes(int m, int ksub) {
    return ((size_t)m * ksub * sizeof(float) + 15) / 16 * 16;
}

// Shared memory of the dense kernel: the table (when it fits) and two code
// tiles.
struct DensePlan {
    size_t smem;
    bool tab_in_smem;
};

DensePlan dense_plan(int m, int ksub, bool packed) {
    const size_t tiles = 2 * (size_t)(packed ? m / 2 : m) * ANT;
    const bool tab = tiles + table_bytes(m, ksub) <= SMEM_LIMIT;
    return {tiles + (tab ? table_bytes(m, ksub) : 0), tab};
}

// grid (B, G). Block (b, g) scores probe ranks [g * per, (g + 1) * per) of
// query b: every slot below its list's high-water mark (pad without marks)
// through the tile pipeline, its (estimate, raw id) at column p * pad + s
// of out (B, nprobe * pad); the slots from the mark to pad get (+inf, -1)
// without a read.
__global__ void __launch_bounds__(ANT)
adc_dense_kernel(const int* __restrict__ probes, const float* __restrict__ probe_coarse,
                 const float* __restrict__ qd, const uint8_t* __restrict__ codes,
                 const float* __restrict__ item_const, const int* __restrict__ ids,
                 const int* __restrict__ hwm, int nprobe, int pad, int m, int ksub, int packed,
                 int per, int tab_in_smem, int tab_vec, int code_vec, float* __restrict__ out_d,
                 int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x, g = blockIdx.y;
    const int rows = packed ? (m >> 1) : m;
    float* s_tab = reinterpret_cast<float*>(smem);
    uint8_t* cb0 = smem + (tab_in_smem ? table_bytes(m, ksub) : 0);
    uint8_t* cb1 = cb0 + rows * ANT;
    const int p0 = g * per, p1 = min(nprobe, p0 + per);
    const int* prb = probes + (int64_t)b * nprobe;
    const float* pcb = probe_coarse + (int64_t)b * nprobe;
    float* od = out_d + (int64_t)b * nprobe * pad;
    int* oi = out_i + (int64_t)b * nprobe * pad;

    const float* tab = stage_table(qd, b, m * ksub, tab_in_smem, tab_vec, s_tab);
    sel::ListTile cur{p0 - 1, 0, 0, 0};
    sel::next_tile(cur, 0, p1, prb, hwm, pad);
    sel::ListTile ld = cur;
    for (int s = 0; s < 2; ++s) {              // two tiles in flight (the table with the first)
        if (ld.p < p1) {
            issue_codes(codes + ld.base * rows, rows, pad, ld.s0, min(ANT, ld.n - ld.s0),
                        code_vec != 0, s ? cb1 : cb0);
            sel::next_tile(ld, ANT, p1, prb, hwm, pad);
        }
        sel::cp_async_commit();
    }
    int buf = 0;
    while (cur.p < p1) {
        sel::cp_async_wait<1>();
        __syncthreads();
        uint8_t* cb = buf ? cb1 : cb0;
        if (threadIdx.x < min(ANT, cur.n - cur.s0)) {
            const int64_t row = cur.base + cur.s0 + threadIdx.x;
            const int64_t col = (int64_t)cur.p * pad + cur.s0 + threadIdx.x;
            const int id = ids[row];
            const float acc = qdot_tile(tab, cb + threadIdx.x, rows, ksub, packed != 0);
            od[col] = adc_finish(pcb[cur.p], acc, item_const[row], id);
            oi[col] = id;
        }
        __syncthreads();                       // the tile is read before it is refilled
        if (ld.p < p1) {
            issue_codes(codes + ld.base * rows, rows, pad, ld.s0, min(ANT, ld.n - ld.s0),
                        code_vec != 0, cb);
            sel::next_tile(ld, ANT, p1, prb, hwm, pad);
        }
        sel::cp_async_commit();
        sel::next_tile(cur, ANT, p1, prb, hwm, pad);
        buf ^= 1;
    }
    // The slots past each list's mark, after the scan (before it, their
    // loop spilled a register across the tile loop).
    if (hwm) {
        for (int p = p0; p < p1; ++p) {
            const int n = min(max(hwm[prb[p]], 0), pad);
            for (int s = n + threadIdx.x; s < pad; s += ANT) {
                od[(int64_t)p * pad + s] = sel::inf_f();
                oi[(int64_t)p * pad + s] = -1;
            }
        }
    }
    sel::cp_async_wait<0>();
}

// -- the select kernel and its merge -------------------------------------------------------

// Shared memory of the select kernel: the table (when it fits), two code
// tiles, the candidates and (when they fit) the two lists.
struct SelectPlan {
    size_t smem;
    bool tab_in_smem;
    bool lists_in_smem;
};

SelectPlan select_plan(int m, int ksub, bool packed, int K) {
    const int rows = packed ? m / 2 : m;
    const size_t fixed = 2 * (size_t)rows * ANT + sizeof(float) * (4 * ANT + 4);
    const size_t table = table_bytes(m, ksub);
    const size_t lists = 2 * (size_t)K * (sizeof(float) + sizeof(int));
    const bool tab = fixed + table <= SMEM_LIMIT;
    const size_t base = fixed + (tab ? table : 0);
    const bool in = K <= SMEM_K_MAX && base + lists <= SMEM_LIMIT;
    return {base + (in ? lists : 0), tab, in};
}

// grid (B, G). Block (b, g) scans probe ranks [g * per, (g + 1) * per)
// of query b and leaves its K best keys (dist, p * pad + s) in part (B,
// G, K), or, when G == 1, the final (dist, id) in out. Lists past
// SMEM_K_MAX live in part and work (B, G, K).
__global__ void __launch_bounds__(ANT)
adc_select_kernel(const int* __restrict__ probes, const float* __restrict__ probe_coarse,
                  const float* __restrict__ qd, const uint8_t* __restrict__ codes,
                  const float* __restrict__ item_const, const int* __restrict__ ids,
                  const int* __restrict__ hwm, int nprobe, int pad, int m, int ksub, int packed,
                  int K, int G, int per, int tab_in_smem, int tab_vec, int code_vec,
                  int smem_lists, float* part_d, int* part_t, float* work_d, int* work_t,
                  float* out_d, int* out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x, g = blockIdx.y;
    const int rows = packed ? (m >> 1) : m;
    float* s_tab = reinterpret_cast<float*>(smem);
    uint8_t* cb0 = smem + (tab_in_smem ? table_bytes(m, ksub) : 0);
    uint8_t* cb1 = cb0 + rows * ANT;
    float* cd = reinterpret_cast<float*>(cb1 + rows * ANT);   // admitted candidates
    int* ct = reinterpret_cast<int*>(cd + ANT);
    float* sd = reinterpret_cast<float*>(ct + ANT);          // ... sorted
    int* st = reinterpret_cast<int*>(sd + ANT);
    int* s_cnt = st + ANT;                                   // [4]
    float* l0d = reinterpret_cast<float*>(s_cnt + 4);        // [K] x 4 when smem_lists
    const int p0 = g * per, p1 = min(nprobe, p0 + per);
    const int64_t slot = ((int64_t)b * G + g) * K;
    const int* prb = probes + (int64_t)b * nprobe;
    const float* pcb = probe_coarse + (int64_t)b * nprobe;

    const float* tab = stage_table(qd, b, m * ksub, tab_in_smem, tab_vec, s_tab);
    sel::Lists L;
    if (smem_lists) {
        L = {l0d, reinterpret_cast<int*>(l0d + K), l0d + 2 * K,
             reinterpret_cast<int*>(l0d + 3 * K)};
    } else {
        L = {part_d + slot, part_t + slot, work_d + slot, work_t + slot};
    }
    sel::list_init<ANT>(L, K);

    sel::ListTile cur{p0 - 1, 0, 0, 0};
    sel::next_tile(cur, 0, p1, prb, hwm, pad);
    sel::ListTile ld = cur;
    for (int s = 0; s < 2; ++s) {              // two tiles in flight (the table with the first)
        if (ld.p < p1) {
            issue_codes(codes + ld.base * rows, rows, pad, ld.s0, min(ANT, ld.n - ld.s0),
                        code_vec != 0, s ? cb1 : cb0);
            sel::next_tile(ld, ANT, p1, prb, hwm, pad);
        }
        sel::cp_async_commit();
    }
    int buf = 0;
    while (cur.p < p1) {
        sel::cp_async_wait<1>();
        __syncthreads();
        uint8_t* cb = buf ? cb1 : cb0;
        const int cnt = min(ANT, cur.n - cur.s0);
        bool admit = false;
        float d = sel::inf_f();
        int t = sel::INT_MAXV;
        if (threadIdx.x < cnt) {
            const int64_t row = cur.base + cur.s0 + threadIdx.x;
            const int id = ids[row];
            const float acc =
                SEL_NO_SCORE ? 0.f : qdot_tile(tab, cb + threadIdx.x, rows, ksub, packed != 0);
            d = adc_finish(pcb[cur.p], acc, item_const[row], id);
            t = cur.p * pad + cur.s0 + threadIdx.x;
            admit = d < sel::inf_f() && sel::lex_less(d, t, L.d[K - 1], L.t[K - 1]);
        }
        int c = 0;
        if (SEL_NO_SELECT) {
            if (admit) cd[threadIdx.x] = d;
            __syncthreads();
        } else {
            c = sel::compact<ANT>(admit, d, t, cd, ct, s_cnt);   // the tile is read
        }
        if (ld.p < p1) {
            issue_codes(codes + ld.base * rows, rows, pad, ld.s0, min(ANT, ld.n - ld.s0),
                        code_vec != 0, cb);
            sel::next_tile(ld, ANT, p1, prb, hwm, pad);
        }
        sel::cp_async_commit();
        if (c > 0) sel::merge_tile<ANT>(L, K, cd, ct, c, sd, st);
        sel::next_tile(cur, ANT, p1, prb, hwm, pad);
        buf ^= 1;
    }
    sel::cp_async_wait<0>();
    for (int i = threadIdx.x; i < K; i += ANT) {
        const float dd = L.d[i];
        const int tt = L.t[i];
        if (G == 1) {
            out_d[(int64_t)b * K + i] = dd;
            out_i[(int64_t)b * K + i] =
                dd < sel::inf_f() ? ids[(int64_t)prb[tt / pad] * pad + tt % pad] : -1;
        } else {
            part_d[slot + i] = dd;
            part_t[slot + i] = tt;
        }
    }
}

// One block per query: the exact merge of its G partial lists; keys
// (dist, p * pad + s) back to ids.
__global__ void __launch_bounds__(sel::MERGE_NT)
adc_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_t,
                 const int* __restrict__ probes, const int* __restrict__ ids, int nprobe,
                 int pad, int G, int K, float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int64_t b = blockIdx.x;
    float* od = out_d + b * K;
    int* oi = out_i + b * K;
    const int* prb = probes + b * nprobe;
    sel::merge_groups(part_d + b * G * K, part_t + b * G * K, G, K, smem,
                      [=](int i, float d, int t) {
                          od[i] = d;
                          oi[i] = d < sel::inf_f() ? ids[(int64_t)prb[t / pad] * pad + t % pad]
                                                   : -1;
                      });
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

int adc_scan_abi_version() { return 3; }

// The dense kernel's blocks per SM at (m, ksub, packed)
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into out[0]. Returns the
// CUDA error code.
int adc_dense_occupancy(int m, int ksub, int packed, int* out) {
    if (!valid_args(1, 1, 1, m, ksub, packed)) return (int)cudaErrorInvalidValue;
    const DensePlan plan = dense_plan(m, ksub, packed != 0);
    cudaError_t err = set_smem(adc_dense_kernel, plan.smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], adc_dense_kernel, ANT,
                                                              plan.smem);
}

// The select kernel's residency at (m, ksub, packed, K): out[0] = blocks
// per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] = 1 when
// its lists live in shared memory (else the launch needs work scratch),
// out[2] = the most probe groups its merge holds. Returns the CUDA error
// code.
int adc_select_occupancy(int m, int ksub, int packed, int K, int* out) {
    if (!valid_args(1, 1, 1, m, ksub, packed) || K <= 0) return (int)cudaErrorInvalidValue;
    const SelectPlan plan = select_plan(m, ksub, packed != 0, K);
    cudaError_t err = set_smem(adc_select_kernel, plan.smem);
    if (err != cudaSuccess) return (int)err;
    out[1] = plan.lists_in_smem ? 1 : 0;
    out[2] = sel::max_merge_groups(K, SMEM_LIMIT);
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], adc_select_kernel, ANT,
                                                              plan.smem);
}

// probes (B, nprobe) int32; probe_coarse (B, nprobe) f32; qd (B, m, ksub)
// f32; codes (nlist, m or m/2, pad) uint8; item_const (nlist, pad) f32;
// ids (nlist, pad) int32; hwm (nlist,) int32 or null (= pad); G probe
// groups (G = ceil(nprobe / ceil(nprobe / G))); part_d/part_t (B, G, K)
// scratch when G > 1; work_d/work_t (B, G, K) scratch when the lists do
// not fit in shared memory (adc_select_occupancy); out_d/out_i (B, K).
// Launches the select kernel, then (G > 1) the merge. Returns the CUDA
// error code (0 on success).
int adc_scan_select(const void* probes, const void* probe_coarse, const void* qd,
                    const void* codes, const void* item_const, const void* ids, const void* hwm,
                    int B, int nprobe, int pad, int m, int ksub, int packed, int K, int G,
                    void* part_d, void* part_t, void* work_d, void* work_t, void* out_d,
                    void* out_i, void* stream) {
    if (!valid_args(B, nprobe, pad, m, ksub, packed) || K <= 0 || !sel::valid_groups(nprobe, G) ||
        (int64_t)nprobe * pad > 0x7fffffff)
        return (int)cudaErrorInvalidValue;
    const SelectPlan plan = select_plan(m, ksub, packed != 0, K);
    if (!plan.lists_in_smem && (work_d == nullptr || work_t == nullptr))
        return (int)cudaErrorInvalidValue;
    if (G > 1 && (part_d == nullptr || part_t == nullptr)) return (int)cudaErrorInvalidValue;
    cudaError_t err = set_smem(adc_select_kernel, plan.smem);
    if (err != cudaSuccess) return (int)err;
    const size_t msmem = sel::merge_smem_bytes(G, K);
    if (G > 1 && (err = set_smem(adc_merge_kernel, msmem)) != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // With one group the kernel's lists and results live in out.
    float* pd = static_cast<float*>(G > 1 ? part_d : out_d);
    int* pt = static_cast<int*>(G > 1 ? part_t : out_i);
    const bool tab_vec = (m * ksub) % 4 == 0 && (reinterpret_cast<uintptr_t>(qd) & 15) == 0;
    const bool code_vec = pad % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
    adc_select_kernel<<<dim3(B, G), ANT, plan.smem, st>>>(
        static_cast<const int*>(probes), static_cast<const float*>(probe_coarse),
        static_cast<const float*>(qd), static_cast<const uint8_t*>(codes),
        static_cast<const float*>(item_const), static_cast<const int*>(ids),
        static_cast<const int*>(hwm), nprobe, pad, m, ksub, packed, K, G, (nprobe + G - 1) / G,
        plan.tab_in_smem ? 1 : 0, tab_vec ? 1 : 0, code_vec ? 1 : 0,
        plan.lists_in_smem ? 1 : 0, pd, pt, static_cast<float*>(work_d),
        static_cast<int*>(work_t), static_cast<float*>(out_d), static_cast<int*>(out_i));
    if ((err = cudaGetLastError()) != cudaSuccess || G == 1) return (int)err;
    adc_merge_kernel<<<B, sel::MERGE_NT, msmem, st>>>(
        pd, pt, static_cast<const int*>(probes), static_cast<const int*>(ids), nprobe, pad, G, K,
        static_cast<float*>(out_d), static_cast<int*>(out_i));
    return (int)cudaGetLastError();
}

// As adc_scan_select, without selection, on G probe groups: out_d/out_i
// (B, nprobe * pad). Returns the CUDA error code (0 on success).
int adc_scan_dense(const void* probes, const void* probe_coarse, const void* qd,
                   const void* codes, const void* item_const, const void* ids, const void* hwm,
                   int B, int nprobe, int pad, int m, int ksub, int packed, int G, void* out_d,
                   void* out_i, void* stream) {
    if (!valid_args(B, nprobe, pad, m, ksub, packed) || !sel::valid_groups(nprobe, G))
        return (int)cudaErrorInvalidValue;
    const DensePlan plan = dense_plan(m, ksub, packed != 0);
    cudaError_t err = set_smem(adc_dense_kernel, plan.smem);
    if (err != cudaSuccess) return (int)err;
    const bool tab_vec = (m * ksub) % 4 == 0 && (reinterpret_cast<uintptr_t>(qd) & 15) == 0;
    const bool code_vec = pad % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
    adc_dense_kernel<<<dim3(B, G), ANT, plan.smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(probes), static_cast<const float*>(probe_coarse),
        static_cast<const float*>(qd), static_cast<const uint8_t*>(codes),
        static_cast<const float*>(item_const), static_cast<const int*>(ids),
        static_cast<const int*>(hwm), nprobe, pad, m, ksub, packed, (nprobe + G - 1) / G,
        plan.tab_in_smem ? 1 : 0, tab_vec ? 1 : 0, code_vec ? 1 : 0, static_cast<float*>(out_d),
        static_cast<int*>(out_i));
    return (int)cudaGetLastError();
}

}  // extern "C"
