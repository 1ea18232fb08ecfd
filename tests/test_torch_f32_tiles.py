"""How the flat kernel's f32 mode (csrc/fused_l2_topk.cu, scan_topk_f32_wgmma_kernel)
lays out its tiles and merges a keys tile into its lists, emulated in numpy.

A block takes a tile of R = 128 store rows by its NQ queries (a multiple of
8 up to 128): two consumer warpgroups, rows 0-63 and 64-127, each running
wgmma m64nNk8 tf32 with the store rows on M (A, in registers) and the
queries on N (B, in shared memory). A ring stage holds boxes of 16 f32
columns: for each, the store chunk [128][16] as its TMA box lands it
(64-byte rows), and the queries' hi and lo parts, staged once a call by
stage_f32_queries_kernel
(ops/topk_cuda.stage_f32_plain is its plain version) as K-major B
operands: 8-query x 16-byte core matrices, 128 bytes apart along the
queries and 16 NQ bytes (the descriptor's leading byte offset) apart along
K. Lane (g = lane / 4, t = lane % 4) of warp wq in warpgroup cw reads one
float4 of each of its rows 64 cw + 16 wq + g and + 8 (columns 4t .. 4t + 3)
and splits it: k step e's A fragment is a0 (row g, k t) = x0[2e], a1 (g +
8, t) = x1[2e], a2 (g, t + 4) = x0[2e + 1], a3 (g + 8, t + 4) = x1[2e + 1]
(the PTX ISA's wgmma .tf32 A-register layout, the m16n8k8 one per warp of
16 rows), so the staged queries hold, at logical column kappa of a stage,
the query column f32_stage_perm()[kappa]. The accumulators are the PTX
ISA's m64nN f32 layout: d[4 j + 2 h + e] is row g + 8 h of the warp's 16,
query 8 j + 2 t + e. Here the fragments, the descriptor's addressing and
the accumulators are emulated by those tables: the keys tile must equal
q . x^T exactly on integer operands, with each (query, row) cell written
once and each store element split by one lane once; the fragment loads and
the keys tile's writes must fall on distinct banks.

The selection (select_tile_f32) holds a list of k <= 32 in registers, one
entry a lane, and takes a tile's admitted candidates one at a time, each
with a ballot and two shuffles, in when fewer than k entries have key' <=
key; emulated here lane by lane, it must give the list that warp_insert
gives in shared memory (select_tile's order: candidates by position, each
after every entry of key <= its own), ties and +inf keys included."""

import numpy as np
import pytest
import torch

from c99_vectordb_tpu_torch.ops import topk_cuda

DK = topk_cuda.F32_BOX_COLS        # f32 columns a TMA box of the store
KS = 128 + 4                       # the keys tile's row stride (FW_KS)
INT32_MAX = 2**31 - 1
NR = 128                           # store rows a tile


def lane_rows(cw, wq):
    """Per lane: (g, t, the lane's first tile row)."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    return g, t, 64 * cw + 16 * wq + g


def a_fragments(chunk, cw, wq):
    """The (32, 2, 4) A fragments of warp wq of warpgroup cw for the stage's
    two k steps, from the store chunk [128][16] as the kernel reads it: a
    float4 of each of the lane's two rows."""
    g, t, row = lane_rows(cw, wq)
    cols = 4 * t[:, None] + np.arange(4)
    x0, x1 = chunk[row[:, None], cols], chunk[row[:, None] + 8, cols]
    return np.stack([np.stack([x0[:, 2 * e], x1[:, 2 * e], x0[:, 2 * e + 1], x1[:, 2 * e + 1]], 1)
                     for e in range(2)], 1)


def warpgroup_a(frags_by_warp, e):
    """The 64 x 8 A matrix that wgmma reads from the warps' fragments of k
    step e (PTX ISA: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
    of the warp's 16 rows)."""
    a = np.full((64, 8), np.nan)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for wq, frags in enumerate(frags_by_warp):
        r = 16 * wq + g
        a[r, t], a[r + 8, t] = frags[:, e, 0], frags[:, e, 1]
        a[r, t + 4], a[r + 8, t + 4] = frags[:, e, 2], frags[:, e, 3]
    assert not np.isnan(a).any()
    return a


def descriptor_b(blob, start, nq):
    """The 8 x NQ B matrix that a descriptor at float `start` addresses: K-major,
    no swizzle, core matrices of 8 queries x 4 floats, 4 NQ floats (the
    leading byte offset, 16 NQ bytes) apart along K and 32 floats (128
    bytes) apart along the queries."""
    k, n = np.meshgrid(np.arange(8), np.arange(nq), indexing="ij")
    return blob[start + (k // 4) * 4 * nq + (n // 8) * 32 + (n % 8) * 4 + k % 4]


def emulate_keys_tile(x_tile, q_st, nq, products):
    """The (NQ, 128) dot products of one tile as the kernel's two warpgroups
    form them from stage_f32_plain's blob, written through the accumulator
    layout (each cell once); `products` maps (x hi, x lo, q hi, q lo) of one
    k step to its contribution."""
    d = q_st.shape[1]
    boxes = -(-d // DK)
    blob = topk_cuda.stage_f32_plain(torch.from_numpy(q_st), nq).numpy().astype(np.float64)
    acc = [np.zeros((64, nq)), np.zeros((64, nq))]
    for c in range(boxes):
        chunk = np.zeros((NR, DK))
        w = min(DK, d - c * DK)
        chunk[:, :w] = x_tile[:, c * DK:c * DK + w]
        base = c * 2 * nq * DK             # this box's hi part; the lo part follows
        for cw in range(2):
            frags = [a_fragments(chunk, cw, wq) for wq in range(4)]
            for e in range(2):
                a = warpgroup_a(frags, e)
                b_hi = descriptor_b(blob, base + e * 8 * nq, nq)
                b_lo = descriptor_b(blob, base + nq * DK + e * 8 * nq, nq)
                acc[cw] += products(a, b_hi, b_lo)
    keys = np.full((nq, NR), np.nan)
    smem = np.full(nq * KS, np.nan)
    for cw in range(2):
        for wq in range(4):
            g, t, row = lane_rows(cw, wq)
            for j in range(nq // 8):
                for h in range(2):
                    for e in range(2):
                        q = 8 * j + 2 * t + e
                        val = acc[cw][16 * wq + g + 8 * h, q]   # d[4 j + 2 h + e] of each lane
                        assert np.isnan(keys[q, row + 8 * h]).all(), "a keys cell written twice"
                        keys[q, row + 8 * h] = val
                        smem[q * KS + row + 8 * h] = val
    assert not np.isnan(keys).any()
    return keys, smem


@pytest.mark.parametrize("d", [100, 384, 768])
@pytest.mark.parametrize("nq", [8, 16, 64, 128])
def test_wgmma_fragments_multiply_to_the_keys_tile(nq, d):
    """Integer operands (exact in every split and product): the emulated
    fragments, descriptors and accumulators give q . x^T for every query
    and row of the tile, each cell once, read back from the keys tile at
    its stride."""
    rng = np.random.default_rng(nq * 1000 + d)
    x = rng.integers(-8, 9, (NR, d)).astype(np.float32)
    q = rng.integers(-8, 9, (nq, d)).astype(np.float32)
    keys, smem = emulate_keys_tile(
        x, q, nq, lambda a, b_hi, b_lo: a @ b_hi)
    want = q.astype(np.float64) @ x.astype(np.float64).T
    np.testing.assert_array_equal(keys, want)
    np.testing.assert_array_equal(smem.reshape(nq, KS)[:, :NR], want)


def test_stage_perm_matches_the_a_fragments():
    """Logical column kappa = 8 e + k of a stage (k step e, row k of the B
    operand) holds the store column that lane t's A fragment holds at that
    k: k < 4 its a0 (float 2e of its float4), k >= 4 its a2 (float 2e + 1)."""
    perm = topk_cuda.f32_stage_perm().tolist()
    assert sorted(perm) == list(range(DK))
    for e in range(2):
        for k in range(8):
            t = k % 4
            assert perm[8 * e + k] == 4 * t + 2 * e + k // 4


@pytest.mark.parametrize("nq", [8, 128])
def test_each_store_element_split_once(nq):
    """Every element of a box of the store is loaded and split by one lane
    of one consumer warp, once: a tile's store is split once per query
    tile, whatever NQ."""
    count = np.zeros((NR, DK), int)
    for cw in range(2):
        for wq in range(4):
            g, t, row = lane_rows(cw, wq)
            for h in range(2):
                for f in range(4):
                    np.add.at(count, (row + 8 * h, 4 * t + f), 1)
    assert (count == 1).all()


@pytest.mark.parametrize("which", ["fragments", "keys"])
def test_smem_accesses_are_conflict_free(which):
    """fragments: a warp's float4 loads of its rows (64-byte rows, no
    swizzle) are served a quarter-warp at a time, and each quarter-warp's
    eight 16-byte pieces fall on the eight distinct 16-byte bank groups;
    keys: a warp's write of one accumulator register to the keys tile
    (stride 132 floats) puts its 32 lanes on 32 distinct banks."""
    for cw in range(2):
        for wq in range(4):
            g, t, row = lane_rows(cw, wq)
            if which == "fragments":
                for h in range(2):
                    byte = (row + 8 * h) * DK * 4 + 16 * t
                    for quarter in range(4):
                        groups = {(int(b) // 16) % 8 for b in byte[8 * quarter:8 * quarter + 8]}
                        assert len(groups) == 8
            else:
                for j in range(16):
                    for h in range(2):
                        for e in range(2):
                            word = (8 * j + 2 * t + e) * KS + row + 8 * h
                            assert len({int(w) % 32 for w in word}) == 32


def insert_one_at_a_time(lk, lp, keys, r0, k):
    """select_tile: candidates in column order, each below the list's last
    key inserted after every entry of key <= its own."""
    lk, lp = list(lk), list(lp)
    for col, key in enumerate(keys):
        if not key < lk[k - 1]:
            continue
        at = sum(1 for j in range(k) if lk[j] <= key)
        lk[at + 1:k] = lk[at:k - 1]
        lp[at + 1:k] = lp[at:k - 1]
        lk[at], lp[at] = key, r0 + col
    return lk, lp


def insert_in_registers(lk, lp, keys, r0, k):
    """select_tile_f32's list of k <= 32, lane by lane: lane j holds entry
    j (+inf past k); the ballots against the list's last key (one per 32
    columns) admit the candidates, which go in by column, each at the count
    at of lanes with key' <= key when at < k, the lanes above it (below k)
    taking their lower neighbour's entry."""
    inf = np.float32(np.inf)
    thr = lk[k - 1]
    order = [c for c in range(len(keys)) if keys[c] < thr]
    vk = [lk[j] if j < k else inf for j in range(32)]
    vp = [lp[j] if j < k else INT32_MAX for j in range(32)]
    for col in order:
        key, pos = keys[col], r0 + col
        at = sum(1 for j in range(32) if vk[j] <= key)
        if not at < k:
            continue
        up_k, up_p = [vk[0]] + vk[:-1], [vp[0]] + vp[:-1]      # __shfl_up_sync by 1
        vk = [key if j == at else up_k[j] if at < j < k else vk[j] for j in range(32)]
        vp = [pos if j == at else up_p[j] if at < j < k else vp[j] for j in range(32)]
    assert all(v == inf for v in vk[k:]), "lanes past k took an entry"
    return vk[:k], vp[:k]


@pytest.mark.parametrize("k", [1, 2, 20, 31, 32])
@pytest.mark.parametrize("kind", ["random", "ties", "inf"])
def test_f32_selection_equals_insertion(k, kind):
    """Many tiles in a row through both selections: the same lists, key for
    key and position for position. "ties": keys from four values, so most
    candidates tie with each other and with the list; "inf": a third of
    the keys +inf (masked rows and rows past N), never admitted."""
    rng = np.random.default_rng(k * 10 + len(kind))
    rows = NR
    lk1 = lk2 = [np.inf] * k
    lp1 = lp2 = [INT32_MAX] * k
    for tile in range(12):
        if kind == "ties":
            keys = rng.integers(0, 4, rows).astype(np.float32) - 1.5 + 0.5 * (tile < 2)
        else:
            keys = (rng.standard_normal(rows) - 0.15 * tile).astype(np.float32)
        if kind == "inf":
            keys[rng.random(rows) < 1 / 3] = np.inf
        r0 = 1000 + rows * tile
        lk1, lp1 = insert_one_at_a_time(lk1, lp1, keys.tolist(), r0, k)
        lk2, lp2 = insert_in_registers(lk2, lp2, keys.tolist(), r0, k)
        assert lk2 == lk1 and lp2 == lp1, (tile, lk1, lk2, lp1, lp2)
    assert all(np.isfinite(lk1))
