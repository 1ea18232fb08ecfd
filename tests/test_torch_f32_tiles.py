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
after every entry of key <= its own), ties and +inf keys included.

Before the selection, the screen (screen_any, screen_write) holds each key
against its query's threshold, the last key of its list, in the
accumulators: only a key below it reaches the keys tile, with a 16-bit mask
of its warp's rows per query, and the selection takes its candidates from
the masks. Emulated lane by lane, with thresholds that may be stale (a
superset of the candidates), it must leave after every tile the lists that
the selection from every key leaves."""

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


# -- the screen in the accumulators and the selection of its survivors ---------------

W = 8                              # consumer warps (FW_CONSUMER_WARPS); warp v holds rows 16 v ..
F_PRUNE = 4                        # select_tile_f32's rounds between re-screens


def screen_tile(keys, thr_seen, thr, smem):
    """The screen (screen_any, then screen_write), lane by lane, on one tile's (NQ, 128) keys as the
    accumulators hold them (lane (g, t) of warp v: query 8 j + 2 t + e, row
    16 v + g + 8 h at bit 2 h + e): the first look for any candidate
    against thr_seen (the thresholds as the warp read them, maybe stale),
    then, when some warp has one, each such warp's screen against thr, its
    survivors' keys into their slots of the keys tile `smem` (NQ, KS; the
    other slots keep what they held), and its 16-bit masks gathered by
    three xor shuffles into the (NQ, W) masks, read back per query as four
    32-bit words. Returns (any, words)."""
    nq = keys.shape[0]
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    seen = np.zeros(W, bool)
    for v in range(W):
        for j in range(nq // 8):
            for i in range(4):
                q, row = 8 * j + 2 * t + (i & 1), 16 * v + g + 8 * (i >> 1)
                seen[v] |= bool((keys[q, row] < thr_seen[q]).any())
    masks = np.zeros((nq, W), np.uint16)
    if not seen.any():
        return False, masks.view("<u4")
    for v in np.flatnonzero(seen):
        for j in range(nq // 8):
            b = np.zeros(32, np.uint32)
            for i in range(4):
                q, row = 8 * j + 2 * t + (i & 1), 16 * v + g + 8 * (i >> 1)
                b |= (keys[q, row] < thr[q]).astype(np.uint32) << i
            if not b.any():
                continue
            for i in range(4):
                q, row = 8 * j + 2 * t + (i & 1), 16 * v + g + 8 * (i >> 1)
                on = (b >> i & 1).astype(bool)
                smem[q[on], row[on]] = keys[q[on], row[on]]
            w = ((b & 1) << g) | ((b >> 2 & 1) << (g + 8)) | ((b >> 1 & 1) << (g + 16)) \
                | ((b >> 3 & 1) << (g + 24))
            for off in (4, 8, 16):                       # __shfl_xor_sync
                w = w | w[lane ^ off]
            for ln in np.flatnonzero(g < 2):
                masks[8 * j + 2 * t[ln] + g[ln], v] = (w[ln] >> (16 * g[ln])) & 0xFFFF
    return True, masks.view("<u4")


def select_screened(lk, lp, kc, words, r0, k):
    """select_tile_f32 for one query, from its four mask words (bit b of
    word j: column 32 j + b) and its row of the keys tile (slots outside
    the mask hold whatever they held): k <= 32 in registers, one candidate
    a round by column, in when fewer than k entries have key' <= key, the
    candidates left held against the list's last key every F_PRUNE rounds;
    deeper lists by warp_insert, one candidate at a time."""
    mc = [int(w) for w in words]
    cand = lambda: [(32 * j + b) for j in range(4) for b in range(32) if mc[j] >> b & 1]
    if k > 32:
        lk, lp = list(lk), list(lp)
        for col in cand():
            key = kc[col]
            if not key < lk[k - 1]:
                continue
            at = sum(1 for e in lk if e <= key)
            lk[at + 1:k], lp[at + 1:k] = lk[at:k - 1], lp[at:k - 1]
            lk[at], lp[at] = key, r0 + col
        return lk, lp
    inf = np.float32(np.inf)
    vk = [lk[j] if j < k else inf for j in range(32)]
    vp = [lp[j] if j < k else INT32_MAX for j in range(32)]
    rnd = 1
    while any(mc):
        if rnd % F_PRUNE == 0:
            last = vk[k - 1]
            for j in range(4):
                mc[j] &= sum(1 << b for b in range(32) if kc[32 * j + b] < last)
            if not any(mc):
                break
        col = cand()[0]
        mc[col // 32] &= ~(1 << (col % 32))
        key, pos = kc[col], r0 + col
        at = sum(1 for e in vk if e <= key)
        if at < k:
            up_k, up_p = [vk[0]] + vk[:-1], [vp[0]] + vp[:-1]
            vk = [key if j == at else up_k[j] if at < j < k else vk[j] for j in range(32)]
            vp = [pos if j == at else up_p[j] if at < j < k else vp[j] for j in range(32)]
        rnd += 1
    assert all(e == inf for e in vk[k:]), "lanes past k took an entry"
    return vk[:k], vp[:k]


def screened_tiles(k, tiles, b, stale, rng):
    """A block's split through the screen and the selection of its
    survivors, tile after tile, against every key through select_tile's
    order (insert_one_at_a_time): the lists after each tile, and how many
    keys the screens passed. Thresholds start +inf (-inf past B) and follow
    each changed list's last key; `stale` screens against the thresholds
    of that many tiles back (both looks, the strongest superset). The keys
    tile starts with random keys in every slot, which the selection must
    never take."""
    nq = tiles[0].shape[0]
    inf = np.float32(np.inf)
    thr = np.where(np.arange(nq) < b, inf, -inf).astype(np.float32)
    history = [thr.copy()]
    smem = rng.standard_normal((nq, KS)).astype(np.float32) - 3.0
    ours = [([inf] * k, [INT32_MAX] * k) for _ in range(nq)]
    want = [([inf] * k, [INT32_MAX] * k) for _ in range(nq)]
    passed = 0
    for tile, keys in enumerate(tiles):
        r0 = 1000 + NR * tile
        seen = history[max(0, len(history) - 1 - stale)]
        any_, words = screen_tile(keys, seen, seen, smem)
        passed += int(sum(bin(int(w)).count("1") for w in words.ravel()))
        for q in range(nq):
            if q < b:
                want[q] = insert_one_at_a_time(*want[q], keys[q].tolist(), r0, k)
            if any_ and q < b and words[q].any():
                ours[q] = select_screened(*ours[q], smem[q, :NR].tolist(), words[q], r0, k)
                thr[q] = ours[q][0][k - 1]
            else:
                assert not words[q].any(), "a query past B has a survivor"
        history.append(thr.copy())
        for q in range(nq):
            assert ours[q] == want[q], (tile, q, ours[q], want[q])
    return ours, passed


def test_screen_masks_are_the_tile_columns():
    """Bit b of a query's mask word j is column 32 j + b of the tile, set
    exactly when that key is below the query's threshold, and the keys tile
    holds each survivor's key in its slot."""
    rng = np.random.default_rng(5)
    for nq in (8, 16, 128):
        keys = rng.standard_normal((nq, NR)).astype(np.float32)
        thr = rng.standard_normal(nq).astype(np.float32) - 1.0
        smem = np.full((nq, KS), np.nan, np.float32)
        any_, words = screen_tile(keys, thr, thr, smem)
        want = keys < thr[:, None]
        assert any_ == bool(want.any())
        got = np.array([[bool(words[q, c // 32] >> (c % 32) & 1) for c in range(NR)]
                        for q in range(nq)])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(smem[:, :NR][want], keys[want])
        assert np.isnan(smem[:, :NR][~want]).all()


SCREEN_CASES = ["stale_1", "stale_3", "equal_threshold", "ties_across_tiles", "first_tile",
                "inf_rows"]


def _screen_tiles(case, nq, rng):
    """Keys of a split's tiles for each case; the queries' keys drift down
    so lists keep changing."""
    n_tiles = 1 if case == "first_tile" else 10
    tiles = []
    for tile in range(n_tiles):
        if case == "ties_across_tiles":
            keys = rng.integers(0, 4, (nq, NR)).astype(np.float32) - 1.5
        else:
            keys = (rng.standard_normal((nq, NR)) - 0.1 * tile).astype(np.float32)
        if case == "inf_rows":
            keys[rng.random((nq, NR)) < 1 / 3] = np.inf       # masked rows (+inf norms)
            if tile == n_tiles - 1:
                keys[:, 77:] = np.inf                            # past the split's end
        tiles.append(keys)
    return tiles


@pytest.mark.parametrize("k", [1, 20, 32, 33])
@pytest.mark.parametrize("case", SCREEN_CASES)
def test_f32_screened_selection_equals_unfiltered(case, k):
    """The screen plus the selection of its survivors gives, after every
    tile, the lists that select_tile's order gives from every key, key for
    key and position for position: with thresholds one and three tiles
    stale; with keys equal to the threshold (never admitted: the screen is
    strict, as the list's order is); with ties of four values inside and
    across tiles (the lower position first); on a split of one tile, where
    the +inf thresholds pass every finite key; with a third of the keys
    +inf and the last tile's rows past the split's end +inf, and queries
    past B (no survivor, no list). k = 33 takes warp_insert."""
    rng = np.random.default_rng(len(case) * 100 + k)
    nq, b = 16, 16 if case != "inf_rows" else 13
    tiles = _screen_tiles(case, nq, rng)
    if case == "equal_threshold":
        # Each tile after the first puts a third of its keys on the lists'
        # last keys as they stand after the tile before.
        lists, _ = screened_tiles(k, tiles[:1], b, 0, np.random.default_rng(0))
        for tile in range(1, len(tiles)):
            last = np.array([lists[q][0][k - 1] for q in range(nq)], np.float32)
            cols = rng.random((nq, NR)) < 1 / 3
            tiles[tile][cols] = np.broadcast_to(last[:, None], (nq, NR))[cols]
            lists, _ = screened_tiles(k, tiles[:tile + 1], b, 0, np.random.default_rng(0))
    stale = {"stale_1": 1, "stale_3": 3}.get(case, 0)
    lists, passed = screened_tiles(k, tiles, b, stale, rng)
    if case == "first_tile":
        assert passed == b * NR, "+inf thresholds pass every finite key"
    if case == "inf_rows":
        assert all(lists[q][1] == [INT32_MAX] * k for q in range(b, nq))
        assert passed < b * NR * len(tiles) * 2 // 3


@pytest.mark.parametrize("nq", [8, 128])
def test_screen_passes_few_keys_of_a_long_split(nq):
    """Rows in random order: a query admits about k / t keys of its t-th
    tile, so over a split of 40 tiles the screen passes a small share of
    the keys (the first tile's all), while the lists stay those of the
    unfiltered selection."""
    rng = np.random.default_rng(nq)
    k, n_tiles = 20, 40
    tiles = [rng.standard_normal((nq, NR)).astype(np.float32) for _ in range(n_tiles)]
    _, passed = screened_tiles(k, tiles, nq, 0, rng)
    share = passed / (nq * NR * n_tiles)
    assert NR * nq <= passed and share < 0.12, share


def shared_cut_splits(tiles_by_split, k, lag, rng):
    """Splits of one query tile screened with a cut shared across them:
    each changed list publishes its last key T (the kernel's atomicMin), and
    each split folds the smallest published T, `lag` rounds late, into its
    thresholds as T's successor (a key equal to T may still win on
    position). Splits take their tiles in turns, the last split first on
    even turns; returns the k best (key, position) of the merged lists per
    query."""
    nq = tiles_by_split[0][0].shape[0]
    inf = np.float32(np.inf)
    cut = np.full(nq, inf, np.float32)
    published = [cut.copy()]
    state = []
    for s in range(len(tiles_by_split)):
        state.append({"thr": np.full(nq, inf, np.float32),
                      "smem": rng.standard_normal((nq, KS)).astype(np.float32) - 3.0,
                      "lists": [([inf] * k, [INT32_MAX] * k) for _ in range(nq)]})
    for t in range(len(tiles_by_split[0])):
        order = range(len(tiles_by_split))
        for s in (order if t % 2 else reversed(order)):
            tiles, st = tiles_by_split[s], state[s]
            seen_cut = published[max(0, len(published) - 1 - lag)]
            st["thr"] = np.minimum(st["thr"], np.nextafter(seen_cut, inf))
            r0 = 1_000_000 * s + NR * t
            any_, words = screen_tile(tiles[t], st["thr"], st["thr"], st["smem"])
            for q in range(nq):
                if any_ and words[q].any():
                    st["lists"][q] = select_screened(*st["lists"][q], st["smem"][q, :NR].tolist(),
                                                     words[q], r0, k)
                    last = np.float32(st["lists"][q][0][k - 1])
                    st["thr"][q] = last
                    cut[q] = min(cut[q], last)
            published.append(cut.copy())
    merged = []
    for q in range(nq):
        pairs = [(kk, pp) for st in state for kk, pp in zip(*st["lists"][q])]
        merged.append(sorted(pairs)[:k])
    return merged


@pytest.mark.parametrize("lag", [0, 2])
@pytest.mark.parametrize("k", [1, 20, 33])
@pytest.mark.parametrize("kind", ["random", "ties", "duplicates"])
def test_f32_shared_cut_keeps_the_result(kind, k, lag):
    """With the cut shared across splits (each split's screen also drops a
    key above another split's k-th key), the merged k best equal those of
    every key, key and position: random keys, keys from four values (ties
    within and across splits), and splits that repeat each other's keys
    (a key equal to the cut, at a lower position, must still come in); the
    cut seen at once or two turns late."""
    rng = np.random.default_rng(len(kind) * 10 + k + lag)
    nq, n_splits, n_tiles = 8, 4, 6
    if kind == "random":
        tiles = [[rng.standard_normal((nq, NR)).astype(np.float32) for _ in range(n_tiles)]
                 for _ in range(n_splits)]
    elif kind == "ties":
        tiles = [[rng.integers(0, 4, (nq, NR)).astype(np.float32) for _ in range(n_tiles)]
                 for _ in range(n_splits)]
    else:
        base = [rng.standard_normal((nq, NR)).astype(np.float32) for _ in range(n_tiles)]
        tiles = [[b.copy() for b in base] for _ in range(n_splits)]
    got = shared_cut_splits(tiles, k, lag, rng)
    for q in range(nq):
        every = [(tiles[s][t][q, c], 1_000_000 * s + NR * t + c)
                 for s in range(n_splits) for t in range(n_tiles) for c in range(NR)]
        want = sorted(every)[:k]
        assert [(np.float32(a), b) for a, b in got[q]] == [(np.float32(a), b) for a, b in want], q
