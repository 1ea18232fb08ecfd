"""How the flat kernel's f32 mode (csrc/fused_l2_topk.cu, scan_topk_f32_kernel)
lays out its tiles and merges a keys tile into its lists, emulated in numpy.

A block holds Q = 64 queries and a tile of R = 128 store rows; ring chunks
of FDK = 64 f32 columns sit in shared memory at a row stride of FSK = 68
floats. Warp w = WR wq + wr (WR = R / 32) owns queries wq*32 .. +31 and tile rows
wr*32 .. +31, loads its fragments with ldmatrix.x4.b16 at the kernel's row
addresses (a_off, b_off) and multiplies with mma.sync.m16n8k8 tf32. Here
ldmatrix is emulated by its definition (lane l's register j: row l / 4,
32-bit word l % 4 of matrix j, whose row r lane 8 j + r addresses) and the
product by the PTX ISA's m16n8k8 .tf32 fragment tables (A: (g, t), (g + 8,
t), (g, t + 4), (g + 8, t + 4); B: (k t, n g), (k t + 4, n g); C: (g, 2t),
(g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1); g = lane / 4, t = lane % 4). The
emulated keys tile must equal q . x^T exactly on integer operands, every
ldmatrix phase must read distinct 16-byte bank groups, and the keys must
land once on every (query, row) cell.

The selection (select_tile_f32) holds a list of k <= 32 in registers, one
entry a lane, and takes a tile's admitted candidates one at a time, each
with a ballot and two shuffles, in when fewer than k entries have key' <=
key; emulated here lane by lane, it must give the list that warp_insert
gives in shared memory (select_tile's order: candidates by position, each
after every entry of key <= its own), ties and +inf keys included."""

import numpy as np
import pytest

FDK = 64
FSK = FDK + 4
INT32_MAX = 2**31 - 1
NQ, NR = 64, 128   # queries, store rows a tile


def ldmatrix_x4(smem_words, row_addr):
    """ldmatrix.x4.b16 on a word-addressed array: row_addr[lane] is the word
    address of row lane % 8 of matrix lane // 8; returns regs[lane][j]."""
    regs = np.zeros((32, 4), smem_words.dtype)
    for j in range(4):
        for lane in range(32):
            regs[lane, j] = smem_words[row_addr[8 * j + lane // 4] + lane % 4]
    return regs


def a_rows(wq, m, r=0):
    """Word addresses of the A (queries) ldmatrix rows of m16 tile m; the
    queries follow the stage's r store rows."""
    return [(r + wq * 32 + m * 16 + (lane & 15)) * FSK + (lane >> 4) * 4 for lane in range(32)]


def b_rows(wr, half):
    """Word addresses of the B (store rows) ldmatrix rows of n8 pieces
    2 half, 2 half + 1."""
    return [(wr * 32 + half * 16 + (lane >> 4) * 8 + (lane & 7)) * FSK + ((lane >> 3) & 1) * 4
            for lane in range(32)]


def mma_m16n8k8(a, b, c):
    """d = a . b + c from per-lane fragments (the PTX tables above)."""
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[lane]
        B[t, g], B[t + 4, g] = b[lane]
    D = A @ B
    out = c.copy()
    for lane in range(32):
        g, t = lane // 4, lane % 4
        out[lane] += [D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_tiles_multiply_to_the_keys_tile(seed):
    nq, nr = NQ, NR
    rng = np.random.default_rng(seed)
    q = rng.integers(-8, 9, (nq, FDK)).astype(np.float64)
    x = rng.integers(-8, 9, (nr, FDK)).astype(np.float64)
    stage = np.zeros((nr + nq) * FSK)            # the store chunk, then the queries
    for r in range(nr):
        stage[r * FSK:r * FSK + FDK] = x[r]
    for r in range(nq):
        stage[(nr + r) * FSK:(nr + r) * FSK + FDK] = q[r]
    keys = np.full((nq, nr), np.nan)
    for warp in range(8):
        wq, wr = warp // (nr // 32), warp % (nr // 32)
        acc = np.zeros((2, 4, 32, 4))
        for kk in range(0, FDK, 8):
            ah = [ldmatrix_x4(stage, [w + kk for w in a_rows(wq, m, nr)]) for m in range(2)]
            bx = [ldmatrix_x4(stage, [w + kk for w in b_rows(wr, h)]) for h in range(2)]
            for m in range(2):
                for p in range(4):
                    b = bx[p >> 1][:, 2 * (p & 1):2 * (p & 1) + 2]
                    acc[m, p] = mma_m16n8k8(ah[m], b, acc[m, p])
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for m in range(2):
                for p in range(4):
                    for h in range(2):
                        for e in range(2):
                            row, col = wq * 32 + m * 16 + g + 8 * h, wr * 32 + p * 8 + 2 * t + e
                            assert np.isnan(keys[row, col]), "a keys cell written twice"
                            keys[row, col] = acc[m, p, lane, 2 * h + e]
    np.testing.assert_array_equal(keys, q @ x.T)


@pytest.mark.parametrize("which", ["a", "b"])
def test_ldmatrix_phases_are_conflict_free(which):
    """Each 8-lane phase of an ldmatrix reads eight 16-byte rows; with the
    row stride FSK * 4 = 272 bytes (16 mod 128) they fall on eight distinct
    16-byte groups of the 32 banks, for every warp, tile and k step."""
    for w in range(4):
        for sub in range(2):
            for kk in range(0, FDK, 8):
                rows = a_rows(w, sub, NR) if which == "a" else b_rows(w, sub)
                for phase in range(4):
                    groups = {((rows[8 * phase + r] + kk) * 4 // 16) % 8 for r in range(8)}
                    assert len(groups) == 8


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
