"""How the flat kernel's int8 x int8 mode feeds the tensor cores
(csrc/fused_l2_topk.cu, scan_topk_mma_kernel<2>), emulated in numpy.

The kernel keeps a block's 64 int8 queries resident in shared memory (row
stride ceil(D / 128) * 128 + 16 bytes) and stages each 128-column chunk of
64 store rows at a row stride of 144 bytes. Each warp (wq, wr) loads its A and
B fragments with ldmatrix.x4.b16 at the kernel's row addresses (a_off,
b_off) and multiplies with mma.sync.m16n8k32.row.col.s32.s8.s8.s32. Here
ldmatrix is emulated by its definition (lane l's register j: row l / 4,
bytes 4 (l % 4) .. + 3 of matrix j, whose row r lane 8 j + r addresses)
and the product by the PTX ISA's m16n8k32 fragment tables for .s8
(independently of ldmatrix). The emulated tile must equal q8 . x8^T
exactly, the rows of every ldmatrix phase must sit on distinct 16-byte
bank groups, and the key epilogue float(dot) * rs (rounded), + norm
(rounded) must give select_plain's keys and selection bit for bit."""

import numpy as np
import pytest
import torch

from c99_vectordb_tpu_torch.ops import topk_cuda

QT = RT = 64          # queries and store rows per block tile
DK = 128              # int8 columns per ring chunk
SK = DK + 16          # padded chunk row, bytes


def q_stride(d: int) -> int:
    """Row stride of the resident int8 queries (mma_layout's dqs)."""
    return -(-d // DK) * DK + 16


def ldmatrix_x4(smem: np.ndarray, addrs: np.ndarray) -> np.ndarray:
    """(32, 4) uint32: lane l's register j is the 32-bit word l % 4 of row
    l / 4 of matrix j, whose rows lanes 8 j .. 8 j + 7 address."""
    lanes = np.arange(32)
    out = np.empty((32, 4), np.uint32)
    for j in range(4):
        rows = addrs[8 * j + lanes // 4] + 4 * (lanes % 4)
        assert (addrs[8 * j: 8 * j + 8] % 16 == 0).all()
        out[:, j] = smem[rows[:, None] + np.arange(4)].copy().view("<u4")[:, 0]
    return out


def bank_groups(addrs: np.ndarray) -> list:
    """The 16-byte bank group (of eight per 128 bytes) of each row of each
    of the four 8-lane phases."""
    return [sorted((addrs[8 * j: 8 * j + 8] // 16 % 8).tolist()) for j in range(4)]


def s8_bytes(reg: np.ndarray) -> np.ndarray:
    """(..., 4) int8 of (...) uint32, element 0 in the low byte."""
    return reg.astype("<u4")[..., None].view(np.int8).reshape(*reg.shape, 4)


def mma_s8(acc, a, b0, b1):
    """acc (32, 4) int64 += the m16n8k32 product of the fragments, by the
    PTX ISA tables: A element i of lane (g, t) is row g + 8 ((i // 4) & 1),
    column 4 t + i % 4 + 16 (i // 8); B element i is column g, row 4 t +
    i % 4 + 16 (i // 4); C element i is row g + 8 (i // 2), column 2 t +
    i % 2."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    av, bv = s8_bytes(a), s8_bytes(np.stack([b0, b1], 1))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for r in range(4):
            A[g + 8 * (r & 1), 4 * t + 16 * (r >> 1): 4 * t + 16 * (r >> 1) + 4] = av[lane, r]
        for r in range(2):
            B[4 * t + 16 * r: 4 * t + 16 * r + 4, g] = bv[lane, r]
    D = A @ B
    for lane in range(32):
        g, t = divmod(lane, 4)
        for i in range(4):
            acc[lane, i] += D[g + 8 * (i // 2), 2 * t + (i & 1)]


def block_tile(q8: np.ndarray, x8: np.ndarray, check_banks=None) -> np.ndarray:
    """The (64, 64) int32 dots of one block tile as the kernel forms them:
    queries resident, each chunk staged zero-filled past D, every warp's
    k steps of 32 bytes (those below the chunk's width), accumulator
    (nt, h, e) of warp (wq, wr) to query wq*16 + g + 8h, row wr*32 + nt*8 +
    2t + e."""
    b, d = q8.shape
    n = x8.shape[0]
    dqs = q_stride(d)
    qs = np.zeros(QT * dqs, np.uint8)
    for r in range(b):
        qs[r * dqs: r * dqs + d] = q8[r].view(np.uint8)
    lanes = np.arange(32)
    acc = np.zeros((8, 4, 32, 4), np.int64)          # warp, piece, lane, element
    for c0 in range(0, d, DK):
        chunk = np.zeros(RT * SK, np.uint8)
        w = min(DK, d - c0)
        for r in range(n):
            chunk[r * SK: r * SK + w] = x8[r, c0: c0 + w].view(np.uint8)
        for warp in range(8):
            wq, wr = warp & 3, warp >> 2
            a_off = (wq * 16 + (lanes & 15)) * dqs + (lanes >> 4) * 16 + c0
            b_off = (wr * 32 + (lanes >> 4) * 8 + (lanes & 7)) * SK + ((lanes >> 3) & 1) * 16
            if check_banks is not None:
                check_banks(a_off, b_off, b_off + 16 * SK)
            for kk in range(0, DK, 32):
                if kk >= w:
                    continue
                a = ldmatrix_x4(qs, a_off + kk)
                b01 = ldmatrix_x4(chunk, b_off + kk)
                b23 = ldmatrix_x4(chunk, b_off + 16 * SK + kk)
                mma_s8(acc[warp, 0], a, b01[:, 0], b01[:, 1])
                mma_s8(acc[warp, 1], a, b01[:, 2], b01[:, 3])
                mma_s8(acc[warp, 2], a, b23[:, 0], b23[:, 1])
                mma_s8(acc[warp, 3], a, b23[:, 2], b23[:, 3])
    tile = np.zeros((QT, RT), np.int64)
    for warp in range(8):
        wq, wr = warp & 3, warp >> 2
        for lane in range(32):
            g, t = divmod(lane, 4)
            for nt in range(4):
                for h in range(2):
                    for e in range(2):
                        tile[wq * 16 + g + 8 * h, wr * 32 + nt * 8 + 2 * t + e] = \
                            acc[warp, nt, lane, 2 * h + e]
    assert np.abs(tile).max() < 2 ** 31
    return tile.astype(np.int32)


def _int8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("d", [384, 392, 64, 44])
def test_emulated_fragments_multiply_to_q8_x8t(d):
    """D = 384 (whole chunks), 392 and 44 (a partial last chunk: one or two
    k steps, zero-filled past D, the rest skipped), 64 (half a chunk); a
    ragged query and row tile."""
    rng = np.random.default_rng(d)
    q8, x8 = _int8(rng, (53, d)), _int8(rng, (61, d))
    tile = block_tile(q8, x8)
    want = q8.astype(np.int64) @ x8.astype(np.int64).T
    np.testing.assert_array_equal(tile[:53, :61], want)
    assert not tile[53:].any() and not tile[:, 61:].any()


def test_emulated_fragments_at_the_extremes():
    """+-127 everywhere: the largest dots (127^2 * D) stay exact."""
    d = 768
    q8 = np.full((64, d), 127, np.int8)
    q8[1::2] = -127
    x8 = np.full((64, d), -127, np.int8)
    x8[::3] = 127
    tile = block_tile(q8, x8)
    np.testing.assert_array_equal(tile, q8.astype(np.int64) @ x8.astype(np.int64).T)


@pytest.mark.parametrize("d", [384, 392, 768])
def test_ldmatrix_phases_are_free_of_bank_conflicts(d):
    """Every ldmatrix phase (8 rows of 16 bytes) of the resident queries
    (stride 128 c + 16 bytes) and of the 144-byte store chunk rows lands
    on eight distinct 16-byte bank groups; the unpadded 128-byte stride
    would not."""
    seen = []

    def check(a_off, b01_off, b23_off):
        for addrs in (a_off, b01_off, b23_off):
            for kk in range(0, DK, 32):
                for phase in bank_groups(addrs + kk):
                    assert phase == list(range(8)), (d, phase)
        seen.append(1)

    rng = np.random.default_rng(1)
    block_tile(_int8(rng, (4, d)), _int8(rng, (4, d)), check_banks=check)
    assert len(seen) == 8 * -(-d // DK)
    unpadded = (np.arange(8) * DK) // 16 % 8
    assert len(set(unpadded.tolist())) == 1


@pytest.mark.parametrize("case", ["random", "duplicates", "inf_norms"])
def test_key_epilogue_equals_select_plain(case):
    """Keys float(dot) * rs (rounded in f32), + norm (rounded in f32) from
    the emulated tiles, selected by (key, position) with +inf never
    entering, equal select_plain's keys and positions bit for bit."""
    rng = np.random.default_rng(len(case))
    d, b, n, k = 392, 37, 150, 20
    x = rng.standard_normal((n, d)).astype(np.float32)
    if case == "duplicates":
        x[40:110] = x[7]
    q = rng.standard_normal((b, d)).astype(np.float32)
    scale = np.abs(x).max(0) / 127.0
    codes = np.clip(np.rint(x / scale), -127, 127)
    dec = (codes * scale).astype(np.float32)
    db = torch.from_numpy(codes.astype(np.int8))
    norms = torch.from_numpy((dec * dec).sum(1).astype(np.float32))
    if case == "inf_norms":
        norms[rng.permutation(n)[: n // 2]] = torch.inf
    q_st, rs = topk_cuda.stage_queries(torch.from_numpy(q * scale), torch.int8)
    q8, x8 = q_st.numpy(), db.numpy()
    dots = np.zeros((b, n), np.int32)
    for q0 in range(0, b, QT):
        for r0 in range(0, n, RT):
            tile = block_tile(q8[q0: q0 + QT], x8[r0: r0 + RT])
            dots[q0: q0 + QT, r0: r0 + RT] = tile[: min(QT, b - q0), : min(RT, n - r0)]
    keys = (dots.astype(np.float32) * rs.numpy()[:, None]).astype(np.float32)
    keys = (keys + norms.numpy()[None, :]).astype(np.float32)
    pos = np.argsort(keys, axis=1, kind="stable")[:, :k]
    got_k = np.take_along_axis(keys, pos, 1)
    got_p = np.where(np.isinf(got_k), 2 ** 31 - 1, pos).astype(np.int32)
    want_k, want_p = topk_cuda.select_plain(q_st, db, norms, k, rs)
    np.testing.assert_array_equal(got_k, want_k.numpy())
    np.testing.assert_array_equal(got_p, want_p.numpy())
