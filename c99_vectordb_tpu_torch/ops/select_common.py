"""What the IVF and ADC select wrappers share (ops/ivf_scan_cuda.py,
ops/adc_cuda.py, and their plain versions in ops/ivf_scan.py, ops/adc.py).

Both select kernels run a (query block, probe group) grid and merge each
query's G partial lists exactly (csrc/select_merge.cuh); both stop each
list at its high-water mark, as the dense kernels (ADC, IVF) do on the
same grid without a merge. This module holds the host side of that: the
high-water mark as the plain versions apply it, the choice of G from the
kernel's occupancy (and of the IVF dense kernels' row splits), the
operand check of the marks and the scratch of the partial lists.
"""

from __future__ import annotations

import functools

import torch

# The select grids aim at this many waves of the blocks that fit on the
# card at once (the occupancy query's blocks per SM times the SMs), cut
# into contiguous probe groups: more, smaller groups balance probed lists
# of unequal length (the IVF and ADC kernels both ran fastest with 8-16
# groups on the 1M paths' own operands, PERF.md).
SELECT_WAVES = 4
# Rows of a list that one tile of the IVF dense kernels holds, and the
# most tiles of a full list that one of their blocks takes (row_splits).
DENSE_TILE_ROWS = 32
DENSE_SPLIT_TILES = 6


def ids_below_hwm(ids, hwm):
    """(nlist, pad) ids with every slot at or past its list's high-water
    mark hwm (nlist,) turned into padding (-1); ids as they are when hwm
    is None. What a select kernel that stops at the mark sees."""
    if hwm is None:
        return ids
    slot = torch.arange(ids.shape[1], device=ids.device)
    return torch.where(slot[None, :] < hwm.to(slot.dtype)[:, None], ids, -1)


@functools.cache
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def probe_groups(b: int, nprobe: int, qpb: int, blocks_per_sm: int, sms: int, max_groups: int,
                 groups: int | None = None) -> int:
    """The number G of contiguous probe groups of `ceil(nprobe / G)` ranks
    each that a select grid of ceil(b / qpb) query blocks splits into. None
    asks for SELECT_WAVES waves of `blocks_per_sm * sms` resident blocks: the
    smallest G that reaches them and cuts the probes into equal groups (a
    block's time follows its group's size). G is then cut to nprobe, to
    `max_groups` (what the merge's shared memory holds, from the kernel's
    occupancy query), and to the count that groups of ceil(nprobe / G)
    ranks give."""
    if groups is None:
        query_blocks = -(-b // qpb)
        want = -(-SELECT_WAVES * blocks_per_sm * sms // query_blocks)
        groups = next(g for g in range(min(max(want, 1), nprobe), nprobe + 1) if nprobe % g == 0)
    g = max(1, min(int(groups), nprobe, max_groups))
    per = -(-nprobe // g)
    return -(-nprobe // per)


def row_splits(blocks: int, blocks_per_sm: int, sms: int, list_tiles: int,
               splits: int | None = None) -> int:
    """The number S of row splits of an IVF dense grid of `blocks` (query,
    probe group) blocks: block split s takes row tiles s, s + S, ... of
    each list. None asks for enough splits that a full list (`list_tiles`
    tiles: pad rows) takes at most DENSE_SPLIT_TILES tiles per block, and
    for SELECT_WAVES waves of `blocks_per_sm * sms` resident blocks, as
    probe_groups does. The longest lists set a dense grid's time, and list
    lengths are skewed (pad is set by the longest list). S is cut to
    `list_tiles` and to the grid's 65535."""
    if splits is None:
        splits = max(-(-list_tiles // DENSE_SPLIT_TILES),
                     -(-SELECT_WAVES * blocks_per_sm * sms // max(blocks, 1)))
    return max(1, min(int(splits), list_tiles, 65535))


def select_plan(occupancy, b: int, nprobe: int, k: int, qpb: int, device,
                groups: int | None = None) -> dict:
    """How a select kernel launches on `device`: probe groups, blocks,
    blocks per SM, SMs, where the running lists live. occupancy(device
    index) gives the kernel's (blocks per SM, lists in shared memory, most
    groups the merge holds) at these shapes."""
    dev = torch.device(device)
    per_sm, in_smem, max_groups = occupancy(dev.index or 0)
    sms = sm_count(dev.index or 0)
    g = probe_groups(b, nprobe, qpb, per_sm, sms, max_groups, groups)
    return {"groups": g, "blocks": -(-b // qpb) * g, "blocks_per_sm": per_sm, "sms": sms,
            "lists_in_smem": in_smem}


def check_hwm(name, hwm, nlist: int, dev) -> None:
    """hwm must be None or a contiguous (nlist,) int32 tensor on dev."""
    if hwm is None:
        return
    if hwm.shape != (nlist,) or hwm.dtype != torch.int32:
        raise ValueError(f"{name}: hwm must be (nlist,) int32")
    if hwm.device != dev or not hwm.is_contiguous():
        raise ValueError(f"{name}: hwm must be contiguous, on the lists' device")


def select_scratch(b: int, groups: int, k: int, lists_in_smem: bool, dev) -> tuple[list, object]:
    """The data pointers of the select launch's scratch (part_d, part_t,
    work_d, work_t), each (B, G, K) of 4-byte entries: part when G > 1, work
    when the running lists do not fit in shared memory; None (a null
    pointer) where not needed. All of it is one allocation. Returns
    [pointers, buffer]: keep the buffer alive until the launch is queued."""
    need = [groups > 1] * 2 + [not lists_in_smem] * 2
    n = b * groups * k
    buf = torch.empty((sum(need) * n,), dtype=torch.int32, device=dev) if any(need) else None
    ptrs, off = [], 0
    for used in need:
        ptrs.append(buf.data_ptr() + off * 4 if used else None)
        off += n if used else 0
    return ptrs, buf
