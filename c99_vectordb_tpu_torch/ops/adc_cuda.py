"""IVF-PQ ADC scans: wrappers of the hand-written Hopper kernels.

The CUDA source is csrc/adc_scan.cu (two kernels replacing the three Pallas
kernels of the JAX package's ops/adc_pallas.py); ops/cuda_build.py
compiles it with nvcc for sm_90a on first use and loads it with ctypes.
Each wrapper takes the plain version (ops/adc.py) for CPU tensors only; on
a CUDA tensor it launches its kernel or raises. Each wrapper counts its
launches in `<wrapper>.launches`; the dense one also by queries per block
in `adc_scan_dense.launches_by_qpb`.

  - `adc_scan_select(probes, probe_coarse, qd, codes, item_const, ids, k,
    packed, hwm=None)`: per query, the first k candidates of a stable
    sort by the ADC estimate in (probe rank, slot) order, (inf, -1) in
    unfilled slots (row 7 of the kernel table: `_adc_kernel`). hwm
    (nlist,) int32: each list's high-water mark (slots at or past it are
    padding and are not read); None = pad. The probes split into
    contiguous groups, each scanned by its own block, then merged exactly
    (select kernel + merge, one counted launch); the group count comes
    from the kernel's occupancy as the IVF select kernel's does
    (ops/select_common.probe_groups; tests force it with `_groups`);
  - `adc_scan_dense(..., packed, qpb=1, hwm=None)`: every probed slot's
    estimate and raw id, (B, nprobe * pad) (`_adc_dense_kernel` at qpb 1,
    `_adc_dense_kernel_multi` at qpb 8: the JAX package's queries per grid
    step, kept as the keyword that counts launches; the kernel's grid is
    (query, probe group) whatever it is). The slots at or past hwm come
    back as (+inf, -1) unread. Its probe groups come from its occupancy
    like the select kernel's (tests force them with `_groups`).

Operands: probes (B, nprobe) int32; probe_coarse (B, nprobe) f32; qd (B,
m, ksub) f32; codes (nlist, m, pad) uint8, or (nlist, m/2, pad)
nibble-packed when packed (ksub == 16, even m); item_const (nlist, pad)
f32 (+inf excludes a row); ids (nlist, pad) int32 with -1 padding. All
contiguous, on one device; ksub <= 256.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build, select_common


def signatures() -> dict:
    """{exported function: (argtypes, restype)} of csrc/adc_scan.cu."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return {
        "adc_select_occupancy": ([ci, ci, ci, ci, vp], ci),
        "adc_scan_select": ([vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                             vp, vp, vp, vp, vp, vp, vp], ci),
        "adc_dense_occupancy": ([ci, ci, ci, vp], ci),
        "adc_scan_dense": ([vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp, vp, vp],
                           ci),
    }


def _load() -> ctypes.CDLL:
    return cuda_build.load("adc_scan", "adc_scan_abi_version", 3, signatures())


def _check(name, probes, probe_coarse, qd, codes, item_const, ids, packed: bool):
    """Devices, dtypes, shapes and contiguity; returns (B, nprobe, pad, m,
    ksub)."""
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if codes.dtype != torch.uint8 or codes.ndim != 3:
        raise TypeError(f"{name}: codes must be (nlist, rows, pad) uint8")
    if probes.dtype != torch.int32 or probes.ndim != 2:
        raise TypeError(f"{name}: probes must be (B, nprobe) int32")
    b, nprobe = probes.shape
    if qd.dtype != torch.float32 or qd.ndim != 3 or qd.shape[0] != b:
        raise ValueError(f"{name}: qd must be (B, m, ksub) float32")
    m, ksub = qd.shape[1], qd.shape[2]
    nlist, rows, pad = codes.shape
    if packed and (ksub != 16 or m % 2):
        raise ValueError(f"{name}: packed codes need ksub 16 and even m (m={m}, ksub={ksub})")
    if not 1 <= ksub <= 256:
        raise ValueError(f"{name}: ksub must be in 1..256 (got {ksub})")
    if rows != (m // 2 if packed else m):
        raise ValueError(f"{name}: codes have {rows} subspace rows for m={m}, packed={packed}")
    if probe_coarse.shape != (b, nprobe) or probe_coarse.dtype != torch.float32:
        raise ValueError(f"{name}: probe_coarse must be (B, nprobe) float32")
    if item_const.shape != (nlist, pad) or item_const.dtype != torch.float32:
        raise ValueError(f"{name}: item_const must be (nlist, pad) float32")
    if ids.shape != (nlist, pad) or ids.dtype != torch.int32:
        raise ValueError(f"{name}: ids must be (nlist, pad) int32")
    for t in (probes, probe_coarse, qd, codes, item_const, ids):
        if t.device != dev:
            raise ValueError(f"{name}: all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return b, nprobe, pad, m, ksub


@functools.cache
def _select_occupancy(m: int, ksub: int, packed: bool, k: int,
                      device_index: int) -> tuple[int, bool, int]:
    lib = _load()
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device_index):
        err = lib.adc_select_occupancy(m, ksub, int(packed), k, out)
    if err != 0:
        raise RuntimeError(f"adc_select_occupancy failed: CUDA error {err}")
    return max(1, out[0]), bool(out[1]), out[2]


def select_plan(b: int, nprobe: int, m: int, ksub: int, packed: bool, k: int, device,
                _groups: int | None = None) -> dict:
    """How `adc_scan_select` launches on `device` for these shapes: probe
    groups, blocks, blocks per SM (occupancy query), SMs, where the running
    lists live (ops/select_common.select_plan)."""
    return select_common.select_plan(
        lambda index: _select_occupancy(m, ksub, bool(packed), k, index), b, nprobe, k, 1,
        device, _groups)


@functools.cache
def _dense_occupancy(m: int, ksub: int, packed: bool, device_index: int) -> int:
    lib = _load()
    out = (ctypes.c_int * 1)()
    with torch.cuda.device(device_index):
        err = lib.adc_dense_occupancy(m, ksub, int(packed), out)
    if err != 0:
        raise RuntimeError(f"adc_dense_occupancy failed: CUDA error {err}")
    return max(1, out[0])


def dense_plan(b: int, nprobe: int, m: int, ksub: int, packed: bool, device,
               _groups: int | None = None) -> dict:
    """How `adc_scan_dense` launches on `device` for these shapes: probe
    groups (no merge, so up to nprobe), blocks, blocks per SM (occupancy
    query), SMs."""
    index = torch.device(device).index or 0
    per_sm = _dense_occupancy(m, ksub, bool(packed), index)
    sms = select_common.sm_count(index)
    g = select_common.probe_groups(b, nprobe, 1, per_sm, sms, nprobe, _groups)
    return {"groups": g, "blocks": b * g, "blocks_per_sm": per_sm, "sms": sms}


def adc_scan_select(probes, probe_coarse, qd, codes, item_const, ids, k: int, packed: bool,
                    hwm=None, _groups: int | None = None):
    """The first k (dist (B, k) f32, ids (B, k) int32) per query (see the
    module doc)."""
    if codes.device.type == "cpu":
        from .adc import adc_select_plain

        return adc_select_plain(probes, probe_coarse, qd, codes, item_const, ids, k, packed,
                                hwm=hwm)
    b, nprobe, pad, m, ksub = _check("adc_scan_select", probes, probe_coarse, qd, codes,
                                     item_const, ids, packed)
    select_common.check_hwm("adc_scan_select", hwm, codes.shape[0], codes.device)
    if k < 1:
        raise ValueError(f"adc_scan_select: k must be >= 1 (got {k})")
    if nprobe * pad > 0x7FFFFFFF:
        raise ValueError(f"adc_scan_select: nprobe * pad must fit int32 ({nprobe} * {pad})")
    dev = codes.device
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    lib = _load()
    plan = select_plan(b, nprobe, m, ksub, packed, k, dev, _groups)
    g = plan["groups"]
    scratch, _keep = select_common.select_scratch(b, g, k, plan["lists_in_smem"], dev)
    with torch.cuda.device(dev):
        err = lib.adc_scan_select(
            probes.data_ptr(), probe_coarse.data_ptr(), qd.data_ptr(), codes.data_ptr(),
            item_const.data_ptr(), ids.data_ptr(), None if hwm is None else hwm.data_ptr(), b,
            nprobe, pad, m, ksub, int(packed), k, g, *scratch, out_d.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adc_scan_select launch failed: CUDA error {err}")
    adc_scan_select.launches += 1
    return out_d, out_i


adc_scan_select.launches = 0


def adc_scan_dense(probes, probe_coarse, qd, codes, item_const, ids, packed: bool, qpb: int = 1,
                   hwm=None, _groups: int | None = None):
    """Every probed slot's (estimate, raw id), each (B, nprobe * pad)."""
    if codes.device.type == "cpu":
        from .adc import adc_dense_plain

        return adc_dense_plain(probes, probe_coarse, qd, codes, item_const, ids, packed, hwm=hwm)
    b, nprobe, pad, m, ksub = _check("adc_scan_dense", probes, probe_coarse, qd, codes,
                                     item_const, ids, packed)
    select_common.check_hwm("adc_scan_dense", hwm, codes.shape[0], codes.device)
    if qpb < 1:
        raise ValueError(f"adc_scan_dense: qpb must be >= 1 (got {qpb})")
    dev = codes.device
    out_d = torch.empty((b, nprobe * pad), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, nprobe * pad), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    lib = _load()
    g = dense_plan(b, nprobe, m, ksub, packed, dev, _groups)["groups"]
    with torch.cuda.device(dev):
        err = lib.adc_scan_dense(
            probes.data_ptr(), probe_coarse.data_ptr(), qd.data_ptr(), codes.data_ptr(),
            item_const.data_ptr(), ids.data_ptr(), None if hwm is None else hwm.data_ptr(), b,
            nprobe, pad, m, ksub, int(packed), g, out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adc_scan_dense launch failed: CUDA error {err}")
    adc_scan_dense.launches += 1
    adc_scan_dense.launches_by_qpb[qpb] = adc_scan_dense.launches_by_qpb.get(qpb, 0) + 1
    return out_d, out_i


adc_scan_dense.launches = 0
adc_scan_dense.launches_by_qpb = {}
