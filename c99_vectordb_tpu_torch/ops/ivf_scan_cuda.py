"""IVF list scans: wrappers of the hand-written Hopper kernels.

The CUDA source is csrc/ivf_scan.cu (three kernels replacing the five
Pallas kernels of the JAX package's ops/ivf_scan_pallas.py);
ops/cuda_build.py compiles it with nvcc for sm_90a on first use and loads
it with ctypes. Each wrapper takes the plain version (ops/ivf_scan.py)
for CPU tensors only; on a CUDA tensor it launches its kernel or raises.
Each wrapper counts its launches in `<wrapper>.launches`.

  - `ivf_scan_select(probes, queries, q_sq, lists, sqn, ids, k, qpb=1)`:
    per query, the k nearest (dist, id) over its probed lists, lowest id
    first on ties, (inf, -1) in unfilled slots (rows 2 and 3 of the
    kernel table: `_ivf_scan_kernel`, `_ivf_scan_kernel_multi`);
  - `ivf_scan_dense(probes, queries, q_sq, lists, sqn, ids)`: every
    probed slot's distance and raw id, (B, nprobe * pad)
    (`_ivf_scan_kernel_dense`);
  - `ivf_scan_dense_int8(probes, q8, rs, codes, dec_sqn, ids, qpb=1)`:
    every probed slot's SQ8 key and raw id (`_ivf_scan_kernel_dense_int8`,
    `_ivf_scan_kernel_dense_int8_multi`).

Operands: probes (B, nprobe) int32; queries (B, D) f32, unstaged; q_sq (B,)
f32; lists (nlist, pad, D) f32 or bf16 (codes int8, D % 4 == 0); sqn/
dec_sqn (nlist, pad) f32; ids (nlist, pad) int32 with -1 padding; q8 (B, D)
int8 with per-row scales rs (B,) f32. All contiguous, on one device.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _load() -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load("ivf_scan", "ivf_scan_abi_version", 1, {
        "ivf_scan_select": ([ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp], ci),
        "ivf_scan_dense": ([ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp, vp, vp], ci),
        "ivf_scan_dense_int8": ([vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp], ci),
    })


def _check(name, probes, rows, lists, list_aux, want_lists):
    """Shared operand checks: devices, dtypes, shapes, contiguity."""
    dev = lists.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if lists.dtype not in want_lists:
        raise TypeError(f"{name}: unsupported list dtype {lists.dtype}")
    if lists.ndim != 3:
        raise ValueError(f"{name}: lists must be (nlist, pad, D)")
    nlist, pad, d = lists.shape
    b, nprobe = probes.shape
    if probes.dtype != torch.int32:
        raise TypeError(f"{name}: probes must be int32")
    for t, shape, dtype in rows:
        if t.shape != shape(b, d) or t.dtype != dtype:
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape(b, d)} {dtype}")
    sqn, ids = list_aux
    if sqn.shape != (nlist, pad) or sqn.dtype != torch.float32:
        raise ValueError(f"{name}: norms must be (nlist, pad) float32")
    if ids.shape != (nlist, pad) or ids.dtype != torch.int32:
        raise ValueError(f"{name}: ids must be (nlist, pad) int32")
    for t in [probes, lists, sqn, ids] + [r[0] for r in rows]:
        if t.device != dev:
            raise ValueError(f"{name}: all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return b, nprobe, nlist, pad, d


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def ivf_scan_select(probes, queries, q_sq, lists, sqn, ids, k: int, qpb: int = 1):
    """The k nearest (dist (B, k) f32, ids (B, k) int32) per query over its
    probed lists (see the module doc)."""
    if lists.device.type == "cpu":
        from .ivf_scan import scan_select_plain

        return scan_select_plain(probes, queries, q_sq, lists, sqn, ids, k)
    b, nprobe, _, pad, d = _check(
        "ivf_scan_select", probes,
        [(queries, lambda b, d: (b, d), torch.float32), (q_sq, lambda b, d: (b,), torch.float32)],
        lists, (sqn, ids), _DTYPE_CODE)
    if k < 1 or qpb < 1:
        raise ValueError(f"ivf_scan_select: need k >= 1 and qpb >= 1 (k={k}, qpb={qpb})")
    out_d = torch.empty((b, k), dtype=torch.float32, device=lists.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=lists.device)
    if b == 0:
        return out_d, out_i
    lib = _load()
    with torch.cuda.device(lists.device):
        err = lib.ivf_scan_select(
            _DTYPE_CODE[lists.dtype], probes.data_ptr(), queries.data_ptr(), q_sq.data_ptr(),
            lists.data_ptr(), sqn.data_ptr(), ids.data_ptr(), b, nprobe, pad, d, k, qpb,
            out_d.data_ptr(), out_i.data_ptr(), _stream(lists.device))
    if err != 0:
        raise RuntimeError(f"ivf_scan_select launch failed: CUDA error {err}")
    ivf_scan_select.launches += 1
    return out_d, out_i


ivf_scan_select.launches = 0


def ivf_scan_dense(probes, queries, q_sq, lists, sqn, ids):
    """Every probed slot's (dist, raw id), each (B, nprobe * pad)."""
    if lists.device.type == "cpu":
        from .ivf_scan import scan_dense_plain

        return scan_dense_plain(probes, queries, q_sq, lists, sqn, ids)
    b, nprobe, _, pad, d = _check(
        "ivf_scan_dense", probes,
        [(queries, lambda b, d: (b, d), torch.float32), (q_sq, lambda b, d: (b,), torch.float32)],
        lists, (sqn, ids), _DTYPE_CODE)
    out_d = torch.empty((b, nprobe * pad), dtype=torch.float32, device=lists.device)
    out_i = torch.empty((b, nprobe * pad), dtype=torch.int32, device=lists.device)
    if b == 0:
        return out_d, out_i
    lib = _load()
    with torch.cuda.device(lists.device):
        err = lib.ivf_scan_dense(
            _DTYPE_CODE[lists.dtype], probes.data_ptr(), queries.data_ptr(), q_sq.data_ptr(),
            lists.data_ptr(), sqn.data_ptr(), ids.data_ptr(), b, nprobe, pad, d,
            out_d.data_ptr(), out_i.data_ptr(), _stream(lists.device))
    if err != 0:
        raise RuntimeError(f"ivf_scan_dense launch failed: CUDA error {err}")
    ivf_scan_dense.launches += 1
    return out_d, out_i


ivf_scan_dense.launches = 0


def ivf_scan_dense_int8(probes, q8, rs, codes, dec_sqn, ids, qpb: int = 1):
    """Every probed slot's SQ8 key float(q8 . code) * rs + dec_sqn and raw
    id, each (B, nprobe * pad)."""
    if codes.device.type == "cpu":
        from .ivf_scan import scan_dense_int8_plain

        return scan_dense_int8_plain(probes, q8, rs, codes, dec_sqn, ids)
    b, nprobe, _, pad, d = _check(
        "ivf_scan_dense_int8", probes,
        [(q8, lambda b, d: (b, d), torch.int8), (rs, lambda b, d: (b,), torch.float32)],
        codes, (dec_sqn, ids), (torch.int8,))
    if d % 4 != 0 or q8.data_ptr() % 4 or codes.data_ptr() % 4:
        raise ValueError(f"ivf_scan_dense_int8: needs D % 4 == 0 and 4-byte aligned rows (D={d})")
    if qpb < 1:
        raise ValueError(f"ivf_scan_dense_int8: qpb must be >= 1 (got {qpb})")
    out_d = torch.empty((b, nprobe * pad), dtype=torch.float32, device=codes.device)
    out_i = torch.empty((b, nprobe * pad), dtype=torch.int32, device=codes.device)
    if b == 0:
        return out_d, out_i
    lib = _load()
    with torch.cuda.device(codes.device):
        err = lib.ivf_scan_dense_int8(
            probes.data_ptr(), q8.data_ptr(), rs.data_ptr(), codes.data_ptr(),
            dec_sqn.data_ptr(), ids.data_ptr(), b, nprobe, pad, d, qpb,
            out_d.data_ptr(), out_i.data_ptr(), _stream(codes.device))
    if err != 0:
        raise RuntimeError(f"ivf_scan_dense_int8 launch failed: CUDA error {err}")
    ivf_scan_dense_int8.launches += 1
    return out_d, out_i


ivf_scan_dense_int8.launches = 0
