"""IVF-PQ asymmetric distance computation (ADC): the non-kernel half of the
JAX package's ops/adc_pallas.py, and the plain versions of the ADC kernels.

The estimate avoids a per-probe residual table by algebra:

  d(q, item) = || (q - c) - y ||^2, summed over subspaces j, with c the
               item's coarse centroid and y_j = codebook_j[code_j]
             = ||q - c||^2                          (the coarse distance)
               - 2 * sum_j q_j . y_jc_j              (query table QD)
               + sum_j (2 c_j . y_jc_j + ||y_jc_j||^2)  (per-item constant)

so per probed item a kernel needs the probe's coarse distance, a constant
baked at build time (`build_item_constants*`), and sum_j QD[j, code_j], a
lookup into the query's (m, ksub) table.

Code canvas. The port stages codes subspace-major, (nlist, m, pad) uint8,
or (nlist, m/2, pad) nibble-packed for 4-bit codebooks (ksub == 16, even
m): subspace 2j in the low nibble of row j, 2j+1 in the high nibble. The
JAX package pads the subspace axis to 128 rows (a Mosaic tiling need);
its first m (or m/2) rows equal this canvas.

Programs (the card route of models/ivf_pq.py):
  - `adc_prologue`: the coarse matmul, the top-nprobe probes (ties to the
    lowest list) with their coarse distances clamped at 0, and the QD table
    einsum("bjd,jcd->bjc"), all left to torch as the JAX package left them
    to XLA;
  - `adc_full_search`: prologue + the select kernel;
  - `adc_dense_search`: prologue + the dense kernel + an exact shortlist
    (`stable_topk`, ties to the lowest dense column, as lax.top_k breaks
    them; the JAX package's approx_min_k is TPU-only).

Kernel contract (csrc/adc_scan.cu; plain versions below). For query b,
probe rank p, list l = probes[b, p] and slot s:
  qdot = sum_{j = 0..m-1} QD[b, j, code_j]      (added in subspace order)
  dist = max((coarse[b, p] - 2 * qdot) + const[l, s], 0), +inf where id < 0
The select kernel keeps, per query, the first k of a STABLE sort by dist
of the candidates in (probe rank, slot) order, +inf never entering and
unfilled slots (inf, -1): on exact ties the earlier probe wins, not the
lower id (the Pallas insertion rule). The dense kernel writes every
(dist, raw id) at column p * pad + s. Both take the lists' high-water
marks (hwm): the slots at or past a list's mark count as padding (id -1),
which the true marks (models/devbuild.list_hwm) leave unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from .adc_cuda import adc_scan_dense, adc_scan_select
from .select_common import ids_below_hwm
from .topk import stable_topk

# Rows of item constants one device-build step decodes at once.
_CONST_CHUNK = 65_536
# Bytes of one plain-version gather step, (queries, m, pad) f32.
_PLAIN_STEP_BYTES = 256 << 20


def packed_layout(ksub: int, m: int) -> bool:
    """True when codes stage nibble-packed (4-bit codebooks, even m)."""
    return ksub == 16 and m % 2 == 0


def kernel_shape(ksub: int, m: int) -> bool:
    """The shapes the JAX package scans with its Pallas kernels, and the
    port on the card: 8-bit codebooks, or packed 4-bit ones."""
    return ksub == 256 or packed_layout(ksub, m)


# -- build-time constants and code staging ------------------------------------------


def build_item_constants(centroids, assign, codes, codebooks, list_order, sorted_lists, slots,
                         nlist: int, pad: int):
    """Host (numpy) build of the per-item ADC constant ||x_hat||^2 - ||c||^2
    = sum_j (2 c_j . y_j + ||y_j||^2), scattered into the (nlist, pad)
    list layout; the JAX package's arithmetic, term by term."""
    n, m = codes.shape
    dsub = codebooks.shape[2]
    cent_sub = centroids.reshape(centroids.shape[0], m, dsub)
    const = np.zeros((n,), np.float32)
    for j in range(m):
        y = codebooks[j][codes[:, j]]
        c_j = cent_sub[assign, j]
        const += 2.0 * np.einsum("nd,nd->n", c_j, y) + np.einsum("nd,nd->n", y, y)
    out = np.zeros((nlist, pad), np.float32)
    out[sorted_lists, slots] = const[list_order]
    return out


def build_item_constants_device(centroids, assign, codes, codebooks, list_order, sorted_lists,
                                slots, nlist: int, pad: int):
    """The same constant from tensors on their device, in chunks of
    _CONST_CHUNK rows (the (chunk, m, dsub) decode never exists for the
    whole corpus): sum over (j, d) of (2 c + y) * y. Returns (nlist, pad)
    f32 on the device."""
    n, m = codes.shape
    dsub = codebooks.shape[2]
    cent_sub = centroids.to(torch.float32).reshape(centroids.shape[0], m, dsub)
    sub = torch.arange(m, device=codes.device)[None, :]
    const = torch.empty((n,), dtype=torch.float32, device=codes.device)
    for s0 in range(0, n, _CONST_CHUNK):
        c_j = cent_sub[assign[s0 : s0 + _CONST_CHUNK].long()]
        y = codebooks[sub, codes[s0 : s0 + _CONST_CHUNK].long()]
        const[s0 : s0 + _CONST_CHUNK] = ((2.0 * c_j + y) * y).sum(dim=(1, 2))
    out = torch.zeros((nlist, pad), dtype=torch.float32, device=codes.device)
    out[sorted_lists, slots] = const[list_order]
    return out


def pack_nibbles(canvas):
    """(nlist, m, pad) 4-bit codes -> (nlist, m/2, pad): subspace 2j in the
    low nibble of row j, 2j+1 in the high nibble. numpy or torch."""
    return canvas[:, 0::2, :] | (canvas[:, 1::2, :] << 4)


def stage_codes_device(list_codes, m: int, ksub: int):
    """(nlist, pad, m) uint8 codes -> the kernels' subspace-major canvas
    (nlist, m, pad), nibble-packed to (nlist, m/2, pad) for 4-bit codes."""
    canvas = list_codes.transpose(1, 2)
    if packed_layout(ksub, m):
        canvas = pack_nibbles(canvas)
    return canvas.contiguous()


def unstage_codes_device(canvas, m: int, ksub: int):
    """Inverse of stage_codes_device: canvas -> (nlist, pad, m) uint8."""
    if packed_layout(ksub, m):
        nlist, _, pad = canvas.shape
        canvas = torch.stack([canvas & 15, canvas >> 4], dim=2).reshape(nlist, m, pad)
    return canvas.transpose(1, 2).contiguous()


# -- plain versions of the kernels -------------------------------------------------


def _unpacked(codes, m: int, packed: bool):
    """(b, m or m/2, pad) canvas rows -> (b, m, pad) int64 codes."""
    if packed:
        b, _, pad = codes.shape
        codes = torch.stack([codes & 15, codes >> 4], dim=2).reshape(b, m, pad)
    return codes.long()


def adc_dense_plain(probes, probe_coarse, qd, codes, item_const, ids, packed: bool, hwm=None):
    """Plain version of the dense kernel: (dist, raw id), each (B, nprobe *
    pad), with the kernel's arithmetic (qdot summed in subspace order, then
    (coarse - 2 qdot) + const, clamped at 0, +inf where id < 0). Slots at
    or past hwm are padding."""
    ids = ids_below_hwm(ids, hwm)
    b, nprobe = probes.shape
    m = qd.shape[1]
    pad = codes.shape[2]
    out_d = torch.empty((b, nprobe * pad), dtype=torch.float32, device=codes.device)
    out_i = torch.empty((b, nprobe * pad), dtype=torch.int32, device=codes.device)
    chunk = max(1, _PLAIN_STEP_BYTES // (m * pad * 8))
    for q0 in range(0, b, chunk):
        rows = slice(q0, min(b, q0 + chunk))
        for p in range(nprobe):
            lst = probes[rows, p].long()
            vals = torch.gather(qd[rows], 2, _unpacked(codes[lst], m, packed))  # (b, m, pad)
            qdot = torch.zeros(vals.shape[0], pad, dtype=torch.float32, device=codes.device)
            for j in range(m):
                qdot = qdot + vals[:, j]
            dist = (probe_coarse[rows, p, None] - 2.0 * qdot) + item_const[lst]
            i = ids[lst]
            cols = slice(p * pad, (p + 1) * pad)
            out_d[rows, cols] = torch.where(i >= 0, torch.clamp_min(dist, 0.0), torch.inf)
            out_i[rows, cols] = i
    return out_d, out_i


def adc_select_plain(probes, probe_coarse, qd, codes, item_const, ids, k: int, packed: bool,
                     hwm=None):
    """Plain version of the select kernel: the dense estimates, then the
    first k of a stable sort by distance in (probe rank, slot) order;
    +inf candidates never enter (unfilled slots are (inf, -1)). Slots at
    or past hwm are padding."""
    d2, i2 = adc_dense_plain(probes, probe_coarse, qd, codes, item_const, ids, packed, hwm=hwm)
    if d2.shape[1] < k:
        extra = k - d2.shape[1]
        d2 = torch.nn.functional.pad(d2, (0, extra), value=torch.inf)
        i2 = torch.nn.functional.pad(i2, (0, extra), value=-1)
    order = torch.argsort(d2, dim=1, stable=True)[:, :k]
    d = torch.gather(d2, 1, order)
    i = torch.gather(i2, 1, order)
    return d, torch.where(torch.isinf(d), -1, i)


# -- programs ---------------------------------------------------------------------------


def adc_prologue(queries, centroids, c_sq, codebooks, nprobe: int):
    """(probes (B, nprobe) int32, probe_coarse (B, nprobe) f32, qd (B, m,
    ksub) f32): the top-nprobe lists by q_sq + c_sq - 2 q.c (ties to the
    lowest list), their coarse distances clamped at 0, and the query dot
    table QD[b, j, c] = q_bj . codebook_jc."""
    q = queries.to(torch.float32)
    b = q.shape[0]
    m, _, dsub = codebooks.shape
    coarse = (q * q).sum(dim=1, keepdim=True) + c_sq[None, :] - 2.0 * (q @ centroids.T)
    top, probes = stable_topk(coarse, nprobe)
    qd = torch.einsum("bjd,jcd->bjc", q.reshape(b, m, dsub), codebooks)
    return (probes.to(torch.int32).contiguous(), torch.clamp_min(top, 0.0).contiguous(),
            qd.contiguous())


def adc_full_search(centroids, c_sq, codebooks, canvas, item_const, list_ids, queries,
                    nprobe: int, k: int, *, hwm=None):
    """Prologue + select kernel: (dists (B, k), ids (B, k)) by the stable
    (probe order) rule of the module doc. hwm: the lists' high-water marks
    (models/devbuild.list_hwm of list_ids), where the kernel stops; None
    scans to pad."""
    m, ksub = codebooks.shape[0], codebooks.shape[1]
    probes, pc, qd = adc_prologue(queries, centroids, c_sq, codebooks, nprobe)
    return adc_scan_select(probes, pc, qd, canvas, item_const, list_ids, k,
                           packed=packed_layout(ksub, m), hwm=hwm)


def adc_dense_search(centroids, c_sq, codebooks, canvas, item_const, list_ids, queries,
                     nprobe: int, k_adc: int, *, qps_step: int | None = None,
                     return_rows: bool = False, hwm=None):
    """Prologue + dense kernel + exact shortlist of min(k_adc, nprobe * pad)
    columns: (dists, ids[, bucket rows list * pad + slot]). qps_step: the
    JAX package's queries per grid step, the kernel's `qpb`; None takes 8
    when the batch divides by 8 and m <= 96, else 1 (the JAX package's
    entry rule). hwm: the lists' high-water marks, where the kernel stops
    (None scans to pad)."""
    m, ksub = codebooks.shape[0], codebooks.shape[1]
    b = queries.shape[0]
    pad = canvas.shape[2]
    if qps_step is None:
        qps_step = 8 if b % 8 == 0 and m <= 96 else 1
    probes, pc, qd = adc_prologue(queries, centroids, c_sq, codebooks, nprobe)
    dense_d, dense_i = adc_scan_dense(probes, pc, qd, canvas, item_const, list_ids,
                                      packed=packed_layout(ksub, m), qpb=qps_step, hwm=hwm)
    d_top, pos = stable_topk(dense_d, min(k_adc, dense_d.shape[1]))
    top_i = torch.gather(dense_i, 1, pos)
    if return_rows:
        rows = torch.gather(probes.long(), 1, pos // pad) * pad + pos % pad
        return d_top, top_i, rows.to(torch.int32)
    return d_top, top_i
