"""IVF list-scan programs (the program layer of the JAX package's
ops/ivf_scan_pallas.py) and the plain versions of the three scan kernels.

Programs (the card route of models/ivf_flat.py):
  - `coarse_probes`: the probe step, top-nprobe of c_sq - 2 q.c (the
    kernel route's formula: no q_sq term, no clamp), ties to the lowest
    list;
  - `ivf_full_search`: probes, then the select kernel, or the dense kernel
    followed by the (distance, id) `merge_topk` — bit-identical results;
  - `ivf_sq8_search`: probes, the SQ8 query fold and row quantisation, the
    int8 dense kernel, then `_shortlist_topk` and `_canvas_rows`.

The kernels themselves are wrapped in ops/ivf_scan_cuda.py; on CPU
tensors the wrappers call the plain versions below. The shortlist
selection is always exact here (ties to the lowest scan position): the
JAX package's approx_min_k is TPU-only.
"""

from __future__ import annotations

import torch

from .distances import INT32_MAX
from .ivf_scan_cuda import ivf_scan_dense, ivf_scan_dense_int8, ivf_scan_select
from .topk import merge_topk, stable_topk

# Bytes of gathered f32 list rows one plain-version step may hold.
_PLAIN_STEP_BYTES = 256 << 20


# -- plain versions of the kernels -------------------------------------------------


def _plain_steps(probes, lists):
    """(query slice, probe rank) steps whose (b, pad, D) f32 gather stays
    under _PLAIN_STEP_BYTES."""
    b, nprobe = probes.shape
    per_query = lists.shape[1] * lists.shape[2] * 4
    chunk = max(1, _PLAIN_STEP_BYTES // max(per_query, 1))
    for q0 in range(0, b, chunk):
        for p in range(nprobe):
            yield slice(q0, min(b, q0 + chunk)), p


def scan_dense_plain(probes, queries, q_sq, lists, sqn, ids):
    """Plain version of the dense kernel: (dist, raw id), each (B,
    nprobe * pad), with dist = max((q_sq + sqn) - 2 q.x, 0) (+inf where
    id < 0). The query is rounded to the list dtype and the product
    accumulates in f32."""
    b, nprobe = probes.shape
    pad = lists.shape[1]
    qs = queries.to(lists.dtype).to(torch.float32)
    out_d = torch.empty((b, nprobe * pad), dtype=torch.float32, device=lists.device)
    out_i = torch.empty((b, nprobe * pad), dtype=torch.int32, device=lists.device)
    for rows, p in _plain_steps(probes, lists):
        lst = probes[rows, p].to(torch.int64)
        x = lists[lst].to(torch.float32)                            # (b, pad, D)
        ip = torch.bmm(x, qs[rows, :, None])[..., 0]                # (b, pad)
        d = torch.clamp_min((q_sq[rows, None] + sqn[lst]) - 2.0 * ip, 0.0)
        i = ids[lst]
        out_d[rows, p * pad : (p + 1) * pad] = torch.where(i >= 0, d, torch.inf)
        out_i[rows, p * pad : (p + 1) * pad] = i
    return out_d, out_i


def lex_topk(dists, tie_ids, k: int):
    """The k smallest (dist, tie_id) pairs per row, lexicographically,
    padded with (inf, INT32_MAX) when a row has fewer than k."""
    if dists.shape[-1] < k:
        pad = k - dists.shape[-1]
        dists = torch.nn.functional.pad(dists, (0, pad), value=torch.inf)
        tie_ids = torch.nn.functional.pad(tie_ids, (0, pad), value=INT32_MAX)
    by_id = torch.argsort(tie_ids, dim=-1, stable=True)
    dists = torch.gather(dists, -1, by_id)
    tie_ids = torch.gather(tie_ids, -1, by_id)
    by_d = torch.argsort(dists, dim=-1, stable=True)[..., :k]
    return torch.gather(dists, -1, by_d), torch.gather(tie_ids, -1, by_d)


def scan_select_plain(probes, queries, q_sq, lists, sqn, ids, k: int):
    """Plain version of the select kernel: the dense distances, then the k
    smallest by (dist, id') with id' = INT32_MAX for padding, so a masked
    row (+inf norm, real id) can fill an underfilled list while padding
    cannot; INT32_MAX comes back as -1."""
    d2, i2 = scan_dense_plain(probes, queries, q_sq, lists, sqn, ids)
    d, i = lex_topk(d2, torch.where(i2 >= 0, i2, INT32_MAX), k)
    return d, torch.where(i == INT32_MAX, -1, i)


def scan_dense_int8_plain(probes, q8, rs, codes, dec_sqn, ids):
    """Plain version of the int8 dense kernel: key = float(q8 . code) * rs +
    dec_sqn (+inf where id < 0). The int8 dot is formed in f32, exact while
    127**2 * D < 2**24; product and sum round separately, as in the
    kernel."""
    b, nprobe = probes.shape
    pad, d = codes.shape[1], codes.shape[2]
    if 127 * 127 * d >= (1 << 24):
        raise ValueError(f"int8 dot not exact in f32 at D={d}")
    qf = q8.to(torch.float32)
    out_d = torch.empty((b, nprobe * pad), dtype=torch.float32, device=codes.device)
    out_i = torch.empty((b, nprobe * pad), dtype=torch.int32, device=codes.device)
    for rows, p in _plain_steps(probes, codes):
        lst = probes[rows, p].to(torch.int64)
        ip = torch.bmm(codes[lst].to(torch.float32), qf[rows, :, None])[..., 0]
        key = ip * rs[rows, None] + dec_sqn[lst]
        i = ids[lst]
        out_d[rows, p * pad : (p + 1) * pad] = torch.where(i >= 0, key, torch.inf)
        out_i[rows, p * pad : (p + 1) * pad] = i
    return out_d, out_i


# -- programs -------------------------------------------------------------------------


def coarse_probes(queries, centroids, c_sq, nprobe: int):
    """(B, nprobe) int32 probed lists: the nprobe smallest c_sq - 2 q.c,
    ties to the lowest list (the kernel route's probe formula)."""
    coarse = c_sq[None, :] - 2.0 * (queries.to(torch.float32) @ centroids.T)
    _, probes = stable_topk(coarse, nprobe)
    return probes.to(torch.int32).contiguous()


def ivf_full_search(centroids, c_sq, list_vecs, list_sqn, list_ids, queries,
                    nprobe: int, k: int, *, dense: bool = False, qpb: int = 1):
    """Coarse probes, then the list scan: (dists (B, k), ids (B, k)) ascending
    by (distance, id), (inf, -1) in empty slots. dense=True takes the dense
    kernel and merge_topk (bit-identical distances); list_vecs may be f32 or
    bf16 (the query is then rounded to bf16)."""
    q = queries.to(torch.float32).contiguous()
    probes = coarse_probes(q, centroids, c_sq, nprobe)
    q_sq = (q * q).sum(dim=1)
    if dense:
        d2, i2 = ivf_scan_dense(probes, q, q_sq, list_vecs, list_sqn, list_ids)
        return merge_topk(d2, i2, k)
    return ivf_scan_select(probes, q, q_sq, list_vecs, list_sqn, list_ids, k, qpb)


def sq8_stage_queries(queries, dim_scale):
    """Fold the per-dimension SQ8 scale and the -2 into the queries, then
    quantise each row: rs = max(max|qs|, 1e-30) / 127, q8 = clip(rint(qs /
    rs), +-127). Returns (q8 (B, D) int8, rs (B,) f32)."""
    qs = queries.to(torch.float32) * dim_scale * -2.0
    rs = torch.clamp_min(qs.abs().amax(dim=1, keepdim=True), 1e-30) / 127.0
    q8 = torch.clamp(torch.round(qs / rs), -127, 127).to(torch.int8)
    return q8.contiguous(), rs[:, 0].contiguous()


def _shortlist_topk(d2, i2, ks: int):
    """Exact shortlist of the ks smallest keys (ties to the lowest scan
    position), padded to width ks with (inf, -1, position 0) when the scan
    is narrower. Returns (keys, ids, positions)."""
    width = d2.shape[1]
    d, pos = stable_topk(d2, min(ks, width))
    i = torch.gather(i2, 1, pos)
    if ks > width:
        pad = ks - width
        d = torch.nn.functional.pad(d, (0, pad), value=torch.inf)
        i = torch.nn.functional.pad(i, (0, pad), value=-1)
        pos = torch.nn.functional.pad(pos, (0, pad), value=0)
    return d, i, pos


def _canvas_rows(pos, probes, pad: int):
    """Bucket-store row (list * pad + slot) of each scan position."""
    lists = torch.gather(probes.to(torch.int64), 1, pos // pad)
    return (lists * pad + pos % pad).to(torch.int32)


def ivf_sq8_search(centroids, c_sq, codes, dim_scale, dec_sqn, list_ids, queries,
                   nprobe: int, ks: int, *, qpb: int | None = None):
    """Coarse probes + SQ8 dense scan -> (keys, ids, rows) shortlist, each
    (B, ks), ordered by the approximate key; `rows` are bucket-store rows
    for ops/rerank.exact_rerank_rows. qpb: queries per block of the int8
    kernel (default 8 when the batch divides by 8, as the JAX package's
    8-query steps)."""
    b = queries.shape[0]
    probes = coarse_probes(queries, centroids, c_sq, nprobe)
    q8, rs = sq8_stage_queries(queries, dim_scale)
    if qpb is None:
        qpb = 8 if b % 8 == 0 else 1
    d2, i2 = ivf_scan_dense_int8(probes, q8, rs, codes, dec_sqn, list_ids, qpb)
    d, i, pos = _shortlist_topk(d2, i2, ks)
    return d, i, _canvas_rows(pos, probes, codes.shape[1])
