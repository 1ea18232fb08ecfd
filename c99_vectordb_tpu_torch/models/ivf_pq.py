"""IVF-PQ index — product-quantized codes with ADC search.

Counterpart of the JAX package's models/ivf_pq.py. Vectors are encoded as m
codes of per-subspace residual codebooks (ksub centroids each), so the
database is m bytes per vector (m/2 for 4-bit codebooks); the coarse
quantizer and the codebooks train with ops/kmeans.py. refine=True keeps
the raw vectors and re-ranks the ADC top-(k * refine_factor) exactly;
opq=True learns an orthogonal rotation before quantization (OPQ).

Storage modes (models/devbuild.py), as in models/ivf_flat.py: numpy
inputs keep host-mode mirrors; a tensor as the first input puts the index
in DEVICE mode, where training, encoding, bucketing, item constants and
the refine store build on the index's device, and after staging the code
canvas and the refine store ARE the storage. Rows added after staging are
encoded at once, their raw rows written into the refine store in place,
and their ADC reconstructions parked in a device tail that search scores
by the same estimator (the exact distance to the reconstruction) and
merges into the shortlist; past tail_restage_threshold a restage rebuilds
the lists. Where the JAX package donates buffers to update the refine
store, the port writes into the same tensors in place (index assignment).

Search has two routes, chosen by the device (explicit in
`_search(..., card_route=)`):
  - the card route (the JAX package's TPU branch), for 8-bit codebooks
    or nibble-packed 4-bit ones: the ADC prologue, then the select kernel,
    or, when refine is on and the shortlist is deeper than 256, the dense
    kernel and an exact shortlist (ops/adc.py); masked ids are scrubbed
    from the shortlist; ties follow the kernels' probe order;
  - the CPU route (`_adc_search_program` in the JAX package): per probe
    rank the direct lookup table sum_j ||r_j - y_j||^2 of the residual and
    a merge_topk, ties by (distance, id). The JAX package takes this route
    on the TPU for other codebook sizes, and so does the port on the card.
The tail merge and the exact rerank follow either route. The two routes
round and break ties differently by design.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..constants import DIM
from ..ops.adc import (
    adc_dense_search,
    adc_full_search,
    build_item_constants,
    build_item_constants_device,
    kernel_shape,
    pack_nibbles,
    packed_layout,
    stage_codes_device,
    unstage_codes_device,
)
from ..ops.distances import (INT32_MAX, query_rows, ranked_many_program, ranked_program,
                             scores_via_matmul, sort_by_dist_id)
from ..ops.kmeans import assign_clusters, assign_clusters_multi, train_kmeans, train_kmeans_multi
from ..ops.rerank import build_id_lookup, exact_rerank_staged
from ..ops.topk import merge_topk, stable_topk
from ..utils.runtime import resolve_device
from .base import list_pad, next_pow2
from .devbuild import (
    ChunkStore,
    GrowTail,
    MaskCache,
    apply_removal,
    bucketize_device,
    build_id_lookup_device,
    capped_assign,
    capped_assign_incremental,
    corpus_geometry,
    is_device_array,
    keep_of,
    list_hwm,
    mask_norms,
    mask_shortlist_ids,
    merge_tail,
    removal_table,
    scatter_list_ids_device,
    scatter_lists_device,
    tail_restage_threshold,
    tail_scores,
)
from .ivf_flat import IVFFlatIndex, _extract_rows
from .registry import register

LANE_K = 128  # shortlists deeper than 2 * LANE_K take the dense ADC kernel

# Bytes of one CPU-route (or pure-code ranking) lookup-table step.
_CPU_STEP_BYTES = 128 << 20

_ORPHAN_MSG = ("retraining a refine=False IVFPQIndex that holds rows would orphan its codes "
               "(raw vectors are not retained); build a fresh index instead")


def _residual_subs(data, centroids, assign, m: int):
    """(n, D) rows minus their list centroids, as (m, n, dsub) subspaces."""
    n, dim = data.shape
    res = data - centroids[assign.long()]
    return res.reshape(n, m, dim // m).transpose(0, 1).contiguous()


def _decode_recon(codes, assign, centroids, codebooks):
    """codes (n, m) + assign -> centroid[a] + decode(codes), the
    reconstruction in the quantization space: its exact distance to a
    (rotated) query IS the ADC estimate, which keeps the tail faithful to
    a fresh build."""
    n, m = codes.shape
    sub = torch.arange(m, device=codes.device)[None, :]
    y = codebooks[sub, codes.long()]                       # (n, m, dsub)
    return centroids[assign.long()] + y.reshape(n, -1)


def train_opq_rotation(data, m: int, *, ksub: int = 256, iters: int = 8, seed: int = 0,
                       device=None) -> np.ndarray:
    """Learn an orthogonal OPQ rotation R (x_rot = x @ R) by alternating
    minimization (Ge et al., 'Optimized Product Quantization', the
    non-parametric variant): fix R -> train per-subspace codebooks on X R;
    fix codebooks -> R = U V^T from svd(X^T Y), Y = decode(encode(X R)),
    the orthogonal Procrustes solution. The matmuls run on the device in
    f32 (TF32 off); the (D, D) SVD runs on the host in numpy, as in the JAX
    package. `data` is numpy (trained on `device`) or a tensor."""
    n, dim = data.shape
    sample_cap = 65_536
    stride = max(1, n // sample_cap)
    if isinstance(data, torch.Tensor):
        x = data[::stride][:sample_cap].to(torch.float32)
    else:
        x = torch.from_numpy(np.ascontiguousarray(data[::stride][:sample_cap], dtype=np.float32))
        x = x.to(resolve_device(device))
    ns = int(x.shape[0])
    dsub = dim // m
    ksub_eff = min(ksub, max(1, ns))
    rot = torch.eye(dim, dtype=torch.float32, device=x.device)
    for it in range(max(1, iters)):
        subs = (x @ rot).reshape(ns, m, dsub).transpose(0, 1).contiguous()
        books = train_kmeans_multi(subs, ksub_eff, iters=3, seed=seed + 7 + it, out_device=True)
        codes = assign_clusters_multi(subs, books, out_device=True)             # (m, ns)
        recon = torch.gather(books, 1, codes.long()[:, :, None].expand(-1, -1, dsub))
        cross = x.T @ recon.transpose(0, 1).reshape(ns, dim)
        u, _, vt = np.linalg.svd(cross.cpu().numpy(), full_matrices=False)
        rot = torch.from_numpy(np.ascontiguousarray((u @ vt).astype(np.float32))).to(x.device)
    return rot.cpu().numpy()


def _adc_ranked(centroids, codebooks, list_codes, list_ids, query):
    """Pure-code full ranking of every staged code against one query: the
    direct lookup-table estimate per list (in bounded steps), then one
    (distance, id) sort. Returns (dists, ids) of length nlist * pad."""
    nlist, pad, m = list_codes.shape
    ksub, dsub = codebooks.shape[1], codebooks.shape[2]
    step = max(1, _CPU_STEP_BYTES // (m * ksub * dsub * 4))
    dists = torch.empty((nlist, pad), dtype=torch.float32, device=list_codes.device)
    for l0 in range(0, nlist, step):
        res = query[None, :] - centroids[l0 : l0 + step]
        diff = res.reshape(-1, m, 1, dsub) - codebooks[None]
        lut = (diff * diff).sum(dim=-1)                                  # (L, m, ksub)
        d = torch.gather(lut, 2, list_codes[l0 : l0 + step].long().transpose(1, 2)).sum(dim=1)
        dists[l0 : l0 + step] = torch.where(list_ids[l0 : l0 + step] >= 0, d, torch.inf)
    flat_d = dists.reshape(-1)
    tie = torch.where(torch.isinf(flat_d), INT32_MAX, list_ids.reshape(-1))
    sd, si = sort_by_dist_id(flat_d, tie, in_id_order=False)
    return sd, torch.where(si == INT32_MAX, -1, si)


@register
class IVFPQIndex:
    kind = "ivf_pq"

    # Device helpers shared with IVFFlatIndex (they read only self.device).
    _on_device = IVFFlatIndex._on_device
    _host = staticmethod(IVFFlatIndex._host)
    _host_ids = staticmethod(IVFFlatIndex._host_ids)

    def __init__(self, dim: int = DIM, nlist: int = 64, nprobe: int = 8, m: int = 8,
                 ksub: int = 256, refine: bool = True, refine_factor: int = 4,
                 refine_dtype: str = "float32", opq: bool = False, opq_iters: int = 8,
                 capacity: int | None = None, pad_cap: int | None = None,
                 device: str | torch.device | None = None):
        """refine=True keeps raw vectors and re-ranks the ADC
        top-(k * refine_factor) exactly (the FAISS IndexRefineFlat pattern);
        refine=False is a pure compressed index. refine_dtype="bfloat16"
        halves the refine store. opq=True learns an orthogonal rotation
        before quantization (rotation preserves L2, so scores and the
        refine are unchanged). capacity pre-declares the corpus size: the
        device-mode refine store allocates once at that (128-aligned) size
        and adds write straight into it. pad_cap bounds inverted-list
        length (devbuild.capped_assign); since codes are residuals of their
        list's centroid, relocated rows re-encode from the raw rows, so
        pad_cap requires refine=True."""
        if dim % m != 0:
            raise ValueError(f"dim ({dim}) must be divisible by m ({m})")
        if refine_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported refine_dtype '{refine_dtype}'")
        if pad_cap is not None and int(pad_cap) < 8:
            raise ValueError(f"pad_cap must be >= 8, got {pad_cap}")
        if pad_cap and not refine:
            raise ValueError(
                "pad_cap requires refine=True: PQ codes are residual-"
                "encoded against their list's centroid, so capped "
                "staging must re-encode relocated rows from raw vectors"
            )
        self.dim = int(dim)
        self.nlist = int(nlist)
        self.nprobe = int(nprobe)
        self.m = int(m)
        self.ksub = int(ksub)
        self.refine = bool(refine)
        self.refine_factor = int(refine_factor)
        self.refine_dtype = str(refine_dtype)
        self.opq = bool(opq)
        self.opq_iters = int(opq_iters)
        self.capacity = int(capacity) if capacity else None
        self.pad_cap = int(pad_cap) if pad_cap else None
        self.device = resolve_device(device)
        self._rotation: np.ndarray | None = None   # (D, D); x_rot = x @ R
        self._rotation_dev: torch.Tensor | None = None
        # Host-mode mirrors (numpy; the CLI scale).
        self._vectors = np.zeros((0, self.dim), dtype=np.float32)
        self._ids = np.zeros((0,), dtype=np.int64)
        self._codes = np.zeros((0, self.m), dtype=np.uint8)
        self._assign: np.ndarray | None = None
        # Device-mode chunk stores (corpus scale; freed after staging).
        self._mode = "host"
        self._dev_vecs = ChunkStore()       # kept rows (refine only)
        self._dev_ids = ChunkStore()
        self._dev_assign = ChunkStore()
        self._dev_codes = ChunkStore()
        self._n_dev = 0
        self._centroids = None              # numpy, or a tensor once on the device
        self._codebooks = None              # numpy, or a tensor (m, ksub_eff, dsub)
        self._staged = None
        self._hwm = None                    # (nlist,) int32 list_hwm of the staged ids
        self._staged_refine = None
        self._cap_valid = False
        self._refine_rows = 0               # rows materialized (positional layout)
        self._tail: GrowTail | None = None
        self._restage_needed = False
        self._list_counts = None            # per-list counts of the last staging
        self._mask_cache = MaskCache(self.device)

    # -- introspection -------------------------------------------------------

    @property
    def ntotal(self) -> int:
        if self._mode == "device":
            return self._n_dev
        return int(self._ids.shape[0])

    @property
    def is_trained(self) -> bool:
        return self._centroids is not None and self._codebooks is not None

    def ids(self) -> np.ndarray:
        if self._mode == "device":
            if self._n_dev == 0:
                return np.zeros((0,), np.int64)
            return self._codes_all()[0].cpu().numpy().astype(np.int64)
        return self._ids.copy()

    @property
    def code_bytes_per_vector(self) -> int:
        return self.m

    def geometry_diagnostic(self) -> dict:
        """Clustering-geometry stats of the current staging (stages if
        needed), from the per-list counts the staging kept."""
        if self.ntotal == 0 or not self.is_trained:
            return corpus_geometry(np.zeros((0,), np.int64))
        self._stage()
        return corpus_geometry(self._list_counts, self.pad_cap)

    # -- helpers ----------------------------------------------------------------

    def _np(self, x) -> np.ndarray:
        return np.ascontiguousarray(self._host(x), dtype=np.float32)

    def _centroids_dev(self) -> torch.Tensor:
        if not isinstance(self._centroids, torch.Tensor):
            self._centroids = self._on_device(self._centroids, torch.float32)
        return self._centroids

    def _codebooks_dev(self) -> torch.Tensor:
        if not isinstance(self._codebooks, torch.Tensor):
            self._codebooks = self._on_device(self._codebooks, torch.float32)
        return self._codebooks

    @property
    def _keep_dtype(self):
        return torch.bfloat16 if self.refine_dtype == "bfloat16" else torch.float32

    def _reset_staging(self) -> None:
        self._staged = None
        self._hwm = None
        self._staged_refine = None
        self._cap_valid = False
        self._tail = None
        self._restage_needed = False

    def _sort_host_rows(self) -> None:
        if not np.all(self._ids[:-1] <= self._ids[1:]):
            order = np.argsort(self._ids, kind="stable")
            self._ids = self._ids[order]
            self._codes = self._codes[order]
            self._assign = self._assign[order]
            if self.refine and self._vectors.shape[0] == order.shape[0]:
                self._vectors = self._vectors[order]

    # -- rotation ---------------------------------------------------------------

    def _train_opq_rotation(self, data, *, iters: int, seed: int) -> None:
        self._rotation = train_opq_rotation(data, self.m, ksub=self.ksub, iters=iters, seed=seed,
                                            device=self.device)
        self._rotation_dev = None

    def _rotate(self, data: np.ndarray) -> np.ndarray:
        """Host-side rotation (build/encode paths)."""
        if self._rotation is None:
            return data
        return np.ascontiguousarray(data @ self._rotation)

    def _rotate_device(self, data: torch.Tensor) -> torch.Tensor:
        """Rotation of tensor rows or queries, f32 on the device (TF32 off)."""
        if self._rotation is None:
            return data
        if self._rotation_dev is None:
            self._rotation_dev = self._on_device(self._rotation, torch.float32)
        return data.to(torch.float32) @ self._rotation_dev

    # -- training ------------------------------------------------------------------

    def train(self, data, *, iters: int = 10, seed: int = 0, init: str = "maximin") -> None:
        """init: coarse-quantizer seeding (ops/kmeans.train_kmeans)."""
        if is_device_array(data) and self.ntotal == 0:
            self._mode = "device"
        if self._mode == "device":
            data = self._on_device(data, torch.float32).reshape(-1, self.dim)
            n = int(data.shape[0])
            if self.opq and self._rotation is None:
                self._train_opq_rotation(data, iters=self.opq_iters, seed=seed)
            data = self._rotate_device(data)
            self._centroids = train_kmeans(data, min(self.nlist, max(1, n)), iters=iters,
                                           seed=seed, out_device=True, init=init)
            assign = assign_clusters(data, self._centroids, out_device=True)
            subs = _residual_subs(data, self._centroids, assign, self.m)
            self._codebooks = train_kmeans_multi(subs, min(self.ksub, max(1, n)), iters=iters,
                                                 seed=seed + 1, out_device=True)
            if self.ntotal:
                self._reencode_all_device()
            self._reset_staging()
            return
        data = np.ascontiguousarray(self._host(data), dtype=np.float32).reshape(-1, self.dim)
        if self.opq and self._rotation is None:
            self._train_opq_rotation(data, iters=self.opq_iters, seed=seed)
        data = self._rotate(data)
        n = data.shape[0]
        self._centroids = train_kmeans(data, min(self.nlist, max(1, n)), iters=iters, seed=seed,
                                       init=init, device=self.device)
        assign = assign_clusters(data, self._centroids, device=self.device)
        residuals = data - self._centroids[assign]
        subs = np.ascontiguousarray(
            residuals.reshape(n, self.m, self.dim // self.m).transpose(1, 0, 2))
        self._codebooks = train_kmeans_multi(subs, min(self.ksub, max(1, n)), iters=iters,
                                             seed=seed + 1, device=self.device)
        if self.ntotal:
            # Rows already added re-encode under the new quantizer (the
            # JAX package keeps their old codes here, which no longer decode).
            if not self.refine:
                raise ValueError(_ORPHAN_MSG)
            self._assign, self._codes = self._encode(self._vectors)
        self._reset_staging()

    def _reencode_all_device(self) -> None:
        """Retrain in device mode: the raw rows re-encode under the new
        quantizer. A refine=False index keeps no raw rows, so its codes would
        be orphaned: retraining it is rejected."""
        if not self.refine:
            raise ValueError(_ORPHAN_MSG)
        vecs, idsa = self._raw_rows_all()
        assign, codes = self._encode(vecs)
        for store in (self._dev_vecs, self._dev_ids, self._dev_assign, self._dev_codes):
            store.clear()
        self._dev_vecs.append(vecs)
        self._dev_ids.append(idsa)
        self._dev_assign.append(assign)
        self._dev_codes.append(codes)

    def _encode_residuals(self, rows_rot, assign):
        subs = _residual_subs(rows_rot, self._centroids_dev(), assign, self.m)
        return assign_clusters_multi(subs, self._codebooks_dev(), out_device=True).T.to(torch.uint8)

    def _encode(self, data):
        """(N, D) -> (assignments (N,), codes (N, m) uint8) in the (rotated)
        quantization space; numpy in -> numpy out, tensor in -> tensor out."""
        if is_device_array(data):
            data = self._rotate_device(data.to(torch.float32))
            assign = assign_clusters(data, self._centroids_dev(), out_device=True)
            return assign, self._encode_residuals(data, assign).contiguous()
        data = self._rotate(data)
        centroids = self._np(self._centroids)
        assign = assign_clusters(data, centroids, device=self.device)
        residuals = data - centroids[assign]
        subs = np.ascontiguousarray(
            residuals.reshape(data.shape[0], self.m, self.dim // self.m).transpose(1, 0, 2))
        codes = assign_clusters_multi(subs, self._np(self._codebooks), device=self.device)
        return assign, np.ascontiguousarray(codes.T.astype(np.uint8))

    # -- mutation ----------------------------------------------------------------------

    def _tail_park(self, ids_dev, assign_dev, codes_dev, raw_rows_dev) -> None:
        """Post-staging add: the ADC reconstructions go to the device tail,
        raw rows straight into the live refine store."""
        recon = _decode_recon(codes_dev, assign_dev, self._centroids_dev(), self._codebooks_dev())
        if self._tail is None:
            self._tail = GrowTail({
                "recon": (self.dim, "float32"),
                "ids": (None, "int32"),
                "assign": (None, "int32"),
                "codes": (self.m, "uint8"),
            }, self.device, initial_cap=tail_restage_threshold(self.ntotal))
        self._tail.append(recon=recon, ids=ids_dev, assign=assign_dev, codes=codes_dev)
        if self.refine and raw_rows_dev is not None:
            self._refine_append(raw_rows_dev, ids_dev)
        if self._tail.count > tail_restage_threshold(self.ntotal):
            self._restage_needed = True

    def _add_device(self, vectors: torch.Tensor, ids) -> None:
        vectors = vectors.reshape(-1, self.dim)
        ids = self._on_device(
            ids if is_device_array(ids) else self._host_ids(ids), torch.int32).reshape(-1)
        if not self.is_trained:
            self.train(vectors)
        assign, codes = self._encode(vectors)
        kept = vectors.to(self._keep_dtype) if self.refine else None
        if self._staged is not None:
            self._tail_park(ids, assign, codes, kept)
        else:
            if self.refine:
                if self.capacity and self._staged_refine is None:
                    # Declared capacity: the refine store exists from the
                    # first add and rows go straight in.
                    self._init_refine_empty(ids)
                if self._staged_refine is not None:
                    self._refine_append(kept, ids)
                else:
                    self._dev_vecs.append(kept)
            self._dev_ids.append(ids)
            self._dev_assign.append(assign)
            self._dev_codes.append(codes)
        self._n_dev += int(vectors.shape[0])

    def add(self, vectors, ids) -> None:
        """Append (n, dim) vectors with external ids (n,). A tensor as the
        first input puts the index in device mode."""
        if is_device_array(vectors) and self._mode == "host" and self.ntotal == 0:
            self._mode = "device"
        if self._mode == "device":
            self._add_device(self._on_device(vectors, torch.float32), ids)
            return
        vectors = np.ascontiguousarray(self._host(vectors), dtype=np.float32).reshape(-1, self.dim)
        ids = self._host_ids(ids)
        if not self.is_trained:
            self.train(vectors)
        assign, codes = self._encode(vectors)
        if self._staged is not None:
            self._tail_park(
                self._on_device(ids.astype(np.int32)), self._on_device(assign),
                self._on_device(codes), self._on_device(vectors) if self.refine else None)
        elif self._staged_refine is not None and self.refine:
            self._refine_append(self._on_device(vectors), self._on_device(ids.astype(np.int32)))
        old_assign = self._assign if self._assign is not None else np.zeros((0,), np.int32)
        self._ids = np.concatenate([self._ids, ids])
        self._codes = np.concatenate([self._codes, codes], axis=0)
        self._assign = np.concatenate([old_assign, assign])
        if self.refine:
            self._vectors = np.concatenate([self._vectors, vectors], axis=0)
        self._sort_host_rows()

    def reconstruct(self, doc_id: int) -> np.ndarray:
        """The stored vector of an external id: with refine the raw (or
        bf16-rounded) row; a pure-code index returns centroid + decode(codes)
        mapped back through the OPQ rotation. Raises KeyError if absent."""
        if self._mode == "device":
            if self._n_dev == 0:
                raise KeyError(f"id {doc_id} not in index")
            if self.refine:
                vecs, idsa = self._raw_rows_all()
                pos = torch.nonzero(idsa == int(doc_id)).flatten()
                if not pos.numel():
                    raise KeyError(f"id {doc_id} not in index")
                return vecs[int(pos[0])].to(torch.float32).cpu().numpy()
            idsa, assign, codes = self._codes_all()
            pos = torch.nonzero(idsa == int(doc_id)).flatten()
            if not pos.numel():
                raise KeyError(f"id {doc_id} not in index")
            p = int(pos[0])
            recon = _decode_recon(codes[p : p + 1], assign[p : p + 1], self._centroids_dev(),
                                  self._codebooks_dev())
            out = recon[0].cpu().numpy()
            return out @ self._rotation.T if self._rotation is not None else out
        pos = np.searchsorted(self._ids, int(doc_id))
        if pos >= self._ids.shape[0] or self._ids[pos] != doc_id:
            raise KeyError(f"id {doc_id} not in index")
        if self.refine:
            return self._vectors[pos].copy()
        centroids, codebooks = self._np(self._centroids), self._np(self._codebooks)
        y = np.concatenate([codebooks[j, int(self._codes[pos, j])] for j in range(self.m)])
        recon = centroids[int(self._assign[pos])] + y.reshape(self.dim)
        return recon @ self._rotation.T if self._rotation is not None else recon

    def remove_ids(self, ids) -> int:
        """Remove stored rows by external id; returns how many were removed.
        Host mode filters the mirrors and restages lazily. Device mode
        removes IN PLACE: the tail folds in, then matching list ids turn -1
        with +inf item constants (the ADC exclusion marker) and the refine
        store's slots are invalidated."""
        if self._mode == "device":
            if self._n_dev == 0:
                return 0
            if self._staged is not None and self._tail and self._tail.count:
                self._restage_needed = True
            self._stage()
            (centroids, c_sq, codebooks, list_codes, li, canvas, item_const, pad) = self._staged
            table = removal_table(ids, self.device)
            li, removed, item_const = apply_removal(li, table, item_const)
            if removed:
                self._put_staged((centroids, c_sq, codebooks, list_codes, li, canvas, item_const,
                                  pad))
                if self.refine and self._staged_refine is not None:
                    store, lookup, ids_arr, valid = self._staged_refine
                    ids_arr, _ = apply_removal(ids_arr, table)
                    self._staged_refine = (store, lookup, ids_arr, valid & (ids_arr >= 0))
                self._n_dev -= removed
                self._mask_cache.clear()
            return removed
        ids = np.unique(self._host_ids(ids))
        keep = ~np.isin(self._ids, ids)
        removed = int(self._ids.shape[0] - keep.sum())
        if removed:
            self._ids = self._ids[keep]
            self._codes = self._codes[keep]
            if self._assign is not None:
                self._assign = self._assign[keep]
            if self.refine:
                self._vectors = self._vectors[keep]
            self._reset_staging()
            self._mask_cache.clear()
        return removed

    # -- device staging ----------------------------------------------------------------

    def _codes_all(self):
        """Device mode: every stored row's (ids, assign, codes) tensors —
        from the staged canvas, the tail, and pending chunks."""
        parts_i, parts_a, parts_c = [], [], []
        if self._staged is not None:
            ids_s, assign_s, codes_s = self._staged_codes_rows()
            if ids_s is not None:
                parts_i.append(ids_s)
                parts_a.append(assign_s)
                parts_c.append(codes_s)
        if self._tail and self._tail.count:
            c = self._tail.count
            parts_i.append(self._tail["ids"][:c])
            parts_a.append(self._tail["assign"][:c])
            parts_c.append(self._tail["codes"][:c])
        if len(self._dev_ids):
            parts_i.append(self._dev_ids.consolidated(torch.int32))
            parts_a.append(self._dev_assign.consolidated(torch.int32))
            parts_c.append(self._dev_codes.consolidated(torch.uint8))
        cat = lambda ps: ps[0] if len(ps) == 1 else torch.cat(ps)  # noqa: E731
        return cat(parts_i), cat(parts_a), cat(parts_c)

    def _staged_codes_rows(self):
        """Rows held by the current staging, read back out of the code
        canvas (device mode keeps no row-major code matrix)."""
        n_staged = self._n_dev - len(self._dev_ids) - (self._tail.count if self._tail else 0)
        if n_staged <= 0:
            return None, None, None
        (_, _, codebooks, list_codes, list_ids, canvas, _, _) = self._staged
        if list_codes is None:
            list_codes = unstage_codes_device(canvas, self.m, int(codebooks.shape[1]))
        codes, ids_s, assign_s = _extract_rows(list_codes, list_ids, n_staged)
        return ids_s, assign_s, codes

    def _raw_rows_all(self):
        """Device mode, refine on: every raw (kept-dtype) row and its id.
        Once the refine store exists it is complete and the sole source;
        before, the chunks are."""
        if self._staged_refine is not None:
            vecs, _, ids_arr, valid = self._staged_refine
            n_mat = int(valid.sum())
            if n_mat == 0:
                raise ValueError("empty refine store")
            v, i, _ = _extract_rows(vecs.reshape(1, -1, self.dim), ids_arr.reshape(1, -1), n_mat)
            return v, i
        if not len(self._dev_vecs):
            raise ValueError("no raw rows retained (refine=False device mode)")
        return self._dev_vecs.consolidated(), self._dev_ids.consolidated(torch.int32)

    def _put_staged(self, staged) -> None:
        """Keep a staging and the high-water marks of its list ids, where
        the select kernel stops; every change to the staged ids comes
        through here."""
        self._staged = staged
        self._hwm = list_hwm(staged[4]).to(torch.int32)

    def _build_masked(self, keep):
        """Once-per-mask staged operands of the keep table `keep`: a masked
        copy of the item constants (+inf IS the ADC kernels' exclusion
        marker) and the lists' keep mask for the plain route."""
        staged = self._stage()
        return mask_norms(staged[6], staged[4], keep), keep_of(staged[4], keep)

    def _stage(self):
        if self._staged is None or self._restage_needed:
            if self._mode == "device":
                self._stage_device()
            else:
                self._stage_host()
            self._tail = None
            self._restage_needed = False
            self._mask_cache.clear()
        return self._staged

    def _stage_device(self):
        """Bucket codes into the padded canvases on the device; only the
        (nlist,) counts cross to the host."""
        # The refine store builds BEFORE the chunks are consumed: afterwards
        # it holds the only raw copies.
        if self.refine and self._staged_refine is None:
            self._stage_refine()
        idsa, assign, codes = self._codes_all()
        centroids, codebooks = self._centroids_dev(), self._codebooks_dev()
        nlist_eff, ksub_eff = int(centroids.shape[0]), int(codebooks.shape[1])
        order, lists, slots, counts = bucketize_device(assign, nlist_eff)
        self._list_counts = counts
        if self.pad_cap and int(counts.max(initial=0)) > self.pad_cap:
            # Codes are residuals of their list's centroid, so capped
            # staging re-encodes relocated rows from the refine store. After
            # a capped staging only the new rows (tail and chunks follow the
            # staged rows in _codes_all order) re-place and re-encode.
            n = int(idsa.shape[0])
            n_base = (self._n_dev - len(self._dev_ids) - (self._tail.count if self._tail else 0)
                      if self._cap_valid else 0)
            done = False
            if 0 < n_base < n:
                base_assign = assign[:n_base].to(torch.int32)
                base_counts = np.bincount(base_assign.cpu().numpy(), minlength=nlist_eff)
                if int(base_counts.max(initial=0)) <= self.pad_cap:
                    try:
                        new_assign, new_codes = self._capped_reencode_incremental(
                            idsa[n_base:], base_counts)
                        assign = torch.cat([base_assign, new_assign])
                        codes = torch.cat([codes[:n_base], new_codes])
                        done = True
                    except ValueError:
                        pass  # not enough free slots: full reassign
            if not done:
                assign, codes = self._capped_reencode(idsa)
            order, lists, slots, counts = bucketize_device(assign, nlist_eff)
            self._list_counts = counts
        self._cap_valid = bool(self.pad_cap)
        pad = list_pad(int(counts.max(initial=1)))
        list_codes = scatter_lists_device(codes, order, lists, slots, nlist_eff, pad)
        li = scatter_list_ids_device(idsa, order, lists, slots, nlist_eff, pad)
        item_const = build_item_constants_device(centroids, assign, codes, codebooks, order, lists,
                                                 slots, nlist_eff, pad)
        canvas = stage_codes_device(list_codes, self.m, ksub_eff)
        # The unpacked codes serve only the CPU route: on the card they are
        # kept for the shapes that take it.
        keep_unpacked = self.device.type != "cuda" or not kernel_shape(ksub_eff, self.m)
        self._put_staged((centroids, (centroids * centroids).sum(dim=1), codebooks,
                          list_codes if keep_unpacked else None, li, canvas, item_const, pad))
        for store in (self._dev_vecs, self._dev_ids, self._dev_assign, self._dev_codes):
            store.clear()

    def _refine_rows_of(self, idsa):
        """Raw rows of the given ids from the refine store, rotated into
        the quantization space."""
        vecs, lookup, _, _ = self._stage_refine()
        idx = idsa.to(torch.int64)
        if lookup == ("identity",):
            rows = vecs[idx]
        elif lookup[0] == "dense":
            rows = vecs[lookup[1][idx].long()]
        else:
            _, ids_search, row_of_pos = lookup
            pos = torch.searchsorted(ids_search, idsa.to(torch.int32).contiguous())
            rows = vecs[row_of_pos[pos].long()]
        return self._rotate_device(rows.to(torch.float32))

    def _capped_reencode(self, idsa):
        """Capped assignment (devbuild.capped_assign) of the refine store's
        rows in idsa order, re-encoded against their new lists."""
        rows_rot = self._refine_rows_of(idsa)
        assign, _ = capped_assign(rows_rot, self._centroids_dev(), self.pad_cap)
        return assign, self._encode_residuals(rows_rot, assign)

    def _capped_reencode_incremental(self, new_ids, base_counts):
        """Place and encode ONLY the new rows in the remaining per-list
        capacity; raises ValueError when it cannot hold them."""
        rows_rot = self._refine_rows_of(new_ids)
        assign, _ = capped_assign_incremental(rows_rot, self._centroids_dev(), base_counts,
                                              self.pad_cap)
        return assign, self._encode_residuals(rows_rot, assign)

    def _stage_host(self):
        """Host-mode staging (the CLI scale): bucket and compute the item
        constants in numpy exactly as the JAX package does, push once."""
        centroids, codebooks = self._np(self._centroids), self._np(self._codebooks)
        nlist_eff = centroids.shape[0]
        assign_eff, codes_eff = self._assign, self._codes
        counts = np.bincount(assign_eff, minlength=nlist_eff)
        self._list_counts = counts
        if self.pad_cap and int(counts.max(initial=0)) > self.pad_cap:
            data_rot = self._rotate(self._vectors)
            assign_t, _ = capped_assign(self._on_device(data_rot),
                                        self._on_device(centroids), self.pad_cap)
            assign_eff = assign_t.cpu().numpy()
            residuals = data_rot - centroids[assign_eff]
            subs = np.ascontiguousarray(
                residuals.reshape(-1, self.m, self.dim // self.m).transpose(1, 0, 2))
            codes_eff = assign_clusters_multi(subs, codebooks, device=self.device).T.astype(
                np.uint8)
            counts = np.bincount(assign_eff, minlength=nlist_eff)
            self._list_counts = counts
        pad = list_pad(int(counts.max(initial=1)))
        list_codes = np.zeros((nlist_eff, pad, self.m), np.uint8)
        list_ids = np.full((nlist_eff, pad), -1, np.int32)
        order = np.argsort(assign_eff, kind="stable")
        sorted_lists = assign_eff[order]
        starts = np.zeros((nlist_eff,), np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        slots = np.arange(len(order)) - starts[sorted_lists]
        list_codes[sorted_lists, slots] = codes_eff[order]
        list_ids[sorted_lists, slots] = self._ids[order]
        c_sq = np.einsum("nd,nd->n", centroids, centroids)
        canvas = np.ascontiguousarray(list_codes.transpose(0, 2, 1))
        if packed_layout(codebooks.shape[1], self.m):
            canvas = np.ascontiguousarray(pack_nibbles(canvas))
        item_const = build_item_constants(centroids, assign_eff, codes_eff, codebooks, order,
                                           sorted_lists, slots, nlist_eff, pad)
        self._put_staged((
            self._centroids_dev(), self._on_device(c_sq.astype(np.float32)),
            self._codebooks_dev(), self._on_device(list_codes), self._on_device(list_ids),
            self._on_device(canvas), self._on_device(item_const), pad,
        ))

    # -- search ----------------------------------------------------------------------------

    def search(self, queries, k: int, *, nprobe: int | None = None,
               id_mask=None) -> tuple[np.ndarray, np.ndarray]:
        """id_mask: optional (cap,) bool keyed by EXTERNAL id (filter
        pushdown): masked rows take a +inf item constant (the kernels'
        exclusion marker) through a once-per-mask staged copy. Pass the
        SAME mask array across calls to reuse the staging."""
        return self._search(queries, k, nprobe=nprobe, id_mask=id_mask,
                            card_route=self.device.type == "cuda")

    def _search(self, queries, k: int, *, nprobe: int | None = None, id_mask=None,
                card_route: bool):
        """search() with the route explicit: card_route=True is the kernels'
        route (on CPU tensors each kernel wrapper takes its plain version)
        for the shapes the kernels serve, False the CPU route."""
        q = self._on_device(queries, torch.float32).reshape(-1, self.dim)
        if self.ntotal == 0 or not self.is_trained:
            shape = (q.shape[0], k)
            return np.full(shape, np.inf, np.float32), np.full(shape, -1, np.int64)
        # Probing and ADC run in the (rotated) quantization space; the exact
        # refine stays in the original space (the refine store is raw).
        q_adc = self._rotate_device(q)
        (centroids, c_sq, codebooks, list_codes, list_ids, canvas, item_const,
         pad) = self._stage()
        keep = keep_rows = None
        if id_mask is not None:
            keep, item_const, keep_rows = self._mask_cache.get(id_mask, self._build_masked)
        ksub_eff = int(codebooks.shape[1])
        nprobe_eff = min(nprobe or self.nprobe, int(centroids.shape[0]))
        k_adc = min(k * self.refine_factor, self.ntotal) if self.refine else k
        k_adc = max(k_adc, k)
        if card_route and kernel_shape(ksub_eff, self.m):
            if self.refine and k_adc > 2 * LANE_K:
                dists, out_ids = adc_dense_search(centroids, c_sq, codebooks, canvas, item_const,
                                                  list_ids, q_adc, nprobe_eff, k_adc,
                                                  hwm=self._hwm)
            else:
                dists, out_ids = adc_full_search(centroids, c_sq, codebooks, canvas, item_const,
                                                 list_ids, q_adc, nprobe_eff, k_adc,
                                                 hwm=self._hwm)
            if keep is not None:
                # Masked rows can pad the dense shortlist as +inf entries
                # with REAL ids; the rerank would re-score them finitely.
                out_ids = mask_shortlist_ids(out_ids, keep)
        else:
            if list_codes is None:
                list_codes = unstage_codes_device(canvas, self.m, ksub_eff)
            dists, out_ids = self._cpu_route(centroids, c_sq, codebooks, list_codes, list_ids,
                                             q_adc, nprobe_eff, k_adc, keep_rows)
        if self._tail and self._tail.count:
            # Tail rows join the shortlist scored by the same estimator (the
            # exact distance to their reconstruction), masked to the probed
            # lists, so the merged shortlist equals a fresh build's.
            td = tail_scores(self._tail, centroids, c_sq, q_adc, nprobe_eff, vec_field="recon")
            if keep is not None:
                td = torch.where(keep_of(self._tail["ids"], keep)[None, :], td, torch.inf)
            dists, out_ids = merge_tail(dists, out_ids, td, self._tail["ids"], k_adc)
        if self.refine:
            vecs, id_lookup, _, _ = self._stage_refine()
            out_d, out_i = exact_rerank_staged(vecs, id_lookup, out_ids.to(torch.int32), q, k)
            return out_d.cpu().numpy(), out_i.cpu().numpy().astype(np.int64)
        return dists[:, :k].cpu().numpy(), out_ids[:, :k].cpu().numpy().astype(np.int64)

    def _cpu_route(self, centroids, c_sq, codebooks, list_codes, list_ids, q, nprobe: int,
                   k: int, keep=None):
        """The CPU route: probes by the clamped q_sq + c_sq - 2 q.c, then per
        probe rank the direct lookup table of the residual, gathered at the
        list's codes and summed, and a merge by (distance, id)."""
        _, probes = stable_topk(scores_via_matmul(q, centroids, c_sq), nprobe)
        m, ksub, dsub = codebooks.shape
        b, pad = q.shape[0], list_codes.shape[1]
        chunk = max(1, _CPU_STEP_BYTES // (4 * m * max(ksub * dsub, pad)))
        out_d, out_i = [], []
        for q0 in range(0, b, chunk):
            qc = q[q0 : q0 + chunk]
            best_d = torch.full((qc.shape[0], k), torch.inf, device=q.device)
            best_i = torch.full((qc.shape[0], k), -1, dtype=torch.int32, device=q.device)
            for p in range(nprobe):
                lists = probes[q0 : q0 + chunk, p]
                res = (qc - centroids[lists]).reshape(-1, m, 1, dsub)
                diff = res - codebooks[None]
                lut = (diff * diff).sum(dim=-1)                          # (b, m, ksub)
                codes = list_codes[lists].long().transpose(1, 2)         # (b, m, pad)
                d = torch.gather(lut, 2, codes).sum(dim=1)
                ids = list_ids[lists]
                d = torch.where(ids >= 0, d, torch.inf)
                if keep is not None:
                    d = torch.where(keep[lists], d, torch.inf)
                best_d, best_i = merge_topk(torch.cat([best_d, d], 1),
                                            torch.cat([best_i, ids], 1), k)
            out_d.append(best_d)
            out_i.append(best_i)
        return torch.cat(out_d), torch.cat(out_i)

    # -- refine store -------------------------------------------------------------------

    def _stage_refine(self):
        """Refine-store tensors: (vectors, id_lookup, ids, valid). In device
        mode the store builds from the device chunks and is updated in
        place by incremental adds."""
        if self._staged_refine is None:
            if self._mode == "device":
                self._stage_refine_device()
            else:
                self._stage_refine_host()
        return self._staged_refine

    def _refine_layout(self, max_id: int, ntotal: int):
        """Id-indexed vs positional store: id-indexed only when its
        capacity is at most 2x the positional one. A declared `capacity`
        replaces pow2 growth with one exact 128-aligned allocation."""
        max_id = int(max_id)
        if self.capacity:
            align = lambda x: ((max(x, 1) + 127) // 128) * 128  # noqa: E731
            pos_cap = align(max(self.capacity, ntotal))
            id_cap = align(max_id + 1)
            if id_cap <= 2 * pos_cap:
                return "identity", max(id_cap, pos_cap)
            return "positional", pos_cap
        pos_cap = next_pow2(max(ntotal, 1))
        if ntotal and next_pow2(max_id + 1) <= 2 * pos_cap:
            return "identity", next_pow2(max_id + 1)
        return "positional", pos_cap

    def _stage_refine_host(self):
        ids_i = self._ids.astype(np.int64)
        layout, cap = self._refine_layout(int(ids_i.max(initial=-1)), self.ntotal)
        vecs = np.zeros((cap, self.dim), np.float32)
        ids = np.full((cap,), -1, np.int32)
        valid = np.zeros((cap,), bool)
        if layout == "identity":
            # A tight id space stages the store ID-INDEXED (row == id), so
            # the rerank gathers rows straight from the shortlist ids.
            vecs[ids_i] = self._vectors
            ids[ids_i] = ids_i.astype(np.int32)
            valid[ids_i] = True
            lookup = ("identity",)
            self._refine_rows = 0
        else:
            vecs[: self.ntotal] = self._vectors
            ids[: self.ntotal] = ids_i.astype(np.int32)
            valid[: self.ntotal] = True
            lookup = build_id_lookup(self._ids, self.device)
            self._refine_rows = self.ntotal
        self._staged_refine = (self._on_device(vecs, self._keep_dtype), lookup,
                               self._on_device(ids), self._on_device(valid))

    def _empty_store(self, cap: int):
        return (torch.zeros((cap, self.dim), dtype=self._keep_dtype, device=self.device),
                torch.full((cap,), -1, dtype=torch.int32, device=self.device),
                torch.zeros((cap,), dtype=torch.bool, device=self.device))

    def _init_refine_empty(self, first_ids) -> None:
        """Declared capacity, device mode: allocate the refine store once
        before any row lands."""
        layout, cap = self._refine_layout(int(first_ids.max()), 0)
        store, ids_arr, valid = self._empty_store(cap)
        if layout == "identity":
            lookup = ("identity",)
        else:
            lookup = ("dense", torch.zeros((128,), dtype=torch.int32, device=self.device))
        self._refine_rows = 0
        self._staged_refine = (store, lookup, ids_arr, valid)

    def _stage_refine_device(self):
        """Build the store chunk by chunk (each chunk is released as it is
        copied in, so the corpus never exists twice); only the id chunks
        consolidate."""
        n = len(self._dev_vecs)
        idsa = (self._dev_ids.consolidated(torch.int32) if n
                else torch.zeros((0,), dtype=torch.int32, device=self.device))
        layout, cap = self._refine_layout(int(idsa.max()) if n else -1, n)
        if layout == "identity":
            lookup = ("identity",)
            self._refine_rows = 0
        else:
            lookup = build_id_lookup_device(idsa)
            self._refine_rows = n
        store, ids_arr, valid = self._empty_store(cap)
        ofs = 0
        id_chunks = list(self._dev_ids._chunks)
        for vchunk, ichunk in zip(self._dev_vecs.drain(), id_chunks):
            b = int(vchunk.shape[0])
            ichunk = ichunk.to(torch.int32)
            pos = (ichunk.long() if layout == "identity"
                   else torch.arange(ofs, ofs + b, device=self.device))
            store[pos] = vchunk.to(store.dtype)
            ids_arr[pos] = ichunk
            valid[pos] = True
            ofs += b
        self._staged_refine = (store, lookup, ids_arr, valid)

    def _grow_store(self, vecs, ids_arr, valid, need: int):
        store, ids_new, valid_new = self._empty_store(need)
        cap = vecs.shape[0]
        store[:cap], ids_new[:cap], valid_new[:cap] = vecs, ids_arr, valid
        return store, ids_new, valid_new

    def _refine_append(self, rows_dev, ids_dev) -> None:
        """Write freshly added raw rows into the LIVE refine store in place
        (O(batch)); grows to the next power of two on demand."""
        vecs, lookup, ids_arr, valid = self._staged_refine
        cap = int(vecs.shape[0])
        batch = int(ids_dev.shape[0])
        new_total = self.ntotal + batch  # ntotal is not yet bumped by the caller
        if lookup == ("identity",):
            max_new = int(ids_dev.max())
            if max_new >= cap:
                need = next_pow2(max_new + 1)
                if need > 2 * next_pow2(max(new_total, 1)):
                    # Gappy growth broke the id-indexed gate: go positional.
                    self._refine_rebuild_positional(rows_dev, ids_dev)
                    return
                vecs, ids_arr, valid = self._grow_store(vecs, ids_arr, valid, need)
            positions = ids_dev.to(torch.int64)
        elif lookup[0] == "sparse":
            # A binary-search layout cannot absorb appends: rebuild.
            self._refine_rebuild_positional(rows_dev, ids_dev)
            return
        else:  # positional store + dense id -> row table
            start = self._refine_rows
            if start + batch > cap:
                vecs, ids_arr, valid = self._grow_store(vecs, ids_arr, valid,
                                                        next_pow2(start + batch))
            positions = torch.arange(start, start + batch, device=self.device)
            self._refine_rows = start + batch
            table = lookup[1]
            max_new = int(ids_dev.max())
            if max_new >= int(table.shape[0]):
                grown = torch.zeros((next_pow2(max_new + 1),), dtype=torch.int32,
                                    device=self.device)
                grown[: table.shape[0]] = table
                table = grown
            table[ids_dev.long()] = positions.to(torch.int32)
            lookup = ("dense", table)
        vecs[positions] = rows_dev.to(vecs.dtype)
        ids_arr[positions] = ids_dev.to(torch.int32)
        valid[positions] = True
        self._staged_refine = (vecs, lookup, ids_arr, valid)

    def _refine_rebuild_positional(self, rows_dev, ids_dev) -> None:
        """When an append breaks the id-indexed gate: compact the existing
        store and the new rows into a positional layout."""
        vecs, _, ids_arr, valid = self._staged_refine
        n_old = int(valid.sum())
        if n_old:
            old_v, old_i, _ = _extract_rows(vecs.reshape(1, -1, self.dim),
                                            ids_arr.reshape(1, -1), n_old)
            all_v = torch.cat([old_v, rows_dev.to(old_v.dtype)])
            all_i = torch.cat([old_i, ids_dev.to(torch.int32)])
        else:
            all_v, all_i = rows_dev, ids_dev.to(torch.int32)
        n = int(all_v.shape[0])
        store, ids_new, valid_new = self._empty_store(next_pow2(max(n, 1)))
        store[:n] = all_v.to(store.dtype)
        ids_new[:n] = all_i
        valid_new[:n] = True
        self._refine_rows = n
        self._staged_refine = (store, build_id_lookup_device(
            all_i, torch.arange(n, dtype=torch.int32, device=self.device)), ids_new, valid_new)

    # -- full ranking -----------------------------------------------------------------

    def ranked_rows(self) -> int | None:
        """Rows of the full ranking (the refine store); None for pure-code
        indexes, which have no batched ranking."""
        return int(self._stage_refine()[0].shape[0]) if self.refine else None

    def ranked_all_device(self, query):
        """Full exact ranking over the refine store, left ON DEVICE: (dists,
        ids_i32, n); the query is a numpy array or a tensor. None for
        pure-code indexes (refine=False), whose full ranking is ranked_all's
        ADC ranking."""
        if not self.refine:
            return None
        vecs, _, ids, valid = self._stage_refine()
        dists, out_ids = ranked_program(vecs.to(torch.float32), ids, valid,
                                        query_rows(query, self.dim, self.device)[0])
        return dists, out_ids, self.ntotal

    def ranked_many_device(self, queries):
        """Batched ranked_all_device: (dists (B, cap), ids (B, cap), n); None
        for pure-code indexes."""
        if not self.refine:
            return None
        q = query_rows(queries, self.dim, self.device)
        vecs, _, ids, valid = self._stage_refine()
        dists, out_ids = ranked_many_program(vecs.to(torch.float32), ids, valid, q)
        return dists, out_ids, self.ntotal

    def ranked_all(self, query: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Full ranking of every stored vector: the exact scan of the refine
        store with refine on; for a pure-code index the ADC estimate of
        every code (bounded steps, one sort), with tail rows merged by the
        same estimate."""
        if self.ntotal == 0:
            return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
        if self.refine:
            dists, out_ids, n = self.ranked_all_device(query)
            return dists[:n].cpu().numpy(), out_ids[:n].cpu().numpy().astype(np.int64)
        q_adc = self._rotate_device(query_rows(query, self.dim, self.device))[0]
        (centroids, _, codebooks, list_codes, list_ids, canvas, _, _) = self._stage()
        if list_codes is None:
            list_codes = unstage_codes_device(canvas, self.m, int(codebooks.shape[1]))
        dists, out_ids = _adc_ranked(centroids, codebooks, list_codes, list_ids, q_adc)
        n = self.ntotal
        dists = dists[:n].cpu().numpy()
        out_ids = out_ids[:n].cpu().numpy().astype(np.int64)
        if self._tail and self._tail.count:
            # ranked_all is exhaustive: tail rows merge unmasked.
            c = self._tail.count
            diff = self._tail["recon"][:c] - q_adc[None, :]
            td = (diff * diff).sum(dim=1).cpu().numpy()
            ti = self._tail["ids"][:c].cpu().numpy().astype(np.int64)
            alld = np.concatenate([dists, td])
            alli = np.concatenate([out_ids, ti])
            perm = np.lexsort((alli, alld))
            dists, out_ids = alld[perm][:n], alli[perm][:n]
        return dists, out_ids

    # -- serialization --------------------------------------------------------------------

    def state(self) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
        params = {
            "dim": self.dim, "nlist": self.nlist, "nprobe": self.nprobe,
            "m": self.m, "ksub": self.ksub,
            "refine": self.refine, "refine_factor": self.refine_factor,
            "refine_dtype": self.refine_dtype,
            "opq": self.opq, "opq_iters": self.opq_iters,
            "capacity": self.capacity, "pad_cap": self.pad_cap,
        }
        rotation = (self._rotation if self._rotation is not None
                    else np.zeros((0, self.dim), np.float32))
        if self._mode == "device" and self.ntotal:
            # The one place device mode crosses to the host: codes come back
            # out of the canvas, raw rows (refine only) out of the refine
            # store, id-aligned; rows are written ascending by id.
            idsa, assign, codes = self._codes_all()
            ids_np = idsa.cpu().numpy().astype(np.int64)
            order = np.argsort(ids_np, kind="stable")
            vectors = np.zeros((0, self.dim), np.float32)
            if self.refine:
                raw_v, raw_i = self._raw_rows_all()
                raw_v = raw_v.to(torch.float32).cpu().numpy()
                raw_i = raw_i.cpu().numpy()
                sorter = np.argsort(raw_i, kind="stable")
                vectors = raw_v[sorter[np.searchsorted(raw_i, ids_np[order], sorter=sorter)]]
            return params, {
                "ids": ids_np[order],
                "codes": codes.cpu().numpy()[order],
                "assign": assign.cpu().numpy().astype(np.int32)[order],
                "centroids": self._np(self._centroids),
                "codebooks": self._np(self._codebooks),
                "vectors": vectors,
                "rotation": rotation,
            }
        empty_books = np.zeros((self.m, 0, self.dim // self.m), np.float32)
        return params, {
            "ids": self._ids,
            "codes": self._codes,
            "assign": self._assign if self._assign is not None else np.zeros((0,), np.int32),
            "centroids": (self._np(self._centroids) if self._centroids is not None
                          else np.zeros((0, self.dim), np.float32)),
            "codebooks": (self._np(self._codebooks) if self._codebooks is not None
                          else empty_books),
            "vectors": self._vectors,
            "rotation": rotation,
        }

    @classmethod
    def from_state(cls, params: dict[str, Any], arrays: dict[str, np.ndarray],
                   device: str | torch.device | None = None) -> "IVFPQIndex":
        """Accepts the JAX package's IVFPQIndex.state() output unchanged, in
        host mode (as the JAX package restores it), with rows sorted by id."""
        index = cls(
            dim=int(params["dim"]), nlist=int(params["nlist"]), nprobe=int(params["nprobe"]),
            m=int(params["m"]), ksub=int(params["ksub"]),
            refine=bool(params.get("refine", False)),
            refine_factor=int(params.get("refine_factor", 4)),
            refine_dtype=str(params.get("refine_dtype", "float32")),
            opq=bool(params.get("opq", False)),
            opq_iters=int(params.get("opq_iters", 8)),
            capacity=params.get("capacity"),
            pad_cap=params.get("pad_cap"),
            device=device,
        )
        if arrays.get("rotation") is not None and arrays["rotation"].size:
            index._rotation = np.ascontiguousarray(arrays["rotation"], np.float32)
        if "vectors" in arrays and arrays["vectors"].size:
            index._vectors = np.ascontiguousarray(arrays["vectors"], dtype=np.float32)
        if arrays["centroids"].size:
            index._centroids = np.ascontiguousarray(arrays["centroids"], dtype=np.float32)
        if arrays["codebooks"].size:
            index._codebooks = np.ascontiguousarray(arrays["codebooks"], dtype=np.float32)
        if arrays["ids"].size:
            index._ids = np.ascontiguousarray(arrays["ids"], dtype=np.int64)
            index._codes = np.ascontiguousarray(arrays["codes"], dtype=np.uint8)
            index._assign = np.ascontiguousarray(arrays["assign"], dtype=np.int32)
            index._sort_host_rows()
        return index
