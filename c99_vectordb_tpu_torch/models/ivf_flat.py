"""IVF-Flat index — k-means coarse quantizer + inverted-list scan.

Counterpart of the JAX package's models/ivf_flat.py. The coarse quantizer
trains with ops/kmeans.py; inverted lists are dense padded (nlist, pad, D)
blocks, so probing is a gather of whole lists with no data-dependent
shapes.

Two storage modes (models/devbuild.py):

  * HOST mode (numpy inputs — the CLI scale): raw vectors are kept on the
    host; staging buckets them once and pushes the device stores.
  * DEVICE mode (the first add/train input is a torch.Tensor — corpus
    scale): train, assignment, bucketing, scatter and quantisation run on
    the index's device and no n-sized array crosses to the host. After
    staging, the bucketed store IS the storage; with rerank_dtype=
    "bfloat16" rows are kept in bf16.

Rows added after staging park in a device-side tail (devbuild.GrowTail)
that search scores exactly, visible only to queries that probe their
assigned list, and merges by (distance, id); a restage folds the tail into
the lists once it outgrows tail_restage_threshold.

Search has two routes, chosen as in models/flat.py by the device (and
explicit in `_search(..., card_route=)`):
  - the card route (the JAX package's TPU branches), on the kernels of
    csrc/ivf_scan.cu (ops/ivf_scan.py): the f32 store scans exactly with
    no rerank, through the dense kernel + merge when nprobe * pad <= 4096
    and the select kernel otherwise; the bf16 store takes a slacked
    shortlist from the same kernels (dense up to 6144) and the exact f32
    rerank; the int8 (SQ8) store takes its shortlist from the int8 dense
    kernel and reranks by bucket row. Probes: c_sq - 2 q.c.
  - the CPU route (`_ivf_search_program` in the JAX package): a loop over
    probe ranks with direct (x - q)^2 distances of the f32-cast store and a
    merge_topk per probe. Probes: clamped q_sq + c_sq - 2 q.c.
The tail's probes use the unclamped q_sq + c_sq - 2 q.c. Each route keeps
its own formula, as in the JAX package, so near-tie probes pick the same
lists there and here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..constants import DIM
from ..ops.distances import query_rows, ranked_many_program, ranked_program, scores_via_matmul
from ..ops.ivf_scan import ivf_full_search, ivf_sq8_search
from ..ops.kmeans import assign_clusters, train_kmeans
from ..ops.rerank import build_id_lookup, exact_rerank_rows, exact_rerank_staged, shortlist_depth
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
    canvas_id_lookup,
    capped_assign,
    capped_assign_incremental,
    corpus_geometry,
    fold_rank,
    fold_scatter,
    grow_pad,
    is_device_array,
    keep_of,
    list_hwm,
    mask_norms,
    mask_shortlist_ids,
    merge_tail,
    removal_table,
    rows_sqn,
    scatter_list_ids_device,
    scatter_lists_device,
    sq8_encode_rows,
    tail_restage_threshold,
    tail_scores,
)
from .registry import register

# Scan-width gates of the card route (the JAX package's values): up to
# this many candidates per query the dense kernel + merge runs, above it
# the select kernel.
DENSE_MAX_F32 = 4096
DENSE_MAX_BF16 = 6144

# Bytes of one SQ8 staging pass block, and of one CPU-route gather step.
_SQ8_BLOCK_BYTES = 256 << 20
_CPU_STEP_BYTES = 128 << 20


def _sq8_stage(lv: torch.Tensor, li: torch.Tensor, reduce_maxabs=None):
    """Symmetric per-dimension SQ8 of the bucketed lists, on their device.

    Scale and statistics compute in f32 whatever the store dtype. Both
    passes walk ~256 MB macro-blocks, so a 1M x 384 store never exists
    whole in f32 beside itself. reduce_maxabs: applied to the (D,) maxabs
    of the live rows before the scale is taken (the sharded index passes
    a MAX all_reduce over its shards, so every shard codes alike). Returns
    (codes (nlist, pad, D) int8, scale (D,), decoded-space norms (nlist,
    pad))."""
    nlist, pad, d = lv.shape
    total = nlist * pad
    nblocks = 1
    while (total // nblocks) * d * 4 > _SQ8_BLOCK_BYTES and total % (nblocks * 2) == 0:
        nblocks *= 2
    step = total // nblocks
    rows = lv.reshape(total, d)
    live = (li >= 0).reshape(total)
    maxabs = torch.zeros((d,), dtype=torch.float32, device=lv.device)
    for s0 in range(0, total, step):
        v32 = torch.where(live[s0 : s0 + step, None], rows[s0 : s0 + step].to(torch.float32), 0.0)
        maxabs = torch.maximum(maxabs, v32.abs().amax(dim=0))
    if reduce_maxabs is not None:
        maxabs = reduce_maxabs(maxabs)
    scale = torch.clamp_min(maxabs, 1e-30) / 127.0
    codes = torch.empty((total, d), dtype=torch.int8, device=lv.device)
    dec_sqn = torch.empty((total,), dtype=torch.float32, device=lv.device)
    for s0 in range(0, total, step):
        c = torch.clamp(torch.round(rows[s0 : s0 + step].to(torch.float32) / scale), -127, 127)
        dec = c * scale
        codes[s0 : s0 + step] = c.to(torch.int8)
        dec_sqn[s0 : s0 + step] = (dec * dec).sum(dim=-1)
    return codes.reshape(nlist, pad, d), scale, dec_sqn.reshape(nlist, pad)


def _extract_rows(store, list_ids, n: int):
    """Staged lists -> compact (n, D) rows, (n,) ids, (n,) assign, in canvas
    (list-major) order; every merge sorts by (distance, id)."""
    nlist, pad, dim = store.shape
    flat_i = list_ids.reshape(-1)
    perm = torch.argsort((flat_i < 0).to(torch.int8), stable=True)[:n]
    return store.reshape(-1, dim)[perm], flat_i[perm], (perm // pad).to(torch.int32)


@register
class IVFFlatIndex:
    kind = "ivf_flat"

    def __init__(self, dim: int = DIM, nlist: int = 64, nprobe: int = 8,
                 scan_dtype: str = "float32", rerank_dtype: str = "float32",
                 pad_cap: int | None = None, device: str | torch.device | None = None):
        """scan_dtype="int8" stages SQ8 inverted lists (a quarter of the f32
        scan bytes; shortlist + exact rerank restores correctness) or
        "bfloat16" (half). rerank_dtype="bfloat16" keeps the rerank store in
        bf16 (recall then caps at the bf16 rounding ceiling).

        pad_cap bounds inverted-list length: overflow rows — the FARTHEST
        from their centroid — relocate to their next-nearest centroid with
        space (devbuild.capped_assign). Spilled rows are only found when
        their host list is probed."""
        if scan_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"unsupported scan_dtype: {scan_dtype}")
        if rerank_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported rerank_dtype: {rerank_dtype}")
        if scan_dtype == "float32" and rerank_dtype == "bfloat16":
            raise ValueError(
                "rerank_dtype='bfloat16' requires a quantized scan_dtype "
                "('int8' or 'bfloat16'); the float32 scan is exact and "
                "has no rerank stage"
            )
        self.dim = int(dim)
        self.nlist = int(nlist)
        self.nprobe = int(nprobe)
        self.scan_dtype = scan_dtype
        self.rerank_dtype = rerank_dtype
        if pad_cap is not None and int(pad_cap) < 8:
            raise ValueError(f"pad_cap must be >= 8, got {pad_cap}")
        self.pad_cap = int(pad_cap) if pad_cap else None
        self.device = resolve_device(device)
        # Host mode storage (numpy mirrors, the CLI scale).
        self._vectors = np.zeros((0, self.dim), dtype=np.float32)
        self._ids = np.zeros((0,), dtype=np.int64)
        self._assign: np.ndarray | None = None
        # Device mode storage (see the module docstring).
        self._mode = "host"
        self._dev_vecs = ChunkStore()
        self._dev_ids = ChunkStore()
        self._dev_assign = ChunkStore()
        self._n_dev = 0
        self._centroids = None          # numpy (host mode) or tensor (device mode)
        self._staged = None
        self._hwm = None                # (nlist,) int32 list_hwm of the staged ids
        self._cap_valid = False         # staged assignment respects pad_cap
        self._tail: GrowTail | None = None
        self._restage_needed = False
        self._ranked_cache = None
        self._list_counts = None        # per-list counts of the last staging
        self._mask_cache = MaskCache(self.device)

    # -- introspection ------------------------------------------------------

    @property
    def ntotal(self) -> int:
        if self._mode == "device":
            return self._n_dev
        return int(self._vectors.shape[0])

    @property
    def is_trained(self) -> bool:
        return self._centroids is not None

    def ids(self) -> np.ndarray:
        if self._mode == "device":
            if self._n_dev == 0:
                return np.zeros((0,), np.int64)
            return self._rows_all()[1].cpu().numpy().astype(np.int64)
        return self._ids.copy()

    def geometry_diagnostic(self) -> dict:
        """Clustering-geometry stats of the current staging (stages if
        needed) — devbuild.corpus_geometry, computed here from the counts
        the staging kept, so staging itself pays nothing for it."""
        if self.ntotal == 0 or not self.is_trained:
            return corpus_geometry(np.zeros((0,), np.int64))
        self._stage()
        counts = self._list_counts
        if isinstance(counts, torch.Tensor):
            counts = counts.cpu().numpy()
        return corpus_geometry(counts, self.pad_cap)

    # -- helpers ----------------------------------------------------------------

    @property
    def _keep_dtype(self):
        """Device-mode row dtype: bf16 when the rerank store is bf16."""
        return torch.bfloat16 if self.rerank_dtype == "bfloat16" else torch.float32

    def _on_device(self, x, dtype=None) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = np.ascontiguousarray(x)
            # Read-only arrays (mmap'd files, other frameworks' buffers) are
            # copied: staged tensors may be written in place (a tail fold).
            x = torch.from_numpy(x if x.flags.writeable else x.copy())
        return x.to(device=self.device, dtype=dtype)

    @staticmethod
    def _host(x) -> np.ndarray:
        """Vectors as a host float32 array."""
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", torch.float32).numpy()
        return x

    @staticmethod
    def _host_ids(ids) -> np.ndarray:
        """Ids as a flat host int64 array (never through a float)."""
        if isinstance(ids, torch.Tensor):
            ids = ids.detach().cpu().numpy()
        return np.asarray(ids, dtype=np.int64).reshape(-1)

    def _centroids_dev(self) -> torch.Tensor:
        return self._on_device(self._centroids, torch.float32)

    def _new_tail(self, vec_dtype: str) -> GrowTail:
        return GrowTail({
            "vecs": (self.dim, vec_dtype),
            "ids": (None, "int32"),
            "assign": (None, "int32"),
        }, self.device, initial_cap=tail_restage_threshold(self.ntotal))

    def _rows_all(self):
        """Device mode: every stored row as (vecs, ids, assign) tensors —
        from the staged lists, the tail, and pending chunks."""
        parts_v, parts_i, parts_a = [], [], []
        if self._staged is not None:
            n_staged = self._n_dev - len(self._dev_vecs) - (
                self._tail.count if self._tail else 0)
            if n_staged:
                v, i, a = _extract_rows(self._staged[2], self._staged[3], n_staged)
                parts_v.append(v)
                parts_i.append(i)
                parts_a.append(a)
        if self._tail and self._tail.count:
            c = self._tail.count
            parts_v.append(self._tail["vecs"][:c])
            parts_i.append(self._tail["ids"][:c])
            parts_a.append(self._tail["assign"][:c])
        if len(self._dev_vecs):
            parts_v.append(self._dev_vecs.consolidated(self._keep_dtype))
            parts_i.append(self._dev_ids.consolidated(torch.int32))
            parts_a.append(self._dev_assign.consolidated(torch.int32))
        cat = lambda ps: ps[0] if len(ps) == 1 else torch.cat(ps)  # noqa: E731
        return cat(parts_v), cat(parts_i), cat(parts_a)

    def _reset_staging(self) -> None:
        self._staged = None
        self._hwm = None
        self._cap_valid = False
        self._tail = None
        self._restage_needed = False
        self._ranked_cache = None

    # -- training / mutation ------------------------------------------------------

    def train(self, data, *, iters: int = 10, seed: int = 0, init: str = "maximin") -> None:
        if is_device_array(data) and self.ntotal == 0:
            self._mode = "device"
        if self._mode == "device":
            data = self._on_device(data, torch.float32).reshape(-1, self.dim)
            nlist_eff = min(self.nlist, max(1, int(data.shape[0])))
            self._centroids = train_kmeans(data, nlist_eff, iters=iters, seed=seed,
                                           out_device=True, init=init)
            if self.ntotal:
                # Retrain: pull every row back out of the staged layout,
                # re-assign, re-park as pending chunks.
                vecs, idsa, _ = self._rows_all()
                assign = assign_clusters(vecs.to(torch.float32), self._centroids,
                                         out_device=True)
                for store in (self._dev_vecs, self._dev_ids, self._dev_assign):
                    store.clear()
                self._dev_vecs.append(vecs)
                self._dev_ids.append(idsa)
                self._dev_assign.append(assign)
            self._reset_staging()
            return
        data = np.ascontiguousarray(self._host(data), dtype=np.float32).reshape(-1, self.dim)
        nlist_eff = min(self.nlist, max(1, data.shape[0]))
        self._centroids = train_kmeans(data, nlist_eff, iters=iters, seed=seed, init=init,
                                       device=self.device)
        if self.ntotal:
            self._assign = assign_clusters(self._vectors, self._centroids, device=self.device)
        self._reset_staging()

    def _add_device(self, vectors: torch.Tensor, ids) -> None:
        vectors = vectors.reshape(-1, self.dim)
        ids = self._on_device(
            ids if is_device_array(ids) else self._host_ids(ids), torch.int32).reshape(-1)
        if not self.is_trained:
            self.train(vectors)
        assign = assign_clusters(vectors.to(torch.float32), self._centroids, out_device=True)
        kept = vectors.to(self._keep_dtype)
        if self._staged is not None:
            if self._tail is None:
                self._tail = self._new_tail(str(self._keep_dtype).removeprefix("torch."))
            self._tail.append(vecs=kept, ids=ids, assign=assign)
            if self._tail.count > tail_restage_threshold(self.ntotal):
                self._restage_needed = True
        else:
            self._dev_vecs.append(kept)
            self._dev_ids.append(ids)
            self._dev_assign.append(assign)
        self._n_dev += int(vectors.shape[0])
        self._ranked_cache = None

    def add(self, vectors, ids) -> None:
        """Append (n, dim) vectors with external ids (n,). A tensor as the
        first input puts the index in device mode."""
        if is_device_array(vectors) and self._mode == "host" and self.ntotal == 0:
            self._mode = "device"
        if self._mode == "device":
            self._add_device(self._on_device(vectors), ids)
            return
        vectors = np.ascontiguousarray(self._host(vectors), dtype=np.float32).reshape(-1, self.dim)
        ids = self._host_ids(ids)
        if not self.is_trained:
            self.train(vectors)
        new_assign = assign_clusters(vectors, self._centroids, device=self.device)
        if self._staged is not None:
            # O(batch) incremental path: park the new rows in the device
            # tail instead of invalidating the whole staging.
            if self._tail is None:
                self._tail = self._new_tail("float32")
            self._tail.append(vecs=torch.from_numpy(vectors),
                              ids=torch.from_numpy(ids.astype(np.int32)),
                              assign=torch.from_numpy(new_assign))
            if self._tail.count > tail_restage_threshold(self.ntotal):
                self._restage_needed = True
        self._vectors = np.concatenate([self._vectors, vectors], axis=0)
        self._ids = np.concatenate([self._ids, ids])
        old_assign = self._assign if self._assign is not None else np.zeros((0,), np.int32)
        self._assign = np.concatenate([old_assign, new_assign])
        self._sort_host_rows()
        self._ranked_cache = None

    def _sort_host_rows(self) -> None:
        if not np.all(self._ids[:-1] <= self._ids[1:]):
            order = np.argsort(self._ids, kind="stable")
            self._vectors = self._vectors[order]
            self._ids = self._ids[order]
            if self._assign is not None and self._assign.shape[0] == order.shape[0]:
                self._assign = self._assign[order]

    def reconstruct(self, doc_id: int) -> np.ndarray:
        """The stored vector of an external id (bf16-retained rows come back
        bf16-rounded); raises KeyError if absent."""
        if self._mode == "device":
            if self._n_dev == 0:
                raise KeyError(f"id {doc_id} not in index")
            vecs, idsa, _ = self._rows_all()
            pos = torch.nonzero(idsa == int(doc_id)).flatten()
            if not pos.numel():
                raise KeyError(f"id {doc_id} not in index")
            return vecs[int(pos[0])].to(torch.float32).cpu().numpy()
        pos = np.searchsorted(self._ids, int(doc_id))
        if pos >= self._ids.shape[0] or self._ids[pos] != doc_id:
            raise KeyError(f"id {doc_id} not in index")
        return self._vectors[pos].copy()

    def remove_ids(self, ids) -> int:
        """Remove stored rows by external id; returns how many were removed.
        Host mode filters the mirrors and restages lazily. Device mode
        removes IN PLACE: the tail folds in, then matching list ids turn -1
        and their scan norms +inf (the kernels' exclusion marker)."""
        if self._mode == "device":
            if self._n_dev == 0:
                return 0
            if self._staged is not None and self._tail and self._tail.count:
                self._restage_needed = True
            self._stage()
            (centroids, c_sq, store, li, list_sqn, id_lookup, pad,
             scan_extra) = self._staged
            table = removal_table(ids, self.device)
            if scan_extra is not None and scan_extra[0] == "int8":
                li, removed, list_sqn, dec_sqn = apply_removal(li, table, list_sqn, scan_extra[3])
                scan_extra = ("int8", scan_extra[1], scan_extra[2], dec_sqn)
            else:
                li, removed, list_sqn = apply_removal(li, table, list_sqn)
            if removed:
                self._put_staged((centroids, c_sq, store, li, list_sqn, id_lookup, pad, scan_extra))
                self._n_dev -= removed
                self._ranked_cache = None
                self._mask_cache.clear()
            return removed
        ids = np.unique(self._host_ids(ids))
        keep = ~np.isin(self._ids, ids)
        removed = int(self._ids.shape[0] - keep.sum())
        if removed:
            self._vectors = self._vectors[keep]
            self._ids = self._ids[keep]
            if self._assign is not None:
                self._assign = self._assign[keep]
            self._reset_staging()
            self._mask_cache.clear()
        return removed

    # -- staging -------------------------------------------------------------------------

    def _put_staged(self, staged) -> None:
        """Keep a staging and the high-water marks of its list ids, where
        the scan kernels stop; every change to the staged ids comes
        through here."""
        self._staged = staged
        self._hwm = list_hwm(staged[3]).to(torch.int32)

    def _build_masked(self, keep):
        """Once-per-mask staged operands of the keep table `keep`: the
        masked list norms (and decoded norms on the int8 scan; +inf IS the
        kernels' exclusion marker) and the lists' keep mask for the plain
        route."""
        _, _, _, list_ids, list_sqn, _, _, scan_extra = self._stage()
        return (mask_norms(list_sqn, list_ids, keep),
                None if scan_extra is None or scan_extra[0] != "int8"
                else mask_norms(scan_extra[3], list_ids, keep),
                keep_of(list_ids, keep))

    def _stage(self):
        if self._staged is None or self._restage_needed:
            # A restage folds the tail into the existing lists when it can
            # (shape-stable, O(tail)); else it rebuilds from scratch.
            if not (self._restage_needed and self._staged is not None and self._fold_tail()):
                if self._mode == "device":
                    self._stage_device()
                else:
                    self._stage_host()
            self._tail = None
            self._restage_needed = False
            self._mask_cache.clear()
        return self._staged

    def _fold_tail(self) -> bool:
        """Incremental restage: append the tail rows at each list's
        high-water mark in the EXISTING canvases, in place. Returns False
        when the fold cannot apply — pending chunks, a sparse-id lookup, or
        a pad_cap the remaining capacity cannot honour — and the caller
        rebuilds. With pad_cap only the tail re-places
        (capped_assign_incremental): staged rows never move."""
        if not (self._tail and self._tail.count):
            return False
        if self._mode == "device" and len(self._dev_vecs):
            return False
        (centroids, c_sq, store, li, list_sqn, id_lookup, pad,
         scan_extra) = self._staged
        if id_lookup[0] not in ("dense", "identity"):
            return False
        nlist = int(centroids.shape[0])
        tail = self._tail
        tvecs, tids, tassign = tail["vecs"], tail["ids"], tail["assign"]
        self._ranked_cache = None        # may alias the staged store
        hwm = list_hwm(li)
        if self.pad_cap:
            base = hwm.cpu().numpy()
            if int(base.max(initial=0)) > self.pad_cap:
                return False
            try:
                tassign, _ = capped_assign_incremental(
                    tvecs.to(torch.float32), centroids, base, self.pad_cap,
                    valid=tids >= 0, n_valid=tail.count)
            except ValueError:
                return False
        order, lists, slots, new_hwm = fold_rank(tassign, tids, hwm, nlist)
        max_new = int(new_hwm.max())
        if self.pad_cap and max_new > self.pad_cap:
            return False
        shared_scan = (scan_extra is not None and scan_extra[0] == "bfloat16"
                       and scan_extra[1] is store)
        if max_new > pad:
            pad = list_pad(max_new)
            store = grow_pad(store, pad)
            li = grow_pad(li, pad, fill=-1)
            list_sqn = grow_pad(list_sqn, pad)
            if scan_extra is not None and scan_extra[0] == "int8":
                scan_extra = ("int8", grow_pad(scan_extra[1], pad), scan_extra[2],
                              grow_pad(scan_extra[3], pad))
            elif scan_extra is not None and not shared_scan:
                scan_extra = ("bfloat16", grow_pad(scan_extra[1], pad))
        store = fold_scatter(store, tvecs, order, lists, slots)
        li = fold_scatter(li, tids, order, lists, slots)
        list_sqn = fold_scatter(list_sqn, rows_sqn(tvecs), order, lists, slots)
        if scan_extra is not None:
            if scan_extra[0] == "int8":
                codes, dec = sq8_encode_rows(tvecs, scan_extra[2])
                scan_extra = ("int8", fold_scatter(scan_extra[1], codes, order, lists, slots),
                              scan_extra[2],
                              fold_scatter(scan_extra[3], dec, order, lists, slots))
            elif shared_scan:
                scan_extra = ("bfloat16", store)
            else:
                scan_extra = ("bfloat16",
                              fold_scatter(scan_extra[1], tvecs, order, lists, slots))
        id_lookup = canvas_id_lookup(li, int(li.max()))
        self._list_counts = (li >= 0).sum(dim=1)
        self._put_staged((centroids, c_sq, store, li, list_sqn, id_lookup, pad, scan_extra))
        self._cap_valid = bool(self.pad_cap)
        return True

    def _stage_device(self):
        """Bucket rows into padded inverted lists on the device — only the
        (nlist,) counts cross to the host."""
        vecs, idsa, assign = self._rows_all()
        # Rows come staged-first (then tail, then chunks): after a capped
        # staging the leading rows hold a capacity-valid assignment and only
        # the new rows re-place.
        n_base = (self._n_dev - len(self._dev_vecs) - (self._tail.count if self._tail else 0)
                  if self._cap_valid else 0)
        self._stage_from_rows(vecs, idsa, assign, n_base=n_base)
        for store in (self._dev_vecs, self._dev_ids, self._dev_assign):
            store.clear()

    def _stage_from_rows(self, vecs, idsa, assign, n_base: int = 0):
        """Device staging core shared by device mode and host mode's capped
        branch. n_base: leading rows whose assignment is already
        capacity-valid; the capped branch then places only the trailing
        rows (capped_assign_incremental)."""
        centroids = self._centroids_dev()
        nlist_eff = int(centroids.shape[0])
        order, lists, slots, counts = bucketize_device(assign, nlist_eff)
        self._list_counts = counts
        if self.pad_cap and int(counts.max(initial=0)) > self.pad_cap:
            assign = assign.to(torch.int32)
            incremental = False
            if 0 < n_base < int(assign.shape[0]):
                base_counts = np.bincount(assign[:n_base].cpu().numpy(), minlength=nlist_eff)
                if int(base_counts.max(initial=0)) <= self.pad_cap:
                    try:
                        new_assign, _ = capped_assign_incremental(
                            vecs[n_base:], centroids, base_counts, self.pad_cap)
                        assign = torch.cat([assign[:n_base], new_assign])
                        incremental = True
                    except ValueError:
                        pass  # not enough free slots: full reassign below
            if not incremental:
                assign, _ = capped_assign(vecs, centroids, self.pad_cap)
            order, lists, slots, counts = bucketize_device(assign, nlist_eff)
        self._cap_valid = bool(self.pad_cap)
        pad = list_pad(int(counts.max(initial=1)))
        store = scatter_lists_device(vecs, order, lists, slots, nlist_eff, pad)
        li = scatter_list_ids_device(idsa, order, lists, slots, nlist_eff, pad)
        c_sq = (centroids * centroids).sum(dim=1)
        list_sqn = rows_sqn(store.reshape(-1, self.dim)).reshape(nlist_eff, pad)
        bucket_row = torch.zeros((int(vecs.shape[0]),), dtype=torch.int32, device=self.device)
        bucket_row[order] = (lists * pad + slots).to(torch.int32)
        id_lookup = build_id_lookup_device(idsa, bucket_row)
        if self.scan_dtype == "float32":
            scan_extra = None
        elif self.scan_dtype == "bfloat16":
            scan_extra = ("bfloat16",
                          store if store.dtype == torch.bfloat16 else store.to(torch.bfloat16))
        else:
            codes, dim_scale, dec_sqn = _sq8_stage(store, li)
            scan_extra = ("int8", codes, dim_scale, dec_sqn)
        self._put_staged((centroids, c_sq, store, li, list_sqn, id_lookup, pad, scan_extra))

    def _stage_host(self):
        """Host-mode staging (the CLI scale): bucket on the host, push once.
        Norms are computed in numpy exactly as the JAX package computes
        them, so both packages stage the same bytes."""
        nlist_eff = self._centroids.shape[0]
        assign_eff = self._assign
        counts = np.bincount(assign_eff, minlength=nlist_eff)
        self._list_counts = counts
        if self.pad_cap and int(counts.max(initial=0)) > self.pad_cap:
            # Capped staging: push the corpus once and run the device core.
            self._stage_from_rows(
                self._on_device(self._vectors, self._keep_dtype),
                self._on_device(self._ids.astype(np.int32)),
                self._on_device(assign_eff),
            )
            return
        pad = list_pad(int(counts.max(initial=1)))
        list_vecs = np.zeros((nlist_eff, pad, self.dim), np.float32)
        list_ids = np.full((nlist_eff, pad), -1, np.int32)
        # Stable sort by list keeps ascending-id order inside each list.
        order = np.argsort(assign_eff, kind="stable")
        sorted_lists = assign_eff[order]
        starts = np.zeros((nlist_eff,), np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        slots = np.arange(len(order)) - starts[sorted_lists]
        list_vecs[sorted_lists, slots] = self._vectors[order]
        list_ids[sorted_lists, slots] = self._ids[order]
        c_sq = np.einsum("nd,nd->n", self._centroids, self._centroids)
        list_sqn = np.einsum("lpd,lpd->lp", list_vecs, list_vecs)
        bucket_row = np.zeros((self.ntotal,), np.int32)
        bucket_row[order] = (sorted_lists * pad + slots).astype(np.int32)
        li_dev = self._on_device(list_ids)
        lv_dev = self._on_device(list_vecs)
        if self.scan_dtype == "float32":
            store, scan_extra = lv_dev, None
        elif self.scan_dtype == "bfloat16":
            scan_store = lv_dev.to(torch.bfloat16)
            scan_extra = ("bfloat16", scan_store)
            store = lv_dev if self.rerank_dtype == "float32" else scan_store
        else:
            codes, dim_scale, dec_sqn = _sq8_stage(lv_dev, li_dev)
            scan_extra = ("int8", codes, dim_scale, dec_sqn)
            store = lv_dev if self.rerank_dtype == "float32" else lv_dev.to(torch.bfloat16)
        del lv_dev
        self._put_staged((
            self._centroids_dev(),
            self._on_device(c_sq.astype(np.float32)),
            store,
            li_dev,
            self._on_device(list_sqn.astype(np.float32)),
            build_id_lookup(self._ids, self.device, rows=bucket_row),
            pad,
            scan_extra,
        ))

    # -- search --------------------------------------------------------------------------------

    def search(self, queries, k: int, *, nprobe: int | None = None,
               id_mask=None) -> tuple[np.ndarray, np.ndarray]:
        """id_mask: optional (cap,) bool keyed by EXTERNAL id (filter
        pushdown): masked rows get +inf scan norms through a once-per-mask
        staged copy of the norms operand. Pass the SAME mask array across
        calls to reuse the staging."""
        return self._search(queries, k, nprobe=nprobe, id_mask=id_mask,
                            card_route=self.device.type == "cuda")

    def _search(self, queries, k: int, *, nprobe: int | None = None, id_mask=None,
                card_route: bool, scan: str | None = None):
        """search() with the route explicit: card_route=True is the
        kernels' route (on CPU tensors each kernel wrapper takes its plain
        version), False the CPU route. scan = "dense" or "select" forces the
        f32/bf16 scan variant instead of the width gate."""
        q = self._on_device(queries, torch.float32).reshape(-1, self.dim)
        if self.ntotal == 0 or not self.is_trained:
            shape = (q.shape[0], k)
            return np.full(shape, np.inf, np.float32), np.full(shape, -1, np.int64)
        (centroids, c_sq, list_vecs, list_ids, list_sqn, id_lookup, pad,
         scan_extra) = self._stage()
        keep = keep_rows = None
        if id_mask is not None:
            keep, list_sqn, m_dec_sqn, keep_rows = self._mask_cache.get(id_mask,
                                                                        self._build_masked)
            if scan_extra is not None and scan_extra[0] == "int8":
                scan_extra = ("int8", scan_extra[1], scan_extra[2], m_dec_sqn)
        nprobe_eff = min(nprobe or self.nprobe, int(centroids.shape[0]))
        width = nprobe_eff * pad
        flat_store = list_vecs.reshape(-1, self.dim)
        if card_route and scan_extra is not None:
            # Quantized scan store: a slacked shortlist from the scan, then
            # the exact f32 rerank against the bucketed store.
            ks = min(shortlist_depth(k, self.ntotal), width)
            if scan_extra[0] == "int8":
                _, codes, dim_scale, dec_sqn = scan_extra
                _, si, srows = ivf_sq8_search(centroids, c_sq, codes, dim_scale, dec_sqn,
                                              list_ids, q, nprobe_eff, ks, hwm=self._hwm)
                if keep is not None:
                    si = mask_shortlist_ids(si, keep)
                dists, out_ids = exact_rerank_rows(flat_store, srows, si, q, k)
            else:
                dense = width <= DENSE_MAX_BF16 if scan is None else scan == "dense"
                _, si = ivf_full_search(centroids, c_sq, scan_extra[1], list_sqn, list_ids, q,
                                        nprobe_eff, ks, dense=dense, hwm=self._hwm)
                if keep is not None:
                    si = mask_shortlist_ids(si, keep)
                dists, out_ids = exact_rerank_staged(flat_store, id_lookup, si, q, k)
        elif card_route:
            # f32 lists: the scan's true-f32 distances are the answer.
            dense = width <= DENSE_MAX_F32 if scan is None else scan == "dense"
            dists, out_ids = ivf_full_search(centroids, c_sq, list_vecs, list_sqn, list_ids, q,
                                             nprobe_eff, k, dense=dense, hwm=self._hwm)
            if keep is not None:
                # The select kernel lets masked rows (+inf, real id) fill an
                # underfilled list; they must not come back as results.
                out_ids = mask_shortlist_ids(out_ids, keep)
        else:
            dists, out_ids = self._cpu_route(centroids, c_sq, list_vecs, list_ids, q,
                                             nprobe_eff, k, keep_rows)
        if self._tail and self._tail.count:
            # Incremental-add rows: exact distances, visible only to
            # queries that probe their assigned list, then one (distance,
            # id) merge.
            td = tail_scores(self._tail, centroids, c_sq, q, nprobe_eff)
            if keep is not None:
                td = torch.where(keep_of(self._tail["ids"], keep)[None, :], td, torch.inf)
            dists, out_ids = merge_tail(dists, out_ids, td, self._tail["ids"], k)
        return dists.cpu().numpy(), out_ids.cpu().numpy().astype(np.int64)

    def _cpu_route(self, centroids, c_sq, list_vecs, list_ids, q, nprobe: int, k: int,
                   keep=None):
        """The CPU route: probes by clamped q_sq + c_sq - 2 q.c, then per probe
        rank the f32-cast list rows by direct (x - q)^2 and merge by
        (distance, id)."""
        _, probes = stable_topk(scores_via_matmul(q, centroids, c_sq), nprobe)
        b, pad = q.shape[0], list_vecs.shape[1]
        chunk = max(1, _CPU_STEP_BYTES // (pad * self.dim * 4))
        out_d, out_i = [], []
        for q0 in range(0, b, chunk):
            qc = q[q0 : q0 + chunk]
            best_d = torch.full((qc.shape[0], k), torch.inf, device=q.device)
            best_i = torch.full((qc.shape[0], k), -1, dtype=torch.int32, device=q.device)
            for p in range(nprobe):
                lists = probes[q0 : q0 + chunk, p]
                diff = list_vecs[lists].to(torch.float32) - qc[:, None, :]
                d = (diff * diff).sum(dim=-1)
                ids = list_ids[lists]
                d = torch.where(ids >= 0, d, torch.inf)
                if keep is not None:
                    d = torch.where(keep[lists], d, torch.inf)
                best_d, best_i = merge_topk(torch.cat([best_d, d], 1),
                                            torch.cat([best_i, ids], 1), k)
            out_d.append(best_d)
            out_i.append(best_i)
        return torch.cat(out_d), torch.cat(out_i)

    def _ranked_staged(self):
        """(vecs, ids, valid) for the full ranking, cached until the next
        add/train. An f32 bucketed store with an empty tail is reused flat
        as (nlist * pad, D) (its rows are in list order, so the ranking puts
        them in id order before sorting by distance); otherwise a
        pow2-padded f32 copy is built once."""
        if self._ranked_cache is not None:
            return self._ranked_cache
        tail_empty = not (self._tail and self._tail.count)
        if (self._staged is not None and self._staged[2].dtype == torch.float32
                and tail_empty and not self._restage_needed):
            ids = self._staged[3].reshape(-1)
            self._ranked_cache = (self._staged[2].reshape(-1, self.dim), ids, ids >= 0)
            return self._ranked_cache
        n = self.ntotal
        cap = next_pow2(max(n, 1))
        if self._mode == "device":
            vecs, idsa, _ = self._rows_all()
            vecs32 = torch.zeros((cap, self.dim), dtype=torch.float32, device=self.device)
            vecs32[:n] = vecs.to(torch.float32)
            ids = torch.full((cap,), -1, dtype=torch.int32, device=self.device)
            ids[:n] = idsa
        else:
            vecs32 = torch.zeros((cap, self.dim), dtype=torch.float32)
            vecs32[:n] = torch.from_numpy(self._vectors)
            ids = torch.full((cap,), -1, dtype=torch.int32)
            ids[:n] = torch.from_numpy(self._ids.astype(np.int32))
            vecs32, ids = vecs32.to(self.device), ids.to(self.device)
        self._ranked_cache = (vecs32, ids, ids >= 0)
        return self._ranked_cache

    def ranked_rows(self) -> int:
        """Rows of the full ranking (_ranked_staged's store)."""
        return int(self._ranked_staged()[0].shape[0])

    def ranked_all_device(self, query):
        """Full exact ranking, left ON DEVICE: (dists, ids_i32, n). The
        query is a numpy array or a tensor."""
        vecs, ids, valid = self._ranked_staged()
        dists, out_ids = ranked_program(vecs, ids, valid,
                                        query_rows(query, self.dim, self.device)[0])
        return dists, out_ids, self.ntotal

    def ranked_many_device(self, queries):
        """Batched ranked_all_device: (dists (B, cap), ids (B, cap), n)."""
        q = query_rows(queries, self.dim, self.device)
        vecs, ids, valid = self._ranked_staged()
        dists, out_ids = ranked_many_program(vecs, ids, valid, q)
        return dists, out_ids, self.ntotal

    def ranked_all(self, query: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Exact full ranking over every stored vector (CLI recall path)."""
        if self.ntotal == 0:
            return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
        dists, out_ids, n = self.ranked_all_device(query)
        return dists[:n].cpu().numpy(), out_ids[:n].cpu().numpy().astype(np.int64)

    # -- serialization -----------------------------------------------------------------------

    def state(self) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
        params = {"dim": self.dim, "nlist": self.nlist, "nprobe": self.nprobe,
                  "scan_dtype": self.scan_dtype, "rerank_dtype": self.rerank_dtype,
                  "pad_cap": self.pad_cap}
        centroids = (np.zeros((0, self.dim), np.float32) if self._centroids is None
                     else np.asarray(self._host(self._centroids), dtype=np.float32))
        if self._mode == "device" and self.ntotal:
            # The one place device mode crosses to the host; bf16 rows widen.
            vecs, idsa, assign = self._rows_all()
            return params, {
                "vectors": vecs.to(torch.float32).cpu().numpy(),
                "ids": idsa.cpu().numpy().astype(np.int64),
                "centroids": centroids,
                "assign": assign.cpu().numpy().astype(np.int32),
            }
        return params, {
            "vectors": self._vectors,
            "ids": self._ids,
            "centroids": centroids,
            "assign": self._assign if self._assign is not None else np.zeros((0,), np.int32),
        }

    @classmethod
    def from_state(cls, params: dict[str, Any], arrays: dict[str, np.ndarray],
                   device: str | torch.device | None = None) -> "IVFFlatIndex":
        """Accepts the JAX package's IVFFlatIndex.state() output unchanged
        (so a JAX-trained index carries across with its centroids and
        assignment). Rows are re-sorted by id when a device-mode file stored
        them in list order, so the host-mode id lookups hold."""
        scan_dtype = str(params.get("scan_dtype", "float32"))
        rerank_dtype = str(params.get("rerank_dtype", "float32"))
        if scan_dtype == "float32":
            # Old files could carry the no-op f32-scan + bf16-rerank pair.
            rerank_dtype = "float32"
        index = cls(
            dim=int(params["dim"]), nlist=int(params["nlist"]), nprobe=int(params["nprobe"]),
            scan_dtype=scan_dtype, rerank_dtype=rerank_dtype,
            pad_cap=params.get("pad_cap"), device=device,
        )
        if arrays["centroids"].size:
            index._centroids = np.ascontiguousarray(arrays["centroids"], dtype=np.float32)
        if arrays["vectors"].size:
            index._vectors = np.ascontiguousarray(arrays["vectors"], dtype=np.float32)
            index._ids = np.ascontiguousarray(arrays["ids"], dtype=np.int64)
            index._assign = np.ascontiguousarray(arrays["assign"], dtype=np.int32)
            index._sort_host_rows()
        return index
