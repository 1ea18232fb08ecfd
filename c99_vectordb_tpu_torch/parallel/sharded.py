"""Multi-rank flat, IVF and IVF-PQ search over torch.distributed (SPMD, one
process per rank).

Counterpart of the JAX package's parallel/sharded.py (shard_map programs
over a device mesh). Here every rank runs the same code on its own shard,
and the collectives of parallel/mesh.py stand in for JAX's all_gather /
psum:

  - search (data parallel): the padded store's rows are split over the
    mesh's corpus axes (a 1-D `data` axis, or ("host", "chip") with the
    two-level merge). Each rank takes its local top-k, then an all_gather
    of the (B, k) candidates and a (distance, id) merge give every rank
    the global top-k. Per-query traffic is O(shards * k).
  - the kernel route (the JAX package's TPU branch): per shard, the port's
    fused L2 top-k kernel (ops/topk_cuda.fused_topk) takes a slacked
    shortlist, masked shortlist ids are scrubbed to -1, and an exact f32
    rerank of the shard's own rows restores exact distances before the
    merge. The SQ8 store scans int8 codes with queries x the GLOBAL
    per-dimension scale (a MAX all_reduce over the corpus axes, so every
    shard codes alike).
  - search (2-D): rows over `data`, dims over `model`; the partial inner
    products and norms are summed over `model` before the local top-k.
  - IVF (ShardedIVFIndex): the inverted lists are SLOT-SHARDED. Each
    list's rows are dealt over the shards by in-list rank (rank r goes to
    shard r % S, local slot r // S), so every rank holds a (nlist,
    pad_local, D) block with 1/S of EVERY list and scans exactly 1/S of
    the single-device work at any nprobe. Per shard the port's IVF kernels
    run unchanged with pad -> pad_local (the select or dense kernel for the
    f32 store; the int8 dense kernel, then an exact rerank of the shard's
    own rows, for the SQ8 store), then the merge. Centroids are
    replicated: every rank trains the same k-means on the same rows.
  - IVF-PQ (ShardedIVFPQIndex): the same slot-sharded lists, holding PQ
    codes and the f32 refine rows. Per shard, the dense ADC kernel (or, off
    the card, a per-probe lookup-table scan) shortlists k * refine_factor
    of the block's rows; an exact f32 refine of those rows (a rank only
    ever reranks rows it holds), then the merge. OPQ rotates the ADC side
    only: the refine stays in the original space.
  - k-means (data parallel): `sharded_kmeans_step`, one Lloyd iteration
    whose per-list sums and counts are summed over `data`.
  - per-rank ingest (ShardedFlatIndex.add_local): each rank streams only
    its own rows into its shard, allocated once; the global count comes
    from the ranks' counts. parallel/serve.py serves such an index from one
    caller on rank 0.

Spans (utils/timing.span, off by default): `sharded.scan` (the shard's
scan), `sharded.rerank` (its exact rerank), `sharded.merge` (the
cross-rank merge), `sharded.fetch` (the copy of the merged result to the
host), `sharded.ingest` (all of add_local) and `sharded.stage` (each fill
of a staged shard). COUNTERS, always on and process-wide (as
ops/topk_cuda.fused_l2_topk.launches): `staged_live_rows`, the live rows
each staging put on this rank, summed; `merge_candidates`, the (distance,
id) candidates the merges gathered from every shard.

A rank's results are replicated after the merge. On the CPU each kernel
wrapper takes its plain version; the exact routes (matmul + top-k, the IVF
probe scan) are plain torch, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..models.base import list_pad, next_pow2
from ..models.devbuild import (
    ChunkStore, GrowTail, MaskCache, apply_removal, bucketize_device, is_device_array, list_hwm,
    merge_tail, removal_table, rows_sqn, scatter_list_ids_device, scatter_lists_device,
    tail_restage_threshold, tail_scores,
)
from ..models.ivf_flat import DENSE_MAX_F32, _sq8_stage
from ..models.ivf_pq import _residual_subs, train_opq_rotation
from ..models.registry import register
from ..ops.adc import (
    adc_dense_search, build_item_constants, build_item_constants_device, kernel_shape,
    stage_codes_device, unstage_codes_device,
)
from ..ops.distances import INT32_MAX, query_rows, ranked_many_program, ranked_program
from ..ops.ivf_scan import coarse_probes, ivf_full_search, ivf_sq8_search
from ..ops.kmeans import assign_clusters, assign_clusters_multi, train_kmeans, \
    train_kmeans_multi
from ..ops.rerank import exact_rerank_rows, shortlist_depth
from ..ops.topk import merge_topk, stable_topk
from ..ops.topk_cuda import fused_topk
from ..utils.timing import span
from .mesh import Mesh, all_gather_axes, all_gather_axis, all_reduce_axes, \
    all_reduce_axis, default_data_mesh

# The kernel keeps shortlists up to this deep (csrc/fused_l2_topk.cu).
KERNEL_MAX_K = 1024

COUNTERS = {"staged_live_rows": 0, "merge_candidates": 0}


def corpus_axes(mesh: Mesh) -> tuple[str, ...]:
    """The mesh axes the corpus shards over: ("data",), or ("host",
    "chip") merged two-level."""
    names = tuple(mesh.axis_names)
    if "data" in names:
        return ("data",)
    if "host" in names and "chip" in names:
        return ("host", "chip")
    raise ValueError(f"mesh must carry a 'data' axis or ('host', 'chip') axes, got {names}")


def shard_count(mesh: Mesh, axes: tuple[str, ...]) -> int:
    s = 1
    for a in axes:
        s *= mesh.shape[a]
    return s


def shard_index(mesh: Mesh, axes: tuple[str, ...]) -> int:
    """This rank's shard: row-major over `axes`, as a JAX P(axes) sharding
    deals the rows."""
    s = 0
    for a in axes:
        s = s * mesh.shape[a] + mesh.coordinate(a)
    return s


def shard_rows(x, mesh: Mesh, axes: tuple[str, ...]):
    """This rank's block of rows of a global (n, ...) array, n divisible by
    the shard count."""
    per = x.shape[0] // shard_count(mesh, axes)
    s = shard_index(mesh, axes)
    return x[s * per : (s + 1) * per]


# -- the merge ----------------------------------------------------------------------


def _local_topk(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """(B, n_local) -> (B, k) ascending, ties to the lowest position; +inf
    marks invalid entries. A shard with fewer than k rows pads with (inf,
    -1), so every rank's candidate block has the same shape."""
    k_eff = min(k, dists.shape[1])
    vals, pos = stable_topk(dists, k_eff)
    out_i = torch.where(torch.isinf(vals), -1, torch.gather(ids, 1, pos).to(torch.int32))
    if k_eff < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_eff), value=torch.inf)
        out_i = torch.nn.functional.pad(out_i, (0, k - k_eff), value=-1)
    return vals, out_i


def _merge_gathered(local_d, local_i, k: int, mesh: Mesh, axis: str):
    """all_gather every shard's (B, k) candidates over `axis` (one
    collective: distances ride as their int32 bits beside the ids) and
    merge them to the (distance, id) top-k."""
    b, kk = local_d.shape
    packed = torch.cat([local_d.to(torch.float32).view(torch.int32),
                        local_i.to(torch.int32)], dim=1)
    gathered = all_gather_axis(packed, mesh, axis)               # (S, B, 2k)
    cand = gathered.permute(1, 0, 2)                             # (B, S, 2k)
    cand_d = cand[..., :kk].contiguous().view(torch.float32).reshape(b, -1)
    cand_i = cand[..., kk:].reshape(b, -1)
    return merge_topk(cand_d, cand_i, k)


def _merge_axes(local_d, local_i, k: int, mesh: Mesh, axes: tuple[str, ...]):
    """The merge over `axes`, innermost first: on a ("host", "chip") mesh
    only k candidates per host cross the outer axis."""
    d, i = local_d, local_i
    with span("sharded.merge"):
        for axis in reversed(axes):
            COUNTERS["merge_candidates"] += mesh.shape[axis] * d.shape[0] * d.shape[1]
            d, i = _merge_gathered(d, i, k, mesh, axis)
    return d, i


def _merge_topk_with_rows(dists, ids, rows, k: int):
    """merge_topk carrying a per-candidate payload (`rows`) through the
    (distance, id) selection: +inf candidates tie at INT32_MAX and come
    back as id -1. The output pads to width k with (inf, -1, 0)."""
    if dists.shape[-1] < k:
        pad = k - dists.shape[-1]
        dists = torch.nn.functional.pad(dists, (0, pad), value=torch.inf)
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        rows = torch.nn.functional.pad(rows, (0, pad), value=0)
    tie_ids = torch.where(torch.isinf(dists), INT32_MAX, ids)
    by_id = torch.argsort(tie_ids, dim=-1, stable=True)
    dists, tie_ids, rows = (torch.gather(a, -1, by_id) for a in (dists, tie_ids, rows))
    by_d = torch.argsort(dists, dim=-1, stable=True)[..., :k]
    out_i = torch.gather(tie_ids, -1, by_d)
    return (torch.gather(dists, -1, by_d), torch.where(out_i == INT32_MAX, -1, out_i),
            torch.gather(rows, -1, by_d))


def _keep_of(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Keep-mask of an ids operand against a (cap,) bool table keyed by
    external id: ids below 0 or at/after cap are excluded, never
    clip-aliased onto the boundary slot."""
    cap = table.shape[0]
    safe = torch.clamp(ids.to(torch.int64), 0, cap - 1)
    return table[safe] & (ids >= 0) & (ids < cap)


def _scrub_ids(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Masked rows enter a kernel shortlist as +inf padding with their REAL
    ids; the per-shard exact rerank would re-score them finitely and leak
    them, so they become -1 first."""
    return torch.where(_keep_of(ids, table), ids, -1)


# -- the per-shard programs (each rank passes its own shard) ---------------------------


def sharded_search_program(mesh: Mesh, db, ids, sq_norms, queries, k: int,
                           axes: tuple[str, ...] = ("data",)):
    """Exact search over a row-sharded store: db (n_local, D), ids and
    sq_norms (n_local,) are this rank's rows (+inf norms on padding and
    masked rows); queries (B, D) are the same on every rank. Returns the
    replicated (dists (B, k), ids (B, k) int32)."""
    with span("sharded.scan"):
        queries = queries.to(torch.float32)
        q_sq = (queries * queries).sum(dim=1, keepdim=True)
        ip = queries @ db.T
        d = torch.clamp_min(q_sq + sq_norms[None, :] - 2.0 * ip, 0.0)
        d = torch.where(torch.isinf(sq_norms)[None, :] | (ids < 0)[None, :], torch.inf, d)
        local_d, local_i = _local_topk(d, ids[None, :].expand(d.shape), k)
    return _merge_axes(local_d, local_i, k, mesh, axes)


def sharded_search_kernels(mesh: Mesh, db, ids, sq_norms, queries, k: int, ks: int,
                           axes: tuple[str, ...] = ("data",), keep=None):
    """Exact search with the flat kernel per shard: fused scan + top-ks
    shortlist over the rank's rows (the (B, n_local) score matrix never
    reaches device memory), then an exact f32 rerank of the shard's own
    shortlisted rows (the kernel's winner rows index the shard directly),
    then the merge. keep: the (cap,) bool table of a filter, whose masked
    shortlist ids are scrubbed before the rerank. The shard needs >= 1
    row and +inf norms on padding rows (the kernel's mask)."""
    with span("sharded.scan"):
        _, si, rows = fused_topk(db, ids, sq_norms, queries, ks, return_rows=True)
        if keep is not None:
            si = _scrub_ids(si, keep)
    with span("sharded.rerank"):
        local_d, local_i = exact_rerank_rows(db, rows, si, queries, k)
    return _merge_axes(local_d, local_i, k, mesh, axes)


def sharded_search_sq8_kernels(mesh: Mesh, codes, db, ids, dec_norms, scale, queries,
                               k: int, ks: int, axes: tuple[str, ...] = ("data",),
                               keep=None):
    """sharded_search_kernels on the SQ8 store: each rank scans its int8
    codes with queries x the global per-dimension scale (the kernel's
    int8 x int8 mode; queries are row-quantised inside fused_topk), then
    reranks its shortlist exactly from its f32 rows."""
    with span("sharded.scan"):
        _, si, rows = fused_topk(codes, ids, dec_norms, queries * scale, ks, return_rows=True)
        if keep is not None:
            si = _scrub_ids(si, keep)
    with span("sharded.rerank"):
        local_d, local_i = exact_rerank_rows(db, rows, si, queries, k)
    return _merge_axes(local_d, local_i, k, mesh, axes)


def sharded_search_2d(mesh: Mesh, db, ids, queries, k: int):
    """Exact search on a ("data", "model") mesh: db is this rank's (n/data,
    D/model) block, ids its (n/data,) rows, queries its (B, D/model)
    columns. The partial inner products and the partial row and query
    norms are summed over `model` (one all_reduce), then the rows merge
    over `data`."""
    queries = queries.to(torch.float32)
    b, n = queries.shape[0], db.shape[0]
    parts = torch.cat([(queries @ db.T).reshape(-1), (db * db).sum(dim=1),
                       (queries * queries).sum(dim=1)])
    total = all_reduce_axis(parts, mesh, "model", "sum")
    ip = total[: b * n].reshape(b, n)
    x_sq = total[b * n : b * n + n]
    q_sq = total[b * n + n :, None]
    d = torch.clamp_min(q_sq + x_sq[None, :] - 2.0 * ip, 0.0)
    d = torch.where((ids >= 0)[None, :], d, torch.inf)
    local_d, local_i = _local_topk(d, ids[None, :].expand(d.shape), k)
    return _merge_axes(local_d, local_i, k, mesh, ("data",))


def sharded_search_2level(mesh: Mesh, db, ids, sq_norms, queries, k: int):
    """Exact search with the two-level (host, chip) merge: the chip merge
    first, then only the per-host winners cross `host`. Bit for bit the 1-D
    merge's result (the same candidates in the same (distance, id) order)."""
    return sharded_search_program(mesh, db, ids, sq_norms, queries, k, axes=("host", "chip"))


# -- staging -------------------------------------------------------------------------------


def _flat_sq8_stage(mesh: Mesh, axes: tuple[str, ...], db, sq):
    """Flat-store SQ8 on this rank's shard: the per-dimension scale is the
    GLOBAL maxabs (a MAX all_reduce over the corpus axes; padding rows are
    zeros and cannot win it), so every shard codes alike. Returns (codes,
    decoded-space norms with sq's +inf rows, scale)."""
    maxabs = all_reduce_axes(db.abs().amax(dim=0), mesh, axes, "max")
    scale = torch.clamp_min(maxabs, 1e-30) / 127.0
    codes = torch.clamp(torch.round(db / scale), -127, 127)
    dec = codes * scale
    dec_sq = (dec * dec).sum(dim=1)
    return codes.to(torch.int8), torch.where(torch.isinf(sq), torch.inf, dec_sq), scale


def _flat_tail_scores(tail_vecs, tail_ids, queries):
    """Exact query -> tail distances (every live tail row is visible: flat
    scans the whole corpus), +inf on unfilled or removed tail slots."""
    tv = tail_vecs.to(torch.float32)
    t_sq = (tv * tv).sum(dim=1)
    q_sq = (queries * queries).sum(dim=1)
    d = torch.clamp_min(t_sq[None, :] - 2.0 * (queries @ tv.T) + q_sq[:, None], 0.0)
    return torch.where((tail_ids >= 0)[None, :], d, torch.inf)


def _mask_tensor(id_mask, device) -> torch.Tensor:
    if isinstance(id_mask, torch.Tensor):
        return id_mask.to(device=device, dtype=torch.bool)
    return torch.from_numpy(np.asarray(id_mask, dtype=bool)).to(device)


class _ShardedBase:
    """Shared plumbing of the sharded families: add / search / ranked_all /
    ids and state() / from_state() through storage/index_io.py.

    Two storage modes, as the single-device families (models/devbuild.py):

      * HOST mode (numpy inputs, the CLI scale): the id-sorted numpy
        mirrors are authoritative on every rank; staging puts each rank's
        row shard on its device. Adds after staging park in a device
        GrowTail (replicated on every rank) and merge into search results
        exactly, so an add never invalidates the staging.
      * DEVICE mode (the first add is a torch.Tensor, the corpus scale):
        rows wait in ChunkStores until staging; after it each rank's staged
        shard IS the storage (chunks freed), adds park in the tail, and
        removal is one in-place ids -> -1 / norms -> +inf pass per shard.
        ids(), reconstruct, ranked_all and state() gather the shards.

    The mesh is environmental and never serialized: a file saved at one
    rank count loads at any other. Assigning another mesh restages on the
    next search.
    """

    def __init__(self, dim: int, mesh: Mesh | None = None, device=None):
        if mesh is None:
            mesh = default_data_mesh(device)
        elif device is not None:
            dev = torch.device(device)
            if dev.type != mesh.device.type or dev.index not in (None, mesh.device.index):
                raise ValueError(f"device {device} differs from the mesh's {mesh.device}")
        self.dim = int(dim)
        self._mask_cache = MaskCache()
        self._reset_rows()
        self._mesh = None
        self.mesh = mesh

    def _reset_rows(self) -> None:
        """An empty host-mode index (the mesh stays)."""
        self._vectors = np.zeros((0, self.dim), dtype=np.float32)
        self._ids = np.zeros((0,), dtype=np.int64)
        self._mode = "host"
        self._dev_vecs = ChunkStore()
        self._dev_ids = ChunkStore()
        self._n_dev = 0
        self._staged = None
        self._tail = None
        self._restage_needed = False
        self._ranked_cache = None
        self._mask_cache.clear()

    # -- the mesh ------------------------------------------------------------------

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    @mesh.setter
    def mesh(self, mesh: Mesh) -> None:
        corpus_axes(mesh)  # validate early (raises on unknown axes)
        if self._mesh is not None and self._mode == "device":
            # The staged shards are the storage: gather them (on the old
            # mesh) back into chunks, which the new mesh stages.
            parts = self._rows_all() if self.ntotal else ()
            for store in self._row_stores():
                store.clear()
            for store, part in zip(self._row_stores(), parts):
                store.append(part.to(mesh.device))
        self._mesh = mesh
        self._staged = None
        self._tail = None
        self._restage_needed = False
        self._ranked_cache = None
        self._mask_cache.clear()

    @property
    def device(self) -> torch.device:
        return self._mesh.device

    @property
    def _axes(self) -> tuple[str, ...]:
        return corpus_axes(self._mesh)

    @property
    def _shards(self) -> int:
        return shard_count(self._mesh, self._axes)

    @property
    def ntotal(self) -> int:
        if self._mode == "device":
            return self._n_dev
        return int(self._ids.shape[0])

    @property
    def _keep_dtype(self) -> torch.dtype:
        """Row dtype of the chunks and the tail (a family with a bf16 store
        keeps bf16)."""
        return torch.float32

    def _row_stores(self) -> tuple[ChunkStore, ...]:
        """The pending-chunk stores, in the order of _rows_all's parts."""
        return (self._dev_vecs, self._dev_ids)

    def ids(self) -> np.ndarray:
        if self._mode == "device":
            if self._n_dev == 0:
                return np.zeros((0,), np.int64)
            return self._rows_all()[1].cpu().numpy().astype(np.int64)
        return self._ids.copy()

    # -- mutation ---------------------------------------------------------------------

    def _tail_spec(self) -> dict:
        return {"vecs": (self.dim, str(self._keep_dtype).removeprefix("torch.")),
                "ids": (None, "int32")}

    def _tail_extras(self, vecs) -> dict:
        """Extra tail fields of a parked batch (IVF: its assignment)."""
        return {}

    def _absorb_device_extras(self, vectors) -> None:
        """Extra per-chunk stores of a pending device batch (IVF: its
        assignment)."""

    def _tail_park(self, vecs, ids) -> None:
        if self._tail is None:
            self._tail = GrowTail(self._tail_spec(), self.device,
                                  initial_cap=tail_restage_threshold(self.ntotal))
        vecs = vecs.to(self.device, torch.float32)
        self._tail.append(vecs=vecs, ids=ids, **self._tail_extras(vecs))
        if self._tail.count > tail_restage_threshold(self.ntotal):
            self._restage_needed = True

    def _absorb(self, vectors, ids) -> None:
        if is_device_array(vectors) and self._mode == "host" and self.ntotal == 0:
            self._mode = "device"
        if self._mode == "device":
            if not is_device_array(vectors):
                vectors = torch.from_numpy(np.ascontiguousarray(vectors, np.float32))
            vectors = vectors.to(self.device, torch.float32).reshape(-1, self.dim)
            if not is_device_array(ids):
                ids = torch.from_numpy(np.asarray(ids, np.int64).astype(np.int32))
            ids = ids.to(self.device, torch.int32).reshape(-1)
            if vectors.shape[0] != ids.shape[0]:
                raise ValueError("vectors and ids must have matching leading dimension")
            if self._staged is not None:
                self._tail_park(vectors, ids)
            else:
                self._dev_vecs.append(vectors.to(self._keep_dtype))
                self._dev_ids.append(ids)
                self._absorb_device_extras(vectors)
            self._n_dev += int(vectors.shape[0])
            self._ranked_cache = None
            return
        if is_device_array(vectors):
            vectors = vectors.detach().to("cpu", torch.float32).numpy()
        vectors = np.ascontiguousarray(vectors, dtype=np.float32).reshape(-1, self.dim)
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if vectors.shape[0] != ids.shape[0]:
            raise ValueError("vectors and ids must have matching leading dimension")
        if self._staged is not None and vectors.shape[0]:
            # O(batch): park the rows in the tail instead of invalidating
            # the staging (which would restage the whole corpus).
            self._tail_park(torch.from_numpy(vectors), torch.from_numpy(ids.astype(np.int32)))
        self._vectors = np.concatenate([self._vectors, vectors], axis=0)
        self._ids = np.concatenate([self._ids, ids])
        if not np.all(self._ids[:-1] <= self._ids[1:]):
            order = np.argsort(self._ids, kind="stable")
            self._vectors = self._vectors[order]
            self._ids = self._ids[order]
        self._ranked_cache = None

    def reconstruct(self, doc_id: int) -> np.ndarray:
        """The stored vector of an external id; KeyError if absent."""
        if self._mode == "device":
            if self._n_dev == 0:
                raise KeyError(f"id {doc_id} not in index")
            vecs, idsa = self._rows_all()[:2]
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
        A staged (or device-mode) index removes IN PLACE: the tail folds in,
        then each shard turns matching ids to -1 and their norms to +inf,
        and the counts are summed over the shards. An unstaged host-mode
        index filters its mirrors."""
        ids_np = np.unique(np.asarray(ids, dtype=np.int64).reshape(-1))
        if self.ntotal == 0 or ids_np.size == 0:
            return 0
        if self._staged is None and self._mode == "host":
            keep = ~np.isin(self._ids, ids_np)
            removed = int(self._ids.shape[0] - keep.sum())
            if removed:
                self._vectors = self._vectors[keep]
                self._ids = self._ids[keep]
                self._ranked_cache = None
                self._mask_cache.clear()
            return removed
        if self._staged is not None and self._tail and self._tail.count:
            self._restage_needed = True
        self._stage()  # folds chunks and tail: every row now lives in the shards
        removed = self._apply_removal_staged(removal_table(ids_np, self.device))
        if removed:
            if self._mode == "device":
                self._n_dev -= removed
            else:
                keep = ~np.isin(self._ids, ids_np)
                self._vectors = self._vectors[keep]
                self._ids = self._ids[keep]
            self._ranked_cache = None
            self._mask_cache.clear()
        return removed

    # -- the full ranking (the CLI's recall path) --------------------------------------

    def _ranked_staged(self):
        """(vecs, ids, valid, in_id_order) of every stored row on this
        rank's device, pow2-padded, cached until the next mutation. Host
        mode pads the id-sorted mirrors; device mode gathers the shards."""
        if self._ranked_cache is None:
            n = self.ntotal
            cap = next_pow2(max(n, 1))
            vecs = torch.zeros((cap, self.dim), dtype=torch.float32, device=self.device)
            ids = torch.full((cap,), -1, dtype=torch.int32, device=self.device)
            if self._mode == "device":
                if n:
                    rows, idsa = self._rows_all()[:2]
                    vecs[:n] = rows.to(torch.float32)
                    ids[:n] = idsa
            else:
                vecs[:n] = torch.from_numpy(self._vectors).to(self.device)
                ids[:n] = torch.from_numpy(self._ids.astype(np.int32)).to(self.device)
            self._ranked_cache = (vecs, ids, ids >= 0, self._mode == "host")
        return self._ranked_cache

    def ranked_rows(self) -> int:
        return int(self._ranked_staged()[0].shape[0])

    def ranked_all_device(self, query):
        """Full exact ranking, left ON DEVICE: (dists, ids_i32, n)."""
        vecs, ids, valid, in_id_order = self._ranked_staged()
        dists, out_ids = ranked_program(vecs, ids, valid,
                                        query_rows(query, self.dim, self.device)[0],
                                        in_id_order=in_id_order)
        return dists, out_ids, self.ntotal

    def ranked_many_device(self, queries):
        """Batched ranked_all_device: (dists (B, cap), ids (B, cap), n)."""
        vecs, ids, valid, in_id_order = self._ranked_staged()
        dists, out_ids = ranked_many_program(vecs, ids, valid,
                                             query_rows(queries, self.dim, self.device),
                                             in_id_order=in_id_order)
        return dists, out_ids, self.ntotal

    def ranked_all(self, query) -> tuple[np.ndarray, np.ndarray]:
        """Exact full ranking over the stored rows (the CLI's recall path)."""
        if self.ntotal == 0:
            return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
        dists, out_ids, n = self.ranked_all_device(query)
        return dists[:n].cpu().numpy(), out_ids[:n].cpu().numpy().astype(np.int64)

    def _mask_table(self, id_mask):
        """The filter's (cap,) keep table on the device + the family's
        masked staged operands, rebuilt only when the mask OBJECT changes."""
        return self._mask_cache.get(
            id_mask, lambda: self._build_masked(_mask_tensor(id_mask, self.device)))


@register
class ShardedFlatIndex(_ShardedBase):
    """Flat exact index with its rows sharded over the mesh's corpus axes
    (a 1-D `data` axis, or ("host", "chip") with the two-level merge).

    The staged store is padded to `_aligned_cap` rows (a tile multiple per
    shard) with +inf norms on padding rows. On a CUDA device search takes
    the kernel route (flat kernel + per-shard exact rerank) while the
    shortlist fits the kernel, else the exact route (matmul + top-k per
    shard); both merge (distance, id) candidates over the mesh.
    scan_dtype="int8" scans SQ8 codes (a quarter of the f32 bytes), still
    exact through the rerank. Adds after staging park in a GrowTail;
    search(id_mask=...) pushes a filter into the scan through masked norm
    copies staged once per mask object. add_local ingests each rank's own
    rows into its shard without a whole-corpus copy anywhere.
    """

    kind = "sharded_flat"

    def __init__(self, dim: int, scan_dtype: str = "float32", mesh: Mesh | None = None,
                 device=None):
        if scan_dtype not in ("float32", "int8"):
            raise ValueError(f"unsupported scan_dtype: {scan_dtype}")
        super().__init__(dim, mesh, device)
        self.scan_dtype = str(scan_dtype)

    def add(self, vectors, ids) -> None:
        self._absorb(vectors, ids)

    def load(self, vectors, ids) -> None:
        """Bulk (re)load: reset, then add."""
        self._reset_rows()
        self.add(vectors, ids)

    def add_local(self, chunks, rows: int) -> None:
        """Per-rank ingest, called once by every rank of the mesh on an empty
        index: this rank's own `rows` rows arrive as an iterable of
        (vectors (m, D), ids (m,)) chunks, tensors on any device or arrays,
        and are copied straight into this rank's shard, which is allocated
        once (every shard as long as the longest rank's rows, aligned as
        _stage aligns, zero rows with id -1 and +inf norms after the live
        ones). Norms and ids are filled chunk by chunk, so no rank holds
        another rank's rows and no process a host copy of the corpus. The
        layout is _stage's: ids ascend strictly on each rank, every id of a
        rank lies below the next non-empty rank's, each in [0, 2**31 - 1).
        Afterwards ntotal is the sum over the ranks and the index is staged
        (device mode: later adds park in the tail). Raises ValueError on
        every rank when any rank's chunks break the layout or do not hold
        its `rows` rows."""
        if self.ntotal:
            raise ValueError("add_local needs an empty index")
        mesh, axes, dev = self._mesh, self._axes, self.device
        with span("sharded.ingest"):
            claims = all_gather_axes(torch.tensor([int(rows)], dtype=torch.int64, device=dev),
                                     mesh, axes).tolist()
            per = -(-max(max(claims), 1) // self._tile_rows) * self._tile_rows
            db = torch.empty((per, self.dim), dtype=torch.float32, device=dev)
            idp = torch.full((per,), -1, dtype=torch.int32, device=dev)
            sq = torch.full((per,), torch.inf, dtype=torch.float32, device=dev)
            ok = torch.ones((), dtype=torch.bool, device=dev)
            seen = filled = 0
            for vectors, ids in chunks:
                v = torch.as_tensor(vectors)
                i64 = torch.as_tensor(ids).to(dev, torch.int64).reshape(-1)
                m = int(i64.shape[0])
                if v.shape != (m, self.dim) or seen + m > rows:
                    ok &= False
                    seen += m
                    continue
                if m == 0:
                    continue
                with span("sharded.stage"):
                    s, e = filled, filled + m
                    db[s:e].copy_(v)
                    idp[s:e] = i64.to(torch.int32)
                    sq[s:e] = (db[s:e] * db[s:e]).sum(dim=1)
                    ok &= ((i64 >= 0) & (i64 < INT32_MAX)).all()
                    ok &= (i64[1:] > i64[:-1]).all()
                    if s:
                        ok &= i64[0] > idp[s - 1]
                seen, filled = seen + m, filled + m
            # Padding rows are zeros, as _stage pads (SQ8's maxabs reads them).
            db[filled:].zero_()
            edge = idp[[0, max(filled - 1, 0)]].to(torch.int64)
            info = torch.cat([torch.tensor([seen], dtype=torch.int64, device=dev),
                              ok.to(torch.int64)[None], edge])
            table = all_gather_axes(info[None], mesh, axes).tolist()
            errors = []
            for r, (got, fine, _, _) in enumerate(table):
                if got != claims[r]:
                    errors.append(f"rank {r}'s chunks held {got} rows, not {claims[r]}")
                elif not fine:
                    errors.append(f"rank {r}'s chunks are not (m, {self.dim}) rows with m "
                                  f"strictly ascending ids in [0, 2**31 - 1)")
            live = [(r, first, last) for r, (got, _, first, last) in enumerate(table) if got]
            for (r, _, last), (q, first, _) in zip(live, live[1:]):
                if last >= first:
                    errors.append(f"rank {r}'s last id {last} is not below rank {q}'s first "
                                  f"id {first}")
            if errors:
                raise ValueError("add_local: " + "; ".join(errors))
            staged = (db, idp, sq)
            if self.scan_dtype == "int8":
                staged += _flat_sq8_stage(mesh, axes, db, sq)
            self._mode = "device"
            self._n_dev = sum(claims)
            self._staged = staged
            COUNTERS["staged_live_rows"] += filled

    def _rows_all(self):
        """Device mode: every stored row as (vecs, ids) on this rank's
        device: the staged shards (gathered over the mesh, live rows first
        in store order), the tail, then pending chunks."""
        parts_v, parts_i = [], []
        if self._staged is not None:
            n_staged = self._n_dev - len(self._dev_vecs) - (self._tail.count if self._tail else 0)
            if n_staged:
                db = all_gather_axes(self._staged[0], self._mesh, self._axes)
                idp = all_gather_axes(self._staged[1], self._mesh, self._axes)
                perm = torch.argsort((idp < 0).to(torch.int8), stable=True)[:n_staged]
                parts_v.append(db[perm])
                parts_i.append(idp[perm])
        if self._tail and self._tail.count:
            c = self._tail.count
            parts_v.append(self._tail["vecs"][:c])
            parts_i.append(self._tail["ids"][:c])
        if len(self._dev_vecs):
            parts_v.append(self._dev_vecs.consolidated(torch.float32))
            parts_i.append(self._dev_ids.consolidated(torch.int32))
        cat = lambda ps: ps[0] if len(ps) == 1 else torch.cat(ps)  # noqa: E731
        return cat(parts_v), cat(parts_i)

    @property
    def _tile_rows(self) -> int:
        """A shard's alignment for the kernel: 1024 rows for f32, 2048 for
        int8 (memory cost < 1 tile a shard)."""
        return 2048 if self.scan_dtype == "int8" else 1024

    def _aligned_cap(self, n: int) -> int:
        """Rows of the staged store: each shard tile-aligned."""
        shards = self._shards
        per = -(-max(n, 1) // shards)
        return -(-per // self._tile_rows) * self._tile_rows * shards

    def _stage(self):
        """This rank's shard of the padded store: (db (per, D) f32, ids
        (per,) int32 with -1 padding, sq norms (per,) with +inf padding),
        plus (codes, decoded norms, scale) for int8."""
        if self._staged is not None and not self._restage_needed:
            return self._staged
        with span("sharded.stage"):
            n = self.ntotal
            cap = self._aligned_cap(n)
            per = cap // self._shards
            lo = shard_index(self._mesh, self._axes) * per
            hi = min(max(n - lo, 0), per) + lo
            if self._mode == "device":
                vecs, idsa = self._rows_all()
                # Free the source chunks and the old staged shard before the
                # new one allocates.
                self._dev_vecs.clear()
                self._dev_ids.clear()
                self._staged = None
                rows, row_ids = vecs[lo:hi], idsa[lo:hi]
                del vecs, idsa
            else:
                rows = torch.from_numpy(self._vectors[lo:hi])
                row_ids = torch.from_numpy(self._ids[lo:hi].astype(np.int32))
            db = torch.zeros((per, self.dim), dtype=torch.float32, device=self.device)
            db[: hi - lo] = rows.to(self.device)
            idp = torch.full((per,), -1, dtype=torch.int32, device=self.device)
            idp[: hi - lo] = row_ids.to(self.device)
            # +inf norms on padding rows ARE the kernel's mask.
            sq = torch.where(idp >= 0, (db * db).sum(dim=1), torch.inf)
            staged = (db, idp, sq)
            if self.scan_dtype == "int8":
                staged += _flat_sq8_stage(self._mesh, self._axes, db, sq)
            self._staged = staged
            self._tail = None
            self._restage_needed = False
            self._mask_cache.clear()
            COUNTERS["staged_live_rows"] += hi - lo
        return self._staged

    def _apply_removal_staged(self, table) -> int:
        staged = self._staged
        if self.scan_dtype == "int8":
            db, idp, sq, codes, dec_sq, scale = staged
            idp, removed, sq, dec_sq = apply_removal(idp, table, sq, dec_sq)
            self._staged = (db, idp, sq, codes, dec_sq, scale)
        else:
            db, idp, sq = staged
            idp, removed, sq = apply_removal(idp, table, sq)
            self._staged = (db, idp, sq)
        count = torch.tensor([removed], dtype=torch.int64, device=self.device)
        return int(all_reduce_axes(count, self._mesh, self._axes, "sum")[0])

    def _build_masked(self, keep):
        """Once-per-mask staged operands: the masked sq norms (and decoded
        norms on the int8 route); +inf IS the scan's exclusion marker."""
        staged = self._stage()
        kept = _keep_of(staged[1], keep)
        masked_sq = torch.where(kept, staged[2], torch.inf)
        masked_dec = (torch.where(kept, staged[4], torch.inf)
                      if self.scan_dtype == "int8" else None)
        return keep, masked_sq, masked_dec

    def search(self, queries, k: int, *, id_mask=None) -> tuple[np.ndarray, np.ndarray]:
        """id_mask: optional (cap,) bool keyed by EXTERNAL id (filter
        pushdown, as models/flat.py). Pass the SAME mask object across calls
        to reuse the staged masked operands."""
        return self._search(queries, k, id_mask, kernel_route=None)

    def search_device(self, queries, k: int, *, id_mask=None):
        """search() with the merged (dists (B, k) f32, ids (B, k) int32)
        left on this rank's device (no copy to the host)."""
        return self._search_device(queries, k, id_mask, kernel_route=None)

    def _search(self, queries, k: int, id_mask, kernel_route: bool | None):
        """search() with the route explicit: kernel_route=True is the flat
        kernel + per-shard rerank (the kernel's plain version on CPU
        tensors), False the exact route, None the card's choice (the
        kernel while the shortlist fits it, on a CUDA device)."""
        d, i = self._search_device(queries, k, id_mask, kernel_route)
        with span("sharded.fetch"):
            return d.cpu().numpy(), i.cpu().numpy().astype(np.int64)

    def _search_device(self, queries, k: int, id_mask, kernel_route: bool | None):
        q = query_rows(queries, self.dim, self.device)
        if self.ntotal == 0:
            shape = (q.shape[0], k)
            return (torch.full(shape, torch.inf, dtype=torch.float32, device=self.device),
                    torch.full(shape, -1, dtype=torch.int32, device=self.device))
        staged = self._stage()
        db, idp, sq = staged[:3]
        keep = masked_dec = None
        if id_mask is not None:
            keep, sq, masked_dec = self._mask_table(id_mask)
        depth = shortlist_depth(k, self.ntotal)
        if kernel_route is None:
            kernel_route = self.device.type == "cuda" and depth <= KERNEL_MAX_K
        if kernel_route:
            ks = min(depth, db.shape[0], KERNEL_MAX_K)
            if self.scan_dtype == "int8":
                codes, dec_sq, scale = staged[3:]
                d, i = sharded_search_sq8_kernels(
                    self._mesh, codes, db, idp, dec_sq if keep is None else masked_dec,
                    scale, q, k, ks, self._axes, keep)
            else:
                d, i = sharded_search_kernels(self._mesh, db, idp, sq, q, k, ks, self._axes,
                                              keep)
        else:
            d, i = sharded_search_program(self._mesh, db, idp, sq, q, k, self._axes)
        if self._tail and self._tail.count:
            # Rows added after staging: exact f32 distances, one (distance,
            # id) merge on the replicated results.
            tail_ids = self._tail["ids"]
            td = _flat_tail_scores(self._tail["vecs"], tail_ids, q)
            if keep is not None:
                td = torch.where(_keep_of(tail_ids, keep)[None, :], td, torch.inf)
            d, i = merge_tail(d, i, td, tail_ids, k)
        return d, i

    def scan_bytes_per_row(self) -> int:
        """Bytes each rank's scan reads per row (4 * dim f32, dim int8)."""
        return self.dim if self.scan_dtype == "int8" else 4 * self.dim

    def state(self) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
        params = {"dim": self.dim, "scan_dtype": self.scan_dtype}
        if self._mode == "device" and self.ntotal:
            vecs, idsa = self._rows_all()
            return params, {"vectors": vecs.to(torch.float32).cpu().numpy(),
                            "ids": idsa.cpu().numpy().astype(np.int64)}
        return params, {"vectors": self._vectors, "ids": self._ids}

    @classmethod
    def from_state(cls, params, arrays, device=None, mesh: Mesh | None = None
                   ) -> "ShardedFlatIndex":
        """Accepts the JAX package's ShardedFlatIndex.state() (written at
        any device count) unchanged."""
        index = cls(dim=int(params["dim"]), scan_dtype=str(params.get("scan_dtype", "float32")),
                    mesh=mesh, device=device)
        if arrays["vectors"].size:
            index.add(arrays["vectors"], arrays["ids"])
        return index


# -- IVF: the slot-sharded layout --------------------------------------------------------


def _slot_shard_layout(assign: np.ndarray, nlist: int, shards: int):
    """Staging math of the slot-sharded inverted lists (host form).

    Each list's rows are dealt round-robin over the S shards by in-list
    rank (the id-stable order): rank r -> shard r % S, local slot r // S,
    so a list's occupancy differs by at most one row between shards and
    each shard's sub-list keeps the list's order. The GLOBAL slot axis is
    shard-major, slot = (r % S) * pad_local + r // S, as a JAX P(None,
    axes) sharding of (nlist, S * pad_local, ...) lays it out.

    Returns (pad_local, order, sorted_lists, slots): `order` is the
    id-stable row permutation grouping rows by list; `slots` the global
    slot per row (shard slot // pad_local, local slot slot % pad_local)."""
    n = assign.shape[0]
    counts = np.bincount(assign, minlength=nlist)
    per_shard = -(-int(counts.max(initial=1)) // shards)
    pad_local = list_pad(per_shard)
    order = np.argsort(assign, kind="stable")
    sorted_lists = assign[order]
    starts = np.zeros((nlist,), np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    rank = np.arange(n) - starts[sorted_lists]
    slots = (rank % shards) * pad_local + rank // shards
    return pad_local, order, sorted_lists, slots


def _slot_shard_layout_device(assign: torch.Tensor, nlist: int, shards: int):
    """Device form of _slot_shard_layout over devbuild.bucketize_device
    (whose stable sort keeps each list's input order). Only the (nlist,)
    counts cross to the host. Returns (pad_local, order, sorted_lists,
    slots, counts)."""
    order, lists, rank, counts = bucketize_device(assign, nlist)
    per_shard = -(-int(counts.max(initial=1)) // shards)
    pad_local = list_pad(per_shard)
    return pad_local, order, lists, (rank % shards) * pad_local + rank // shards, counts


def _own_rows(order, lists, slots, pad_local: int, shard: int):
    """The rows of one shard in a slot-shard layout: (order, lists, local
    slots) of the rows with slot // pad_local == shard."""
    mine = slots // pad_local == shard
    return order[mine], lists[mine], slots[mine] % pad_local


# -- IVF: the per-shard programs (each rank passes its own block) -------------------------


# Rows of one (rows, k) one-hot block of the distributed Lloyd step.
_KMEANS_STEP_ROWS = 65_536


def sharded_kmeans_step(mesh: Mesh, data, valid, centroids):
    """One distributed Lloyd iteration over this rank's row shard: data (n,
    D) and valid (n,) weights are this rank's rows, centroids (k, D) are
    replicated. Rows go to argmin(c_sq - 2 x.c) (ties to the lowest list);
    the weighted per-list sums and counts are summed over `data` (one
    all_reduce); a list with no rows keeps its centroid. Returns the
    replicated (k, D) centroids."""
    data = data.to(torch.float32)
    valid = valid.to(torch.float32)
    centroids = centroids.to(torch.float32)
    k, dim = centroids.shape
    c_sq = (centroids * centroids).sum(dim=1)
    lists = torch.arange(k, device=data.device)
    sums = torch.zeros((k, dim), dtype=torch.float32, device=data.device)
    counts = torch.zeros((k,), dtype=torch.float32, device=data.device)
    for s0 in range(0, data.shape[0], _KMEANS_STEP_ROWS):
        block = data[s0 : s0 + _KMEANS_STEP_ROWS]
        assign = torch.argmin(c_sq[None, :] - 2.0 * (block @ centroids.T), dim=1)
        # A one-hot product, not index_add_: the sums come out in one fixed
        # order on every device (atomics would not).
        onehot = (assign[:, None] == lists[None, :]).to(torch.float32)
        onehot = onehot * valid[s0 : s0 + _KMEANS_STEP_ROWS, None]
        sums += onehot.T @ block
        counts += onehot.sum(dim=0)
    total = all_reduce_axis(torch.cat([sums.reshape(-1), counts]), mesh, "data", "sum")
    sums, counts = total[: k * dim].reshape(k, dim), total[k * dim :]
    fresh = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where((counts > 0.0)[:, None], fresh, centroids)


# Bytes of one step of the plain IVF probe scan's gathered lists.
_IVF_STEP_BYTES = 128 << 20


def _ivf_probe_scan(centroids, c_sq, list_vecs, list_ids, queries, nprobe: int, k: int,
                    keep=None):
    """The JAX package's CPU route of the sharded IVF search, on this
    rank's block: probes by c_sq - 2 q.c (ties to the lowest list), then
    per probe rank direct (x - q)^2 distances of the probed lists' rows and
    a (distance, id) merge. keep: a (nlist, pad_local) keep canvas of a
    filter."""
    probes = coarse_probes(queries, centroids, c_sq, nprobe).to(torch.int64)
    b, pad, dim = queries.shape[0], list_vecs.shape[1], list_vecs.shape[2]
    chunk = max(1, _IVF_STEP_BYTES // max(pad * dim * 4, 1))
    out_d, out_i = [], []
    for q0 in range(0, b, chunk):
        qc = queries[q0 : q0 + chunk]
        best_d = torch.full((qc.shape[0], k), torch.inf, device=queries.device)
        best_i = torch.full((qc.shape[0], k), -1, dtype=torch.int32, device=queries.device)
        for p in range(nprobe):
            lists = probes[q0 : q0 + chunk, p]
            diff = list_vecs[lists].to(torch.float32) - qc[:, None, :]
            d = (diff * diff).sum(dim=-1)
            ids = list_ids[lists]
            d = torch.where(ids >= 0, d, torch.inf)
            if keep is not None:
                d = torch.where(keep[lists], d, torch.inf)
            best_d, best_i = merge_topk(torch.cat([best_d, d], 1), torch.cat([best_i, ids], 1), k)
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


def sharded_ivf_search_program(mesh: Mesh, centroids, c_sq, list_vecs, list_sqn, list_ids,
                               queries, nprobe: int, k: int, use_kernels: bool = False,
                               axes: tuple[str, ...] = ("data",), keep=None, hwm=None,
                               dense: bool | None = None):
    """Exact-distance IVF search over slot-sharded lists: centroids (nlist,
    D) and c_sq (nlist,) replicated; list_vecs (nlist, pad_local, D) f32,
    list_sqn and list_ids (nlist, pad_local) this rank's block; queries (B,
    D) replicated. Returns the replicated (dists (B, k), ids (B, k)).

    use_kernels=True (the card route): ops/ivf_scan.ivf_full_search on the
    block, the dense kernel + merge while nprobe * pad_local <= 4096, else
    the select kernel; a filter is the caller's masked list_sqn (+inf IS
    the kernels' exclusion marker), and hwm (nlist,) the block's own
    high-water marks; dense=True / False forces the dense / select
    kernel. A select kernel may fill an underfilled list with masked rows
    (+inf, real id); the merge turns every +inf to -1. False:
    the plain probe scan, with a filter's keep canvas `keep` (its diff^2
    scoring never reads list_sqn)."""
    queries = queries.to(torch.float32)
    if use_kernels:
        if dense is None:
            dense = nprobe * list_vecs.shape[1] <= DENSE_MAX_F32
        local_d, local_i = ivf_full_search(centroids, c_sq, list_vecs, list_sqn, list_ids,
                                           queries, nprobe, k, dense=dense, hwm=hwm)
    else:
        local_d, local_i = _ivf_probe_scan(centroids, c_sq, list_vecs, list_ids, queries,
                                           nprobe, k, keep)
    return _merge_axes(local_d, local_i, k, mesh, axes)


def sharded_ivf_search_2level(mesh: Mesh, *args, **kwargs):
    """sharded_ivf_search_program on a ("host", "chip") mesh: the lists are
    slot-sharded over both axes and merge two-level (k candidates a host
    cross `host`); bit for bit the 1-D merge's result."""
    return sharded_ivf_search_program(mesh, *args, axes=("host", "chip"), **kwargs)


def sharded_ivf_sq8_search_program(mesh: Mesh, centroids, c_sq, codes, dim_scale, dec_sqn,
                                   list_ids, rerank_vecs, queries, nprobe: int, k: int, ks: int,
                                   axes: tuple[str, ...] = ("data",), keep=None, hwm=None):
    """Slot-sharded SQ8 IVF search: per shard, the int8 dense kernel's
    shortlist of ks over the block's codes (ops/ivf_scan.ivf_sq8_search;
    dim_scale is the GLOBAL per-dimension scale), then an exact rerank of
    the shard's own rerank store (nlist, pad_local, D) by the scan's bucket
    rows (every shortlisted row lives on this shard), then the merge. keep:
    a filter's (cap,) keep table; masked rows pad the shortlist at +inf with
    their REAL ids, so their ids are scrubbed before the rerank (with the
    caller's masked dec_sqn)."""
    queries = queries.to(torch.float32)
    _, si, srows = ivf_sq8_search(centroids, c_sq, codes, dim_scale, dec_sqn, list_ids, queries,
                                  nprobe, ks, hwm=hwm)
    if keep is not None:
        si = _scrub_ids(si, keep)
    local_d, local_i = exact_rerank_rows(rerank_vecs.reshape(-1, rerank_vecs.shape[-1]), srows,
                                         si, queries, k)
    return _merge_axes(local_d, local_i, k, mesh, axes)


def _pq_probe_scan(centroids, c_sq, codebooks, list_codes, list_ids, list_vecs, q_adc, queries,
                   nprobe: int, k: int, k_adc: int, keep=None):
    """The JAX package's CPU route of the sharded IVF-PQ search, on this
    rank's block: probes by c_sq - 2 q.c (no q_sq term; ties to the lowest
    list), then per probe rank the lookup table sum_j ||r_j - y_j||^2 of the
    residual gathered at the list's codes, +inf where id < 0 (masked ids
    become -1 first: `keep` is a filter's (cap,) keep table), and a
    (distance, id) merge of k_adc candidates carrying their block rows
    (list * pad_local + slot). Then an exact f32 refine of those rows
    against the original-space queries."""
    coarse = c_sq[None, :] - 2.0 * (q_adc @ centroids.T)
    _, probes = stable_topk(coarse, nprobe)
    m, ksub, dsub = codebooks.shape
    b, pad, dim = q_adc.shape[0], list_codes.shape[1], list_vecs.shape[2]
    flat_vecs = list_vecs.reshape(-1, dim)
    lane = torch.arange(pad, dtype=torch.int32, device=q_adc.device)
    chunk = max(1, _IVF_STEP_BYTES // max(12 * m * pad, 4 * ksub * dim, 4 * k_adc * dim))
    out_d, out_i = [], []
    for q0 in range(0, b, chunk):
        qa = q_adc[q0 : q0 + chunk]
        bc = qa.shape[0]
        best_d = torch.full((bc, k_adc), torch.inf, device=qa.device)
        best_i = torch.full((bc, k_adc), -1, dtype=torch.int32, device=qa.device)
        best_r = torch.zeros((bc, k_adc), dtype=torch.int32, device=qa.device)
        for p in range(nprobe):
            lists = probes[q0 : q0 + chunk, p]
            r_sub = (qa - centroids[lists]).reshape(bc, m, 1, dsub)
            lut = ((r_sub - codebooks[None]) ** 2).sum(dim=-1)              # (bc, m, ksub)
            codes = list_codes[lists].long().transpose(1, 2)                # (bc, m, pad)
            ids = list_ids[lists]
            if keep is not None:
                ids = _scrub_ids(ids, keep)
            d = torch.gather(lut, 2, codes).sum(dim=1)
            d = torch.where(ids >= 0, d, torch.inf)
            rows = lists[:, None].to(torch.int32) * pad + lane[None, :]
            best_d, best_i, best_r = _merge_topk_with_rows(
                torch.cat([best_d, d], 1), torch.cat([best_i, ids], 1),
                torch.cat([best_r, rows], 1), k_adc)
        d, i = exact_rerank_rows(flat_vecs, best_r, best_i, queries[q0 : q0 + chunk], k)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def sharded_pq_search_program(mesh: Mesh, centroids, c_sq, codebooks, canvas, item_const,
                              list_ids, list_vecs, q_adc, queries, nprobe: int, k: int,
                              k_adc: int, use_kernels: bool = False,
                              axes: tuple[str, ...] = ("data",), keep=None, hwm=None):
    """Slot-sharded IVF-PQ search with a per-shard exact refine: centroids
    (nlist, D) (quantization space), c_sq (nlist,) and codebooks (m, ksub,
    dsub) replicated; canvas (nlist, m or m/2, pad_local) (ops/adc's code
    canvas, nibble-packed for 4-bit codes), item_const and list_ids
    (nlist, pad_local) and the f32 refine rows list_vecs (nlist,
    pad_local, D) this rank's block; q_adc the (rotated) ADC-space queries,
    queries the original-space ones. Returns the replicated (dists (B, k),
    ids (B, k)).

    use_kernels=True (the card route): ops/adc.adc_dense_search on the
    block (the dense ADC kernel at every k_adc) shortlists k_adc rows of
    the block; a filter is the caller's masked item_const (+inf IS the
    kernel's exclusion marker) plus its (cap,) keep table `keep`, which
    scrubs masked shortlist ids (they pad at +inf with their real ids);
    then an exact rerank of the shortlisted block rows. False: the plain
    route (_pq_probe_scan) on the unstaged codes, invalidating masked ids
    at scan time through `keep`. hwm (nlist,): the block's high-water
    marks, where the kernel stops."""
    queries = queries.to(torch.float32)
    q_adc = q_adc.to(torch.float32)
    m, ksub = int(codebooks.shape[0]), int(codebooks.shape[1])
    if use_kernels:
        _, si, rows = adc_dense_search(centroids, c_sq, codebooks, canvas, item_const, list_ids,
                                       q_adc, nprobe, k_adc, return_rows=True, hwm=hwm)
        if keep is not None:
            si = _scrub_ids(si, keep)
        local_d, local_i = exact_rerank_rows(list_vecs.reshape(-1, list_vecs.shape[-1]), rows,
                                             si, queries, k)
    else:
        local_d, local_i = _pq_probe_scan(centroids, c_sq, codebooks,
                                          unstage_codes_device(canvas, m, ksub), list_ids,
                                          list_vecs, q_adc, queries, nprobe, k, k_adc, keep)
    return _merge_axes(local_d, local_i, k, mesh, axes)


def _gather_rows(mesh: Mesh, axes: tuple[str, ...], vecs, keys):
    """Every shard's (n_s, D) rows and (n_s, 2) int64 (sort key, id) pairs,
    gathered over `axes` (padded to the largest n_s: gloo gathers equal
    shapes) and put in key order. Returns (vecs, ids int32, keys)."""
    count = torch.tensor([keys.shape[0]], dtype=torch.int64, device=keys.device)
    m = int(all_reduce_axes(count, mesh, axes, "max")[0])
    v = torch.zeros((m, vecs.shape[1]), dtype=vecs.dtype, device=vecs.device)
    v[: vecs.shape[0]] = vecs
    kk = torch.full((m, 2), -1, dtype=torch.int64, device=keys.device)
    kk[: keys.shape[0]] = keys
    # bf16 rows ride as their int16 bits (gloo has no bf16 reduction type).
    wire = v.view(torch.int16) if v.dtype == torch.bfloat16 else v
    gv = all_gather_axes(wire, mesh, axes)
    gv = gv.view(torch.bfloat16) if v.dtype == torch.bfloat16 else gv
    gk = all_gather_axes(kk, mesh, axes)
    live = torch.nonzero(gk[:, 0] >= 0).flatten()
    order = live[torch.argsort(gk[live, 0])]
    return gv[order], gk[order, 1].to(torch.int32), gk[order, 0]


# -- IVF: the index ---------------------------------------------------------------------------


@register
class ShardedIVFIndex(_ShardedBase):
    """IVF-Flat index with its inverted lists slot-sharded over the mesh's
    corpus axes (a 1-D `data` axis, or ("host", "chip") with the two-level
    merge).

    The build mirrors IVFFlatIndex (k-means coarse quantizer, dense padded
    lists), but every list's slots are dealt over the shards, so each rank
    holds a (nlist, pad_local, D) block with 1/S of every list
    (_slot_shard_layout) and never the whole canvas. Centroids are
    replicated: every rank trains the same k-means on the same rows (the
    JAX class's `train`); sharded_kmeans_step is the distributed Lloyd
    step. On a CUDA device search runs each shard's IVF kernels (the
    card route, sharded_ivf_search_program), else the plain probe scan;
    scan_dtype="int8" stages SQ8 codes under a GLOBAL scale and reranks
    each shard's shortlist exactly (rerank_dtype="bfloat16" halves the
    rerank store at the bf16 recall ceiling). Adds after staging park in a
    replicated GrowTail with their list assignment; id_mask pushes a
    filter into the scan through masked norms staged once per mask
    object; remove_ids works in place on every shard.
    """

    kind = "sharded_ivf"
    # The tail field its scores read (tail_scores' vec_field).
    _tail_field = "vecs"

    def __init__(self, dim: int, nlist: int = 64, nprobe: int = 8,
                 scan_dtype: str = "float32", rerank_dtype: str = "float32",
                 mesh: Mesh | None = None, device=None):
        if scan_dtype not in ("float32", "int8"):
            raise ValueError(f"unsupported scan_dtype: {scan_dtype}")
        if rerank_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported rerank_dtype: {rerank_dtype}")
        if scan_dtype == "float32" and rerank_dtype == "bfloat16":
            raise ValueError(
                "rerank_dtype='bfloat16' requires scan_dtype='int8'; the "
                "float32 scan is exact and has no rerank stage"
            )
        self.nlist = int(nlist)
        self.nprobe = int(nprobe)
        self.scan_dtype = str(scan_dtype)
        self.rerank_dtype = str(rerank_dtype)
        super().__init__(dim, mesh, device)

    def _reset_rows(self) -> None:
        super()._reset_rows()
        self._centroids = None          # numpy (host mode) or a tensor (device mode)
        self._dev_assign = ChunkStore()
        self._params = None             # (nlist, pad_local) of the staging
        self._hwm = None                # (nlist,) int32 list_hwm of this rank's block

    @property
    def is_trained(self) -> bool:
        return self._centroids is not None

    @property
    def _keep_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.rerank_dtype == "bfloat16" else torch.float32

    def _row_stores(self) -> tuple[ChunkStore, ...]:
        return (self._dev_vecs, self._dev_ids, self._dev_assign)

    def _centroids_dev(self) -> torch.Tensor:
        if self._staged is not None:
            return self._staged[0]
        c = self._centroids
        if not isinstance(c, torch.Tensor):
            c = torch.from_numpy(np.array(c, dtype=np.float32))
        return c.to(self.device, torch.float32)

    def _centroids_host(self) -> np.ndarray:
        if self._centroids is None:
            return np.zeros((0, self.dim), np.float32)
        if isinstance(self._centroids, torch.Tensor):
            return self._centroids.to(torch.float32).cpu().numpy()
        return np.asarray(self._centroids, np.float32)

    def _assign(self, vecs: torch.Tensor) -> torch.Tensor:
        return assign_clusters(vecs.to(self.device, torch.float32), self._centroids_dev(),
                               out_device=True)

    def _tail_spec(self) -> dict:
        spec = super()._tail_spec()
        spec["assign"] = (None, "int32")
        return spec

    def _tail_extras(self, vecs) -> dict:
        return {"assign": self._assign(vecs)}

    def _absorb_device_extras(self, vectors) -> None:
        self._dev_assign.append(self._assign(vectors))

    def _unstage(self) -> None:
        self._staged = None
        self._params = None
        self._hwm = None
        self._tail = None
        self._restage_needed = False
        self._ranked_cache = None
        self._mask_cache.clear()

    # -- training / mutation ---------------------------------------------------------

    def train(self, data, *, iters: int = 8, seed: int = 0) -> None:
        """The coarse quantizer: ops/kmeans.train_kmeans on every rank over
        the same rows (replicated, so every rank gets the same centroids).
        A tensor puts an empty index in device mode; a device-mode index
        that holds rows re-assigns them."""
        if is_device_array(data) and self._mode == "host" and self.ntotal == 0:
            self._mode = "device"
        if self._mode == "device":
            if not is_device_array(data):
                data = torch.from_numpy(np.ascontiguousarray(data, np.float32))
            data = data.to(self.device, torch.float32).reshape(-1, self.dim)
            nlist_eff = min(self.nlist, max(1, int(data.shape[0])))
            centroids = train_kmeans(data, nlist_eff, iters=iters, seed=seed, out_device=True)
            rows = self._rows_all() if self.ntotal else None
            self._centroids = centroids
            self._unstage()
            if rows is not None:
                for store in self._row_stores():
                    store.clear()
                self._dev_vecs.append(rows[0])
                self._dev_ids.append(rows[1])
                self._dev_assign.append(self._assign(rows[0]))
            return
        if is_device_array(data):
            data = data.detach().to("cpu", torch.float32).numpy()
        data = np.ascontiguousarray(data, dtype=np.float32).reshape(-1, self.dim)
        nlist_eff = min(self.nlist, max(1, data.shape[0]))
        self._centroids = train_kmeans(data, nlist_eff, iters=iters, seed=seed,
                                       device=self.device)
        self._unstage()

    def add(self, vectors, ids) -> None:
        if is_device_array(vectors) and self._mode == "host" and self.ntotal == 0:
            self._mode = "device"
        if not self.is_trained:
            self.train(vectors)
        self._absorb(vectors, ids)

    def load(self, vectors, ids, *, kmeans_iters: int = 8) -> None:
        """Bulk (re)load: reset, train on the corpus, then add."""
        self._reset_rows()
        if not is_device_array(vectors):
            vectors = np.ascontiguousarray(vectors, dtype=np.float32).reshape(-1, self.dim)
        self.train(vectors, iters=kmeans_iters)
        self.add(vectors, ids)

    # -- storage ------------------------------------------------------------------------------

    def _staged_store_ids(self):
        """(store, list ids) of this rank's block: the rows whatever the
        scan dtype (the rerank store of the int8 route)."""
        if self.scan_dtype == "int8":
            return self._staged[6], self._staged[5]
        return self._staged[2], self._staged[4]

    def _staged_rows(self):
        """Every staged row as (vecs, ids, assign) on this rank, in the JAX
        package's global canvas order (list-major, then shard-major slots):
        each shard sends its live rows with their global canvas position,
        never its padding."""
        store, li = self._staged_store_ids()
        pad_local = li.shape[1]
        shards = self._shards
        live = torch.nonzero(li.reshape(-1) >= 0).flatten()
        lists = live // pad_local
        key = (lists * shards + shard_index(self._mesh, self._axes)) * pad_local \
            + live % pad_local
        keys = torch.stack([key, li.reshape(-1)[live].to(torch.int64)], dim=1)
        vecs, ids, key = _gather_rows(self._mesh, self._axes,
                                      store.reshape(-1, self.dim)[live], keys)
        return vecs, ids, (key // (shards * pad_local)).to(torch.int32)

    def _rows_all(self):
        """Device mode: every stored row as (vecs, ids, assign) on this
        rank's device: the staged shards (gathered over the mesh, in the
        JAX package's canvas order), the tail, then pending chunks."""
        parts = []
        if self._staged is not None:
            staged = self._staged_rows()
            if staged[1].numel():
                parts.append(staged)
        if self._tail and self._tail.count:
            c = self._tail.count
            parts.append((self._tail["vecs"][:c], self._tail["ids"][:c],
                          self._tail["assign"][:c]))
        if len(self._dev_vecs):
            parts.append((self._dev_vecs.consolidated(self._keep_dtype),
                          self._dev_ids.consolidated(torch.int32),
                          self._dev_assign.consolidated(torch.int32)))
        if len(parts) == 1:
            return parts[0]
        return tuple(torch.cat([p[j] for p in parts]) for j in range(3))

    # -- staging --------------------------------------------------------------------------------

    def _put_staged(self, staged) -> None:
        """Keep a staging and its block's high-water marks (where the scan
        kernels stop); every change to the staged ids comes through here."""
        self._staged = staged
        self._hwm = list_hwm(self._staged_store_ids()[1]).to(torch.int32)

    def _stage(self):
        if self._staged is not None and not self._restage_needed:
            return self._staged
        if self._mode == "device":
            rows = self._rows_all()
            # Free the source chunks and the old block before the new
            # block allocates (at 1M x 384 each is gigabytes).
            for store in self._row_stores():
                store.clear()
            self._staged = None
            self._stage_rows_device(*rows)
        else:
            self._staged = None
            self._stage_host()
        self._tail = None
        self._restage_needed = False
        self._mask_cache.clear()
        return self._staged

    def _finish_stage(self, lv, li, centroids, pad_local: int) -> None:
        """Shared epilogue: the scan stores from this rank's block, on its
        device. int8: SQ8 codes under the GLOBAL per-dimension scale (a MAX
        all_reduce of the live rows' maxabs over the corpus axes), and the
        block itself as the rerank store (bf16 for rerank_dtype
        bfloat16)."""
        nlist = int(centroids.shape[0])
        self._params = (nlist, pad_local)
        common = (centroids, (centroids * centroids).sum(dim=1))
        if self.scan_dtype == "int8":
            codes, scale, dec_sqn = _sq8_stage(
                lv, li, lambda m: all_reduce_axes(m, self._mesh, self._axes, "max"))
            self._put_staged(common + (codes, scale, dec_sqn, li, lv.to(self._keep_dtype)))
        else:
            sqn = rows_sqn(lv.reshape(-1, self.dim)).reshape(nlist, pad_local)
            self._put_staged(common + (lv, sqn, li))

    def _stage_host(self) -> None:
        """Host mode: assign and deal on the host, then push only this
        rank's block."""
        centroids = self._centroids_host()
        nlist = int(centroids.shape[0])
        assign = assign_clusters(self._vectors, centroids, device=self.device)
        pad_local, order, lists, slots = _slot_shard_layout(assign, nlist, self._shards)
        rows, lists, local = _own_rows(order, lists, slots, pad_local,
                                       shard_index(self._mesh, self._axes))
        list_vecs = np.zeros((nlist, pad_local, self.dim), np.float32)
        list_ids = np.full((nlist, pad_local), -1, np.int32)
        list_vecs[lists, local] = self._vectors[rows]
        list_ids[lists, local] = self._ids[rows]
        self._finish_stage(torch.from_numpy(list_vecs).to(self.device),
                           torch.from_numpy(list_ids).to(self.device),
                           torch.from_numpy(centroids).to(self.device), pad_local)

    def _stage_rows_device(self, vecs, idsa, assign) -> None:
        """Device mode: deal the rows on the device and scatter only this
        rank's rows into its block (the global canvas is never built)."""
        centroids = self._centroids_dev()
        nlist = int(centroids.shape[0])
        pad_local, order, lists, slots, _ = _slot_shard_layout_device(
            assign.to(torch.int64), nlist, self._shards)
        order, lists, local = _own_rows(order, lists, slots, pad_local,
                                        shard_index(self._mesh, self._axes))
        lv = scatter_lists_device(vecs.to(self._keep_dtype), order, lists, local, nlist,
                                  pad_local)
        li = scatter_list_ids_device(idsa, order, lists, local, nlist, pad_local)
        self._finish_stage(lv, li, centroids, pad_local)

    def _apply_removal_staged(self, table) -> int:
        staged = list(self._staged)
        li_at, norms_at = (5, 4) if self.scan_dtype == "int8" else (4, 3)
        staged[li_at], removed, staged[norms_at] = apply_removal(staged[li_at], table,
                                                                 staged[norms_at])
        self._put_staged(tuple(staged))
        count = torch.tensor([removed], dtype=torch.int64, device=self.device)
        return int(all_reduce_axes(count, self._mesh, self._axes, "sum")[0])

    def _build_masked(self, keep):
        """Once-per-mask staged operands: the masked scan norms (list_sqn,
        or dec_sqn for int8; +inf IS the kernels' exclusion marker) and the
        block's keep canvas for the plain probe scan (which scores diff^2
        and never reads the norms)."""
        staged = self._stage()
        li_at, norms_at = (5, 4) if self.scan_dtype == "int8" else (4, 3)
        kept = _keep_of(staged[li_at], keep)
        return keep, torch.where(kept, staged[norms_at], torch.inf), kept

    def scan_rows_per_chip(self, b: int, nprobe: int | None = None) -> dict:
        """Candidate rows each rank scans for a (b,)-query batch: B * nprobe
        * pad_local, 1/S of the single-device scan."""
        self._stage()
        nlist, pad_local = self._params
        nprobe_eff = min(nprobe or self.nprobe, nlist)
        shards = self._shards
        return {"shards": shards, "pad_local": pad_local,
                "rows_per_chip": b * nprobe_eff * pad_local,
                "rows_all_chips": b * nprobe_eff * pad_local * shards}

    def _merge_ivf_tail(self, d, i, q, k: int, nprobe: int, keep):
        """Rows added after staging: exact distances, visible only to the
        queries that probe their assigned list (devbuild.tail_scores), then
        one (distance, id) merge on the replicated results. q is in the
        space of the tail's _tail_field rows (IVF-PQ: the rotated one)."""
        tail_ids = self._tail["ids"]
        td = tail_scores(self._tail, self._staged[0], self._staged[1], q, nprobe,
                         vec_field=self._tail_field)
        if keep is not None:
            td = torch.where(_keep_of(tail_ids, keep)[None, :], td, torch.inf)
        return merge_tail(d, i, td, tail_ids, k)

    # -- search -----------------------------------------------------------------------------------

    def search(self, queries, k: int, *, nprobe: int | None = None,
               id_mask=None) -> tuple[np.ndarray, np.ndarray]:
        """id_mask: optional (cap,) bool keyed by EXTERNAL id (filter
        pushdown): masked rows get +inf scan norms (and, on the plain
        route, a keep canvas) staged once per mask object; pass the SAME
        object across calls to reuse them."""
        return self._search(queries, k, nprobe=nprobe, id_mask=id_mask, kernel_route=None)

    def _search(self, queries, k: int, *, nprobe: int | None = None, id_mask=None,
                kernel_route: bool | None, scan: str | None = None):
        """search() with the f32 route explicit: kernel_route=True is the
        IVF kernels per shard (their plain versions on CPU tensors), False
        the plain probe scan, None the device's choice (the kernels on a
        CUDA device); scan = "dense" or "select" forces that kernel instead
        of the width gate. The int8 route always runs the int8 dense
        kernel, as the JAX package's SQ8 program does."""
        q = query_rows(queries, self.dim, self.device)
        if self.ntotal == 0 or not self.is_trained:
            shape = (q.shape[0], k)
            return np.full(shape, np.inf, np.float32), np.full(shape, -1, np.int64)
        staged = self._stage()
        nlist, pad_local = self._params
        nprobe_eff = min(nprobe or self.nprobe, nlist)
        keep = masked_norms = keep_canvas = None
        if id_mask is not None:
            keep, masked_norms, keep_canvas = self._mask_table(id_mask)
        if self.scan_dtype == "int8":
            centroids, c_sq, codes, scale, dec_sqn, li, rerank = staged
            ks = min(shortlist_depth(k, self.ntotal), nprobe_eff * pad_local)
            d, i = sharded_ivf_sq8_search_program(
                self._mesh, centroids, c_sq, codes, scale,
                dec_sqn if keep is None else masked_norms, li, rerank, q, nprobe_eff, k, ks,
                self._axes, keep=keep, hwm=self._hwm)
        else:
            if kernel_route is None:
                kernel_route = self.device.type == "cuda"
            centroids, c_sq, lv, sqn, li = staged
            d, i = sharded_ivf_search_program(
                self._mesh, centroids, c_sq, lv, sqn if keep is None else masked_norms, li, q,
                nprobe_eff, k, use_kernels=kernel_route, axes=self._axes,
                keep=None if kernel_route else keep_canvas, hwm=self._hwm,
                dense=None if scan is None else scan == "dense")
        if self._tail and self._tail.count:
            d, i = self._merge_ivf_tail(d, i, q, k, nprobe_eff, keep)
        return d.cpu().numpy(), i.cpu().numpy().astype(np.int64)

    # -- serialization ----------------------------------------------------------------------------

    def state(self) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
        params = {"dim": self.dim, "nlist": self.nlist, "nprobe": self.nprobe,
                  "scan_dtype": self.scan_dtype, "rerank_dtype": self.rerank_dtype}
        if self._mode == "device" and self.ntotal:
            # bf16-kept rows widen to f32, as in the JAX package.
            vecs, idsa, _ = self._rows_all()
            return params, {"vectors": vecs.to(torch.float32).cpu().numpy(),
                            "ids": idsa.cpu().numpy().astype(np.int64),
                            "centroids": self._centroids_dev().cpu().numpy()}
        return params, {"vectors": self._vectors, "ids": self._ids,
                        "centroids": self._centroids_host()}

    @classmethod
    def from_state(cls, params, arrays, device=None, mesh: Mesh | None = None
                   ) -> "ShardedIVFIndex":
        """Accepts the JAX package's ShardedIVFIndex.state() (written at any
        device count) unchanged; an old file's float32 scan + bfloat16
        rerank pair (a no-op) loads as float32 + float32."""
        scan_dtype = str(params.get("scan_dtype", "float32"))
        rerank_dtype = str(params.get("rerank_dtype", "float32"))
        if scan_dtype == "float32":
            rerank_dtype = "float32"
        index = cls(dim=int(params["dim"]), nlist=int(params["nlist"]),
                    nprobe=int(params["nprobe"]), scan_dtype=scan_dtype,
                    rerank_dtype=rerank_dtype, mesh=mesh, device=device)
        if arrays["centroids"].size:
            index._centroids = np.array(arrays["centroids"], dtype=np.float32)
        if arrays["vectors"].size:
            index._absorb(arrays["vectors"], arrays["ids"])
        return index


# -- IVF-PQ: the index ------------------------------------------------------------------------

# Rows one step of the device-mode encode handles at once.
_ENCODE_ROWS = 262_144


@register
class ShardedIVFPQIndex(ShardedIVFIndex):
    """IVF-PQ with its code lists AND its f32 refine store slot-sharded over
    the mesh's corpus axes (a 1-D `data` axis, or ("host", "chip") with the
    two-level merge).

    The lists are ShardedIVFIndex's (each rank holds pad_local slots of
    every list); per shard the block's codes are ADC-scanned, k *
    refine_factor of its rows shortlisted and refined exactly from the
    rank's own f32 rows (sharded_pq_search_program), so the scan reads m
    bytes a row (m/2 for 4-bit codes) while results are exact distances.
    The quantizer trains like IVFPQIndex's (coarse k-means, then per-
    subspace k-means of the residuals), the same on every rank from the
    same rows; opq=True learns IVFPQIndex's OPQ rotation first, and the
    quantization runs in the rotated space while the refine stays in the
    original one. Each rank stages only its own rows: the codes in the
    ADC kernels' canvas (ops/adc.stage_codes_device, nibble-packed at
    ksub 16 with even m) and their item constants at pad_local. On a CUDA
    device for those shapes search runs the dense ADC kernel per shard
    (the card route), else the lookup-table scan on the unstaged codes.
    Adds after staging park in the replicated tail with their ROTATED rows
    ("rvecs"), whose exact distances merge after the refine; id_mask pushes
    a filter into the scan (a masked item-constant copy plus the keep
    table, once per mask object); remove_ids works in place on every
    shard.
    """

    kind = "sharded_ivf_pq"
    _tail_field = "rvecs"

    def __init__(self, dim: int, nlist: int = 64, nprobe: int = 8, m: int = 8, ksub: int = 256,
                 refine_factor: int = 4, opq: bool = False, opq_iters: int = 8,
                 mesh: Mesh | None = None, device=None):
        if dim % m != 0:
            raise ValueError(f"dim ({dim}) must be divisible by m ({m})")
        self.m = int(m)
        self.ksub = int(ksub)
        self.refine_factor = int(refine_factor)
        self.opq = bool(opq)
        self.opq_iters = int(opq_iters)
        self._rotation: np.ndarray | None = None    # (D, D); x_rot = x @ R
        self._rotation_dev = None
        super().__init__(dim, nlist, nprobe, mesh=mesh, device=device)

    def _reset_rows(self) -> None:
        super()._reset_rows()
        self._codebooks = None          # numpy (host mode) or a tensor (device mode)

    @property
    def is_trained(self) -> bool:
        return self._centroids is not None and self._codebooks is not None

    # -- the quantizer --------------------------------------------------------------------

    def _rotate(self, data: np.ndarray) -> np.ndarray:
        if self._rotation is None:
            return data
        return np.ascontiguousarray(data @ self._rotation)

    def _rotate_device(self, data: torch.Tensor) -> torch.Tensor:
        """Rows or queries into the quantization space, f32 on their device."""
        data = data.to(torch.float32)
        if self._rotation is None:
            return data
        if self._rotation_dev is None or self._rotation_dev.device != data.device:
            self._rotation_dev = torch.from_numpy(self._rotation).to(data.device)
        return data @ self._rotation_dev

    def _codebooks_dev(self) -> torch.Tensor:
        if self._staged is not None:
            return self._staged[2]
        c = self._codebooks
        if not isinstance(c, torch.Tensor):
            c = torch.from_numpy(np.array(c, dtype=np.float32))
        return c.to(self.device, torch.float32)

    def _codebooks_host(self) -> np.ndarray:
        if self._codebooks is None:
            return np.zeros((self.m, 0, self.dim // self.m), np.float32)
        if isinstance(self._codebooks, torch.Tensor):
            return self._codebooks.to(torch.float32).cpu().numpy()
        return np.asarray(self._codebooks, np.float32)

    def _assign(self, vecs: torch.Tensor) -> torch.Tensor:
        return assign_clusters(self._rotate_device(vecs.to(self.device)), self._centroids_dev(),
                               out_device=True)

    def _tail_spec(self) -> dict:
        # "vecs" keeps the original rows (extraction, serialization);
        # "rvecs" the rotated ones, which the tail scores against the
        # rotated queries (the rotation preserves L2).
        spec = super()._tail_spec()
        spec["rvecs"] = (self.dim, "float32")
        return spec

    def _tail_extras(self, vecs) -> dict:
        rvecs = self._rotate_device(vecs)
        return {"rvecs": rvecs,
                "assign": assign_clusters(rvecs, self._centroids_dev(), out_device=True)}

    def _encode_device(self, rows: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
        """(n, D) original-space rows and their lists -> (n, m) uint8 codes
        of their rotated residuals, in steps of _ENCODE_ROWS rows."""
        centroids, codebooks = self._centroids_dev(), self._codebooks_dev()
        parts = [assign_clusters_multi(
            _residual_subs(self._rotate_device(rows[s0 : s0 + _ENCODE_ROWS]), centroids,
                           assign[s0 : s0 + _ENCODE_ROWS], self.m), codebooks,
            out_device=True).T.to(torch.uint8)
            for s0 in range(0, rows.shape[0], _ENCODE_ROWS)]
        if not parts:
            return torch.zeros((0, self.m), dtype=torch.uint8, device=rows.device)
        return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts)

    def train(self, data, *, iters: int = 8, seed: int = 0) -> None:
        """Every rank trains the same quantizer from the same rows: the OPQ
        rotation (opq=True, once), coarse k-means of the rotated rows, then
        the codebooks (ops/kmeans.train_kmeans_multi of the residual
        subspaces, seed + 1). A tensor puts an empty index in device mode;
        a device-mode index that holds rows re-parks them under the new
        quantizer."""
        if is_device_array(data) and self._mode == "host" and self.ntotal == 0:
            self._mode = "device"
        if self._mode == "device":
            if not is_device_array(data):
                data = torch.from_numpy(np.ascontiguousarray(data, np.float32))
            data = data.to(self.device, torch.float32).reshape(-1, self.dim)
            n = int(data.shape[0])
            if self.opq and self._rotation is None:
                self._rotation = train_opq_rotation(data, self.m, ksub=self.ksub,
                                                    iters=self.opq_iters, seed=seed)
            data_r = self._rotate_device(data)
            centroids = train_kmeans(data_r, min(self.nlist, max(1, n)), iters=iters, seed=seed,
                                     out_device=True)
            subs = _residual_subs(data_r, centroids,
                                  assign_clusters(data_r, centroids, out_device=True), self.m)
            del data_r
            codebooks = train_kmeans_multi(subs, min(self.ksub, max(1, n)), iters=iters,
                                           seed=seed + 1, out_device=True)
            del subs
            rows = self._rows_all() if self.ntotal else None
            self._centroids, self._codebooks = centroids, codebooks
            self._unstage()
            if rows is not None:
                for store in self._row_stores():
                    store.clear()
                self._dev_vecs.append(rows[0])
                self._dev_ids.append(rows[1])
                self._dev_assign.append(self._assign(rows[0]))
            return
        if is_device_array(data):
            data = data.detach().to("cpu", torch.float32).numpy()
        data = np.ascontiguousarray(data, dtype=np.float32).reshape(-1, self.dim)
        n = data.shape[0]
        if self.opq and self._rotation is None:
            self._rotation = train_opq_rotation(data, self.m, ksub=self.ksub,
                                                iters=self.opq_iters, seed=seed,
                                                device=self.device)
        data_r = self._rotate(data)
        self._centroids = train_kmeans(data_r, min(self.nlist, max(1, n)), iters=iters,
                                       seed=seed, device=self.device)
        assign = assign_clusters(data_r, self._centroids, device=self.device)
        subs = np.ascontiguousarray((data_r - self._centroids[assign]).reshape(
            n, self.m, self.dim // self.m).transpose(1, 0, 2))
        self._codebooks = train_kmeans_multi(subs, min(self.ksub, max(1, n)), iters=iters,
                                             seed=seed + 1, device=self.device)
        self._unstage()

    # -- staging ----------------------------------------------------------------------------

    def _staged_store_ids(self):
        return self._staged[6], self._staged[5]

    def _finish_pq_stage(self, centroids, codebooks, list_codes, item_const, li, lv,
                         pad_local: int) -> None:
        """Shared epilogue: (centroids, c_sq, codebooks, canvas, item
        constants, list ids, refine rows) of this rank's block."""
        self._params = (int(centroids.shape[0]), pad_local)
        canvas = stage_codes_device(list_codes, self.m, int(codebooks.shape[1]))
        self._put_staged((centroids, (centroids * centroids).sum(dim=1), codebooks, canvas,
                          item_const, li, lv))

    def _stage_host(self) -> None:
        """Host mode: assign every row (the layout needs every list's
        count), then encode, scatter and build item constants for this
        rank's rows only, and push its block."""
        centroids, codebooks = self._centroids_host(), self._codebooks_host()
        nlist = int(centroids.shape[0])
        vecs_r = self._rotate(self._vectors)
        assign = assign_clusters(vecs_r, centroids, device=self.device)
        pad_local, order, lists, slots = _slot_shard_layout(assign, nlist, self._shards)
        rows, lists, local = _own_rows(order, lists, slots, pad_local,
                                       shard_index(self._mesh, self._axes))
        own_assign = assign[rows]
        subs = np.ascontiguousarray((vecs_r[rows] - centroids[own_assign]).reshape(
            -1, self.m, self.dim // self.m).transpose(1, 0, 2))
        codes = np.ascontiguousarray(
            assign_clusters_multi(subs, codebooks, device=self.device).T.astype(np.uint8))
        list_codes = np.zeros((nlist, pad_local, self.m), np.uint8)
        list_ids = np.full((nlist, pad_local), -1, np.int32)
        list_vecs = np.zeros((nlist, pad_local, self.dim), np.float32)
        list_codes[lists, local] = codes
        list_ids[lists, local] = self._ids[rows]
        list_vecs[lists, local] = self._vectors[rows]
        item_const = build_item_constants(centroids, own_assign, codes, codebooks,
                                          np.arange(rows.shape[0]), lists, local, nlist, pad_local)
        on = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        self._finish_pq_stage(on(centroids), on(codebooks), on(list_codes), on(item_const),
                              on(list_ids), on(list_vecs), pad_local)

    def _stage_rows_device(self, vecs, idsa, assign) -> None:
        """Device mode: deal the rows on the device; this rank's rows are
        re-encoded from their raw rows (codes are not kept between
        stagings) and scattered into its block (the global canvases are
        never built)."""
        centroids, codebooks = self._centroids_dev(), self._codebooks_dev()
        nlist = int(centroids.shape[0])
        pad_local, order, lists, slots, _ = _slot_shard_layout_device(
            assign.to(torch.int64), nlist, self._shards)
        order, lists, local = _own_rows(order, lists, slots, pad_local,
                                        shard_index(self._mesh, self._axes))
        lv = scatter_lists_device(vecs.to(torch.float32), order, lists, local, nlist, pad_local)
        li = scatter_list_ids_device(idsa, order, lists, local, nlist, pad_local)
        own_assign = assign[order]
        codes = self._encode_device(vecs[order], own_assign)
        mine = torch.arange(codes.shape[0], device=codes.device)
        list_codes = scatter_lists_device(codes, mine, lists, local, nlist, pad_local)
        item_const = build_item_constants_device(centroids, own_assign, codes, codebooks, mine,
                                                 lists, local, nlist, pad_local)
        del codes
        self._finish_pq_stage(centroids, codebooks, list_codes, item_const, li, lv, pad_local)

    def _apply_removal_staged(self, table) -> int:
        staged = list(self._staged)
        staged[5], removed, staged[4] = apply_removal(staged[5], table, staged[4])
        self._put_staged(tuple(staged))
        count = torch.tensor([removed], dtype=torch.int64, device=self.device)
        return int(all_reduce_axes(count, self._mesh, self._axes, "sum")[0])

    def _build_masked(self, keep):
        """Once-per-mask staged operands: the keep table and a masked copy
        of the block's item constants (+inf IS the ADC kernel's exclusion
        marker; the plain route reads the table only)."""
        staged = self._stage()
        return keep, torch.where(_keep_of(staged[5], keep), staged[4], torch.inf)

    # -- search -----------------------------------------------------------------------------

    def search(self, queries, k: int, *, nprobe: int | None = None,
               id_mask=None) -> tuple[np.ndarray, np.ndarray]:
        """id_mask: optional (cap,) bool keyed by EXTERNAL id (filter
        pushdown; pass the SAME object across calls to reuse its staging).
        Tail rows merge AFTER the per-shard refine with their exact
        distances: they never compete for shortlist slots, so a tail row
        can only add a true neighbour the shortlist would have dropped."""
        return self._search(queries, k, nprobe=nprobe, id_mask=id_mask, kernel_route=None)

    def _search(self, queries, k: int, *, nprobe: int | None = None, id_mask=None,
                kernel_route: bool | None):
        """search() with the route explicit: kernel_route=True is the dense
        ADC kernel per shard (its plain version on CPU tensors), False the
        plain lookup-table route, None the device's choice (the kernel on a
        CUDA device for the shapes it serves: ksub 256, or 16 with even
        m). The shortlist is k * refine_factor (at least k, at most
        ntotal) rows per shard at every depth."""
        q = query_rows(queries, self.dim, self.device)
        if self.ntotal == 0 or not self.is_trained:
            shape = (q.shape[0], k)
            return np.full(shape, np.inf, np.float32), np.full(shape, -1, np.int64)
        centroids, c_sq, codebooks, canvas, item_const, li, lv = self._stage()
        nprobe_eff = min(nprobe or self.nprobe, self._params[0])
        k_adc = max(min(k * self.refine_factor, self.ntotal), k)
        keep = None
        if id_mask is not None:
            keep, item_const = self._mask_table(id_mask)
        if kernel_route is None:
            kernel_route = self.device.type == "cuda" and kernel_shape(int(codebooks.shape[1]),
                                                                       self.m)
        q_adc = self._rotate_device(q)
        d, i = sharded_pq_search_program(self._mesh, centroids, c_sq, codebooks, canvas,
                                         item_const, li, lv, q_adc, q, nprobe_eff, k, k_adc,
                                         use_kernels=kernel_route, axes=self._axes, keep=keep,
                                         hwm=self._hwm)
        if self._tail and self._tail.count:
            d, i = self._merge_ivf_tail(d, i, q_adc, k, nprobe_eff, keep)
        return d.cpu().numpy(), i.cpu().numpy().astype(np.int64)

    # -- serialization ----------------------------------------------------------------------

    def state(self) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
        params = {"dim": self.dim, "nlist": self.nlist, "nprobe": self.nprobe, "m": self.m,
                  "ksub": self.ksub, "refine_factor": self.refine_factor, "opq": self.opq,
                  "opq_iters": self.opq_iters}
        rotation = (self._rotation if self._rotation is not None
                    else np.zeros((0, self.dim), np.float32))
        quantizer = {"centroids": self._centroids_host(), "codebooks": self._codebooks_host(),
                     "rotation": rotation}
        if self._mode == "device" and self.ntotal:
            vecs, idsa, _ = self._rows_all()
            return params, {"vectors": vecs.to(torch.float32).cpu().numpy(),
                            "ids": idsa.cpu().numpy().astype(np.int64), **quantizer}
        return params, {"vectors": self._vectors, "ids": self._ids, **quantizer}

    @classmethod
    def from_state(cls, params, arrays, device=None, mesh: Mesh | None = None
                   ) -> "ShardedIVFPQIndex":
        """Accepts the JAX package's ShardedIVFPQIndex.state() (written at
        any device count) unchanged."""
        index = cls(dim=int(params["dim"]), nlist=int(params["nlist"]),
                    nprobe=int(params["nprobe"]), m=int(params["m"]), ksub=int(params["ksub"]),
                    refine_factor=int(params.get("refine_factor", 4)),
                    opq=bool(params.get("opq", False)),
                    opq_iters=int(params.get("opq_iters", 8)), mesh=mesh, device=device)
        if arrays.get("rotation") is not None and arrays["rotation"].size:
            index._rotation = np.array(arrays["rotation"], dtype=np.float32)
        if arrays["centroids"].size:
            index._centroids = np.array(arrays["centroids"], dtype=np.float32)
        if arrays["codebooks"].size:
            index._codebooks = np.array(arrays["codebooks"], dtype=np.float32)
        if arrays["vectors"].size:
            index._absorb(arrays["vectors"], arrays["ids"])
        return index
