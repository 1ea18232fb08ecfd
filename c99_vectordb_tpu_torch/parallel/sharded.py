"""Multi-rank flat search over torch.distributed (SPMD, one process per rank).

Counterpart of the flat half of the JAX package's parallel/sharded.py
(shard_map programs over a device mesh). Here every rank runs the same
code on its own row shard, and the collectives of parallel/mesh.py stand
in for JAX's all_gather / psum:

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

A rank's results are replicated after the merge. On the CPU the kernel
wrapper takes its plain version; the exact route (matmul + top-k) is plain
torch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..models.base import next_pow2
from ..models.devbuild import (
    ChunkStore, GrowTail, MaskCache, apply_removal, is_device_array, merge_tail,
    removal_table, tail_restage_threshold,
)
from ..models.registry import register
from ..ops.distances import query_rows, ranked_many_program, ranked_program
from ..ops.rerank import exact_rerank_rows, shortlist_depth
from ..ops.topk import merge_topk, stable_topk
from ..ops.topk_cuda import fused_topk
from .mesh import Mesh, all_gather_axes, all_gather_axis, all_reduce_axes, \
    all_reduce_axis, default_data_mesh

# The kernel keeps shortlists up to this deep (csrc/fused_l2_topk.cu).
KERNEL_MAX_K = 1024


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
    for axis in reversed(axes):
        d, i = _merge_gathered(d, i, k, mesh, axis)
    return d, i


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
    _, si, rows = fused_topk(db, ids, sq_norms, queries, ks, return_rows=True)
    if keep is not None:
        si = _scrub_ids(si, keep)
    local_d, local_i = exact_rerank_rows(db, rows, si, queries, k)
    return _merge_axes(local_d, local_i, k, mesh, axes)


def sharded_search_sq8_kernels(mesh: Mesh, codes, db, ids, dec_norms, scale, queries,
                               k: int, ks: int, axes: tuple[str, ...] = ("data",),
                               keep=None):
    """sharded_search_kernels on the SQ8 store: each rank scans its int8
    codes with queries x the global per-dimension scale (the kernel's
    int8 x int8 mode; queries are row-quantised inside fused_topk), then
    reranks its shortlist exactly from its f32 rows."""
    _, si, rows = fused_topk(codes, ids, dec_norms, queries * scale, ks, return_rows=True)
    if keep is not None:
        si = _scrub_ids(si, keep)
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
            parts = self._rows_all() if self.ntotal else None
            self._dev_vecs, self._dev_ids = ChunkStore(), ChunkStore()
            if parts is not None:
                self._dev_vecs.append(parts[0].to(mesh.device))
                self._dev_ids.append(parts[1].to(mesh.device))
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

    def ids(self) -> np.ndarray:
        if self._mode == "device":
            if self._n_dev == 0:
                return np.zeros((0,), np.int64)
            return self._rows_all()[1].cpu().numpy().astype(np.int64)
        return self._ids.copy()

    # -- mutation ---------------------------------------------------------------------

    def _tail_park(self, vecs, ids) -> None:
        if self._tail is None:
            self._tail = GrowTail({"vecs": (self.dim, "float32"), "ids": (None, "int32")},
                                  self.device, initial_cap=tail_restage_threshold(self.ntotal))
        self._tail.append(vecs=vecs, ids=ids)
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
                self._dev_vecs.append(vectors)
                self._dev_ids.append(ids)
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
            vecs, idsa = self._rows_all()
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
                    rows, idsa = self._rows_all()
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
    copies staged once per mask object.
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

    def _aligned_cap(self, n: int) -> int:
        """Rows of the staged store: each shard tile-aligned for the kernel,
        1024 rows for f32 and 2048 for int8 (memory cost < 1 tile a shard)."""
        shards = self._shards
        per = -(-max(n, 1) // shards)
        align = 2048 if self.scan_dtype == "int8" else 1024
        return -(-per // align) * align * shards

    def _stage(self):
        """This rank's shard of the padded store: (db (per, D) f32, ids
        (per,) int32 with -1 padding, sq norms (per,) with +inf padding),
        plus (codes, decoded norms, scale) for int8."""
        if self._staged is not None and not self._restage_needed:
            return self._staged
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

    def _search(self, queries, k: int, id_mask, kernel_route: bool | None):
        """search() with the route explicit: kernel_route=True is the flat
        kernel + per-shard rerank (the kernel's plain version on CPU
        tensors), False the exact route, None the card's choice (the
        kernel while the shortlist fits it, on a CUDA device)."""
        q = query_rows(queries, self.dim, self.device)
        if self.ntotal == 0:
            shape = (q.shape[0], k)
            return np.full(shape, np.inf, np.float32), np.full(shape, -1, np.int64)
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
        return d.cpu().numpy(), i.cpu().numpy().astype(np.int64)

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
