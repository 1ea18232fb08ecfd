"""Flat exact index — brute-force squared-L2 over the whole database.

Rows live in a power-of-two padded device buffer with a validity mask;
+inf norms on padding rows are the scan kernel's mask.

Invariant: rows are kept sorted by external id (inserts are monotone in
the CLI; bulk loads are sorted on ingest), which makes the lowest-position
tie-break of every selection equal the contract's lowest-id tie-break.

Search routes (counterpart of the JAX package's models/flat.py):
  - on CUDA: a slacked shortlist (rerank.shortlist_depth) from
    kernel_shortlist (the fused L2 top-k kernel of ops/topk_cuda.py, masked
    ids scrubbed) when the store has >= 1024 rows and the shortlist is at
    most topk_cuda.SHORTLIST_MAX deep, else from topk_program; then the
    exact f32 rerank of the selected rows restores exact distances and
    (distance, id) order. ShardedFlatIndex runs kernel_shortlist per shard;
  - on the CPU: topk_program at depth k, with no rerank.

On a card, an unmasked search on the kernel route replays a CUDA graph
of its (B, k) from the key's third call on (SearchGraph, GraphCache):
the queries' copy in from a pinned buffer, the kernel's shortlist, the
exact rerank and the results' copies out, the same launches on the same
operands as the eager route, issued by one replay. A key's first call
runs eagerly (it stages the store and builds the kernel), its second
captures. The cache belongs to one staging: add and remove_ids drop it
with the staged tensors, so no graph outlives the pointers it holds.

A masked search (`id_mask`) always runs eagerly. Its mask staging
(devbuild.MaskCache: the keep table and a MaskedStore, built once per mask
object) runs inside the span `flat.mask`, within `flat.scan`. A mask that
keeps at most 1/COMPACT_SHARE of the padded store stages the rows it keeps
compacted (span `flat.compact`, inside `flat.mask`), and the kernel route
scans that copy instead of the whole store; the rerank reads the f32 store
at the rows it maps back to.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from ..constants import DIM
from ..ops.distances import query_rows, ranked_many_program, ranked_program
from ..ops.rerank import exact_rerank_rows, shortlist_depth
from ..ops.topk import topk_program
from ..ops.topk_cuda import SHORTLIST_MAX, add_launch_counts, fused_topk, launch_counts
from ..utils.runtime import resolve_device
from ..utils.timing import span
from . import devbuild
from .base import next_pow2
from .devbuild import MaskCache, keep_of, mask_norms, mask_shortlist_ids
from .registry import register

_SCAN_DTYPES = ("float32", "bfloat16", "int8")

# The keys (B, k) whose searches one staging keeps captured, the least
# recently used dropped past it: the bound on the graphs' memory pools.
GRAPH_KEYS = 8

# The smallest store the kernel route scans, and the kernel's row tile.
KERNEL_MIN_ROWS = 1024
ROW_TILE = 128
# A mask that keeps at most 1/COMPACT_SHARE of the padded store stages its
# rows compacted: the copy costs at most that share of the store's bytes,
# the ratio devbuild.tail_restage_threshold holds an append tail to.
COMPACT_SHARE = 64

# Always on and process-wide (as parallel/sharded.COUNTERS): searches that
# captured a CUDA graph of their key, that replayed one an earlier search
# captured, and that ran eagerly (on any device); searches that passed an
# id_mask, and those of them that scanned a mask's compacted rows; and the
# rows every search's route handed the scan (the padded store, or a mask's
# compacted rows), summed. The mask stagings are counted in
# devbuild.COUNTERS.
COUNTERS = {"graph_captures": 0, "graph_replays": 0, "eager_searches": 0,
            "masked_searches": 0, "compact_searches": 0, "scanned_rows": 0}


def kernel_shortlist(store, ids, norms, queries, depth: int, scale=None, keep=None):
    """The flat kernel's step: the top-`depth` rows of `store` by the fused
    L2 kernel (norms: +inf on padding and masked rows; scale: an SQ8
    store's per-dimension scale, folded into the queries), with the ids of
    a filter's masked rows scrubbed to -1 against its keep table `keep`.
    Returns (ids (B, depth) int32, store rows (B, depth) int32) for an
    exact rerank of those rows."""
    _, out_ids, rows = fused_topk(store, ids, norms, queries if scale is None else queries * scale,
                                  depth, return_rows=True)
    if keep is not None:
        out_ids = mask_shortlist_ids(out_ids, keep)
    return out_ids, rows


def kernel_route(cap: int, k_scan: int) -> bool:
    """Whether the card's shortlist comes from the kernel: it keeps
    k_scan-deep lists, so deeper shortlists and small stores (cap rows,
    padded) take topk_program."""
    return cap >= KERNEL_MIN_ROWS and k_scan <= SHORTLIST_MAX


def compact_rows(pos, scan_vecs, scan_norms, ids):
    """The store rows `pos` (ascending) copied out of the scan store, its
    norms and ids into a fresh staging of whole row tiles, at least
    KERNEL_MIN_ROWS of them, so the kernel scans it: (scan rows, norms,
    ids int32, store rows int32). Padding rows take the staging's
    conventions: zero rows, +inf norms, id -1 (store row 0)."""
    n = int(pos.shape[0])
    m = max(KERNEL_MIN_ROWS, -(-n // ROW_TILE) * ROW_TILE)
    dev = scan_vecs.device
    vecs = torch.zeros((m, scan_vecs.shape[1]), dtype=scan_vecs.dtype, device=dev)
    torch.index_select(scan_vecs, 0, pos, out=vecs[:n])   # no (n, D) temporary
    norms = torch.full((m,), torch.inf, dtype=torch.float32, device=dev)
    norms[:n] = scan_norms[pos]
    out_ids = torch.full((m,), -1, dtype=torch.int32, device=dev)
    out_ids[:n] = ids[pos]
    rows = torch.zeros((m,), dtype=torch.int32, device=dev)
    rows[:n] = pos
    return vecs, norms, out_ids, rows


class MaskedStore:
    """One mask's operands on one FlatIndex staging (FlatIndex._build_masked,
    cached per mask object by devbuild.MaskCache).

    `compact` is compact_rows of the rows the mask keeps where they are at
    most 1/COMPACT_SHARE of the padded store, else None. They stay in store
    order, which is id order, so the scan's (distance, position) ties stay
    (distance, id) ties, and only passing rows and padding are in it, so
    its shortlist needs no scrub. The kernel route scans it in place of
    the store.

    `full()` gives the full-store operands: the sq norms and scan norms
    (None where they alias) with +inf on the rows the mask drops (the
    kernel's exclusion marker) and the live rows topk_program reads. A
    mask without `compact` builds them with the store; one with it builds
    them on the first search that takes a full-store route."""

    def __init__(self, staged, keep, live=None, compact=None):
        self._staged, self._keep = staged, keep
        self._full = None
        self.compact = compact
        if compact is None:
            self.full(live)

    def full(self, live=None):
        if self._full is None:
            _, ids, valid, sq_norms, _, scan_norms, _ = self._staged
            keep = self._keep
            if live is None:
                live = valid & keep_of(ids, keep)
            self._full = (mask_norms(sq_norms, ids, keep),
                          None if scan_norms is None else mask_norms(scan_norms, ids, keep),
                          live)
        return self._full


class GraphCache:
    """The captured searches of one staging by key (B, k): None for a key
    seen once, its SearchGraph once captured; past `keys` keys the least
    recently used goes."""

    def __init__(self, keys: int = GRAPH_KEYS):
        self.keys = keys
        self._entries: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __getitem__(self, key):
        return self._entries[key]

    def step(self, key, *, cuda: bool, masked: bool, kernel: bool) -> str:
        """How a search of `key` runs: "replay" its graph, "capture" it (the
        key's second sighting) or "eager": off the card, under a mask, off
        the kernel route, and at a key's first sighting, which stages the
        store, builds the kernel and sets its attributes (none of which
        may happen inside a capture)."""
        if not cuda or masked or not kernel:
            return "eager"
        if key not in self._entries:
            self._entries[key] = None
            if len(self._entries) > self.keys:
                self._entries.popitem(last=False)
            return "eager"
        self._entries.move_to_end(key)
        return "capture" if self._entries[key] is None else "replay"

    def put(self, key, graph) -> None:
        self._entries[key] = graph


class SearchGraph:
    """An index's card route for one (B, k), captured as one CUDA graph: the
    queries' copy from a pinned host buffer into a device buffer,
    FlatIndex._device_search's launches as the eager route makes them, and
    the (B, k_eff) distances' and ids' copies into pinned host buffers."""

    def __init__(self, index: "FlatIndex", b: int, k_eff: int, k_scan: int):
        self.q_host = torch.empty((b, index.dim), dtype=torch.float32, pin_memory=True)
        self.q_dev = torch.empty((b, index.dim), dtype=torch.float32, device=index.device)
        self.d_host = torch.empty((b, k_eff), dtype=torch.float32, pin_memory=True)
        self.i_host = torch.empty((b, k_eff), dtype=torch.int32, pin_memory=True)
        self.q_np, self.d_np, self.i_np = (t.numpy() for t in (self.q_host, self.d_host,
                                                              self.i_host))
        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        # A capture stream on the index's card (the default one is made on
        # whichever card is current when the first graph is captured).
        with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(index.device)):
            self.q_dev.copy_(self.q_host, non_blocking=True)
            dists, ids = index._device_search(self.q_dev, k_eff, k_scan, None, True)
            self.d_host.copy_(dists, non_blocking=True)
            self.i_host.copy_(ids, non_blocking=True)
        # The capture launched nothing; each replay counts its launches.
        self.launched = launch_counts() - before
        add_launch_counts(self.launched, -1)

    def run(self, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One search of `queries` ((B, D) f32): copy in, replay, one
        synchronisation, and the results as fresh host arrays (f32
        distances, int64 ids), never views of the pinned buffers."""
        with span("flat.upload"):
            self.q_np[...] = queries
        with span("flat.replay"):
            self.graph.replay()
            add_launch_counts(self.launched)
        with span("flat.fetch"):
            torch.cuda.current_stream(self.q_dev.device).synchronize()
            return self.d_np.copy(), self.i_np.astype(np.int64)


def _padded(dists: np.ndarray, ids: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(B, k_eff) host results padded to k columns with (inf, -1)."""
    if ids.shape[1] < k:
        pad = ((0, 0), (0, k - ids.shape[1]))
        dists = np.pad(dists, pad, constant_values=np.inf)
        ids = np.pad(ids, pad, constant_values=-1)
    return dists, ids


@register
class FlatIndex:
    kind = "flat"

    def __init__(self, dim: int = DIM, scan_dtype: str = "float32",
                 device: str | torch.device | None = None):
        """scan_dtype="bfloat16" stages an EXTRA bf16 copy that only the
        scan kernel reads (half the scan's bytes) while the f32 store still
        serves the exact rerank. scan_dtype="int8" stages symmetric
        per-dimension SQ8 codes instead (a quarter of the f32 bytes); the
        slacked shortlist + exact f32 rerank keep end results exact."""
        if scan_dtype not in _SCAN_DTYPES:
            raise ValueError(f"unsupported scan_dtype '{scan_dtype}'")
        self.dim = int(dim)
        self.scan_dtype = str(scan_dtype)
        self.device = resolve_device(device)
        self._vectors = np.zeros((0, self.dim), dtype=np.float32)
        self._ids = np.zeros((0,), dtype=np.int64)
        self._device = None
        self._mask_cache = MaskCache(self.device)
        self._graphs = GraphCache()

    # -- introspection ----------------------------------------------------

    @property
    def ntotal(self) -> int:
        return int(self._vectors.shape[0])

    def ids(self) -> np.ndarray:
        return self._ids.copy()

    # -- mutation ----------------------------------------------------------

    @staticmethod
    def _host(vectors) -> np.ndarray:
        if isinstance(vectors, torch.Tensor):
            return vectors.detach().to("cpu", torch.float32).numpy()
        return vectors

    @staticmethod
    def _coerce_sorted(vectors, ids, dim: int) -> tuple[np.ndarray, np.ndarray]:
        """Validate/coerce a (vectors, ids) pair and enforce the
        sorted-by-id invariant. No copy when the inputs are already clean —
        from_state relies on this to adopt read-only mmap views."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32).reshape(-1, dim)
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if vectors.shape[0] != ids.shape[0]:
            raise ValueError("vectors and ids must have matching leading dimension")
        if not np.all(ids[:-1] <= ids[1:]):
            order = np.argsort(ids, kind="stable")
            vectors = vectors[order]
            ids = ids[order]
        return vectors, ids

    def add(self, vectors, ids: np.ndarray) -> None:
        """Append (n, dim) vectors (numpy or a tensor on any device) with
        external ids (n,). The host copy is the index's state; the device
        stagings rebuild on the next search."""
        with span("flat.add"):
            vectors = np.ascontiguousarray(self._host(vectors), dtype=np.float32)
            vectors = vectors.reshape(-1, self.dim)
            ids = np.asarray(ids, dtype=np.int64).reshape(-1)
            if vectors.shape[0] != ids.shape[0]:
                raise ValueError("vectors and ids must have matching leading dimension")
            self._vectors, self._ids = self._coerce_sorted(
                np.concatenate([self._vectors, vectors], axis=0),
                np.concatenate([self._ids, ids]),
                self.dim,
            )
            self._unstage()

    def reconstruct(self, doc_id: int) -> np.ndarray:
        """Return the stored vector for an external id. Raises KeyError if
        absent."""
        pos = np.searchsorted(self._ids, int(doc_id))
        if pos >= self._ids.shape[0] or self._ids[pos] != doc_id:
            raise KeyError(f"id {doc_id} not in index")
        return self._vectors[pos].copy()

    def remove_ids(self, ids) -> int:
        """Remove stored rows by external id; returns how many were removed
        (ids not present are ignored)."""
        ids = np.unique(np.asarray(ids, dtype=np.int64).reshape(-1))
        keep = ~np.isin(self._ids, ids)
        removed = int(self._ids.shape[0] - keep.sum())
        if removed:
            self._vectors = self._vectors[keep]
            self._ids = self._ids[keep]
            self._unstage()
        return removed

    # -- device staging ----------------------------------------------------

    def _unstage(self) -> None:
        """Drop the device stagings (rebuilt on the next search) and what
        holds their pointers: the masked operands and the captured
        searches."""
        self._device = None
        self._mask_cache.clear()
        self._graphs = GraphCache()

    def _build_masked(self, keep):
        """The keep table `keep`'s MaskedStore, once per mask: compacted
        where the mask keeps at most 1/COMPACT_SHARE of the padded store
        (its positions found first and the full-size temporaries freed
        before the rows are gathered), else the full-store operands. Sets
        devbuild.COUNTERS["mask_live_rows"] to the rows the mask keeps."""
        staged = self._staged()
        _, ids, valid, sq_norms, scan_vecs, scan_norms, _ = staged
        live = valid & keep_of(ids, keep)
        n_live = int(live.sum())
        devbuild.COUNTERS["mask_live_rows"] = n_live
        if n_live > ids.shape[0] // COMPACT_SHARE:
            return (MaskedStore(staged, keep, live=live),)
        with span("flat.compact"):
            pos = torch.nonzero(live).squeeze(1)
            del live
            compact = compact_rows(pos, scan_vecs, sq_norms if scan_norms is None else scan_norms,
                                   ids)
        return (MaskedStore(staged, keep, compact=compact),)

    def _staged(self):
        """Padded device tensors, a 7-tuple:
        (vectors f32, ids_i32, valid, sq_norms, scan_dev, scan_norms,
        scan_scale). scan_dev is the scan_dtype copy the kernel
        reads (aliases `vectors` for f32); scan_norms is None when it would
        alias sq_norms (f32/bf16 scans) and the decoded-space norms for
        int8; scan_scale is the (D,) SQ8 per-dimension scale (None unless
        scan_dtype == "int8"). Norms, codes and scale are computed in numpy
        exactly as the JAX package computes them, so both stage the same
        bytes."""
        if self._device is None:
            with span("flat.stage"):
                dev = self.device
                cap = next_pow2(max(self.ntotal, 1))
                vecs = np.zeros((cap, self.dim), dtype=np.float32)
                vecs[: self.ntotal] = self._vectors
                ids = np.full((cap,), -1, dtype=np.int32)
                ids[: self.ntotal] = self._ids.astype(np.int32)
                valid = np.zeros((cap,), dtype=bool)
                valid[: self.ntotal] = True
                sq_norms = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
                sq_norms[self.ntotal :] = np.inf  # the kernel's padding mask
                vecs_dev = torch.from_numpy(vecs).to(dev)
                scan_norms = scan_scale = None
                if self.scan_dtype == "bfloat16":
                    scan_dev = vecs_dev.to(torch.bfloat16)
                elif self.scan_dtype == "int8":
                    # Symmetric per-dimension SQ8: codes = round(x / a),
                    # a_d = maxabs_d / 127. The scan scores DECODED space
                    # (norms of x_hat; queries pre-scaled by a in search).
                    maxabs = np.abs(vecs[: self.ntotal]).max(axis=0, initial=1e-30)
                    scale = (maxabs / 127.0).astype(np.float32)  # (D,)
                    codes = np.clip(np.rint(vecs / scale), -127, 127)
                    scan_dev = torch.from_numpy(codes.astype(np.int8)).to(dev)
                    decoded = codes * scale
                    dec_norms = np.einsum("nd,nd->n", decoded, decoded).astype(np.float32)
                    dec_norms[self.ntotal :] = np.inf
                    scan_norms = torch.from_numpy(dec_norms).to(dev)
                    scan_scale = torch.from_numpy(scale).to(dev)
                else:
                    scan_dev = vecs_dev
                self._device = (
                    vecs_dev,
                    torch.from_numpy(ids).to(dev),
                    torch.from_numpy(valid).to(dev),
                    torch.from_numpy(sq_norms).to(dev),
                    scan_dev,
                    scan_norms,
                    scan_scale,
                )
        return self._device

    # -- search -------------------------------------------------------------

    def search(
        self, queries: np.ndarray, k: int, *, id_mask=None
    ) -> tuple[np.ndarray, np.ndarray]:
        """id_mask: optional (cap,) bool keyed by EXTERNAL id — rows whose
        id is False (or >= cap) are excluded exactly (metadata filter
        pushdown), through operands staged once per mask object: where the
        mask keeps at most 1/COMPACT_SHARE of the padded store (1/64), a
        compacted copy of the rows it keeps, which the card's kernel scans
        in place of the store; otherwise, and on the full-store routes, a
        masked copy of the norms operand. Pass the SAME mask array across
        calls to reuse the staging."""
        return self._search(queries, k, id_mask, rerank_route=self.device.type == "cuda")

    def _search(self, queries, k: int, id_mask, rerank_route: bool):
        """search() with the route made explicit: rerank_route=True is the
        card's shortlist -> kernel -> rerank route (on CPU tensors the
        kernel wrapper takes its plain version), False the single exact
        topk_program pass. On a card, GraphCache.step picks between the
        eager route and a CUDA graph of the same launches."""
        with span("flat.search"):
            queries = np.ascontiguousarray(queries, dtype=np.float32).reshape(-1, self.dim)
            b = queries.shape[0]
            if not self.ntotal:
                return np.full((b, k), np.inf, np.float32), np.full((b, k), -1, np.int64)
            cap = next_pow2(self.ntotal)
            k_eff = min(k, cap)
            k_scan = shortlist_depth(k_eff, cap) if rerank_route else k_eff
            key = (b, k)
            if id_mask is None:
                COUNTERS["scanned_rows"] += cap
            else:
                COUNTERS["masked_searches"] += 1     # its rows counted by _device_search
            step = self._graphs.step(key, cuda=self.device.type == "cuda",
                                     masked=id_mask is not None,
                                     kernel=rerank_route and b > 0 and kernel_route(cap, k_scan))
            if step == "capture":
                COUNTERS["graph_captures"] += 1
                with span("flat.capture"):
                    self._graphs.put(key, SearchGraph(self, b, k_eff, k_scan))
            elif step == "replay":
                COUNTERS["graph_replays"] += 1
            if step != "eager":
                dists, out_ids = self._graphs[key].run(queries)
                return _padded(dists, out_ids, k)
            COUNTERS["eager_searches"] += 1
            with span("flat.upload"):
                q_dev = torch.from_numpy(queries).to(self.device)
            dists, out_ids = self._device_search(q_dev, k_eff, k_scan, id_mask, rerank_route)
            with span("flat.fetch"):
                dists = dists.cpu().numpy()
                out_ids = out_ids.cpu().numpy().astype(np.int64)
            return _padded(dists, out_ids, k)

    def _device_search(self, q_dev, k_eff: int, k_scan: int, id_mask, rerank_route: bool):
        """The search's device work on staged queries q_dev: (distances
        (B, k_eff), ids (B, k_eff)) on the index's device. The card's
        kernel route keeps k_scan-deep shortlists for the rerank."""
        with span("flat.scan"):
            vecs, ids, valid, sq_norms, scan_vecs, scan_norms, scan_scale = self._staged()
            kernel = rerank_route and kernel_route(vecs.shape[0], k_scan)
            keep = compact = None
            if id_mask is not None:
                with span("flat.mask"):
                    keep, masked = self._mask_cache.get(id_mask, self._build_masked)
                compact = masked.compact if kernel else None
                if compact is None:
                    sq_norms, scan_norms, valid = masked.full()
                    COUNTERS["scanned_rows"] += vecs.shape[0]
                else:
                    COUNTERS["compact_searches"] += 1
                    COUNTERS["scanned_rows"] += compact[0].shape[0]
            if compact is not None:
                c_vecs, c_norms, c_ids, c_rows = compact
                out_ids, rows = kernel_shortlist(c_vecs, c_ids, c_norms, q_dev, k_scan, scan_scale)
                rows = c_rows[rows]
            elif kernel:
                out_ids, rows = kernel_shortlist(
                    scan_vecs, ids, sq_norms if scan_norms is None else scan_norms, q_dev,
                    k_scan, scan_scale, keep)
            else:
                dists, out_ids, rows = topk_program(vecs, ids, valid, sq_norms, q_dev, k_scan)
        if rerank_route:
            with span("flat.rerank"):
                # The scan store shares row order with the f32 store (a
                # compacted scan's rows mapped back to it), so the selected
                # rows index the rerank store directly.
                dists, out_ids = exact_rerank_rows(vecs, rows, out_ids, q_dev, k_eff)
        return dists, out_ids

    def ranked_rows(self) -> int:
        """Rows of the full ranking: the staged store's padded capacity."""
        return int(self._staged()[0].shape[0])

    def ranked_all_device(self, query):
        """Full exact ranking, left ON DEVICE: (dists, ids_i32, n). The
        query is a numpy array or a tensor."""
        vecs, ids, valid = self._staged()[:3]
        # The store is sorted by id with its padding last (_coerce_sorted).
        dists, out_ids = ranked_program(vecs, ids, valid,
                                        query_rows(query, self.dim, self.device)[0],
                                        in_id_order=True)
        return dists, out_ids, self.ntotal

    def ranked_many_device(self, queries):
        """Batched ranked_all_device: (dists (B, cap), ids (B, cap), n).
        Each row matches the single-query ranking for that query."""
        q = query_rows(queries, self.dim, self.device)
        vecs, ids, valid = self._staged()[:3]
        dists, out_ids = ranked_many_program(vecs, ids, valid, q, in_id_order=True)
        return dists, out_ids, self.ntotal

    def ranked_all(self, query: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        if self.ntotal == 0:
            return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
        dists, out_ids, n = self.ranked_all_device(query)
        return dists[:n].cpu().numpy(), out_ids[:n].cpu().numpy().astype(np.int64)

    # -- serialization -------------------------------------------------------

    def state(self) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
        params = {"dim": self.dim, "scan_dtype": self.scan_dtype}
        arrays = {"vectors": self._vectors, "ids": self._ids}
        return params, arrays

    @classmethod
    def from_state(cls, params: dict[str, Any], arrays: dict[str, np.ndarray],
                   device: str | torch.device | None = None) -> "FlatIndex":
        """Accepts the JAX package's FlatIndex.state() output unchanged."""
        index = cls(
            dim=int(params["dim"]),
            scan_dtype=str(params.get("scan_dtype", "float32")),
            device=device,
        )
        if arrays["vectors"].size:
            # Adopt the state arrays without copying (they may be read-only
            # mmap views — storage/index_io.py).
            index._vectors, index._ids = cls._coerce_sorted(
                arrays["vectors"], arrays["ids"], index.dim
            )
        return index
