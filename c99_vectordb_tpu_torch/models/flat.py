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
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..constants import DIM
from ..ops.distances import query_rows, ranked_many_program, ranked_program
from ..ops.rerank import exact_rerank_rows, shortlist_depth
from ..ops.topk import topk_program
from ..ops.topk_cuda import SHORTLIST_MAX, fused_topk
from ..utils.runtime import resolve_device
from ..utils.timing import span
from .base import next_pow2
from .devbuild import MaskCache, keep_of, mask_norms, mask_shortlist_ids
from .registry import register

_SCAN_DTYPES = ("float32", "bfloat16", "int8")


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
            self._device = None
            self._mask_cache.clear()

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
            self._device = None
            self._mask_cache.clear()
        return removed

    # -- device staging ----------------------------------------------------

    def _build_masked(self, keep):
        """Once-per-mask staged operands of the keep table `keep`: the
        masked sq norms and scan norms (+inf IS the kernel's exclusion
        marker) and the valid rows that topk_program reads."""
        _, ids, valid, sq_norms, _, scan_norms, _ = self._staged()
        return (mask_norms(sq_norms, ids, keep),
                None if scan_norms is None else mask_norms(scan_norms, ids, keep),
                valid & keep_of(ids, keep))

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
        pushdown), through a masked copy of the norms operand staged once
        per mask object. Pass the SAME mask array across calls to reuse
        the staging."""
        return self._search(queries, k, id_mask, rerank_route=self.device.type == "cuda")

    def _search(self, queries, k: int, id_mask, rerank_route: bool):
        """search() with the route made explicit: rerank_route=True is the
        card's shortlist -> kernel -> rerank route (on CPU tensors the
        kernel wrapper takes its plain version), False the single exact
        topk_program pass."""
        with span("flat.search"):
            with span("flat.upload"):
                queries = np.ascontiguousarray(queries, dtype=np.float32).reshape(-1, self.dim)
                q_dev = torch.from_numpy(queries).to(self.device) if self.ntotal else None
            if q_dev is None:
                shape = (queries.shape[0], k)
                return np.full(shape, np.inf, np.float32), np.full(shape, -1, np.int64)
            with span("flat.scan"):
                vecs, ids, valid, sq_norms, scan_vecs, scan_norms, scan_scale = self._staged()
                keep = None
                if id_mask is not None:
                    keep, sq_norms, scan_norms, valid = self._mask_cache.get(id_mask,
                                                                             self._build_masked)
                cap = vecs.shape[0]
                k_eff = min(k, cap)
                k_scan = shortlist_depth(k_eff, cap) if rerank_route else k_eff
                # The kernel keeps k_scan-deep lists; deeper shortlists and
                # small stores take topk_program.
                if rerank_route and cap >= 1024 and k_scan <= SHORTLIST_MAX:
                    out_ids, rows = kernel_shortlist(
                        scan_vecs, ids, sq_norms if scan_norms is None else scan_norms, q_dev,
                        k_scan, scan_scale, keep)
                else:
                    dists, out_ids, rows = topk_program(vecs, ids, valid, sq_norms, q_dev, k_scan)
            if rerank_route:
                with span("flat.rerank"):
                    # The scan store shares row order with the f32 store, so
                    # the selected rows index the rerank store directly.
                    dists, out_ids = exact_rerank_rows(vecs, rows, out_ids, q_dev, k_eff)
            with span("flat.fetch"):
                dists = dists.cpu().numpy()
                out_ids = out_ids.cpu().numpy().astype(np.int64)
                if k_eff < k:
                    pad = ((0, 0), (0, k - k_eff))
                    dists = np.pad(dists, pad, constant_values=np.inf)
                    out_ids = np.pad(out_ids, pad, constant_values=-1)
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
