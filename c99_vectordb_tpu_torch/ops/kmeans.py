"""k-means (batched Lloyd's) — the IVF coarse quantizer trainer (plain torch).

Counterpart of the JAX package's ops/kmeans.py (`train_kmeans`,
`assign_clusters`). Assignment is one matmul per data chunk (distance =
||c||^2 - 2 x.c, argmin over centroids, ties to the lowest centroid); the
update sums each cluster's rows and divides by its count; empty clusters
keep their previous centroid. Chunking bounds the (chunk, k) distance
block so 1M+ points train without materialising (N, k).

Determinism: the per-cluster sums are a one-hot matmul per chunk, in f32
(TF32 is off, utils/runtime.py), so two trainings on the same device give
bit-identical centroids. (`index_add_` on CUDA sums with atomics in an
order that changes from run to run.) Sums on the card and on the CPU
differ in the last bits, as do sums here and in the JAX package's
scatter-add.

Seeding: farthest-first traversal ("maximin", the default) over a strided
subsample, or a seeded permutation of that subsample ("sample"). The
JAX package draws that permutation with jax.random; here a torch.Generator
seeded from `seed` draws it, so the two packages pick different seeds
from the same subsample.

The `*_multi` trainers of the PQ subspaces are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.runtime import resolve_device

# Rows per update chunk on the card: the (chunk, k) one-hot block and the
# distance block stay ~1 GB at k = 4096.
_DEVICE_CHUNK = 65_536


def _as_f32(data, device) -> torch.Tensor:
    """(N, D) float32 tensor: a tensor stays on its device, numpy goes to
    `device`."""
    if isinstance(data, torch.Tensor):
        return data.to(torch.float32)
    data = np.ascontiguousarray(data, dtype=np.float32)
    return torch.from_numpy(data if data.flags.writeable else data.copy()).to(device)


def _assign_chunk(chunk: torch.Tensor, centroids: torch.Tensor, c_sq: torch.Tensor) -> torch.Tensor:
    """(chunk, D) x (k, D) -> (chunk,) int64 nearest-centroid index
    (||x||^2 is constant per row and left out)."""
    ip = chunk @ centroids.T
    return torch.argmin(c_sq[None, :] - 2.0 * ip, dim=1)


def _chunk_rows(chunk: int, device: torch.device) -> int:
    return max(chunk, _DEVICE_CHUNK) if device.type == "cuda" else chunk


def _lloyd(data: torch.Tensor, init: torch.Tensor, iters: int, chunk: int) -> torch.Tensor:
    n, dim = data.shape
    k = init.shape[0]
    step = _chunk_rows(chunk, data.device)
    cluster = torch.arange(k, device=data.device)
    centroids = init.clone()
    for _ in range(iters):
        c_sq = (centroids * centroids).sum(dim=1)
        sums = torch.zeros((k, dim), dtype=torch.float32, device=data.device)
        counts = torch.zeros((k,), dtype=torch.float32, device=data.device)
        for s0 in range(0, n, step):
            block = data[s0 : s0 + step]
            assign = _assign_chunk(block, centroids, c_sq)
            onehot = (assign[:, None] == cluster[None, :]).to(torch.float32)
            sums += onehot.T @ block
            counts += onehot.sum(dim=0)
        fresh = sums / torch.clamp_min(counts, 1.0)[:, None]
        centroids = torch.where((counts > 0.0)[:, None], fresh, centroids)
    return centroids


def _maximin(data: torch.Tensor, k: int) -> torch.Tensor:
    """Farthest-first traversal: start from the point farthest from the
    mean, then repeatedly take the point farthest from every chosen
    centroid (ties to the lowest row)."""
    mean = data.sum(dim=0) / max(data.shape[0], 1)
    first = int(torch.argmax(((data - mean) ** 2).sum(dim=1)))
    centroids = torch.zeros((k, data.shape[1]), dtype=torch.float32, device=data.device)
    centroids[0] = data[first]
    min_d = ((data - data[first]) ** 2).sum(dim=1)
    for i in range(1, k):
        nxt = torch.argmax(min_d)
        chosen = data[nxt]
        centroids[i] = chosen
        min_d = torch.minimum(min_d, ((data - chosen) ** 2).sum(dim=1))
    return centroids


def train_kmeans(data, k: int, *, iters: int = 10, seed: int = 0, chunk: int = 2048,
                 out_device: bool = False, init: str = "maximin", device=None):
    """Train k centroids on (N, D) float32 data (numpy, or a tensor on its
    own device); returns (k, D) float32: numpy, or a tensor on the data's
    device when out_device=True. Numpy data trains on `device`
    (utils/runtime.resolve_device).

    init="maximin" (default) seeds by farthest-first traversal; init="sample"
    seeds from a seeded permutation of the strided subsample (Forgy), the
    right choice when cluster populations are imbalanced."""
    dev = data.device if isinstance(data, torch.Tensor) else resolve_device(device)
    data = _as_f32(data, dev).reshape(-1, data.shape[-1])
    n = data.shape[0]
    if n < k:
        raise ValueError(f"need at least k={k} training points, got {n}")
    # Seed over a deterministic strided subsample (capped so init stays
    # O(k * sample) at any corpus size).
    sample_cap = max(k * 16, 16384)
    stride = max(1, n // sample_cap)
    sample = data[(seed % stride) :: stride][: max(k, sample_cap)]
    if init == "sample":
        gen = torch.Generator(device="cpu").manual_seed(seed)
        perm = torch.randperm(sample.shape[0], generator=gen)[:k].to(dev)
        init_c = sample[perm]
    elif init == "maximin":
        init_c = _maximin(sample, k)
    else:
        raise ValueError(f"unknown kmeans init '{init}'")
    out = _lloyd(data, init_c, iters, min(chunk, n))
    return out if out_device else out.cpu().numpy()


def assign_clusters(data, centroids, *, chunk: int = 2048, out_device: bool = False,
                    device=None):
    """Nearest-centroid assignment for (N, D) data; returns (N,) int32
    (numpy, or a tensor on the data's device when out_device=True).
    Numpy data runs on the centroids' device when they are a tensor, else
    on `device`."""
    if isinstance(data, torch.Tensor):
        dev = data.device
    elif isinstance(centroids, torch.Tensor):
        dev = centroids.device
    else:
        dev = resolve_device(device)
    data = _as_f32(data, dev)
    n = data.shape[0]
    if n == 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=dev)
        return empty if out_device else empty.cpu().numpy()
    cents = _as_f32(centroids, dev).to(dev)
    c_sq = (cents * cents).sum(dim=1)
    step = _chunk_rows(min(chunk, n), dev)
    out = torch.cat([
        _assign_chunk(data[s0 : s0 + step], cents, c_sq) for s0 in range(0, n, step)
    ]).to(torch.int32)
    return out if out_device else out.cpu().numpy()
