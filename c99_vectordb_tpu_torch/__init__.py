"""c99_vectordb_tpu_torch — the PyTorch/CUDA port of c99_vectordb_tpu.

Same module layout and names as the JAX package, written in PyTorch's
idiom: plain functions on tensors and an explicit `device` on every entry
point (utils/runtime.resolve_device: the argument, then C99VDB_PLATFORM,
then cuda; CUDA requested without a device raises).

Layer map:
  - storage/   host-side YAML record store + TPUVDB01 index serialization
  - utils/     deterministic hashing, text lifecycle, filter engine, device rule
  - ops/       torch compute (embed, distances, top-k, rerank) and the
               hand-written CUDA fused L2 top-k kernel (ops/topk_cuda.py,
               csrc/fused_l2_topk.cu)
  - models/    index families: Flat (exact), IVF-Flat, IVF-PQ
  - parallel/  rank meshes over torch.distributed and the sharded flat index
  - api.py     the embedded MemoDB serving surface
"""

__version__ = "0.1.0"

from .constants import DIM, MAX_K  # noqa: F401
