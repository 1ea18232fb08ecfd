"""Device rule for every entry point of the port.

The device is chosen in this order:
  1. the caller's `device` argument;
  2. the C99VDB_PLATFORM environment variable (`cpu` or `cuda`);
  3. `cuda`.

A request for CUDA on a machine without it raises: the port never
continues on the CPU silently. (The JAX package routes small corpora to
the CPU on its own; the port leaves that choice to the caller.)
"""

from __future__ import annotations

import os

import torch

# The plain versions of the kernels, the exact rerank and the recall ground
# truth are full f32. TF32 would keep ~3 decimal digits in a CUDA matmul (or
# a cuDNN convolution) and break both the parity and the rerank's exactness,
# so both switches are pinned off rather than left to the library default.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch.device an entry point runs on (see the module docstring)."""
    if device is None:
        device = os.environ.get("C99VDB_PLATFORM", "").strip().lower() or "cuda"
    try:
        dev = torch.device(device)
    except RuntimeError:  # not a device name torch knows ("auto", "tpu")
        dev = None
    if dev is None or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device '{device}' (expected cpu or cuda)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but no CUDA device is available; "
            "pass device='cpu' or set C99VDB_PLATFORM=cpu to run on the CPU"
        )
    return dev
