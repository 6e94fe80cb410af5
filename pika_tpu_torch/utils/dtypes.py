"""The matmul dtype of the decode loops (port of
``pika_tpu/utils/dtypes.py:resolve_mm_dtype``)."""

from __future__ import annotations

import torch


def resolve_mm_dtype(mm_dtype, device: torch.device) -> torch.dtype:
    """Resolve a matmul compute-dtype spec for tensors on ``device``:
    ``"auto"`` is bf16 on the card and float32 on the CPU (the plain loss
    backend's rule, ``ops/rnnt_loss.py:plain_mm_dtype``); ``None``,
    ``"float32"`` and ``"bfloat16"`` (or the torch dtypes) name theirs."""
    if mm_dtype == "auto":
        return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    if mm_dtype in (None, "float32", torch.float32):
        return torch.float32
    if mm_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"unsupported mm_dtype {mm_dtype!r}")
