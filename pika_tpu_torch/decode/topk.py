"""The top-k of the decoders, with ``jax.lax.top_k``'s tie rule."""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values, sorted,
    the lower index first among equal values."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]
