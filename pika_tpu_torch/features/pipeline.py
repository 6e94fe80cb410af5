"""Feature post-processing: splice, stride and CMVN
(port of ``pika_tpu/features/pipeline.py``; SpecAugment is training-only and
not ported yet)."""

from __future__ import annotations

from typing import Optional

import torch


def splice(feats: torch.Tensor, lctx: int, rctx: int,
           frame_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Frame splicing with edge replication: (B, T, D) or (T, D) ->
    (..., T, D*(lctx+1+rctx)).  With ``frame_lens`` the right edge replicates
    each element's own last valid frame instead of the padded buffer edge."""
    squeeze = feats.dim() == 2
    if squeeze:
        feats = feats[None]
    b, t, d = feats.shape
    offsets = torch.arange(-lctx, rctx + 1, device=feats.device)
    idx = torch.arange(t, device=feats.device)[:, None] + offsets  # (T, C)
    if frame_lens is None:
        idx = idx.clamp(0, t - 1).expand(b, t, -1)
    else:
        # clip to [0, len-1] like jnp.clip; an empty element (len 0) gives
        # index -1, which wraps to the last frame as JAX's gather does
        hi = (frame_lens.long() - 1)[:, None, None]
        idx = torch.minimum(idx.clamp(min=0)[None], hi) % t
    out = torch.gather(feats, 1, idx.reshape(b, -1, 1).expand(-1, -1, d))
    out = out.reshape(b, t, (lctx + 1 + rctx) * d)
    return out[0] if squeeze else out


def stride_subsample(feats: torch.Tensor, stride: int) -> torch.Tensor:
    """Take every ``stride``-th frame."""
    return feats if stride == 1 else feats[..., ::stride, :]


def strided_len(frame_lens, stride: int):
    """ceil(len / stride), the loader's utt_len computation."""
    return (frame_lens + stride - 1) // stride


def apply_cmvn(feats: torch.Tensor, offset: torch.Tensor, scale: torch.Tensor,
               cmn: bool = False) -> torch.Tensor:
    """Per-utterance CMN (optional, over the padded length) then global CMVN
    offset/scale."""
    if cmn:
        feats = feats - feats.mean(dim=-2, keepdim=True)
    return (feats + offset) * scale
