"""Feature post-processing: splice, stride, CMVN and SpecAugment
(port of ``pika_tpu/features/pipeline.py``)."""

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


def spec_augment_mask(num_frames: int, num_bins: int, freq_span, time_span, freq_start,
                      time_start) -> torch.Tensor:
    """The (T, D) keep-mask of one frequency span and one time span: False on
    bins [freq_start, freq_start + freq_span) and frames
    [time_start, time_start + time_span).  Spans and starts are ints or 0-d
    tensors (on the mask's device)."""
    device = time_start.device if isinstance(time_start, torch.Tensor) else None
    freq_idx = torch.arange(num_bins, device=device)
    time_idx = torch.arange(num_frames, device=device)
    freq_mask = (freq_idx >= freq_start) & (freq_idx < freq_start + freq_span)
    time_mask = (time_idx >= time_start) & (time_idx < time_start + time_span)
    return ~(freq_mask[None, :] | time_mask[:, None])


def spec_augment(feats: torch.Tensor, max_freq_span: int, max_time_span: int,
                 generator: torch.Generator) -> torch.Tensor:
    """SpecAugment with one frequency span and one time span shared across
    the batch: span widths uniform over [0, max], starts uniform over
    [0, dim - span] inclusive (the JAX package's fix of the reference's
    off-by-one, PARITY.md "Known deltas").  Draws stay on feats' device, so
    there is no host sync."""
    _, t, d = feats.shape
    dev = feats.device

    def draw_span(max_span):
        return torch.randint(0, max_span + 1, (), generator=generator, device=dev)

    def draw_start(dim, span):
        hi = torch.clamp(dim - span + 1, min=1)  # starts in [0, hi)
        u = torch.rand((), generator=generator, device=dev)
        return torch.minimum((u * hi).long(), hi - 1)

    freq_span, time_span = draw_span(max_freq_span), draw_span(max_time_span)
    freq_start, time_start = draw_start(d, freq_span), draw_start(t, time_span)
    keep = spec_augment_mask(t, d, freq_span, time_span, freq_start, time_start)
    return feats * keep.to(feats.dtype)
