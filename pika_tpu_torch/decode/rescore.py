"""LAS forward and backward rescoring of an RNN-T N-best, and the score
fusion (port of ``pika_tpu/decode/rescore.py``).

``las_score_hyps`` teacher-forces all B x N hypotheses in one batched pass
(forward, or with each hypothesis reversed for the backward rescorer);
``rerank_nbest`` is the length-normalised weighted sum of the RNN-T and the
LAS scores, as the reference's ``nbest_rerank.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pika_tpu_torch.models.las import LAS


def _build_targets(tokens: torch.Tensor, lens: torch.Tensor, sos: int, eos: int, pad: int,
                   reverse: bool) -> torch.Tensor:
    """Hypotheses (N, Um) with lengths (N,) -> targets (N, Um + 2) =
    [SOS] hyp [EOS] [pad ...], the hypothesis reversed within its length
    when ``reverse``."""
    n, um = tokens.shape
    lens = lens.long()[:, None]
    idx = torch.arange(um, device=tokens.device)[None, :]
    src = tokens.gather(1, (lens - 1 - idx).clamp(0, um - 1)) if reverse else tokens
    body = torch.where(idx < lens, src, pad)
    tgt = torch.cat([body.new_full((n, 1), sos), body, body.new_full((n, 1), pad)], dim=1)
    pos = torch.arange(um + 2, device=tokens.device)[None, :]
    return torch.where(pos == lens + 1, eos, tgt)


@torch.no_grad()
def las_score_hyps(model: LAS, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                   tokens: torch.Tensor, lens: torch.Tensor, sos: int, eos: int,
                   reverse: bool = False):
    """Teacher-forced LAS log-probabilities of (B, N, Um) hypotheses (-1 or
    pad past their lengths ``lens`` (B, N)), the model in its own mode.

    ``enc_out`` (B, T, C) is the rescorer's input: the transducer encoder's
    output for a shared-encoder rescorer, else the decode features.  Returns
    (total (B, N), per_token (B, N, Um + 1)): the per-token scores cover the
    hypothesis tokens and the EOS step, 0 past them.

    The LAS encoder runs once per utterance and its output is repeated over
    the N hypotheses; the decoder steps only as far as the longest
    hypothesis (it is causal, so the steps past it change no score)."""
    b, n, um = tokens.shape
    cfg = model.config
    flat_tokens = tokens.clamp(0, cfg.output_dim).reshape(b * n, um).long()
    flat_lens = lens.reshape(b * n).long()
    steps = min(um, int(flat_lens.max()) if flat_lens.numel() else 0)
    tgt = _build_targets(flat_tokens[:, :steps], flat_lens, sos, eos, cfg.pad_idx, reverse)

    _, _, ds_out, (h, c), ds_lens = model.encode(enc_out, enc_lens)
    outputs, _ = model.decode(
        tgt[:, :-1], ds_out.repeat_interleave(n, 0),
        (h.repeat_interleave(n, 1), c.repeat_interleave(n, 1)),
        None if ds_lens is None else ds_lens.repeat_interleave(n, 0))
    lp = torch.log_softmax(model.output_logits(outputs).float(), dim=-1)  # (BN, steps + 1, V)
    targets = tgt[:, 1:]
    tok = lp.gather(-1, targets.clamp(0, cfg.output_dim - 1)[..., None])[..., 0]
    valid = torch.arange(steps + 1, device=tok.device)[None, :] <= flat_lens[:, None]
    tok = torch.where(valid & (targets != cfg.pad_idx), tok, 0.0)
    per_token = tok.new_zeros(b * n, um + 1)
    per_token[:, :steps + 1] = tok
    return per_token.sum(dim=1).reshape(b, n), per_token.reshape(b, n, um + 1)


def rerank_nbest(rnnt_scores: np.ndarray, lens: np.ndarray,
                 fw_scores: Optional[np.ndarray] = None, bw_scores: Optional[np.ndarray] = None,
                 rnnt_scale: float = 1.0, fw_scale: float = 0.3, bw_scale: float = 0.7):
    """Length-normalized fusion of (B, N) scores; returns (best_idx (B,),
    fused (B, N)).  Empty hypotheses are normalized by 0.001, as the
    reference's ``nbest_rerank.py`` does."""
    score = rnnt_scale * np.asarray(rnnt_scores, np.float32)
    if fw_scores is not None:
        score = score + fw_scale * np.asarray(fw_scores, np.float32)
    if bw_scores is not None:
        score = score + bw_scale * np.asarray(bw_scores, np.float32)
    lens = np.asarray(lens)
    fused = score / np.where(lens == 0, np.float32(0.001), lens.astype(np.float32))
    return np.argmax(fused, axis=1), fused
