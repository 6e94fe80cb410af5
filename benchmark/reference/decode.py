"""The reference's score of a served hypothesis: the log-probability of its
alignment, step by step, under the reference model.

A beam search's hypothesis carries its alignment: the tokens it took, a
blank moving to the next frame.  At each step the joint of the frame and
the prediction net's output after the tokens so far gives
``log_softmax(sm_scale * logits)``, and the step adds the taken token's
entry.  A hypothesis that finished also took a blank at the last frame,
which its alignment does not list: ``score_finished`` adds it.

A beam keeps the K best of its beams' candidates, so a token that a
hypothesis took at a step is among the K best of that beam's own
candidates: those it could take there (only blank once ``max_symbols``
labels are held, no blank at the last frame).  ``rank_gap`` is how far
below the K-th best the taken token lies under the reference (0 when it
is among the K best): the gap of a greedy token below the best, for a
beam of K.
"""

from __future__ import annotations

import torch

from benchmark.reference import features as RF
from benchmark.reference import model as M


@M.exact_float32()
def encode(state: dict, wavs: torch.Tensor, model: dict, feat: dict, cmvn: tuple,
           prec=M.FLOAT32):
    """Eval-mode features (no dither) normalized by ``cmvn`` (offset,
    scale), and the encoder output (B, T', H)."""
    x = RF.splice(RF.fbank(wavs, feat), feat["lctx"], feat["rctx"])
    return M.encoder(state, (x + cmvn[0]) * cmvn[1], model, prec)


@torch.no_grad()
@M.exact_float32()
def alignment_scores(state: dict, enc: torch.Tensor, utt: torch.Tensor, tokens: torch.Tensor,
                     lens: torch.Tensor, aligns: torch.Tensor, align_lens: torch.Tensor,
                     model: dict, sm_scale: float, beam: int, max_symbols: int,
                     prec=M.FLOAT32, block: int = 16):
    """Scores of M hypotheses: ``utt`` (M,) their utterance in ``enc``,
    ``tokens`` (M, Um) and ``lens``, ``aligns`` (M, S) and ``align_lens``.
    Returns (score along the listed alignment, score_finished, rank_gap),
    each (M,)."""
    m, s = aligns.shape
    dev = enc.device
    valid = torch.arange(s, device=dev)[None, :] < align_lens[:, None]
    tok = torch.where(valid, aligns, 0).long()
    blank = (tok == 0) & valid
    t_idx = torch.cumsum(blank.long(), 1) - blank.long()          # frames consumed before
    emit = valid & ~blank
    u_idx = torch.cumsum(emit.long(), 1) - emit.long()            # tokens emitted before
    dec = M.predict(state, tokens.clamp(min=0), lens, model, prec)  # (M, Um+1, H)
    ax, gx, ay, gy = M.joint_factors(state, enc, dec, prec)
    t_last = enc.shape[1] - 1
    listed, final, rank = [], [], []
    for i in range(0, m, block):
        sl = slice(i, i + block)
        rows = torch.arange(min(block, m - i), device=dev)[:, None]
        ti = t_idx[sl].clamp(max=t_last)
        ui = u_idx[sl]
        uu = utt[sl][:, None]
        logits = M.joint_logits(state, ax[uu, ti], gx[uu, ti], ay[i + rows, ui], gy[i + rows, ui],
                                prec)
        lp = torch.log_softmax(sm_scale * logits, dim=-1)
        taken = lp.gather(-1, tok[sl][..., None])[..., 0]
        listed.append((taken * valid[sl]).sum(1))
        allowed = torch.ones_like(lp, dtype=torch.bool)
        allowed[..., 1:] &= (ui < max_symbols)[..., None]
        allowed[..., 0] &= t_idx[sl] < t_last
        kth = torch.where(allowed, lp, -torch.inf).topk(beam, dim=-1).values[..., -1]
        rank.append((kth - taken).clamp(min=0).nan_to_num(0.0).mul(valid[sl]).amax(1))
        ue = lens[sl].long()
        end = M.joint_logits(state, ax[utt[sl], t_last], gx[utt[sl], t_last],
                             ay[i + rows[:, 0], ue], gy[i + rows[:, 0], ue], prec)
        final.append(torch.log_softmax(sm_scale * end, dim=-1)[:, 0])
    listed = torch.cat(listed)
    return listed, listed + torch.cat(final), torch.cat(rank)
