"""Batched greedy RNN-T decoding (port of ``pika_tpu/decode/greedy.py``,
LSTM prediction net).

Time-synchronous greedy search: at each step run the joint on the current
(encoder frame, prediction-net state) pair and take the argmax; a blank
advances the frame, a label is emitted and advances the prediction net.  The
JAX ``while_loop`` becomes a Python loop with the same bound and update
order; checking ``done.all()`` costs one host sync per step.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pika_tpu_torch.models.transducer import Transducer


@torch.inference_mode()
def greedy_decode(model: Transducer, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                  max_symbols: int = 200, blank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode a batch of encoder outputs (B, T, H) in float32.

    Returns (hyps (B, max_symbols) int32 padded with -1, hyp_lens (B,) int32).
    """
    b, t_max, _ = enc_out.shape
    dev = enc_out.device
    cfg = model.config
    ax_all, gx_all = model.joint_enc_factors(enc_out)  # hoisted out of the loop

    # the prediction net first consumes SOS (= blank)
    zeros = torch.zeros(cfg.dec_layers, b, cfg.hid_dim, device=dev, dtype=enc_out.dtype)
    dec_hid, state = model.predict_step(torch.full((b,), blank, device=dev), (zeros, zeros))
    dec_ay, dec_gy = model.joint_dec_factors(dec_hid)

    rows = torch.arange(b, device=dev)
    slots = torch.arange(max_symbols, device=dev)[None, :]
    t_idx = torch.zeros(b, dtype=torch.int32, device=dev)
    done = enc_lens <= 0
    hyps = torch.full((b, max_symbols), -1, dtype=torch.int32, device=dev)
    hyp_len = torch.zeros(b, dtype=torch.int32, device=dev)
    for _ in range(t_max + max_symbols):  # each step advances t or emits
        if bool(done.all()):
            break
        tc = t_idx.clamp(0, t_max - 1).long()
        logits = model.joint_from_factors(ax_all[rows, tc], gx_all[rows, tc], dec_ay, dec_gy)
        tok = logits.float().argmax(dim=-1).to(torch.int32)
        is_blank = (tok == blank) | done | (hyp_len >= max_symbols)
        t_idx = torch.where(is_blank, t_idx + 1, t_idx)
        done = done | (t_idx >= enc_lens)
        emit = ~is_blank
        pos = hyp_len.clamp(0, max_symbols - 1)
        hyps = torch.where(emit[:, None] & (slots == pos[:, None]), tok[:, None], hyps)
        hyp_len = hyp_len + emit.to(torch.int32)
        # advance the prediction net only on emitting rows
        new_hid, (new_h, new_c) = model.predict_step(tok, state)
        keep = emit[:, None]
        state = (torch.where(keep[None], new_h, state[0]), torch.where(keep[None], new_c, state[1]))
        new_ay, new_gy = model.joint_dec_factors(new_hid)
        dec_ay = torch.where(keep, new_ay, dec_ay)
        dec_gy = torch.where(keep, new_gy, dec_gy)
    return hyps, hyp_len


@torch.inference_mode()
def greedy_decode_waveforms(model: Transducer, featurizer, wavs, wav_lens,
                            max_symbols: int = 200, blank: int = 0):
    """Waveforms -> features -> encoder -> greedy decode."""
    feats, feat_lens = featurizer(wavs, wav_lens)
    enc = model.encode(feats, feat_lens)
    return greedy_decode(model, enc, model.encoder_out_len(feat_lens), max_symbols, blank)
