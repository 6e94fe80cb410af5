"""Batched greedy RNN-T decoding (port of ``pika_tpu/decode/greedy.py``).

Time-synchronous greedy search: at each step run the joint on the current
(encoder frame, prediction-net state) pair and take the argmax; a blank
advances the frame, a label is emitted and advances the prediction net.  The
JAX ``while_loop`` becomes a ``decode.loop.DecodeLoop`` with the same bound
and update order: one CUDA graph of the body on the card, the same body
eagerly on the CPU.

The prediction net advances every row (``Transducer.advance``, from its
state and its (B, max_symbols) hypothesis buffer) and the emitting rows
take its output and new state.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pika_tpu_torch.decode.loop import STEPS_PER_CHECK, DecodeLoop, cached_loop
from pika_tpu_torch.models.transducer import Transducer
from pika_tpu_torch.utils.dtypes import resolve_mm_dtype


class GreedyLoop(DecodeLoop):
    def __init__(self, net: Transducer, b: int, t_max: int, max_symbols: int, blank: int,
                 device: torch.device):
        super().__init__()
        cfg = net.config
        dtype = net.fc2.weight.dtype
        self.net, self.blank, self.max_symbols = net, blank, max_symbols
        self.max_bodies = t_max + max_symbols + 1  # the last one sees the loop's end
        h = cfg.hid_dim
        zeros = dict(device=device, dtype=dtype)
        self.slots = torch.arange(max_symbols, device=device)[None, :]
        self.inputs = {"ax_all": torch.zeros(b, t_max, h, **zeros),
                       "gx_all": torch.zeros(b, t_max, h, **zeros),
                       "enc_lens": torch.zeros(b, dtype=torch.long, device=device)}
        self.state = {
            "running": torch.zeros((), dtype=torch.bool, device=device),
            "step": torch.zeros((), dtype=torch.long, device=device),
            "t_idx": torch.zeros(b, dtype=torch.long, device=device),
            "done": torch.zeros(b, dtype=torch.bool, device=device),
            "dec_ay": torch.zeros(b, h, **zeros),
            "dec_gy": torch.zeros(b, h, **zeros),
            "hyps": torch.zeros(b, max_symbols, dtype=torch.long, device=device),
            "hyp_len": torch.zeros(b, dtype=torch.long, device=device),
        }
        dec = net.dec_state((b,), device, dtype)
        self.dec_names = tuple(dec)
        self.state.update(dec)

    def reset(self, enc_out, enc_lens) -> None:
        net, st, b = self.net, self.state, enc_out.shape[0]
        ax_all, gx_all = net.joint_enc_factors(enc_out.to(net.fc2.weight.dtype))
        self.inputs["ax_all"].copy_(ax_all)
        self.inputs["gx_all"].copy_(gx_all)
        self.inputs["enc_lens"].copy_(enc_lens)
        st["running"].fill_(True)
        st["step"].zero_()
        st["t_idx"].zero_()
        st["done"].copy_(self.inputs["enc_lens"] <= 0)
        st["hyps"].fill_(-1)
        st["hyp_len"].zero_()
        for name in self.dec_names:
            st[name].zero_()
        # the prediction net first consumes SOS (= blank) from the zero state
        dec_hid, dec = net.advance(torch.full((b,), self.blank, device=enc_out.device),
                                   {name: st[name] for name in self.dec_names}, st["hyps"],
                                   st["hyp_len"])
        for name, x in dec.items():
            st[name].copy_(x)
        ay, gy = net.joint_dec_factors(dec_hid)
        st["dec_ay"].copy_(ay)
        st["dec_gy"].copy_(gy)

    def body(self) -> None:
        st, net, blank = self.state, self.net, self.blank
        ax_all, gx_all, enc_lens = (self.inputs[k] for k in ("ax_all", "gx_all", "enc_lens"))
        st["running"].logical_and_(~st["done"].all() & (st["step"] < self.max_bodies - 1))
        t_max, h = ax_all.shape[1], ax_all.shape[2]
        tc = st["t_idx"].clamp(0, t_max - 1)[:, None, None].expand(-1, 1, h)
        logits = net.joint_from_factors(ax_all.gather(1, tc)[:, 0], gx_all.gather(1, tc)[:, 0],
                                        st["dec_ay"], st["dec_gy"])
        tok = logits.float().argmax(dim=-1)
        is_blank = (tok == blank) | st["done"] | (st["hyp_len"] >= self.max_symbols)
        t_idx = torch.where(is_blank, st["t_idx"] + 1, st["t_idx"])
        emit = ~is_blank
        pos = st["hyp_len"].clamp(0, self.max_symbols - 1)
        hyps = torch.where(emit[:, None] & (self.slots == pos[:, None]), tok[:, None],
                           st["hyps"])
        hyp_len = st["hyp_len"] + emit.long()
        keep = emit[:, None]
        new = {"step": st["step"] + 1, "t_idx": t_idx, "done": st["done"] | (t_idx >= enc_lens),
               "hyps": hyps, "hyp_len": hyp_len}
        # advance the prediction net only on emitting rows
        new_hid, dec = net.advance(tok, {name: st[name] for name in self.dec_names}, hyps,
                                   hyp_len)
        for name, x in dec.items():
            new[name] = torch.where(emit.view((1, -1) + (1,) * (x.dim() - 2)), x, st[name])
        new_ay, new_gy = net.joint_dec_factors(new_hid)
        new["dec_ay"] = torch.where(keep, new_ay, st["dec_ay"])
        new["dec_gy"] = torch.where(keep, new_gy, st["dec_gy"])
        self.commit(new)


def _greedy(model, enc_out, enc_lens, max_symbols, mm_dtype, blank, steps_per_check, graphed):
    b, t_max, _ = enc_out.shape
    dev = enc_out.device
    dtype = resolve_mm_dtype(mm_dtype, dev)
    loop = cached_loop(model, ("greedy", str(dev), b, t_max, max_symbols, blank), dtype,
                       lambda net: GreedyLoop(net, b, t_max, max_symbols, blank, dev))
    loop.run(graphed, steps_per_check, enc_out, enc_lens)
    return loop.state["hyps"].to(torch.int32), loop.state["hyp_len"].to(torch.int32)


@torch.no_grad()
def greedy_decode(model: Transducer, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                  max_symbols: int = 200, mm_dtype=None, blank: int = 0,
                  steps_per_check: int = STEPS_PER_CHECK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode a batch of encoder outputs (B, T, H): one CUDA graph of the
    loop's body on the card, the same body eagerly on the CPU.

    ``mm_dtype`` is the matmul dtype of the loop (``utils.dtypes``:
    ``"auto"`` is bf16 on the card); the argmax is taken over float32
    logits.  Returns (hyps (B, max_symbols) int32 padded with -1, hyp_lens
    (B,) int32).
    """
    return _greedy(model, enc_out, enc_lens, max_symbols, mm_dtype, blank, steps_per_check,
                   graphed=enc_out.is_cuda)


@torch.no_grad()
def greedy_decode_eager(model: Transducer, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                        max_symbols: int = 200, mm_dtype=None, blank: int = 0,
                        steps_per_check: int = STEPS_PER_CHECK):
    """``greedy_decode`` with the body run eagerly on any device: the
    reference the card's checks hold the graph to."""
    return _greedy(model, enc_out, enc_lens, max_symbols, mm_dtype, blank, steps_per_check,
                   graphed=False)


@torch.no_grad()
def greedy_decode_waveforms(model: Transducer, featurizer, wavs, wav_lens,
                            max_symbols: int = 200, mm_dtype=None, blank: int = 0):
    """Waveforms -> features -> encoder -> greedy decode."""
    feats, feat_lens = featurizer(wavs, wav_lens)
    enc = model.encode(feats, feat_lens)
    return greedy_decode(model, enc, model.encoder_out_len(feat_lens), max_symbols, mm_dtype,
                         blank)
