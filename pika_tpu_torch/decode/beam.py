"""Batched RNN-T beam search (port of ``pika_tpu/decode/beam.py``, LSTM
prediction net, without FST fusion).

The JAX search is one ``lax.while_loop`` over fixed-shape (B, K) arrays;
here it is a ``decode.loop.DecodeLoop`` over (B, K) tensors with the same
update order as the JAX ``body``: one CUDA graph of the body on the card,
the same body eagerly on the CPU.

* per-beam time pointers advance on blank;
* the prediction net advances only for non-blank beams;
* duplicate partial hypotheses are pruned: rolling hashes (uint32
  arithmetic, carried in int64 and masked to 32 bits) as a prefilter, then
  equal token buffers;
* finished hypotheses (blank at the last frame) move into a top-N finished
  store and never occupy live beam slots; live beams backfill it at the end;
* softmax temperature ``sm_scale``.

Every top-k (the K-of-(K*V) selection and the finished-store merges) is a
stable descending sort: ``jax.lax.top_k`` puts the lower index first among
equal values, and ties are common (every dead beam sits at NEG, where
NEG + lp == NEG in float32).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pika_tpu_torch.decode.loop import STEPS_PER_CHECK, DecodeLoop, cached_loop
from pika_tpu_torch.models.transducer import Transducer
from pika_tpu_torch.utils.dtypes import resolve_mm_dtype

NEG = -1.0e20
HASH_MULT = 1000003
HASH_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    """Every field of ``pika_tpu.decode.beam.BeamConfig``.  The FST fusion
    fields (``lm_scale``, ``nonblk_reward``, ``max_fst_states``,
    ``fst_backoff_levels``, ``lm_per_token``, ``lm_topm``) act only with
    FST tables, which the port does not take yet: ``beam_search`` raises on
    a non-default ``lm_scale``, ``nonblk_reward`` or ``lm_per_token``.
    ``mm_dtype`` is the loop's matmul dtype (``utils.dtypes``; None is
    float32); scores, ``log_softmax`` and the bookkeeping stay float32."""

    beam_size: int = 8
    n_best: int = 1
    blank: int = 0
    sm_scale: float = 1.0
    max_symbols: int = 200
    prune_dups: bool = True
    lm_scale: float = 0.0
    nonblk_reward: float = 0.0
    max_fst_states: int = 4
    fst_backoff_levels: int = 6
    lm_per_token: bool = False
    lm_topm: int = 8
    mm_dtype: Optional[str] = None


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values, sorted,
    the lower index first among equal values."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _dup_mask(hashes, lens, tokens):
    """True where a beam duplicates an earlier (higher-ranked) beam's
    emitted prefix: equal hash and length as a prefilter, then equal token
    buffers, so a hash collision never merges two distinct hypotheses.
    Unwritten token positions are -1 and lengths must be equal, so
    full-buffer equality is exactly prefix equality; empty prefixes never
    merge."""
    k = hashes.shape[1]
    same = ((hashes[:, None, :] == hashes[:, :, None]) & (lens[:, None, :] == lens[:, :, None])
            & (lens[:, :, None] > 0))
    same &= (tokens[:, None, :, :] == tokens[:, :, None, :]).all(dim=-1)
    ar = torch.arange(k, device=hashes.device)
    earlier = ar[None, :] < ar[:, None]
    return (same & earlier[None]).any(dim=2)


def _gather_beams(x, idx):
    """Gather along the beam axis: x (B, K, ...) by idx (B, K')."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return x.gather(1, idx)


class BeamLoop(DecodeLoop):
    def __init__(self, net: Transducer, cfg: BeamConfig, b: int, t_max: int,
                 device: torch.device):
        super().__init__()
        mcfg = net.config
        dtype = net.fc2.weight.dtype
        self.net, self.cfg = net, cfg
        k, n, um, h = cfg.beam_size, cfg.n_best, cfg.max_symbols, mcfg.hid_dim
        self.max_steps = t_max + um
        self.max_bodies = self.max_steps + 1  # the last one sees the loop's end
        floats = dict(device=device, dtype=dtype)
        longs = dict(device=device, dtype=torch.long)
        self.align_pos = torch.arange(self.max_steps, device=device)
        self.token_pos = torch.arange(um, device=device)
        self.non_blank = torch.arange(mcfg.vocab_size, device=device) != cfg.blank
        self.inputs = {"ax_all": torch.zeros(b, t_max, h, **floats),
                       "gx_all": torch.zeros(b, t_max, h, **floats),
                       "enc_lens": torch.zeros(b, **longs)}
        layers = mcfg.dec_layers
        self.state = {
            "running": torch.zeros((), dtype=torch.bool, device=device),
            "step": torch.zeros((), **longs),
            "scores": torch.zeros(b, k, device=device),
            "t_idx": torch.zeros(b, k, **longs),
            "tokens": torch.zeros(b, k, um, **longs),
            "lens": torch.zeros(b, k, **longs),
            "aligns": torch.zeros(b, k, self.max_steps, **longs),
            "align_lens": torch.zeros(b, k, **longs),
            "hashes": torch.zeros(b, k, **longs),
            "dec_ay": torch.zeros(b, k, h, **floats),
            "dec_gy": torch.zeros(b, k, h, **floats),
            "dec_h": torch.zeros(layers, b, k, h, **floats),
            "dec_c": torch.zeros(layers, b, k, h, **floats),
            "fin_scores": torch.zeros(b, n, device=device),
            "fin_tokens": torch.zeros(b, n, um, **longs),
            "fin_lens": torch.zeros(b, n, **longs),
            "fin_aligns": torch.zeros(b, n, self.max_steps, **longs),
            "fin_align_lens": torch.zeros(b, n, **longs),
        }

    def reset(self, enc_out, enc_lens) -> None:
        net, st, cfg = self.net, self.state, self.cfg
        layers, b, k, h = st["dec_h"].shape
        # encoder-side joint factors, hoisted out of the loop
        ax_all, gx_all = net.joint_enc_factors(enc_out.to(net.fc2.weight.dtype))
        self.inputs["ax_all"].copy_(ax_all)
        self.inputs["gx_all"].copy_(gx_all)
        self.inputs["enc_lens"].copy_(enc_lens)
        # every beam consumed SOS (= blank); beam 0 live, the others NEG
        zeros = torch.zeros(layers, b * k, h, device=enc_out.device, dtype=st["dec_h"].dtype)
        dec_hid, (h0, c0) = net.predict_step(
            torch.full((b * k,), cfg.blank, device=enc_out.device), (zeros, zeros))
        ay, gy = net.joint_dec_factors(dec_hid)
        st["dec_ay"].copy_(ay.reshape(b, k, h))
        st["dec_gy"].copy_(gy.reshape(b, k, h))
        st["dec_h"].copy_(h0.reshape(layers, b, k, h))
        st["dec_c"].copy_(c0.reshape(layers, b, k, h))
        st["running"].fill_(True)
        st["scores"].fill_(NEG)
        st["scores"][:, 0] = 0.0
        st["fin_scores"].fill_(NEG)
        for name in ("tokens", "aligns", "fin_tokens", "fin_aligns"):
            st[name].fill_(-1)
        for name in ("step", "t_idx", "lens", "align_lens", "hashes", "fin_lens",
                     "fin_align_lens"):
            st[name].zero_()

    def body(self) -> None:
        st, net, cfg = self.state, self.net, self.cfg
        ax_all, gx_all, enc_lens = (self.inputs[x] for x in ("ax_all", "gx_all", "enc_lens"))
        layers, b, k, h = st["dec_h"].shape
        t_max = ax_all.shape[1]
        n, um, blank = cfg.n_best, cfg.max_symbols, cfg.blank
        vocab = net.config.vocab_size

        # cond: some live beam still beats the worst kept finished one
        undecided = st["scores"].max(dim=1).values > st["fin_scores"][:, n - 1]
        st["running"].logical_and_((st["step"] < self.max_steps) & undecided.any())

        # --- duplicate-prefix pruning (beam order is score-descending) ---
        scores = st["scores"]
        if cfg.prune_dups:
            scores = torch.where(_dup_mask(st["hashes"], st["lens"], st["tokens"]), NEG, scores)

        # --- joint over the current (enc frame, dec state) ---------------
        t_gather = st["t_idx"].clamp(0, t_max - 1)[..., None].expand(-1, -1, h)
        logits = net.joint_from_factors(
            ax_all.gather(1, t_gather).reshape(b * k, h),
            gx_all.gather(1, t_gather).reshape(b * k, h),
            st["dec_ay"].reshape(b * k, h), st["dec_gy"].reshape(b * k, h))
        lp = torch.log_softmax(cfg.sm_scale * logits.float(), dim=-1).reshape(b, k, vocab)
        cand = scores[..., None] + lp

        # full beams may only take blank
        full = st["lens"] >= um
        cand = torch.where(full[..., None] & self.non_blank, NEG, cand)

        # --- finished extraction: blank at the last frame ----------------
        at_last = st["t_idx"] >= (enc_lens[:, None] - 1)
        finish_now = at_last & (scores > NEG / 2)
        fin_cand = torch.where(finish_now, scores + lp[..., blank], NEG)
        top_fin, fin_idx = top_k(torch.cat([st["fin_scores"], fin_cand], dim=1), n)

        def merged(fin, live):
            return _gather_beams(torch.cat([st[fin], st[live]], dim=1), fin_idx)

        # finished beams cannot continue via blank past the last frame
        cand = torch.where(at_last[..., None] & ~self.non_blank, NEG, cand)

        # --- top-k continuation ------------------------------------------
        top_val, top_idx = top_k(cand.reshape(b, k * vocab), k)
        prev_k = top_idx // vocab
        tok = top_idx % vocab
        tokens, lens, aligns, align_lens, hashes, t_idx, dec_ay, dec_gy = (
            _gather_beams(st[x], prev_k) for x in ("tokens", "lens", "aligns", "align_lens",
                                                   "hashes", "t_idx", "dec_ay", "dec_gy"))
        beam_idx = prev_k[None, :, :, None].expand(layers, -1, -1, h)
        dec_h, dec_c = st["dec_h"].gather(2, beam_idx), st["dec_c"].gather(2, beam_idx)

        emit = tok != blank
        # record the alignment step (blank or not)
        apos = align_lens.clamp(0, self.max_steps - 1)
        aligns = torch.where(self.align_pos == apos[..., None], tok[..., None], aligns)
        # append emitted tokens
        pos = lens.clamp(0, um - 1)
        tokens = torch.where(emit[..., None] & (self.token_pos == pos[..., None]),
                             tok[..., None], tokens)
        hashes = torch.where(emit, (hashes * HASH_MULT + tok + 1) & HASH_MASK, hashes)

        # prediction-net advance for emitting beams only
        new_hid, (nh, nc) = net.predict_step(
            tok.reshape(b * k), (dec_h.reshape(layers, b * k, h), dec_c.reshape(layers, b * k, h)))
        new_ay, new_gy = net.joint_dec_factors(new_hid)
        keep = emit[..., None]
        self.commit({
            "step": st["step"] + 1,
            "scores": top_val,
            "t_idx": torch.where(emit, t_idx, t_idx + 1),
            "tokens": tokens,
            "lens": lens + emit.long(),
            "aligns": aligns,
            "align_lens": align_lens + 1,
            "hashes": hashes,
            "dec_ay": torch.where(keep, new_ay.reshape(b, k, h), dec_ay),
            "dec_gy": torch.where(keep, new_gy.reshape(b, k, h), dec_gy),
            "dec_h": torch.where(keep[None], nh.reshape(layers, b, k, h), dec_h),
            "dec_c": torch.where(keep[None], nc.reshape(layers, b, k, h), dec_c),
            "fin_scores": top_fin,
            "fin_tokens": merged("fin_tokens", "tokens"),
            "fin_lens": merged("fin_lens", "lens"),
            "fin_aligns": merged("fin_aligns", "aligns"),
            "fin_align_lens": merged("fin_align_lens", "align_lens"),
        })

    def result(self) -> dict:
        """The N-best: finished hypotheses and live beams (force-finished)
        ranked together, as the JAX search's backfill."""
        st = self.state
        top, idx = top_k(torch.cat([st["fin_scores"], st["scores"]], dim=1), self.cfg.n_best)
        out = {name: _gather_beams(torch.cat([st["fin_" + name], st[name]], dim=1), idx)
               .to(torch.int32) for name in ("tokens", "lens", "aligns", "align_lens")}
        out["scores"] = top
        out["steps"] = st["step"].clone()
        return out


def _check_config(cfg: BeamConfig, fst_tables) -> None:
    if fst_tables is not None or cfg.lm_scale > 0 or cfg.nonblk_reward != 0 or cfg.lm_per_token:
        raise NotImplementedError(
            "FST shallow fusion (fst_tables, lm_scale > 0, nonblk_reward, lm_per_token) is "
            "not ported yet: ROADMAP Queue 1 item 4")


def _search(model, enc_out, enc_lens, cfg, steps_per_check, graphed):
    b, t_max, _ = enc_out.shape
    dev = enc_out.device
    dtype = resolve_mm_dtype(cfg.mm_dtype, dev)
    loop = cached_loop(model, ("beam", str(dev), b, t_max, cfg), dtype,
                       lambda net: BeamLoop(net, cfg, b, t_max, dev))
    loop.run(graphed, steps_per_check, enc_out, enc_lens)
    return loop.result()


@torch.no_grad()
def beam_search(model: Transducer, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                cfg: BeamConfig, fst_tables: Optional[dict] = None, fst_start: int = 0,
                steps_per_check: int = STEPS_PER_CHECK) -> dict:
    """Decode a batch of encoder outputs (B, T, H): one CUDA graph of the
    loop's body on the card (captured once per shape and config), the same
    body eagerly on the CPU.

    Returns dict(tokens (B, N, Um), lens (B, N), scores (B, N), aligns
    (B, N, T+Um), align_lens (B, N), steps) sorted best-first; padding token
    is -1.  ``aligns`` is the full emission sequence including blanks;
    ``steps`` is the number of loop steps the search took.  FST fusion
    (``fst_tables``) raises until it is ported.
    """
    _check_config(cfg, fst_tables)
    return _search(model, enc_out, enc_lens, cfg, steps_per_check, graphed=enc_out.is_cuda)


@torch.no_grad()
def beam_search_eager(model: Transducer, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                      cfg: BeamConfig, steps_per_check: int = STEPS_PER_CHECK) -> dict:
    """``beam_search`` with the body run eagerly on any device: the
    reference the card's checks hold the graph to."""
    _check_config(cfg, None)
    return _search(model, enc_out, enc_lens, cfg, steps_per_check, graphed=False)


@torch.no_grad()
def beam_search_features(model: Transducer, feats, feat_lens, cfg: BeamConfig,
                         fst_tables=None, fst_start: int = 0) -> dict:
    """Spliced, strided features -> encoder -> beam search; the result also
    holds ``enc_out``, ``enc_lens``, ``feats`` and ``feat_lens``."""
    enc = model.encode(feats, feat_lens)
    enc_lens = model.encoder_out_len(feat_lens)
    out = beam_search(model, enc, enc_lens, cfg, fst_tables, fst_start)
    out.update(enc_out=enc, enc_lens=enc_lens, feats=feats, feat_lens=feat_lens)
    return out


@torch.no_grad()
def beam_search_waveforms(model: Transducer, featurizer, wavs, wav_lens, cfg: BeamConfig,
                          fst_tables=None, fst_start: int = 0) -> dict:
    """Waveforms -> features -> encoder (float32) -> beam search, on the
    device of the model and the featurizer (the card unless they were built
    for the CPU)."""
    feats, feat_lens = featurizer(wavs, wav_lens)
    return beam_search_features(model, feats, feat_lens, cfg, fst_tables, fst_start)
