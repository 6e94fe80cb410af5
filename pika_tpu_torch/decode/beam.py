"""Batched RNN-T beam search with n-gram FST shallow fusion (port of
``pika_tpu/decode/beam.py``).

The JAX search is one ``lax.while_loop`` over fixed-shape (B, K) arrays;
here it is a ``decode.loop.DecodeLoop`` over (B, K) tensors with the same
update order as the JAX ``body``: one CUDA graph of the body on the card,
the same body eagerly on the CPU.

* per-beam time pointers advance on blank;
* the prediction net advances (``Transducer.advance``, over the B*K beams
  as rows) from the selected beams' gathered state and token buffers, and
  only the non-blank beams take its output and new state;
* duplicate partial hypotheses are pruned: rolling hashes (uint32
  arithmetic, carried in int64 and masked to 32 bits) as a prefilter, then
  equal token buffers;
* optional FST shallow fusion (``decode/fst.py``): each beam carries a
  fixed-capacity set of LM states with min-cost tracking; the LM biases
  selection per beam (``lm_per_token=False``, the reference's semantics)
  or scores each candidate token with its advanced LM score (per-token:
  top-m candidates, or every token through the dense advance cache at
  ``lm_topm=0``); finished scores add the FST final weights;
* finished hypotheses (blank at the last frame) move into a top-N finished
  store and never occupy live beam slots; live beams backfill it at the end;
* softmax temperature ``sm_scale``.

The plain beam (no FST tables) on a CUDA tensor runs its bookkeeping as
``decode/beam_kernels.py``'s four launches a step, graphed or eager; the
torch body (``BeamLoop.torch_body``) is their plain version, which the CPU
and the FST-fusion searches run.  ``BODIES`` counts the bodies run by route.

Every top-k (the K-of-(K*V) and K-of-(K*(m+1)) selections, the FST state
sets' and the finished-store merges) is a stable descending sort:
``jax.lax.top_k`` puts the lower index first among equal values, and ties
are common (every dead beam sits at NEG, where NEG + lp == NEG in float32).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pika_tpu_torch.decode import beam_kernels
from pika_tpu_torch.decode.fst import (
    INF,
    fst_advance_min_costs,
    fst_advance_min_costs_all,
    fst_advance_sets,
    fst_final_scores,
)
from pika_tpu_torch.decode.loop import STEPS_PER_CHECK, DecodeLoop, cached_loop
from pika_tpu_torch.decode.topk import top_k
from pika_tpu_torch.models.transducer import Transducer
from pika_tpu_torch.utils.dtypes import resolve_mm_dtype

NEG = -1.0e20
HASH_MULT = 1000003
HASH_MASK = 0xFFFFFFFF

# bodies run in Python by route: "kernels" (the plain beam on the card),
# "plain" (the torch body without an LM), "fst" (the torch body with one); a
# graphed search runs its body at warm-up and capture, then replays it
BODIES = {"kernels": 0, "plain": 0, "fst": 0}


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    """Every field of ``pika_tpu.decode.beam.BeamConfig``.  The FST fusion
    fields act with FST tables (``beam_search(fst_tables=...)``):
    ``lm_scale`` weighs the LM, ``nonblk_reward`` is added to the LM score
    of every emission, ``max_fst_states`` is a beam's state-set capacity,
    ``fst_backoff_levels`` bounds the backoff walks; ``lm_per_token=False``
    is the reference's per-beam selection bias, True scores each candidate
    token with its advanced LM score: the top ``lm_topm`` non-blank tokens
    of each beam, or every token when ``lm_topm=0`` (needs the tables'
    dense advance cache).  ``mm_dtype`` is the loop's matmul dtype
    (``utils.dtypes``; None is float32); scores, ``log_softmax`` and the
    bookkeeping stay float32."""

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


def _gather_beams(x, idx, dim=1):
    """Gather along the beam axis ``dim``: x (..., B, K, ...) by idx (B, K')."""
    lead, rest = x.shape[:dim - 1], x.shape[dim + 1:]
    full = idx.reshape((1,) * len(lead) + idx.shape + (1,) * len(rest))
    return x.gather(dim, full.expand(lead + idx.shape + rest))


def _min0(x: torch.Tensor) -> torch.Tensor:
    """min(min(x), 0) as a 0-d float32 tensor, 0 for an empty x."""
    if x.numel() == 0:
        return torch.zeros((), device=x.device)
    return torch.clamp(x.min(), max=0.0)


class BeamLoop(DecodeLoop):
    def __init__(self, net: Transducer, cfg: BeamConfig, b: int, t_max: int,
                 device: torch.device, fst_tables: Optional[dict] = None, fst_start: int = 0,
                 plain: bool = False):
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
            "fin_scores": torch.zeros(b, n, device=device),
            "fin_tokens": torch.zeros(b, n, um, **longs),
            "fin_lens": torch.zeros(b, n, **longs),
            "fin_aligns": torch.zeros(b, n, self.max_steps, **longs),
            "fin_align_lens": torch.zeros(b, n, **longs),
        }
        dec = net.dec_state((b, k), device, dtype)
        self.dec_names = tuple(dec)
        self.state.update(dec)
        # FST fusion: the tables are inputs the graph reads in place
        self.fst, self.fst_start = fst_tables, fst_start
        self.use_lm = fst_tables is not None
        self.per_token = self.use_lm and cfg.lm_per_token
        self.has_cache = self.use_lm and "adv_cost" in fst_tables
        if self.per_token and cfg.lm_topm <= 0 and not self.has_cache:
            raise ValueError(
                "lm_topm=0 (exact per-token fusion) needs the dense advance cache: build "
                "fst_tables with device_arrays(n_ilabels=..., cache_max_bytes>0) or set "
                "lm_topm > 0")
        if self.use_lm:
            s_cap = cfg.max_fst_states
            self.state["lm_scores"] = torch.zeros(b, k, device=device)
            self.state["fst_states"] = torch.zeros(b, k, s_cap, **longs)
            self.state["fst_costs"] = torch.zeros(b, k, s_cap, device=device)
        if self.use_lm and cfg.lm_scale > 0:
            self.gain_per_emit, self.final_gain = self._stop_bound_gains()
        self.route = ("fst" if self.use_lm else
                      "kernels" if torch.device(device).type == "cuda" and not plain else "plain")
        self.kernels = None
        if self.route == "kernels":
            self.kernels = beam_kernels.BeamStep(self.state, self.inputs, mcfg.vocab_size,
                                                 cfg.blank, cfg.sm_scale, cfg.prune_dups)

    def _stop_bound_gains(self):
        """The admissible stop bound's two terms, as float32 device scalars
        made once per table set, outside the loop body.  A live beam's
        eventual finished total can exceed its model-only score wherever an
        emission can lower the LM cost (``nonblk_reward > 0``, or negative
        arc, backoff or final weights): each remaining emission slot is
        credited with the largest possible gain per emission, and the end
        with the largest possible final-weight gain.  With non-negative
        weights and no reward both are 0."""
        fst, cfg = self.fst, self.cfg
        dw, fw = fst["disambig_weight"], fst["final_weight"]
        min_bw = _min0(fst["backoff_weight"])
        gain_per_emit = cfg.nonblk_reward - (
            _min0(fst["arc_weight"]) + cfg.fst_backoff_levels * min_bw
            + _min0(torch.where(dw < 1e29, dw, 0.0)))
        final_gain = torch.clamp(
            -(_min0(torch.where(fw < 1e29, fw, 0.0)) + cfg.fst_backoff_levels * min_bw), min=0.0)
        return gain_per_emit, final_gain

    def reset(self, enc_out, enc_lens) -> None:
        net, st, cfg = self.net, self.state, self.cfg
        b, k, h = st["dec_ay"].shape
        dev = enc_out.device
        # encoder-side joint factors, hoisted out of the loop
        ax_all, gx_all = net.joint_enc_factors(enc_out.to(net.fc2.weight.dtype))
        self.inputs["ax_all"].copy_(ax_all)
        self.inputs["gx_all"].copy_(gx_all)
        self.inputs["enc_lens"].copy_(enc_lens)
        st["running"].fill_(True)
        st["scores"].fill_(NEG)
        st["scores"][:, 0] = 0.0
        st["fin_scores"].fill_(NEG)
        for name in ("tokens", "aligns", "fin_tokens", "fin_aligns"):
            st[name].fill_(-1)
        for name in ("step", "t_idx", "lens", "align_lens", "hashes", "fin_lens",
                     "fin_align_lens", *self.dec_names):
            st[name].zero_()
        # every beam consumed SOS (= blank) from the zero state; beam 0 live, the others NEG
        dec_hid, dec = net.advance(torch.full((b * k,), cfg.blank, device=dev), self._net_rows(),
                                   st["tokens"].view(b * k, -1), st["lens"].view(b * k))
        for name, x in dec.items():
            st[name].copy_(x.reshape(st[name].shape))
        ay, gy = net.joint_dec_factors(dec_hid)
        st["dec_ay"].copy_(ay.reshape(b, k, h))
        st["dec_gy"].copy_(gy.reshape(b, k, h))
        if self.use_lm:  # every beam's state set is {start: 0}
            st["lm_scores"].zero_()
            st["fst_states"].fill_(-1)
            st["fst_states"][..., 0] = self.fst_start
            st["fst_costs"].fill_(float(INF))
            st["fst_costs"][..., 0] = 0.0
        if self.kernels is not None:
            self.kernels.reset()

    def _net_rows(self) -> dict:
        """The net's state with the beams as rows, (L, B*K, ...): views of
        the loop's."""
        return {name: self.state[name].flatten(1, 2) for name in self.dec_names}

    def body(self) -> None:
        BODIES[self.route] += 1
        if self.kernels is not None:
            self.kernel_body()
        else:
            self.torch_body()

    def kernel_body(self) -> None:
        """The plain beam's step on the card: the net's calls between the
        bookkeeping kernels (``decode/beam_kernels.py``), which update the
        state in place under ``running``; ``torch_body`` without an LM is
        their plain version."""
        st, net, ks = self.state, self.net, self.kernels
        b, k, h = st["dec_ay"].shape

        def rows(x):
            return x.view(b * k, h)

        logits = net.joint_from_factors(rows(ks.scratch["ax_sel"]), rows(ks.scratch["gx_sel"]),
                                        rows(st["dec_ay"]), rows(st["dec_gy"]))
        beam_kernels.select(ks, logits)
        beam_kernels.update(ks)  # the state now holds the picked beams' buffers
        new_hid, new_dec = net.advance(ks.scratch["tok"].view(b * k), self._net_rows(),
                                       st["tokens"].view(b * k, -1), st["lens"].view(b * k))
        new_ay, new_gy = net.joint_dec_factors(new_hid)
        beam_kernels.commit(ks, new_ay, new_gy, new_dec)

    def torch_body(self) -> None:
        st, net, cfg, fst = self.state, self.net, self.cfg, self.fst
        ax_all, gx_all, enc_lens = (self.inputs[x] for x in ("ax_all", "gx_all", "enc_lens"))
        b, k, h = st["dec_ay"].shape
        t_max = ax_all.shape[1]
        n, um, blank = cfg.n_best, cfg.max_symbols, cfg.blank
        vocab = net.config.vocab_size
        use_lm, per_token, has_cache = self.use_lm, self.per_token, self.has_cache
        use_bias = use_lm and not cfg.lm_per_token
        reward, levels, lm_scale = cfg.nonblk_reward, cfg.fst_backoff_levels, cfg.lm_scale

        # cond: some live beam still beats the worst kept finished one (with
        # the LM, under the admissible bound on its future LM gain)
        if use_lm and lm_scale > 0:
            slack = self.gain_per_emit * (um - st["lens"]).clamp(min=0)
            live_best = (st["scores"] + lm_scale * (st["lm_scores"] + slack + self.final_gain)
                         ).amax(dim=1)
        else:
            live_best = st["scores"].amax(dim=1)
        undecided = live_best > st["fin_scores"][:, n - 1]
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
        if use_bias:
            # a beam whose LM state set died (only with no-backoff FSTs) can
            # never finish: kill it here, or lm_scale * NEG rides through the
            # bias and the float32 subtract-back cancels it to exactly 0
            scores = torch.where(st["lm_scores"] <= NEG / 2, NEG, scores)
            cand = scores[..., None] + lp + (lm_scale * st["lm_scores"])[..., None]
        else:
            cand = scores[..., None] + lp

        # full beams may only take blank
        full = st["lens"] >= um
        cand = torch.where(full[..., None] & self.non_blank, NEG, cand)

        # --- finished extraction: blank at the last frame ----------------
        at_last = st["t_idx"] >= (enc_lens[:, None] - 1)
        fin_cand = scores + lp[..., blank]
        if use_lm:
            fin_lm = fst_final_scores(fst, st["fst_states"], st["fst_costs"], levels)
            fin_cand = fin_cand + lm_scale * fin_lm
        fin_cand = torch.where(at_last & (scores > NEG / 2), fin_cand, NEG)
        top_fin, fin_idx = top_k(torch.cat([st["fin_scores"], fin_cand], dim=1), n)

        def merged(fin, live):
            return _gather_beams(torch.cat([st[fin], st[live]], dim=1), fin_idx)

        # finished beams cannot continue via blank past the last frame
        cand = torch.where(at_last[..., None] & ~self.non_blank, NEG, cand)

        # --- top-k continuation ------------------------------------------
        if per_token and cfg.lm_topm <= 0:
            # exact per-token fusion: every (beam, token) candidate scored
            # with its advanced LM score (token v emits FST ilabel v + 1;
            # tokens past the table are dead); the blank candidate carries
            # the prefix LM score through; the winners' sets advance below
            lm_tok = fst_advance_min_costs_all(fst, st["fst_states"], st["fst_costs"], reward)
            vt = lm_tok.shape[-1]
            if vt < vocab + 1:
                lm_tok = torch.cat([lm_tok, lm_tok.new_full(lm_tok.shape[:-1] + (vocab + 1 - vt,),
                                                            -float(INF))], -1)
            lm_grid = lm_tok[..., 1:vocab + 1].clamp(min=NEG)
            lm_grid = torch.where(self.non_blank, lm_grid, st["lm_scores"][..., None])
            _, top_idx = top_k((cand + lm_scale * lm_grid).reshape(b, k * vocab), k)
            prev_k, tok = top_idx // vocab, top_idx % vocab
            new_scores = cand.reshape(b, k * vocab).gather(1, top_idx)
            sel_lm = lm_grid.reshape(b, k * vocab).gather(1, top_idx)
        elif per_token:
            # blank and the top-m non-blank candidates of each beam, each
            # scored with its advanced LM score
            m = min(cfg.lm_topm, vocab - 1)
            nb_val, nb_tok = top_k(torch.where(self.non_blank, cand, NEG), m)
            s_cap = cfg.max_fst_states
            bs = st["fst_states"][:, :, None].expand(b, k, m, s_cap)
            bc = st["fst_costs"][:, :, None].expand(b, k, m, s_cap)
            if has_cache:
                # selection needs only each candidate's best advanced cost;
                # the k winners' sets advance after selection
                adv_lm = fst_advance_min_costs(fst, bs, bc, nb_tok + 1, reward)
            else:
                adv_states, adv_costs, adv_lm = fst_advance_sets(fst, bs, bc, nb_tok + 1, levels,
                                                                 reward)
            adv_lm = adv_lm.clamp(min=NEG)
            mc = m + 1  # candidate 0 is blank: the prefix LM set unchanged
            vals = torch.cat([cand[..., blank][..., None], nb_val], -1)
            lm_all = torch.cat([st["lm_scores"][..., None], adv_lm], -1)
            toks = torch.cat([torch.full_like(nb_tok[..., :1], blank), nb_tok], -1)
            _, top_idx = top_k((vals + lm_scale * lm_all).reshape(b, k * mc), k)
            prev_k = top_idx // mc
            tok = toks.reshape(b, k * mc).gather(1, top_idx)
            new_scores = vals.reshape(b, k * mc).gather(1, top_idx)
            sel_lm = lm_all.reshape(b, k * mc).gather(1, top_idx)
            if not has_cache:
                idx = top_idx[..., None].expand(b, k, s_cap)
                sel_states = torch.cat([st["fst_states"][:, :, None], adv_states], 2).reshape(
                    b, k * mc, s_cap).gather(1, idx)
                sel_costs = torch.cat([st["fst_costs"][:, :, None], adv_costs], 2).reshape(
                    b, k * mc, s_cap).gather(1, idx)
        else:
            new_scores, top_idx = top_k(cand.reshape(b, k * vocab), k)
            prev_k, tok = top_idx // vocab, top_idx % vocab
        if per_token:
            # a candidate whose LM state set died cannot continue in-grammar
            # or ever finish: kill it instead of decoding on LM-free
            new_scores = torch.where(sel_lm <= NEG / 2, NEG, new_scores)
        tokens, lens, aligns, align_lens, hashes, t_idx, dec_ay, dec_gy = (
            _gather_beams(st[x], prev_k) for x in ("tokens", "lens", "aligns", "align_lens",
                                                   "hashes", "t_idx", "dec_ay", "dec_gy"))

        emit = tok != blank
        # record the alignment step (blank or not)
        apos = align_lens.clamp(0, self.max_steps - 1)
        aligns = torch.where(self.align_pos == apos[..., None], tok[..., None], aligns)
        # append emitted tokens
        pos = lens.clamp(0, um - 1)
        tokens = torch.where(emit[..., None] & (self.token_pos == pos[..., None]),
                             tok[..., None], tokens)
        hashes = torch.where(emit, (hashes * HASH_MULT + tok + 1) & HASH_MASK, hashes)

        lens = lens + emit.long()
        keep = emit[..., None]
        new = {}
        # prediction-net advance for emitting beams only
        dec = {name: _gather_beams(st[name], prev_k, dim=2) for name in self.dec_names}
        new_hid, new_dec = net.advance(tok.reshape(b * k),
                                       {name: x.flatten(1, 2) for name, x in dec.items()},
                                       tokens.reshape(b * k, um), lens.reshape(b * k))
        for name, x in new_dec.items():
            old = dec[name]
            new[name] = torch.where(emit.view((1, b, k) + (1,) * (old.dim() - 3)),
                                    x.reshape(old.shape), old)
        new_ay, new_gy = net.joint_dec_factors(new_hid)
        new.update({
            "step": st["step"] + 1,
            "scores": new_scores,
            "t_idx": torch.where(emit, t_idx, t_idx + 1),
            "tokens": tokens,
            "lens": lens,
            "aligns": aligns,
            "align_lens": align_lens + 1,
            "hashes": hashes,
            "dec_ay": torch.where(keep, new_ay.reshape(b, k, h), dec_ay),
            "dec_gy": torch.where(keep, new_gy.reshape(b, k, h), dec_gy),
            "fin_scores": top_fin,
            "fin_tokens": merged("fin_tokens", "tokens"),
            "fin_lens": merged("fin_lens", "lens"),
            "fin_aligns": merged("fin_aligns", "aligns"),
            "fin_align_lens": merged("fin_align_lens", "align_lens"),
        })
        if use_lm:
            lm_prev = _gather_beams(st["lm_scores"], prev_k)
            if use_bias:
                new["scores"] = new_scores - lm_scale * lm_prev
            if per_token and not has_cache:
                # the walk advanced the candidates' sets before selection;
                # candidate 0 (blank) carried the prefix set through
                new.update(fst_states=sel_states, fst_costs=sel_costs, lm_scores=sel_lm)
            else:
                # per-beam, and per-token with the cache: the k winners' sets
                # advance now, when the reference advances them (per-token,
                # the lm equals the selection's sel_lm bit for bit)
                fst_states = _gather_beams(st["fst_states"], prev_k)
                fst_costs = _gather_beams(st["fst_costs"], prev_k)
                adv_states, adv_costs, adv_lm = fst_advance_sets(fst, fst_states, fst_costs,
                                                                 tok + 1, levels, reward)
                new.update(fst_states=torch.where(keep, adv_states, fst_states),
                           fst_costs=torch.where(keep, adv_costs, fst_costs),
                           lm_scores=torch.where(emit, adv_lm.clamp(min=NEG), lm_prev))
        self.commit(new)

    def result(self) -> dict:
        """The N-best: finished hypotheses and live beams (force-finished,
        with their FST final scores) ranked together, as the JAX search's
        backfill."""
        st, cfg = self.state, self.cfg
        live = st["scores"]
        if self.use_lm:
            fin_lm = fst_final_scores(self.fst, st["fst_states"], st["fst_costs"],
                                      cfg.fst_backoff_levels)
            live = live + cfg.lm_scale * fin_lm.clamp(min=NEG)
        top, idx = top_k(torch.cat([st["fin_scores"], live], dim=1), cfg.n_best)
        out = {name: _gather_beams(torch.cat([st["fin_" + name], st[name]], dim=1), idx)
               .to(torch.int32) for name in ("tokens", "lens", "aligns", "align_lens")}
        out["scores"] = top
        out["steps"] = st["step"].clone()
        return out


def _search(model, enc_out, enc_lens, cfg, fst_tables, fst_start, steps_per_check, graphed,
            plain):
    b, t_max, _ = enc_out.shape
    dev = enc_out.device
    dtype = resolve_mm_dtype(cfg.mm_dtype, dev)
    fst_key = None
    if fst_tables is not None:
        fst_key = getattr(fst_tables, "key", None)
        if fst_key is None:
            raise TypeError("fst_tables must come from FstTables.device_arrays (its key names "
                            "the LM a captured decode graph reads)")
        if fst_tables["arc_start"].device != dev:
            raise ValueError(f"fst_tables are on {fst_tables['arc_start'].device}, the encoder "
                             f"output on {dev}")
    key = ("beam", str(dev), b, t_max, cfg, fst_key, fst_start if fst_key else None, plain)
    loop = cached_loop(model, key, dtype,
                       lambda net: BeamLoop(net, cfg, b, t_max, dev, fst_tables, fst_start, plain))
    loop.run(graphed, steps_per_check, enc_out, enc_lens)
    return loop.result()


@torch.no_grad()
def beam_search(model: Transducer, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                cfg: BeamConfig, fst_tables: Optional[dict] = None, fst_start: int = 0,
                steps_per_check: int = STEPS_PER_CHECK, _plain: bool = False) -> dict:
    """Decode a batch of encoder outputs (B, T, H): one CUDA graph of the
    loop's body on the card (captured once per shape, config and LM), the
    same body eagerly on the CPU.  Without an LM the card's body runs the
    bookkeeping kernels (``_plain=True``, for the card's tests only, runs
    the torch body there).

    ``fst_tables`` (``FstTables.device_arrays`` on the encoder output's
    device) and ``fst_start`` (``FstTables.start``) turn on FST shallow
    fusion.  The loop for an LM is kept on the model with the tables' tensors
    (the graph reads them in place), keyed by their content fingerprint.

    Returns dict(tokens (B, N, Um), lens (B, N), scores (B, N), aligns
    (B, N, T+Um), align_lens (B, N), steps) sorted best-first; padding token
    is -1.  ``aligns`` is the full emission sequence including blanks;
    ``steps`` is the number of loop steps the search took.
    """
    return _search(model, enc_out, enc_lens, cfg, fst_tables, fst_start, steps_per_check,
                   graphed=enc_out.is_cuda, plain=_plain)


@torch.no_grad()
def beam_search_eager(model: Transducer, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                      cfg: BeamConfig, fst_tables: Optional[dict] = None, fst_start: int = 0,
                      steps_per_check: int = STEPS_PER_CHECK, _plain: bool = False) -> dict:
    """``beam_search`` with the body run eagerly on any device: the
    reference the card's checks hold the graph to."""
    return _search(model, enc_out, enc_lens, cfg, fst_tables, fst_start, steps_per_check,
                   graphed=False, plain=_plain)


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
