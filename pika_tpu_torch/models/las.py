"""LAS (Listen-Attend-Spell), the N-best rescorer (port of
``pika_tpu/models/las.py``): an LSTM or SRU encoder, an optional
pyramid-LSTM downsampler, and an input-feeding attention decoder stepped
over the target tokens in a Python loop (the JAX package's ``lax.scan``).

* dot, general and mlp (Bahdanau) attention, masked past each context
  length at -1e18;
* coverage attention: from the second step on, the keys are
  ``tanh(context + linear_cover(coverage))`` with the coverage the summed
  attention of the earlier steps;
* source, target and both context gates;
* the pyramid downsampler: ``rate`` consecutive frames stacked, then an LSTM;
* scheduled sampling: one uniform toss per step from the generator passed
  to ``forward``; when it falls under ``sampling_prob`` (from the second step
  on), the ids in (1, pad_idx) are replaced by the argmax of the previous
  feed's output projection;
* decoder-only LM pretraining (``enable_enc=False``), and the ``dec_proj``
  (NLL) and ``enc_proj`` (CTC auxiliary) heads.

Conventions: SOS = 0, EOS a real vocabulary id, pad = ``pad_idx``; the
embedding has ``output_dim + 1`` rows, the last for padding.  The decoder's
own parameters (``dec_cell_*``, ``attn_*``, ``gate_*``) keep the JAX
(in, out) layout, so converted weights drop straight in.  Train mode is the
module's own: dropout in the encoder, the downsampler and on the decoder's
outputs, with masks from the generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pika_tpu_torch.device import resolve_device
from pika_tpu_torch.models.lstm import LSTM
from pika_tpu_torch.models.sru import SRU, SRUCell
from pika_tpu_torch.models.transducer import _lecun_normal_, init_parameters
from pika_tpu_torch.models.transformer import dropout as _dropout


@dataclasses.dataclass(frozen=True)
class LASConfig:
    """Same fields and defaults as ``pika_tpu.models.las.LASConfig``."""

    input_dim: int
    output_dim: int
    pad_idx: int
    rnn_size: int = 512
    enc_layers: int = 4
    dec_layers: int = 1
    embd_dim: int = 100
    brnn: bool = False
    dropout: float = 0.0
    attn_type: str = "mlp"              # 'dot' | 'general' | 'mlp'
    coverage_attn: bool = False
    rnn_type: str = "LSTM"              # 'LSTM' | 'SRU'
    context_gate: Optional[str] = None  # None | 'source' | 'target' | 'both'
    use_downsampler: bool = False
    downsampler_layers: int = 1
    downsampler_rate: int = 2


class PyramidLSTM(nn.Module):
    """Temporal downsampling: stack ``rate`` consecutive frames (the last
    group zero-padded), then an LSTM."""

    def __init__(self, input_dim: int, hid_dim: int, num_layers: int = 1, rate: int = 2,
                 brnn: bool = False, dropout: float = 0.0, device=None):
        super().__init__()
        self.rate = rate
        self.rnn = LSTM(input_dim * rate, hid_dim, num_layers, dropout, brnn, device=device)

    def forward(self, x, lengths=None, generator=None):
        b, t, d = x.shape
        out_len = (t - 1) // self.rate + 1
        x = F.pad(x, (0, 0, 0, out_len * self.rate - t)).reshape(b, out_len, d * self.rate)
        new_lengths = None if lengths is None else (lengths - 1) // self.rate + 1
        out, hidden = self.rnn(x, generator, lengths=new_lengths)
        return out, hidden, new_lengths


class LAS(nn.Module):
    def __init__(self, config: LASConfig, device=None):
        super().__init__()
        cfg = self.config = config
        h = cfg.rnn_size
        dirs = 2 if cfg.brnn else 1

        def param(name, *shape):
            self.register_parameter(name, nn.Parameter(torch.empty(*shape, device=device)))

        if cfg.rnn_type == "SRU":
            self.encoder = SRU(cfg.input_dim, h // dirs, cfg.enc_layers, bidirectional=cfg.brnn,
                               dropout=cfg.dropout, device=device)
        else:
            self.encoder = LSTM(cfg.input_dim, h, cfg.enc_layers, cfg.dropout, cfg.brnn,
                                device=device)
        self.enc_proj = nn.Linear(h, cfg.output_dim, device=device)
        if cfg.use_downsampler:
            self.downsampler = PyramidLSTM(h, h, cfg.downsampler_layers, cfg.downsampler_rate,
                                           cfg.brnn, cfg.dropout, device=device)
        self.embed = nn.Embedding(cfg.output_dim + 1, cfg.embd_dim, device=device)
        self.dec_proj = nn.Linear(h, cfg.output_dim, device=device)
        for i in range(cfg.dec_layers):  # the input-feed stacked LSTM cells
            param(f"dec_cell_{i}_wih", cfg.embd_dim + h if i == 0 else h, 4 * h)
            param(f"dec_cell_{i}_whh", h, 4 * h)
            param(f"dec_cell_{i}_b", 4 * h)
        if cfg.attn_type == "general":
            param("attn_linear_in", h, h)
        elif cfg.attn_type == "mlp":
            param("attn_linear_query", h, h)
            param("attn_linear_query_b", h)
            param("attn_linear_context", h, h)
            param("attn_v", h, 1)
        param("attn_linear_out", 2 * h, h)
        if cfg.attn_type == "mlp":
            param("attn_linear_out_b", h)
        if cfg.coverage_attn:
            param("attn_linear_cover", 1, h)
        if cfg.context_gate:
            in_dim = cfg.embd_dim + h  # the gate sees [emb; feed]
            param("gate_w", in_dim + 2 * h, h)
            param("gate_b", h)
            param("gate_src_w", h, h)
            param("gate_src_b", h)
            param("gate_tgt_w", in_dim + h, h)
            param("gate_tgt_b", h)

    # -- attention and gate ---------------------------------------------

    def _attend(self, query, context, ctx_pre, context_lengths, cover, cover_active: bool):
        """query (B, H), context (B, T, H); ``ctx_pre`` the mlp keys'
        projection.  With coverage, from the second step on
        (``cover_active``) the keys are ``tanh(context + cover * w_cover)``."""
        cfg = self.config
        if cfg.coverage_attn and cover is not None:
            if cover_active:
                context = torch.tanh(context + cover[..., None] * self.attn_linear_cover[0])
            if cfg.attn_type == "mlp":
                ctx_pre = context @ self.attn_linear_context
        if cfg.attn_type == "general":
            scores = torch.einsum("bh,bth->bt", query @ self.attn_linear_in, context)
        elif cfg.attn_type == "dot":
            scores = torch.einsum("bh,bth->bt", query, context)
        else:
            wq = query @ self.attn_linear_query + self.attn_linear_query_b
            scores = (torch.tanh(wq[:, None, :] + ctx_pre) @ self.attn_v)[..., 0]
        if context_lengths is not None:
            mask = torch.arange(context.shape[1], device=context.device)[None, :] \
                >= context_lengths[:, None]
            scores = scores.masked_fill(mask, -1e18)
        attn = torch.softmax(scores, dim=-1)
        c = torch.einsum("bt,bth->bh", attn, context)
        out = torch.cat([c, query], dim=-1) @ self.attn_linear_out
        out = out + self.attn_linear_out_b if cfg.attn_type == "mlp" else torch.tanh(out)
        return out, attn

    def _apply_gate(self, emb_feed, dec_state, attn_state):
        mode = self.config.context_gate
        z = torch.sigmoid(torch.cat([emb_feed, dec_state, attn_state], -1) @ self.gate_w
                          + self.gate_b)
        proj_src = attn_state @ self.gate_src_w + self.gate_src_b
        proj_tgt = torch.cat([emb_feed, dec_state], -1) @ self.gate_tgt_w + self.gate_tgt_b
        if mode == "source":
            return torch.tanh(proj_tgt + z * proj_src)
        if mode == "target":
            return torch.tanh(z * proj_tgt + proj_src)
        return torch.tanh((1.0 - z) * proj_tgt + z * proj_src)  # both

    def _cells(self, x, h, c):
        new_h, new_c = [], []
        for i in range(self.config.dec_layers):
            z = (x @ getattr(self, f"dec_cell_{i}_wih") + h[i] @ getattr(self, f"dec_cell_{i}_whh")
                 + getattr(self, f"dec_cell_{i}_b"))
            gi, gf, gg, go = z.chunk(4, dim=-1)
            cc = torch.sigmoid(gf) * c[i] + torch.sigmoid(gi) * torch.tanh(gg)
            x = torch.sigmoid(go) * torch.tanh(cc)
            new_h.append(x)
            new_c.append(cc)
        return x, torch.stack(new_h), torch.stack(new_c)

    # -- encoder ----------------------------------------------------------

    def encode(self, src, lengths=None, generator=None):
        """Returns (enc_out, hidden, ds_out, ds_hidden, ds_lengths): the
        encoder's output and final (h, c), and the same after the
        downsampler (the encoder's own without one)."""
        cfg = self.config
        if cfg.rnn_type == "SRU":
            # no length masking; the decoder's initial state comes from the
            # last layer's last c
            enc_out, c = self.encoder(src, generator)
            dirs = 2 if cfg.brnn else 1
            h_like = c[-1][None].expand(cfg.enc_layers * dirs, -1, -1)[..., :cfg.rnn_size // dirs]
            hidden = (h_like, h_like)
        else:
            enc_out, hidden = self.encoder(src, generator, lengths=lengths)
        if cfg.use_downsampler:
            ds_out, ds_hidden, ds_lengths = self.downsampler(enc_out, lengths, generator)
            return enc_out, hidden, ds_out, ds_hidden, ds_lengths
        return enc_out, hidden, enc_out, hidden, lengths

    def _init_dec_hidden(self, enc_hidden):
        """Merge the two directions, keep the last ``dec_layers``."""
        cfg = self.config
        h, c = enc_hidden
        if cfg.brnn:
            h = torch.cat([h[0::2], h[1::2]], dim=-1)
            c = torch.cat([c[0::2], c[1::2]], dim=-1)
        return h[-cfg.dec_layers:], c[-cfg.dec_layers:]

    # -- decoder ----------------------------------------------------------

    def decode(self, tgt_in, context, enc_hidden, context_lengths=None,
               sampling_prob: float = 0.0, generator: Optional[torch.Generator] = None):
        """Teacher-forced input-feeding decoder over ``tgt_in`` (B, U) ->
        (outputs (B, U, H), attentions (B, U, T)).  Scheduled sampling acts
        when a generator is given and ``sampling_prob > 0``."""
        cfg = self.config
        b, u = tgt_in.shape
        emb = self.embed(tgt_in.clamp(0, cfg.output_dim).long())
        h, c = self._init_dec_hidden(enc_hidden)
        feed = emb.new_zeros(b, cfg.rnn_size)
        ctx_pre = context @ self.attn_linear_context if cfg.attn_type == "mlp" else None
        cover = context.new_zeros(b, context.shape[1]) if cfg.coverage_attn else None
        sampling = generator is not None and sampling_prob > 0
        outs, attns = [], []
        for idx in range(u):
            emb_t = emb[:, idx]
            if sampling:
                toss = torch.rand((), generator=generator, device=tgt_in.device)
                if idx > 0:
                    tok_t = tgt_in[:, idx]
                    sampled = self.dec_proj(feed).argmax(dim=-1)
                    use = (toss < sampling_prob) & (tok_t < cfg.pad_idx) & (tok_t > 1)
                    emb_t = torch.where(use[:, None], self.embed(sampled), emb_t)
            emb_feed = torch.cat([emb_t, feed], dim=-1)
            rnn_out, h, c = self._cells(emb_feed, h, c)
            attn_out, attn = self._attend(rnn_out, context, ctx_pre, context_lengths, cover,
                                          idx > 0)
            if cfg.coverage_attn:
                cover = cover + attn
            feed = self._apply_gate(emb_feed, rnn_out, attn_out) if cfg.context_gate else attn_out
            outs.append(feed)
            attns.append(attn)
        return torch.stack(outs, dim=1), torch.stack(attns, dim=1)

    def pretrain_decode(self, tgt_in):
        """Decoder-only LM pretraining: no attention, the previous output fed
        back."""
        cfg = self.config
        b, u = tgt_in.shape
        emb = self.embed(tgt_in.clamp(0, cfg.output_dim).long())
        h = c = emb.new_zeros(cfg.dec_layers, b, cfg.rnn_size)
        x = emb.new_zeros(b, cfg.rnn_size)
        outs = []
        for idx in range(u):
            x, h, c = self._cells(torch.cat([emb[:, idx], x], dim=-1), h, c)
            outs.append(x)
        return torch.stack(outs, dim=1)

    def forward(self, src, tgt, lengths=None, enable_dec: bool = True, enable_enc: bool = True,
                sampling_prob: float = 0.0, generator: Optional[torch.Generator] = None):
        """Returns (dec_outputs (B, U-1, H), attentions, enc_out); the
        decoder consumes ``tgt[:, :-1]``."""
        tgt_in = tgt[:, :-1]
        if not enable_enc:
            return self.pretrain_decode(tgt_in), None, None
        enc_out, _, ds_out, ds_hidden, ds_lengths = self.encode(src, lengths, generator)
        if not enable_dec:
            return None, None, enc_out
        outputs, attns = self.decode(tgt_in, ds_out, ds_hidden, ds_lengths, sampling_prob,
                                     generator)
        if self.training:
            outputs = _dropout(outputs, self.config.dropout, generator)
        return outputs, attns, enc_out

    def output_logits(self, dec_outputs):
        return self.dec_proj(dec_outputs)

    def encoder_logits(self, enc_out):
        return self.enc_proj(enc_out)


def init_las(cfg: LASConfig, generator: torch.Generator, device=None) -> LAS:
    """A ``LAS`` on ``device`` (the CUDA card unless the caller names
    another) with random weights from ``generator``, in the distributions
    flax uses (truncated LeCun normal kernels, orthogonal recurrent weights,
    zero biases, the SRU's uniform weights), in eval mode."""
    with torch.device("meta"):
        model = LAS(cfg)
    model = model.to_empty(device=resolve_device(device))
    init_parameters(model, generator)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, SRUCell):
                bound = math.sqrt(3.0 / mod.n_in)
                mod.weight.uniform_(-bound, bound, generator=generator)
                mod.bias.zero_()
        for name, p in model.named_parameters(recurse=False):
            if name.endswith("_whh"):
                nn.init.orthogonal_(p, generator=generator)
            elif p.dim() == 2:
                _lecun_normal_(p, p.shape[0], generator)
            else:
                p.zero_()
    return model.eval()
