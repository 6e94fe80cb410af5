"""RNN-Transducer: TDNN-Transformer or LSTM encoder + LSTM or
conv-transformer prediction net + gated, factorized joint (port of
``pika_tpu/models/transducer.py``).

Joint:  h(t, u) = tanh(fc1_x x_t + fc1_y y_u) * sigmoid(gate_x x_t + gate_y y_u)
        z(t, u) = W2 h(t, u) + b2
with the first-layer biases on the y side only.  Blank = 0 doubles as SOS,
prepended to the labels before the prediction net.

``attn_flash`` takes the encoder's attention core through K4
(``ops/flash_attention.py``) where the JAX package takes its flash kernel;
``attn_chunk``, ``attn_cheap_dropout`` and ``remat`` are the encoder's
(``models/tdnn_transformer.py``).

The ``rnn`` encoder (``encoder_type="rnn"``, the JAX package's default) is
an ``enc_layers`` LSTM of width ``hid_dim`` over the frames, bidirectional
with ``brnn`` (half the width each way), masked by the frame lengths; it
does not subsample, so ``encoder_out_len`` is the identity.

The ``transformer`` prediction net (``decoder_type="transformer"``) is a
``ConvTransformerLM`` of ``dec_layers`` layers (``dec_d_model``,
``dec_heads``, ``dec_d_ff``) over the embedded labels, masked causally and
by the label lengths.  It has no incremental step: the decode loops take
``predict_last``, a full re-forward of each prefix.

``simple_joint`` adds the pruned loss's two linear heads ``simple_am`` and
``simple_lm`` (``simple_factors``; ``ops/rnnt_pruned.py``); the decoders
leave them unused.

Train mode is the module's own (``model.train()``): the TDNN encoder's
BatchNorm takes batch statistics and updates its running ones, its
transformer layers drop out with ``tdnn_transformer_dropout``, and the LSTMs
(the rnn encoder's, the LSTM prediction net's) between their layers and the
transformer prediction net's layers with ``dropout``, drawing their masks from the generator passed to ``encode``
and ``predict``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from pika_tpu_torch.device import resolve_device
from pika_tpu_torch.models.conv_transformer_lm import ConvTransformerLM
from pika_tpu_torch.models.lstm import LSTM, lstm_stack_step
from pika_tpu_torch.models.tdnn_transformer import TDNNTransformerEncoder
from pika_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class TransducerConfig:
    """Same fields and defaults as ``pika_tpu.models.TransducerConfig``."""

    input_dim: int
    vocab_size: int          # labels 0..V-1, blank = 0
    hid_dim: int = 512       # rnn_size / joint dim
    encoder_type: str = "rnn"          # 'rnn' | 'tdnn_transformer'
    decoder_type: str = "rnn"          # 'rnn' | 'transformer'
    enc_layers: int = 2
    dec_layers: int = 2
    embd_dim: int = 300
    dropout: float = 0.0
    brnn: bool = False
    tdnn_nhid: int = 1024
    tdnn_layers: int = 9
    tdnn_transformer_dropout: float = 0.2
    remat: bool = False
    attn_chunk: int = 0
    attn_flash: bool = False
    attn_cheap_dropout: bool = False
    dec_d_model: int = 512
    dec_heads: int = 8
    dec_d_ff: int = 2048
    simple_joint: bool = False

    @property
    def pad_id(self) -> int:
        # the embedding has vocab_size+1 rows; the last one is padding
        return self.vocab_size


class Transducer(nn.Module):
    def __init__(self, config: TransducerConfig, device=None):
        super().__init__()
        cfg = config
        if cfg.encoder_type not in ("rnn", "tdnn_transformer"):
            raise ValueError(f"unknown encoder_type {cfg.encoder_type!r}")
        self.config = cfg
        h = cfg.hid_dim
        if cfg.encoder_type == "rnn":
            self.encoder = LSTM(cfg.input_dim, h, cfg.enc_layers, cfg.dropout,
                                bidirectional=cfg.brnn, device=device)
        else:
            self.encoder = TDNNTransformerEncoder(
                cfg.input_dim, h, cfg.tdnn_nhid, cfg.tdnn_layers,
                transformer_dropout=cfg.tdnn_transformer_dropout, attn_flash=cfg.attn_flash,
                attn_chunk=cfg.attn_chunk, attn_cheap_dropout=cfg.attn_cheap_dropout,
                remat=cfg.remat, device=device)
        self.embed = nn.Embedding(cfg.vocab_size + 1, cfg.embd_dim, device=device)
        if cfg.decoder_type == "rnn":
            self.decoder = LSTM(cfg.embd_dim, h, cfg.dec_layers, cfg.dropout, device=device)
        else:
            self.decoder = ConvTransformerLM(
                cfg.embd_dim, h, d_model=cfg.dec_d_model, num_layers=cfg.dec_layers,
                heads=cfg.dec_heads, d_ff=cfg.dec_d_ff, dropout_rate=cfg.dropout, device=device)
        self.fc1_x = nn.Linear(h, h, bias=False, device=device)
        self.fc1_y = nn.Linear(h, h, device=device)
        self.gate_x = nn.Linear(h, h, bias=False, device=device)
        self.gate_y = nn.Linear(h, h, device=device)
        self.fc2 = nn.Linear(h, cfg.vocab_size, device=device)
        if cfg.simple_joint:
            self.simple_am = nn.Linear(h, cfg.vocab_size, device=device)
            self.simple_lm = nn.Linear(h, cfg.vocab_size, device=device)

    def encode(self, x: torch.Tensor, x_len: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, D) -> (B, T', H).  The rnn encoder masks by ``x_len``
        (outputs 0 past each length); the TDNN encoder sees the padded
        frames, as the JAX encoder does.  Train mode draws dropout masks
        from ``generator``."""
        with span("encoder"):
            if self.config.encoder_type == "rnn":
                return self.encoder(x, generator, lengths=x_len)[0]
            return self.encoder(x, generator=generator)

    def encoder_out_len(self, x_len):
        if self.config.encoder_type == "rnn":
            return x_len
        return self.encoder.output_length(x_len)

    def predict(self, y: torch.Tensor, y_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Prediction net over labels with SOS prepended: (B, U) -> (B, U+1, H).
        Positions at or past ``y_len + 1`` take the padding embedding row
        (and the transformer net's key mask).  Train mode drops out with
        masks from ``generator``."""
        with span("prediction_net"):
            pad_id = self.config.pad_id
            y_in = nn.functional.pad(y, (1, 0))  # SOS = blank = 0
            pad_pos = None
            if y_len is not None:
                pad_pos = torch.arange(y_in.shape[1], device=y.device)[None, :] > y_len[:, None]
                y_in = torch.where(pad_pos, pad_id, y_in)
            emb = self.embed(y_in.clamp(0, pad_id).long())
            if self.config.decoder_type == "rnn":
                return self.decoder(emb, generator)[0]
            return self.decoder(emb, pad_positions=pad_pos, generator=generator)

    def predict_step(self, y_tok: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]):
        """One incremental step of the LSTM prediction net: y_tok (B,),
        state = (h, c), each (layers, B, H) -> (out (B, H), new_state)."""
        emb = self.embed(y_tok.clamp(0, self.config.pad_id).long())
        top, h, c = lstm_stack_step(self.decoder, emb, state[0], state[1])
        return top, (h, c)

    def predict_last(self, tokens: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """Prediction-net output after a full prefix: (B, Um) tokens with
        per-row lengths -> (B, H), the output at position ``lens`` (SOS
        included).  The transformer net's decode step: a full re-forward."""
        dec = self.predict(tokens, lens)
        return dec.gather(1, lens.long()[:, None, None].expand(-1, 1, dec.shape[-1]))[:, 0]

    def joint_factors(self, enc_out: torch.Tensor, dec_out: torch.Tensor):
        """(ax, gx) over T and (ay, gy) over U+1 for the fused loss."""
        return (*self.joint_enc_factors(enc_out), *self.joint_dec_factors(dec_out))

    def joint_step(self, enc_hid: torch.Tensor, dec_hid: torch.Tensor) -> torch.Tensor:
        """Joint over aligned pairs: enc_hid, dec_hid (..., H) -> logits (..., V)."""
        return self.joint_from_factors(*self.joint_enc_factors(enc_hid),
                                       *self.joint_dec_factors(dec_hid))

    def joint_enc_factors(self, enc_out: torch.Tensor):
        return self.fc1_x(enc_out), self.gate_x(enc_out)

    def joint_dec_factors(self, dec_hid: torch.Tensor):
        return self.fc1_y(dec_hid), self.gate_y(dec_hid)

    def joint_from_factors(self, ax, gx, ay, gy) -> torch.Tensor:
        """Logits from the factors of aligned (t, u) pairs: (..., V)."""
        return self.fc2(torch.tanh(ax + ay) * torch.sigmoid(gx + gy))

    def joint_logits(self, enc_out: torch.Tensor, dec_out: torch.Tensor) -> torch.Tensor:
        """Full lattice logits (B, T, U+1, V): oracle and test use only (the
        loss never writes the lattice)."""
        ax, gx, ay, gy = self.joint_factors(enc_out, dec_out)
        return self.joint_from_factors(ax[:, :, None], gx[:, :, None], ay[:, None], gy[:, None])

    def simple_factors(self, enc_out: torch.Tensor, dec_out: torch.Tensor):
        """The pruned loss's additive joint, ``logit(t, u) = am[t] + lm[u]``:
        (am (B, T, V), lm (B, U+1, V)); needs ``simple_joint``."""
        return self.simple_am(enc_out), self.simple_lm(dec_out)

    def joint_params(self):
        """(W2 (H, V), b2 (V,)) of the output projection, in the JAX layout."""
        return self.fc2.weight.t().contiguous(), self.fc2.bias

    def forward(self, x: torch.Tensor, y: torch.Tensor, x_len: Optional[torch.Tensor] = None,
                y_len: Optional[torch.Tensor] = None, softmax: bool = True) -> torch.Tensor:
        """Full-lattice forward: log-probs (B, T', U+1, V) (logits without
        ``softmax``); oracle and test use only."""
        out = self.joint_logits(self.encode(x, x_len), self.predict(y, y_len))
        return torch.log_softmax(out, dim=-1) if softmax else out

    def decode_net(self, dtype: torch.dtype) -> "Transducer":
        """A Transducer without an encoder (and without the simple heads),
        holding the prediction net and the joint in ``dtype``: what the
        decode loops run.  At this model's
        own dtype it shares this model's modules; in another it holds a
        copy, which the loops keep across calls and refresh in place with
        ``load_decode_weights`` before each search, so a captured CUDA
        graph keeps reading the same tensors."""
        share = dtype == self.fc2.weight.dtype
        net = Transducer.__new__(Transducer)
        nn.Module.__init__(net)
        net.config = self.config
        for name, mod in self.named_children():
            if name not in ("encoder", "simple_am", "simple_lm"):
                setattr(net, name, mod if share else
                        copy.deepcopy(mod).to(dtype).requires_grad_(False).eval())
        return net

    def load_decode_weights(self, net: "Transducer") -> None:
        """Copy this model's prediction net and joint into ``net`` (a
        ``decode_net``) where it holds copies, casting to their dtype."""
        for name, mod in net.named_children():
            if mod is not getattr(self, name):
                mod.load_state_dict(getattr(self, name).state_dict())


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=generator)
    w.mul_(1.0 / (0.87962566103423978 * fan_in ** 0.5))  # flax's truncated lecun_normal


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator``, in the distributions flax uses:
    truncated LeCun normal for dense and conv kernels and the LSTM input
    weights, orthogonal LSTM recurrent weights, normal(1/sqrt(E)) embeddings,
    zero biases, identity norms and BatchNorm running stats (0, 1)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d)):
                _lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                nn.init.normal_(mod.weight, std=mod.embedding_dim ** -0.5, generator=generator)
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d)):
                mod.reset_parameters()
            elif isinstance(mod, LSTM):
                for k in range(mod.num_layers):
                    for d in range(mod.dirs):
                        w_ih, w_hh, bias = mod.layer_params(k, d)
                        _lecun_normal_(w_ih, w_ih.shape[1], generator)
                        nn.init.orthogonal_(w_hh, generator=generator)
                        bias.zero_()


def init_transducer(cfg: TransducerConfig, generator: torch.Generator,
                    device=None) -> Transducer:
    """A ``Transducer`` on ``device`` (the CUDA card unless the caller names
    another, e.g. ``"cpu"``) with random weights drawn from ``generator``
    (which must live on the same device type), in eval mode."""
    with torch.device("meta"):
        model = Transducer(cfg)
    model = model.to_empty(device=resolve_device(device))
    init_parameters(model, generator)
    return model.eval()
