"""Conformer encoder (Gulati et al., "Conformer: Convolution-augmented
Transformer for Speech Recognition", arXiv:2005.08100) for the transducer.

Subsampling: the (B, T, F) features as one channel through two 3x3
convolutions of ``d_model`` channels, stride 2, VALID, each with ReLU;
flattened to (B, T', d_model * F') and mapped to ``d_model``, then dropout.
T' = ((T - 3) // 2 + 1 - 3) // 2 + 1 (``output_length``).

Each of ``layers`` blocks (the paper's eq. 1):

    x~ = x + FFN(x) / 2
    x' = x~ + MHSA(x~)
    x" = x' + Conv(x')
    y  = LN(x" + FFN(x") / 2)

* FFN: LayerNorm, linear to ``d_ff``, Swish, dropout, linear back, dropout.
* MHSA: LayerNorm, then Transformer-XL relative-position attention.  q, k,
  v from one linear with biases (``linear_qkv``, in that order); the
  positions' keys p = W_pos P (no bias) over the sinusoidal table P of the
  relative positions T'-1 ... -(T'-1) (``relative_position_table``,
  computed, not kept as state); with the learned biases u and v (heads,
  d_head)::

      score(i, j) = ((q_i + u) . k_j + (q_i + v) . p_(i-j)) / sqrt(d_head)

  the second term formed against all 2T'-1 positions and shifted into
  place (``rel_shift``).  Keys past each length are masked; softmax,
  dropout on the probabilities (one mask shared by the heads with
  ``cheap_dropout``), context, output linear, then dropout.  As in
  ``models/transformer.py``: q + u, q + v, k, p, v and the probabilities
  are rounded to bf16 and the products sum in float32.
* Conv: LayerNorm, pointwise linear to 2 ``d_model``, GLU, the frames past
  each length set to 0, depthwise convolution of ``kernel`` over time with
  TF's "SAME" padding ((kernel - 1) // 2 frames before, kernel // 2 after),
  BatchNorm, Swish, pointwise linear, dropout.  BatchNorm is PyTorch's: in
  train mode it normalizes by the moments of the batch over every frame
  (the biased variance) and moves the running statistics a tenth of the
  way towards them (the unbiased variance).

After the blocks ``fc_out`` maps ``d_model`` to the joint's width.

In train mode the dropout masks are drawn from the passed generator in
this order: after the subsampling; then per block FFN 1's two masks, the
probabilities, the attention's output, the conv module's output, FFN 2's
two masks.  Each mask but the probabilities' is one float32 Bernoulli
draw of the keep probability over the tensor's shape (``_keep``); the kept
values are scaled by its inverse, and a mask after a sublayer is applied
with its residual sum in one ``addcmul`` (``_residual``).  The
probabilities' is ``models/transformer.py``'s.

Spans (``utils/profiling.py:span``): ``conformer.subsample``, and per
block ``conformer.ffn`` (twice), ``conformer.mhsa`` and ``conformer.conv``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pika_tpu_torch.models.tdnn_transformer import BN_EPS, BN_MOMENTUM
from pika_tpu_torch.models.transformer import LN_EPS, attention_core
from pika_tpu_torch.utils.profiling import span


def _valid_len(length, kernel: int = 3, stride: int = 2):
    return (length - kernel) // stride + 1


def _keep(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """Dropout's float32 mask over x's shape, 1 where kept and 0 where
    dropped: one Bernoulli draw of 1 - rate."""
    return torch.empty(x.shape, device=x.device).bernoulli_(1.0 - rate, generator=generator)


def _dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    if rate == 0.0:
        return x
    return x * _keep(x, rate, generator).div_(1.0 - rate).to(x.dtype)


def _residual(x: torch.Tensor, y: torch.Tensor, scale: float, rate: float,
              generator) -> torch.Tensor:
    """x + scale * dropout(y), the residual sum and the mask in one kernel."""
    if rate == 0.0:
        return torch.add(x, y, alpha=scale)
    return torch.addcmul(x, y, _keep(y, rate, generator).to(y.dtype),
                         value=scale / (1.0 - rate))


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, laid out contiguously for the batched products."""
    return x.to(torch.bfloat16, memory_format=torch.contiguous_format)


def relative_position_table(length: int, d_model: int, device=None) -> torch.Tensor:
    """(2 length - 1, d_model) float32 sinusoids of the relative positions
    length - 1, ..., -(length - 1): sin in the even columns, cos in the odd,
    of the position times 10000^(-2i / d_model)."""
    pos = torch.arange(length - 1, -length, -1, device=device, dtype=torch.float32)
    inv = torch.exp(torch.arange(0, d_model, 2, device=device, dtype=torch.float32)
                    * (-math.log(10000.0) / d_model))
    angle = pos[:, None] * inv[None, :]
    return torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1).reshape(len(pos), d_model)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(..., T, 2T - 1) scores against the positions T-1 ... -(T-1) ->
    (..., T, T) with out[i, j] = x[i, T - 1 - i + j], the position i - j: a
    strided view of x."""
    x = x.contiguous()
    t, n = x.shape[-2:]
    return x.as_strided((*x.shape[:-1], t), (*x.stride()[:-2], n - 1, 1),
                        x.storage_offset() + t - 1)


class ConvSubsampling(nn.Module):
    def __init__(self, input_dim: int, d_model: int, device=None):
        super().__init__()
        self.conv_0 = nn.Conv2d(1, d_model, 3, stride=2, device=device)
        self.conv_1 = nn.Conv2d(d_model, d_model, 3, stride=2, device=device)
        self.linear = nn.Linear(d_model * _valid_len(_valid_len(input_dim)), d_model,
                                device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) -> (B, T', d_model)."""
        x = torch.relu(self.conv_1(torch.relu(self.conv_0(x[:, None]))))
        b, c, t, f = x.shape
        return self.linear(x.transpose(1, 2).reshape(b, t, c * f))


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dropout_rate: float, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.w_1 = nn.Linear(d_model, d_ff, device=device)
        self.w_2 = nn.Linear(d_ff, d_model, device=device)

    def forward(self, x, generator=None):
        """The FFN before its output's dropout (the block's ``_residual``)."""
        rate = self.dropout_rate if self.training else 0.0
        return self.w_2(_dropout(F.silu(self.w_1(self.layer_norm(x))), rate, generator))


class RelPositionAttention(nn.Module):
    """LayerNorm and relative-position self-attention (module docstring),
    before its output's dropout; ``key_pad`` (B, 1, T) is True where a key
    lies past its length."""

    def __init__(self, d_model: int, heads: int, dropout_rate: float, cheap_dropout: bool,
                 device=None):
        super().__init__()
        self.heads = heads
        self.dropout_rate = dropout_rate
        self.cheap_dropout = cheap_dropout
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.linear_qkv = nn.Linear(d_model, 3 * d_model, device=device)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False, device=device)
        d_head = d_model // heads
        self.pos_bias_u = nn.Parameter(torch.empty(heads, d_head, device=device))
        self.pos_bias_v = nn.Parameter(torch.empty(heads, d_head, device=device))
        self.final_linear = nn.Linear(d_model, d_model, device=device)

    def forward(self, x, pos, key_pad=None, generator=None):
        b, t, d = x.shape
        h = self.heads
        scale = 1.0 / math.sqrt(d // h)   # a power of 2 for d_head 4^k: exact in bf16

        def split(y):
            return y.reshape(y.shape[0], y.shape[1], h, d // h).transpose(1, 2)

        q, k, v = (split(y) for y in self.linear_qkv(self.layer_norm(x)).chunk(3, dim=-1))
        k, v = _round_bf16(k), _round_bf16(v)
        p = _round_bf16(split(self.linear_pos(pos[None]))) * scale
        q_u = _round_bf16(q + self.pos_bias_u[:, None]) * scale
        q_v = _round_bf16(q + self.pos_bias_v[:, None])
        pos_scores = rel_shift(q_v.float() @ p.float().transpose(-1, -2))
        rate = self.dropout_rate if self.training else 0.0
        ctx = attention_core(q_u, k, v, key_pad, rate, self.cheap_dropout, generator, pos_scores)
        return self.final_linear(ctx.to(x.dtype).transpose(1, 2).reshape(b, t, d))


class ConvModule(nn.Module):
    """The conv module before its output's dropout."""

    def __init__(self, d_model: int, kernel: int, device=None):
        super().__init__()
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.pointwise_in = nn.Linear(d_model, 2 * d_model, device=device)
        self.depthwise = nn.Conv1d(d_model, d_model, kernel, groups=d_model, device=device)
        self.batch_norm = nn.BatchNorm1d(d_model, eps=BN_EPS, device=device)
        self.pointwise_out = nn.Linear(d_model, d_model, device=device)

    def forward(self, x, pad=None):
        y = F.glu(self.pointwise_in(self.layer_norm(x)), dim=-1)
        if pad is not None:
            y = y.masked_fill(pad[..., None], 0.0)
        kernel = self.depthwise.kernel_size[0]
        y = self.depthwise(F.pad(y.transpose(1, 2), ((kernel - 1) // 2, kernel // 2)))
        bn = self.batch_norm
        # float32 scale and shift beside the running statistics, whatever
        # the input's dtype (the bf16 step casts the parameters)
        y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight.float(), bn.bias.float(),
                         self.training, 1.0 - BN_MOMENTUM, bn.eps)
        return self.pointwise_out(F.silu(y).transpose(1, 2))


class ConformerBlock(nn.Module):
    def __init__(self, d_model: int, heads: int, d_ff: int, kernel: int, dropout_rate: float,
                 cheap_dropout: bool, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.ffn_0 = FeedForward(d_model, d_ff, dropout_rate, device=device)
        self.mhsa = RelPositionAttention(d_model, heads, dropout_rate, cheap_dropout,
                                         device=device)
        self.conv = ConvModule(d_model, kernel, device=device)
        self.ffn_1 = FeedForward(d_model, d_ff, dropout_rate, device=device)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS, device=device)

    def forward(self, x, pos, pad=None, generator=None):
        rate = self.dropout_rate if self.training else 0.0
        with span("conformer.ffn"):
            x = _residual(x, self.ffn_0(x, generator), 0.5, rate, generator)
        with span("conformer.mhsa"):
            key_pad = None if pad is None else pad[:, None, :]
            x = _residual(x, self.mhsa(x, pos, key_pad, generator), 1.0, rate, generator)
        with span("conformer.conv"):
            x = _residual(x, self.conv(x, pad), 1.0, rate, generator)
        with span("conformer.ffn"):
            return self.layer_norm(_residual(x, self.ffn_1(x, generator), 0.5, rate, generator))


class ConformerEncoder(nn.Module):
    """(B, T, input_dim) features -> (B, T', output_dim) (module docstring)."""

    def __init__(self, input_dim: int, output_dim: int, d_model: int = 512, layers: int = 17,
                 heads: int = 8, d_ff: int = 2048, kernel: int = 32, dropout_rate: float = 0.1,
                 cheap_dropout: bool = False, device=None):
        super().__init__()
        self.d_model = d_model
        self.dropout_rate = dropout_rate
        self.subsample = ConvSubsampling(input_dim, d_model, device=device)
        self.blocks = nn.ModuleList(
            ConformerBlock(d_model, heads, d_ff, kernel, dropout_rate, cheap_dropout,
                           device=device) for _ in range(layers))
        self.fc_out = nn.Linear(d_model, output_dim, device=device)

    @classmethod
    def from_config(cls, cfg, device=None) -> "ConformerEncoder":
        if cfg.attn_flash or cfg.attn_chunk or cfg.remat:
            raise ValueError("the conformer encoder takes none of attn_flash, attn_chunk, remat")
        return cls(cfg.input_dim, cfg.hid_dim, d_model=cfg.conformer_d_model,
                   layers=cfg.conformer_layers, heads=cfg.conformer_heads,
                   d_ff=cfg.conformer_d_ff, kernel=cfg.conformer_kernel,
                   dropout_rate=cfg.conformer_dropout, cheap_dropout=cfg.attn_cheap_dropout,
                   device=device)

    @staticmethod
    def output_length(in_len):
        """Output frame count given input frames (ints or tensors)."""
        return _valid_len(_valid_len(in_len))

    def forward(self, x: torch.Tensor, x_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x_len`` (B,): the input frames of each row; without them no
        frame is masked.  Train mode draws dropout from ``generator``."""
        rate = self.dropout_rate if self.training else 0.0
        with span("conformer.subsample"):
            x = _dropout(self.subsample(x), rate, generator)
        t = x.shape[1]
        pos = relative_position_table(t, self.d_model, x.device).to(x.dtype)
        pad = None
        if x_len is not None:
            pad = (torch.arange(t, device=x.device)[None, :]
                   >= self.output_length(x_len.to(x.device))[:, None])
        for block in self.blocks:
            x = block(x, pos, pad, generator)
        return self.fc_out(x)
