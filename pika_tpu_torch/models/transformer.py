"""Transformer blocks of the encoder (port of ``pika_tpu/models/transformer.py``).

Attention follows the JAX package's numerics: q, k, v and the softmax
probabilities are rounded to bf16 and the products accumulate in float32
(there: bf16 einsums with a float32 result).  Here the rounded values are
multiplied as float32, which is exact for bf16 inputs, so CPU and GPU agree
with the JAX package up to summation order; autograd rounds the gradients
of q, k, v and the probabilities to bf16 at the same casts.  LayerNorm eps
is 1e-6.

With ``use_flash`` (``attn_flash`` on the layer), the attention core goes
through K4 (``ops/flash_attention.py``: the hand-written kernel on CUDA
tensors, its plain version on CPU tensors) under the JAX layer's own
conditions -- no mask, one length for queries and keys, and no dropout on
the probabilities (eval mode or rate 0) -- and takes the exact path
otherwise, as the JAX layer does.  Its output is bf16 too.

In train mode, dropout acts where the JAX layer puts it: on the attention
probabilities, on the attention output before the residual, and after the
FFN's ReLU and its second linear layer.  Its masks come from the
``torch.Generator`` passed to ``forward``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pika_tpu_torch.ops.flash_attention import flash_attention

LN_EPS = 1e-6


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout``: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate), in x's dtype; the mask is drawn from
    ``generator``."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class MultiHeadedAttention(nn.Module):
    """Scaled dot-product MHA; ``mask`` is (B, Tq, Tk) bool, True = disallow.
    In train mode, dropout of ``dropout_rate`` on the probabilities.
    ``use_flash``: the core through K4 where the JAX layer takes its flash
    kernel (module docstring).

    The query-chunked path, clipped relative positions and the head-shared
    cheap dropout of the JAX module are not ported yet.
    """

    def __init__(self, head_count: int, model_dim: int, dropout_rate: float = 0.0,
                 use_flash: bool = False, device=None):
        super().__init__()
        self.head_count = head_count
        self.model_dim = model_dim
        self.dropout_rate = dropout_rate
        self.use_flash = use_flash
        self.linear_keys = nn.Linear(model_dim, model_dim, device=device)
        self.linear_values = nn.Linear(model_dim, model_dim, device=device)
        self.linear_query = nn.Linear(model_dim, model_dim, device=device)
        self.final_linear = nn.Linear(model_dim, model_dim, device=device)

    def forward(self, key, value, query, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h, dim = self.head_count, self.model_dim
        d_head = dim // h
        b, tq = query.shape[:2]

        def split_heads(x):
            return _bf16(x.reshape(x.shape[0], x.shape[1], h, d_head).transpose(1, 2))

        k = split_heads(self.linear_keys(key))
        v = split_heads(self.linear_values(value))
        q = split_heads(self.linear_query(query))
        q = q / torch.tensor(math.sqrt(d_head), dtype=torch.bfloat16)  # scaled after the cast
        no_prob_dropout = not self.training or self.dropout_rate == 0.0
        if self.use_flash and mask is None and tq == k.shape[2] and no_prob_dropout:
            ctx = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
            ctx = ctx.to(query.dtype).transpose(1, 2).reshape(b, tq, dim)
            return self.final_linear(ctx)
        scores = q.float() @ k.float().transpose(-1, -2)
        if mask is not None:
            scores = scores.masked_fill(mask[:, None], -1e18)
        attn = _bf16(torch.softmax(scores, dim=-1))
        attn = dropout(attn, self.dropout_rate if self.training else 0.0, generator)
        ctx = attn.float() @ v.float()
        ctx = ctx.to(query.dtype).transpose(1, 2).reshape(b, tq, dim)
        return self.final_linear(ctx)


class PositionwiseFeedForward(nn.Module):
    """LN -> Linear(d_ff) -> ReLU -> dropout -> Linear(d_model) -> dropout -> +x."""

    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.w_1 = nn.Linear(d_model, d_ff, device=device)
        self.w_2 = nn.Linear(d_ff, d_model, device=device)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        rate = self.dropout_rate if self.training else 0.0
        inter = dropout(torch.relu(self.w_1(self.layer_norm(x))), rate, generator)
        return dropout(self.w_2(inter), rate, generator) + x


class TransformerEncoderLayer(nn.Module):
    """Pre-norm self-attention block + FFN: ``x + dropout(attn(LN(x)))``
    then the FFN, with dropout of ``dropout_rate`` in train mode;
    ``attn_flash`` is the attention's ``use_flash``."""

    def __init__(self, d_model: int, heads: int, d_ff: int, dropout_rate: float = 0.0,
                 attn_flash: bool = False, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.self_attn = MultiHeadedAttention(heads, d_model, dropout_rate, attn_flash,
                                              device=device)
        self.feed_forward = PositionwiseFeedForward(d_model, d_ff, dropout_rate, device=device)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x_norm = self.layer_norm(x)
        ctx = self.self_attn(x_norm, x_norm, x_norm, mask=mask, generator=generator)
        rate = self.dropout_rate if self.training else 0.0
        return self.feed_forward(dropout(ctx, rate, generator) + x, generator)
