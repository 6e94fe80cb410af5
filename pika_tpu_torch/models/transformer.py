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
``torch.Generator`` passed to ``forward``.  ``cheap_dropout`` replaces the
per-head mask on the probabilities with one bits-threshold mask of shape
(B, 1, Tq, Tk) shared across heads (unbiased, head-correlated noise).

``q_chunk`` > 0 (the encoder's ``attn_chunk``) computes the attention core
over query blocks of ``q_chunk`` rows: a block's scores are (B, H, qc, Tk),
and the block is recomputed in the backward instead of keeping its
probabilities, so the core holds O(T * qc) at a time.  It is the full
path's function; in train mode its dropout is always the head-shared mask.
A recomputed block draws the same mask as its forward
(``checkpoint_with_generator``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def head_shared_dropout(attn: torch.Tensor, rate: float,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout of (B, H, Tq, Tk) probabilities with one mask shared across
    heads: keep where 32 random bits fall under ``round(keep * 0xFFFFFFFF)``
    (the JAX layer's threshold, here on int32 bits offset by 2^31), and
    divide by keep, in attn's dtype."""
    keep = 1.0 - rate
    thr = int(round(keep * 0xFFFFFFFF)) - 2 ** 31
    bits = torch.randint(-2 ** 31, 2 ** 31, (attn.shape[0], 1) + tuple(attn.shape[2:]),
                         dtype=torch.int32, generator=generator, device=attn.device)
    return torch.where(bits < thr, attn / keep, torch.zeros((), dtype=attn.dtype,
                                                            device=attn.device))


def checkpoint_with_generator(fn: Callable, generator: Optional[torch.Generator], *args):
    """``fn(*args, generator)`` with its activations recomputed in the
    backward (``torch.utils.checkpoint``), drawing the same random numbers
    in the recomputation as in the forward.

    ``torch.utils.checkpoint`` restores only the global RNG; ``fn`` draws
    from a passed generator instead.  So ``fn`` gets a fresh generator set
    to a snapshot of ``generator``'s state (on the card, its Philox seed
    and offset) in the forward and again in the recomputation, and
    ``generator`` is then moved to where the forward's draws left it: later
    draws see the state they would have seen without the checkpoint, and
    the recomputation's draws move nothing.  Without autograd it is
    ``fn(*args, generator)``."""
    if not torch.is_grad_enabled():
        return fn(*args, generator)
    if generator is None:
        return checkpoint(fn, *args, None, use_reentrant=False, preserve_rng_state=False)
    state = generator.get_state()
    after = []

    def run(*xs):
        g = torch.Generator(generator.device)
        g.set_state(state)
        out = fn(*xs, g)
        after.append(g.get_state())
        return out

    out = checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
    generator.set_state(after[0])
    return out


def attention_core(q, k, v, mask, rate: float, head_shared: bool,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """softmax(q kᵀ) v over bf16 q, k, v (q already scaled): float32 scores,
    probabilities rounded to bf16, dropout of ``rate`` (head-shared or per
    element), float32 output (B, H, Tq, d)."""
    scores = q.float() @ k.float().transpose(-1, -2)
    if mask is not None:
        scores = scores.masked_fill(mask[:, None], -1e18)
    attn = _bf16(torch.softmax(scores, dim=-1))
    if rate > 0.0:
        attn = (head_shared_dropout if head_shared else dropout)(attn, rate, generator)
    return attn.float() @ v.float()


class MultiHeadedAttention(nn.Module):
    """Scaled dot-product MHA; ``mask`` is (B, Tq, Tk) bool, True = disallow.
    In train mode, dropout of ``dropout_rate`` on the probabilities.
    ``use_flash``: the core through K4 where the JAX layer takes its flash
    kernel; ``q_chunk``: the query-blocked core; ``cheap_dropout``: the
    head-shared mask on the probabilities (module docstring).

    Clipped relative positions are not ported yet.
    """

    def __init__(self, head_count: int, model_dim: int, dropout_rate: float = 0.0,
                 use_flash: bool = False, q_chunk: int = 0, cheap_dropout: bool = False,
                 device=None):
        super().__init__()
        self.head_count = head_count
        self.model_dim = model_dim
        self.dropout_rate = dropout_rate
        self.use_flash = use_flash
        self.q_chunk = q_chunk
        self.cheap_dropout = cheap_dropout
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
        rate = self.dropout_rate if self.training else 0.0
        if 0 < self.q_chunk < tq:
            qc = self.q_chunk
            drop = generator if rate > 0.0 else None
            ctx = torch.cat([checkpoint_with_generator(
                lambda q_c, m_c, g: attention_core(q_c, k, v, m_c, rate, True, g), drop,
                q[:, :, i:i + qc], None if mask is None else mask[:, i:i + qc])
                for i in range(0, tq, qc)], dim=2)
        elif self.use_flash and mask is None and tq == k.shape[2] and rate == 0.0:
            ctx = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        else:
            ctx = attention_core(q, k, v, mask, rate, self.cheap_dropout, generator)
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
    ``attn_flash``, ``attn_q_chunk`` and ``attn_cheap_dropout`` are the
    attention's ``use_flash``, ``q_chunk`` and ``cheap_dropout``."""

    def __init__(self, d_model: int, heads: int, d_ff: int, dropout_rate: float = 0.0,
                 attn_flash: bool = False, attn_q_chunk: int = 0,
                 attn_cheap_dropout: bool = False, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.self_attn = MultiHeadedAttention(heads, d_model, dropout_rate, attn_flash,
                                              attn_q_chunk, attn_cheap_dropout, device=device)
        self.feed_forward = PositionwiseFeedForward(d_model, d_ff, dropout_rate, device=device)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x_norm = self.layer_norm(x)
        ctx = self.self_attn(x_norm, x_norm, x_norm, mask=mask, generator=generator)
        rate = self.dropout_rate if self.training else 0.0
        return self.feed_forward(dropout(ctx, rate, generator) + x, generator)
