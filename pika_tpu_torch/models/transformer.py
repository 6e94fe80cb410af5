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

``max_relative_positions`` m > 0 adds clipped relative positions to
self-attention (queries and keys of one length, as in the JAX layer): a
``relative_positions_embeddings`` table of 2m+1 rows of d_head, and the
score of query i and key j gains ``q_i . table[clip(j - i, -m, m) + m]``.
The full path gathers the (Tq, Tk, d_head) table; the query-blocked path
forms the (B, H, qc, 2m+1) products of a block with the table and gathers
from them, so nothing quadratic in T beyond the block's scores exists.
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
    return torch.where(mask, x / keep, 0.0)


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
    return torch.where(bits < thr, attn / keep, 0.0)


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


def relative_positions_matrix(length: int, max_relative_positions: int, device=None,
                              start: int = 0, rows: Optional[int] = None) -> torch.Tensor:
    """(rows, L) clipped relative position ids ``clip(j - i, -m, m) + m`` in
    [0, 2m] of queries i = start .. start + rows - 1 (all L by default) and
    keys j < L."""
    m = max_relative_positions
    i = torch.arange(start, start + (length if rows is None else rows), device=device)
    return (torch.arange(length, device=device)[None, :] - i[:, None]).clamp(-m, m) + m


def causal_mask(length: int, device=None) -> torch.Tensor:
    """(1, L, L) bool mask, True above the diagonal (future positions)."""
    return torch.ones(1, length, length, dtype=torch.bool, device=device).triu(1)


def padding_mask(tokens: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """(B, L, L) bool: True where the key position holds ``padding_idx``."""
    b, length = tokens.shape
    return (tokens == padding_idx)[:, None, :].expand(b, length, length)


def attention_core(q, k, v, mask, rate: float, head_shared: bool,
                   generator: Optional[torch.Generator], rel_scores=None) -> torch.Tensor:
    """softmax(q kᵀ + rel_scores) v over bf16 q, k, v (q already scaled):
    float32 scores, probabilities rounded to bf16, dropout of ``rate``
    (head-shared or per element), float32 output (B, H, Tq, d).
    ``rel_scores`` is the relative-position term (B, H, Tq, Tk) or None."""
    scores = q.float() @ k.float().transpose(-1, -2)
    if rel_scores is not None:
        scores = scores + rel_scores
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
    head-shared mask on the probabilities; ``max_relative_positions``: the
    clipped relative positions of self-attention (module docstring).
    """

    def __init__(self, head_count: int, model_dim: int, dropout_rate: float = 0.0,
                 use_flash: bool = False, q_chunk: int = 0, cheap_dropout: bool = False,
                 max_relative_positions: int = 0, device=None):
        super().__init__()
        self.head_count = head_count
        self.model_dim = model_dim
        self.dropout_rate = dropout_rate
        self.use_flash = use_flash
        self.q_chunk = q_chunk
        self.cheap_dropout = cheap_dropout
        self.max_relative_positions = max_relative_positions
        self.linear_keys = nn.Linear(model_dim, model_dim, device=device)
        self.linear_values = nn.Linear(model_dim, model_dim, device=device)
        self.linear_query = nn.Linear(model_dim, model_dim, device=device)
        if max_relative_positions > 0:
            self.relative_positions_embeddings = nn.Embedding(
                2 * max_relative_positions + 1, model_dim // head_count, device=device)
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
        m, tk = self.max_relative_positions, k.shape[2]
        table = self.relative_positions_embeddings.weight.float() if m > 0 and tq == tk else None
        if 0 < self.q_chunk < tq:
            qc = self.q_chunk
            drop = generator if rate > 0.0 else None

            def block(q_c, m_c, start, g):
                rel = None
                if table is not None:  # gather from the block's (B, H, qc, 2m+1) products
                    prod = q_c.float() @ table.t()
                    ids = relative_positions_matrix(tk, m, q.device, start, q_c.shape[2])
                    rel = prod.gather(-1, ids.expand(*prod.shape[:2], *ids.shape))
                return attention_core(q_c, k, v, m_c, rate, True, g, rel)

            ctx = torch.cat([checkpoint_with_generator(
                block, drop, q[:, :, i:i + qc], None if mask is None else mask[:, i:i + qc], i)
                for i in range(0, tq, qc)], dim=2)
        elif (self.use_flash and mask is None and table is None and tq == tk
              and rate == 0.0):
            ctx = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        else:
            rel = None
            if table is not None:  # q . table[rel_ids] for each (query, key) pair
                rel = torch.einsum("bhqd,qkd->bhqk", q.float(),
                                   table[relative_positions_matrix(tk, m, q.device)])
            ctx = attention_core(q, k, v, mask, rate, self.cheap_dropout, generator, rel)
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
    ``attn_flash``, ``attn_q_chunk``, ``attn_cheap_dropout`` and
    ``max_relative_positions`` are the attention's ``use_flash``,
    ``q_chunk``, ``cheap_dropout`` and ``max_relative_positions``."""

    def __init__(self, d_model: int, heads: int, d_ff: int, dropout_rate: float = 0.0,
                 attn_flash: bool = False, attn_q_chunk: int = 0,
                 attn_cheap_dropout: bool = False, max_relative_positions: int = 0,
                 device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.self_attn = MultiHeadedAttention(heads, d_model, dropout_rate, attn_flash,
                                              attn_q_chunk, attn_cheap_dropout,
                                              max_relative_positions, device=device)
        self.feed_forward = PositionwiseFeedForward(d_model, d_ff, dropout_rate, device=device)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x_norm = self.layer_norm(x)
        ctx = self.self_attn(x_norm, x_norm, x_norm, mask=mask, generator=generator)
        rate = self.dropout_rate if self.training else 0.0
        return self.feed_forward(dropout(ctx, rate, generator) + x, generator)
