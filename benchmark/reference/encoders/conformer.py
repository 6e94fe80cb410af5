"""The Conformer encoder (Gulati et al., "Conformer: Convolution-augmented
Transformer for Speech Recognition", arXiv:2005.08100, eq. 1 and Fig. 1-4).

Subsampling: the features as one channel through two 3x3 convolutions of
``conformer_d_model`` channels, stride 2, no padding, each with ReLU; the
channels and the remaining frequencies flattened and mapped to
``conformer_d_model``, then dropout.  Each of ``conformer_layers`` blocks:

    x~ = x + FFN(x) / 2;  x' = x~ + MHSA(x~);  x" = x' + Conv(x');
    y = LN(x" + FFN(x") / 2)

FFN: LayerNorm, linear to ``conformer_d_ff``, Swish, dropout, linear,
dropout.  MHSA: LayerNorm, then Transformer-XL's relative-position
attention (q, k, v from one linear, ``linear_qkv``, in that order): with
the learned biases u and v and the positions' keys p, the
sinusoids of the relative positions T'-1 ... -(T'-1) through ``linear_pos``,
score(i, j) = ((q_i + u) . k_j + (q_i + v) . p(i - j)) / sqrt(d_head); keys
past each length hidden; softmax, dropout on the probabilities, context,
output linear, dropout.  Conv: LayerNorm, pointwise linear to twice the
width, GLU, frames past each length set to 0, depthwise convolution over
time with TF's "SAME" padding (``same_padding``), BatchNorm, Swish,
pointwise linear, dropout.  Then the map to the joint's width.

Train-mode draws from the passed generator, in the program's order: after
the subsampling; then per block FFN 1's two masks, the probabilities'
(``attention_keep``: shared across heads with ``attn_cheap_dropout``), the
attention's output, the conv module's output, FFN 2's two masks.  Each
mask but the probabilities' is one float32 Bernoulli draw of the keep
probability over the tensor's shape (``drop``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.model import (
    FLOAT32,
    Precision,
    attention_keep,
    batch_norm,
    layer_norm,
    linear,
)

KEYS = ("input_dim", "conformer_layers", "conformer_d_model", "conformer_heads",
        "conformer_d_ff", "conformer_kernel", "conformer_dropout", "attn_cheap_dropout")
TINY = {"input_dim": 8, "conformer_layers": 2, "conformer_d_model": 16, "conformer_heads": 4,
        "conformer_d_ff": 32, "conformer_kernel": 4}


def valid(n, kernel: int = 3, stride: int = 2):
    """Outputs of a convolution without padding."""
    return (n - kernel) // stride + 1


def output_frames(frames):
    return valid(valid(frames))


def shapes(frames: int, model: dict) -> dict:
    """The output frames of ``frames`` input frames, and the blocks' widths."""
    return {"t_enc": output_frames(frames), "d_model": model["conformer_d_model"],
            "d_ff": model["conformer_d_ff"]}


def flops(shapes: dict, model: dict) -> float:
    """The forward matmul operations of one utterance: the subsampling's two
    convolutions and its linear; per block the two FFNs, q, k, v and the
    output projection, the content and position scores (the latter against
    all 2T'-1 positions), the context, the conv module's two pointwise
    products and its depthwise convolution, and the positions' keys, which
    one batch computes once (counted over the batch); then the map to the
    joint's width."""
    t, f, d = shapes["frames"], model["input_dim"], model["conformer_d_model"]
    dff, k, hid = model["conformer_d_ff"], model["conformer_kernel"], model["hid_dim"]
    t1, f1 = valid(t), valid(f)
    t2, f2 = valid(t1), valid(f1)
    n = 2 * t2 - 1
    fwd = 2.0 * 9 * d * t1 * f1 + 2.0 * 9 * d * d * t2 * f2 + 2.0 * t2 * d * f2 * d
    block = (2 * 2 * 2.0 * t2 * d * dff                  # two FFNs
             + 2 * 4.0 * t2 * d * d                      # q, k, v, output
             + 2.0 * n * d * d / shapes["batch"]         # positions' keys
             + 2.0 * t2 * t2 * d + 2.0 * t2 * n * d      # content and position scores
             + 2.0 * t2 * t2 * d                         # context
             + 2.0 * t2 * d * 2 * d + 2.0 * t2 * d * k + 2.0 * t2 * d * d)   # conv module
    return fwd + model["conformer_layers"] * block + 2.0 * t2 * d * hid


def same_padding(kernel: int) -> tuple:
    """TF's "SAME" for stride 1: the odd frame of an even kernel after."""
    return (kernel - 1) // 2, kernel // 2


def position_table(length: int, d: int, device) -> torch.Tensor:
    """(2 length - 1, d): sin(pos / 10000^(2i/d)) in column 2i, cos in 2i + 1,
    for pos = length - 1 down to -(length - 1)."""
    pos = torch.arange(length - 1, -length, -1, dtype=torch.float32, device=device)
    angle = pos[:, None] / 10000.0 ** (torch.arange(0, d, 2, device=device) / d)
    table = torch.empty(len(pos), d, device=device)
    table[:, 0::2] = torch.sin(angle)
    table[:, 1::2] = torch.cos(angle)
    return table


def drop(x, rate, gen):
    """Dropout: x where a Bernoulli draw of 1 - rate keeps it, over 1 - rate."""
    if gen is None or rate == 0.0:
        return x
    keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - rate, generator=gen)
    return x * keep / (1.0 - rate)


def ffn(r, x, p, name, rate, gen):
    h = linear(r, layer_norm(x, p, name + ".layer_norm"), p, name + ".w_1")
    h = drop(h * torch.sigmoid(h), rate, gen)
    return drop(linear(r, h, p, name + ".w_2"), rate, gen)


def mhsa(r, x, p, name, heads, table, pad, rate, head_shared, gen):
    b, t, d = x.shape
    dh = d // heads

    def split(y):
        return y.reshape(*y.shape[:-1], heads, dh).transpose(-3, -2)

    xn = layer_norm(x, p, name + ".layer_norm")
    q, k, v = (split(y) for y in linear(r, xn, p, name + ".linear_qkv").chunk(3, dim=-1))
    pos = split(linear(r, table, p, name + ".linear_pos", bias=False))      # (H, 2T-1, dh)
    u, w = p[name + ".pos_bias_u"][:, None], p[name + ".pos_bias_v"][:, None]
    content = r(q + u) @ r(k).transpose(-1, -2)
    by_pos = r(q + w) @ r(pos).transpose(-1, -2)                             # (B, H, T, 2T-1)
    i, j = torch.arange(t, device=x.device)[:, None], torch.arange(t, device=x.device)[None, :]
    at = (t - 1 - (i - j)).expand(b, heads, t, t)                            # row of i - j
    scores = (content + by_pos.gather(-1, at)) / math.sqrt(dh)
    if pad is not None:
        scores = scores.masked_fill(pad[:, None, None, :], -math.inf)
    probs = torch.softmax(scores, dim=-1)
    if gen is not None and rate > 0.0:
        keep = attention_keep(probs.shape, rate, head_shared, gen, x.device)
        probs = torch.where(keep, probs / (1.0 - rate), 0.0)
    ctx = (r(probs) @ r(v)).transpose(1, 2).reshape(b, t, d)
    return linear(r, ctx, p, name + ".final_linear")


def conv_module(r, x, p, name, kernel, pad, train, rate, gen, stats):
    y = linear(r, layer_norm(x, p, name + ".layer_norm"), p, name + ".pointwise_in")
    a, g = y.chunk(2, dim=-1)
    y = a * torch.sigmoid(g)
    if pad is not None:
        y = y.masked_fill(pad[..., None], 0.0)
    w = p[name + ".depthwise.weight"]
    y = F.conv1d(F.pad(r(y).transpose(1, 2), same_padding(kernel)), r(w),
                 p[name + ".depthwise.bias"], groups=w.shape[0]).transpose(1, 2)
    if train and stats is not None:
        flat = y.reshape(-1, y.shape[-1])
        stats[name + ".batch_norm"] = (flat.mean(0), flat.var(0, unbiased=False))
    y = batch_norm(y, p, name + ".batch_norm", train)
    return drop(linear(r, y * torch.sigmoid(y), p, name + ".pointwise_out"), rate, gen)


def forward(p, x, model: dict, prec: Precision = FLOAT32, train: bool = False, gen=None,
            lens=None, stats=None):
    """(B, T, input_dim) features -> (B, T', hid_dim).  ``lens`` (B,): the
    input frames of each row (none hidden without); ``stats``: a dict that
    takes each BatchNorm's train-mode batch moments (mean, biased
    variance) by name."""
    r = prec.enc
    rate = model["conformer_dropout"] if train else 0.0
    heads, kernel = model["conformer_heads"], model["conformer_kernel"]
    y = x[:, None]
    for i in range(2):
        y = torch.relu(F.conv2d(r(y), r(p[f"encoder.subsample.conv_{i}.weight"]),
                                p[f"encoder.subsample.conv_{i}.bias"], stride=2))
    b, c, t, f = y.shape
    x = drop(linear(r, y.transpose(1, 2).reshape(b, t, c * f), p, "encoder.subsample.linear"),
             rate, gen)
    pad = None
    if lens is not None:
        pad = torch.arange(t, device=x.device)[None, :] >= output_frames(lens)[:, None]
    table = position_table(t, model["conformer_d_model"], x.device)
    for n in range(model["conformer_layers"]):
        name = f"encoder.blocks.{n}"
        x = x + 0.5 * ffn(r, x, p, name + ".ffn_0", rate, gen)
        x = x + drop(mhsa(r, x, p, name + ".mhsa", heads, table, pad, rate,
                          model["attn_cheap_dropout"], gen), rate, gen)
        x = x + conv_module(r, x, p, name + ".conv", kernel, pad, train, rate, gen, stats)
        x = layer_norm(x + 0.5 * ffn(r, x, p, name + ".ffn_1", rate, gen), p,
                       name + ".layer_norm")
    return linear(r, x, p, "encoder.fc_out")
