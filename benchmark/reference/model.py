"""The transducer's forward pass in plain PyTorch over a dict of weights:
the TDNN-Transformer encoder, the LSTM and the conv-transformer prediction
nets and the gated joint, as pika's papers and recipes describe them
(tencent-ailab/pika ``trainer/model``).

Every product goes through ``Precision``: float32 by default (the
reference), or with its operands rounded to a lower precision (the
control).  In train mode the random numbers are drawn from a passed
``torch.Generator`` in this order, which is the order of the program's
draws: for each transformer layer the attention's keep-mask, then the
masks after the attention's output projection, after the FFN's ReLU and
after its second linear layer.  Weights are keyed by the names of the
program's checkpoints (``encoder.conv_0.weight``, ...).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LN_EPS = 1e-6


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude at e4m3's largest value, 448), back in float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUND: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "float32": lambda x: x,
    "bfloat16": lambda x: x.to(torch.bfloat16).float(),
    "fp8": fp8_round,
}


class Precision:
    """How the products of the encoder (``enc``) and of the prediction net
    and joint (``dec``) round their operands before a float32 product."""

    def __init__(self, enc: str = "float32", dec: str = "float32"):
        self.enc, self.dec = ROUND[enc], ROUND[dec]


FLOAT32 = Precision()


def linear(r, x, p, name, bias=True):
    y = r(x) @ r(p[name + ".weight"]).t()
    return y + p[name + ".bias"] if bias else y


def layer_norm(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], LN_EPS)


def batch_norm(x, p, name, train: bool):
    """Over the channels of (B, T, C): batch statistics (biased variance) in
    train mode, the running ones in eval mode."""
    if train:
        flat = x.reshape(-1, x.shape[-1])
        mean = flat.mean(0)
        var = ((flat - mean) ** 2).mean(0)
    else:
        mean, var = p[name + ".running_mean"], p[name + ".running_var"]
    return (x - mean) * torch.rsqrt(var + BN_EPS) * p[name + ".weight"] + p[name + ".bias"]


def dropout(x, rate: float, gen: Optional[torch.Generator]):
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(torch.rand(x.shape, generator=gen, device=x.device) < keep, x / keep, 0.0)


def attention_keep(shape, rate: float, head_shared: bool, gen, device):
    """The keep-mask of the attention probabilities: (B, 1, T, T) from 32
    random bits each under the threshold of ``1 - rate`` when shared across
    heads, else (B, H, T, T) uniforms under ``1 - rate``."""
    keep = 1.0 - rate
    if head_shared:
        b, _, tq, tk = shape
        bits = torch.randint(-2 ** 31, 2 ** 31, (b, 1, tq, tk), dtype=torch.int32,
                             generator=gen, device=device)
        return bits < int(round(keep * 0xFFFFFFFF)) - 2 ** 31
    return torch.rand(shape, generator=gen, device=device) < keep


def transformer_layer(r, x, p, name, heads: int, mask=None, rate: float = 0.0,
                      head_shared: bool = False, gen=None):
    """Pre-norm self-attention and FFN, each added to its input, with
    dropout of ``rate`` when ``gen`` is given; ``mask`` (B, T, T) is True
    where a key is hidden."""
    b, t, d = x.shape
    dh = d // heads
    xn = layer_norm(x, p, name + ".layer_norm")
    att = name + ".self_attn"

    def split(y):
        return y.reshape(b, t, heads, dh).transpose(1, 2)

    q = split(linear(r, xn, p, att + ".linear_query")) / math.sqrt(dh)
    k = split(linear(r, xn, p, att + ".linear_keys"))
    v = split(linear(r, xn, p, att + ".linear_values"))
    scores = r(q) @ r(k).transpose(-1, -2)
    if mask is not None:
        scores = scores.masked_fill(mask[:, None], -1e18)
    probs = torch.softmax(scores, dim=-1)
    if gen is not None and rate > 0.0:
        keep = attention_keep(probs.shape, rate, head_shared, gen, x.device)
        probs = torch.where(keep, probs / (1.0 - rate), 0.0)
    ctx = (r(probs) @ r(v)).transpose(1, 2).reshape(b, t, d)
    x = dropout(linear(r, ctx, p, att + ".final_linear"), rate, gen) + x
    ff = name + ".feed_forward"
    inner = dropout(torch.relu(linear(r, layer_norm(x, p, ff + ".layer_norm"), p, ff + ".w_1")),
                    rate, gen)
    return dropout(linear(r, inner, p, ff + ".w_2"), rate, gen) + x


def tdnn_schedule(layers: int):
    """(dilation, stride) of each TDNN layer: 1, 1, 1, 3, ..., 3, the last
    with stride 4."""
    return [(1 if l < 3 else 3, 4 if l == layers - 1 else 1) for l in range(layers)]


def encoder(p, x, model: dict, prec: Precision = FLOAT32, train: bool = False, gen=None):
    """(B, T, input_dim) features -> (B, T', hid_dim)."""
    r = prec.enc
    heads = model["encoder_heads"]
    rate = model["tdnn_transformer_dropout"] if train else 0.0
    x = batch_norm(torch.relu(linear(r, x, p, "encoder.fc_in")), p, "encoder.bn_in", train)
    n_tf = 0
    for l, (dil, stride) in enumerate(tdnn_schedule(model["tdnn_layers"])):
        w = p[f"encoder.conv_{l}.weight"]
        y = F.conv1d(r(x).transpose(1, 2), r(w), p[f"encoder.conv_{l}.bias"], stride=stride,
                     dilation=dil)
        x = batch_norm(torch.relu(y).transpose(1, 2), p, f"encoder.bn_{l}", train)
        if (l + 1) % 3 == 0 and n_tf < len(heads):
            x = transformer_layer(r, x, p, f"encoder.transformer_{n_tf}", heads[n_tf],
                                  rate=rate, head_shared=model["attn_cheap_dropout"], gen=gen)
            n_tf += 1
    return linear(r, batch_norm(x, p, "encoder.bn_final", train), p, "encoder.fc_out")


def embed_labels(p, labels, lens, model: dict):
    """[SOS = blank = 0, labels...] embedded; positions past each length take
    the padding row (the last).  Returns (embedded (B, U+1, E), padding
    positions (B, U+1))."""
    pad_id = model["vocab_size"]
    y = F.pad(labels.long(), (1, 0))
    pad = torch.arange(y.shape[1], device=y.device)[None, :] > lens[:, None]
    y = torch.where(pad, pad_id, y.clamp(0, pad_id))
    return p["embed.weight"][y], pad


def lstm(r, p, x, layers: int, rate: float = 0.0, gen=None):
    """Unidirectional LSTM (gates i, f, g, o; one bias a layer) over
    (B, U, E), one cell step a position."""
    for k in range(layers):
        w_ih, w_hh, bias = (p[f"decoder.{n}_l{k}"] for n in ("weight_ih", "weight_hh", "bias"))
        xp = r(x) @ r(w_ih).t() + bias
        h = c = x.new_zeros(x.shape[0], w_hh.shape[1])
        outs = []
        for t in range(x.shape[1]):
            i, f, g, o = (xp[:, t] + r(h) @ r(w_hh).t()).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        x = torch.stack(outs, dim=1)
        if k < layers - 1:
            x = dropout(x, rate, gen)
    return x


def conv_transformer_lm(r, p, x, pad, model: dict, rate: float = 0.0, gen=None):
    """Causal conv (kernel 5, left-padded) + ReLU + transformer layer under
    the causal and key-padding masks, per layer; then LayerNorm and the map
    to the joint's width."""
    b, u, _ = x.shape
    mask = torch.ones(u, u, dtype=torch.bool, device=x.device).triu(1)[None] | pad[:, None, :]
    for i in range(model["dec_layers"]):
        w = p[f"decoder.conv_{i}.weight"]
        y = F.conv1d(F.pad(r(x).transpose(1, 2), (w.shape[-1] - 1, 0)), r(w),
                     p[f"decoder.conv_{i}.bias"])
        x = transformer_layer(r, torch.relu(y).transpose(1, 2), p, f"decoder.transformer_{i}",
                              model["dec_heads"], mask=mask, rate=rate, gen=gen)
    return linear(r, layer_norm(x, p, "decoder.layer_norm"), p, "decoder.linear_out")


def predict(p, labels, lens, model: dict, prec: Precision = FLOAT32, train: bool = False,
            gen=None):
    """(B, U) labels with lengths -> (B, U+1, hid_dim) prediction-net
    outputs, SOS first."""
    r = prec.dec
    rate = model["dropout"] if train else 0.0
    x, pad = embed_labels(p, labels, lens, model)
    if model["decoder_type"] == "rnn":
        return lstm(r, p, x, model["dec_layers"], rate, gen)
    return conv_transformer_lm(r, p, x, pad, model, rate, gen)


def joint_factors(p, enc, dec, prec: Precision = FLOAT32):
    """(ax, gx) over the frames and (ay, gy) over the label positions."""
    r = prec.dec
    return (linear(r, enc, p, "fc1_x", bias=False), linear(r, enc, p, "gate_x", bias=False),
            linear(r, dec, p, "fc1_y"), linear(r, dec, p, "gate_y"))


def joint_logits(p, ax, gx, ay, gy, prec: Precision = FLOAT32):
    """Logits of aligned factor pairs: tanh(ax + ay) * sigmoid(gx + gy)
    through fc2."""
    return linear(prec.dec, torch.tanh(ax + ay) * torch.sigmoid(gx + gy), p, "fc2")
