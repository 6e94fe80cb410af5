"""The TDNN-Transformer encoder (pika's ``tdnn_transformer``): a dense
layer with ReLU and BatchNorm, then ``tdnn_layers`` VALID convolutions of
kernel 3 (dilations 1, 1, 1, 3, ..., 3, the last with stride 4), each with
ReLU and BatchNorm, a transformer layer after every third while
``encoder_heads`` lasts, a final BatchNorm and the map to the joint's
width.  Dropout of ``tdnn_transformer_dropout`` in the transformer layers,
on the probabilities shared across heads with ``attn_cheap_dropout``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark import counts
from benchmark.reference.model import FLOAT32, Precision, batch_norm, linear, transformer_layer

KEYS = ("tdnn_layers", "tdnn_nhid", "encoder_heads", "tdnn_transformer_dropout",
        "attn_cheap_dropout")
TINY = {"tdnn_nhid": 32}


def shapes(frames: int, model: dict) -> dict:
    """The output frames of ``frames`` input frames, and the layers' width."""
    return {"t_enc": counts.encoder_frames(frames, model["tdnn_layers"]),
            "nhid": model["tdnn_nhid"]}


def flops(shapes: dict, model: dict) -> float:
    """The forward matmul operations of one utterance, ``bench.py``'s
    terms: nine kernel-3 layers, the first from the input features, over
    the input frames (the last, of stride 4, over a quarter; the VALID
    edges not taken off), and the transformer layers over the frames they
    see."""
    t, nhid = shapes["frames"], shapes["nhid"]
    t4 = t // 4
    fwd = 2 * 3 * model["input_dim"] * nhid * t
    fwd += 2 * 3 * nhid * nhid * (7 * t + t4)
    for tl in (t, t, t4):
        fwd += 2 * 4 * tl * nhid * nhid          # q, k, v, o
        fwd += 2 * 2 * tl * tl * nhid            # scores and context
        fwd += 2 * 2 * tl * nhid * (4 * nhid)    # FFN
    return fwd


def tdnn_schedule(layers: int):
    """(dilation, stride) of each TDNN layer: 1, 1, 1, 3, ..., 3, the last
    with stride 4."""
    return [(1 if l < 3 else 3, 4 if l == layers - 1 else 1) for l in range(layers)]


def forward(p, x, model: dict, prec: Precision = FLOAT32, train: bool = False, gen=None):
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
