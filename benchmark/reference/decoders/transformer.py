"""The conv-transformer prediction net (pika's ``transformer`` decoder,
``trainer/model/rnnt_conv_transformer_lm.py``): per layer a causal
convolution of kernel ``dec_kernel`` (left-padded) with ReLU and a
transformer layer of ``dec_d_model`` under the causal and key-padding
masks; then LayerNorm and the map to the joint's width.  Dropout of
``dropout`` in the transformer layers, a mask per head."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.model import FLOAT32, Precision, layer_norm, linear, transformer_layer

KEYS = ("dec_layers", "dec_heads", "dec_d_model", "dec_d_ff", "dec_kernel", "embd_dim", "dropout")
TINY = {"dec_d_model": 16, "dec_heads": 4, "dec_d_ff": 32}


def flops(shapes: dict, model: dict) -> float:
    """Per layer over the U+1 label positions: the causal convolution, the
    attention's four projections, its scores and context, the FFN; then the
    map to the joint's width."""
    u1, d, k = shapes["u1"], model["dec_d_model"], model["dec_kernel"]
    fwd = 0.0
    for i in range(model["dec_layers"]):
        fwd += 2 * u1 * k * (model["embd_dim"] if i == 0 else d) * d
        fwd += 2 * 4 * u1 * d * d + 2 * 2 * u1 * u1 * d + 2 * 2 * u1 * d * model["dec_d_ff"]
    return fwd + 2 * u1 * d * model["hid_dim"]


def conv_transformer_lm(r, p, x, pad, model: dict, rate: float = 0.0, gen=None):
    """Causal conv (the weights' kernel, left-padded) + ReLU + transformer layer under
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


def forward(p, x, pad, model: dict, prec: Precision = FLOAT32, train: bool = False, gen=None):
    """(B, U+1, E) embedded labels, (B, U+1) padding positions ->
    (B, U+1, hid_dim).  The weights' kernel has to be the configuration's
    ``dec_kernel``, which the program takes from its own default."""
    kernel = p["decoder.conv_0.weight"].shape[-1]
    if kernel != model["dec_kernel"]:
        raise ValueError(f"the prediction net's convolutions have kernel {kernel}; "
                         f"the configuration states dec_kernel {model['dec_kernel']}")
    rate = model["dropout"] if train else 0.0
    return conv_transformer_lm(prec.dec, p, x, pad, model, rate, gen)
