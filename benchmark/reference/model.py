"""The transducer's forward pass in plain PyTorch over a dict of weights,
as pika's papers and recipes describe it (tencent-ailab/pika
``trainer/model``).  This file holds what the model parts share: the
products, the norms, dropout, the transformer layer, the label embedding
and the gated joint.  Each encoder and prediction net is a part of its
own, found by the configuration's ``encoder_type`` and ``decoder_type``:
``encoders/<encoder_type>.py`` and ``decoders/<decoder_type>.py``.

A part defines ``forward`` (its float32 reference, through ``Precision``,
with its train-mode draws), ``KEYS`` (the ``model`` keys it reads),
``TINY`` (its sizes in the CPU tests' tree) and ``flops(shapes, model)``
(its own forward matmul operations for one utterance, which
``counts.train_step_flops`` adds to the joint's); an encoder part also
``shapes(frames, model)``, the cell-shape keys it owns (its output frames
``t_enc``, ...).

Every product goes through ``Precision``: float32 by default (the
reference), or with its operands rounded to a lower precision (the
control).  The reference's entries (``train.train_steps``,
``decode.encode``, ``decode.alignment_scores``) run under
``exact_float32``: the TF32 flags the harness sets for the program do
not reach the reference's float32 products.  In train mode the random
numbers are drawn from a passed ``torch.Generator`` in this order, which
is the order of the program's draws: the encoder's, then the prediction
net's, each part's in its own order; a transformer layer draws the
attention's keep-mask, then the masks after the attention's output
projection, after the FFN's ReLU and after its second linear layer.
Weights are keyed by the names of the program's checkpoints
(``encoder.conv_0.weight``, ...).
"""

from __future__ import annotations

import contextlib
import importlib
import math
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LN_EPS = 1e-6
HERE = Path(__file__).resolve().parent
# the model keys read here, whatever the parts
KEYS = ("encoder_type", "decoder_type", "vocab_size", "hid_dim")


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
    """How the products of the encoder (``enc``), of the prediction net
    (``dec``) and of the joint (``joint``, by default as ``dec``) round
    their operands before a float32 product."""

    def __init__(self, enc: str = "float32", dec: str = "float32", joint: Optional[str] = None):
        self.enc, self.dec, self.joint = ROUND[enc], ROUND[dec], ROUND[joint or dec]


FLOAT32 = Precision()


@contextlib.contextmanager
def exact_float32():
    """cuDNN's and the matmuls' TF32 off inside, as they were after: the
    harness sets them for the program (``program.set_precision``)."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


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


def part(kind: str, name: str):
    """The model part ``<kind>/<name>.py`` (``kind``: ``encoders`` or
    ``decoders``), imported as a module of this package."""
    module = f"{__package__}.{kind}.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise LookupError(f"no reference part for {kind[:-1]} {name!r}: "
                          f"looked for {HERE / kind / (name + '.py')}") from None


def parts(model: dict) -> tuple:
    """(encoder part, prediction-net part) of a configuration's model."""
    return part("encoders", model["encoder_type"]), part("decoders", model["decoder_type"])


def keys(model: dict) -> set:
    """The model keys the reference reads for this configuration."""
    enc, dec = parts(model)
    return set(KEYS) | set(enc.KEYS) | set(dec.KEYS)


def encoder(p, x, model: dict, prec: Precision = FLOAT32, train: bool = False, gen=None):
    """(B, T, input_dim) features -> (B, T', hid_dim), by the encoder part."""
    return part("encoders", model["encoder_type"]).forward(p, x, model, prec, train, gen)


def embed_labels(p, labels, lens, model: dict):
    """[SOS = blank = 0, labels...] embedded; positions past each length take
    the padding row (the last).  Returns (embedded (B, U+1, E), padding
    positions (B, U+1))."""
    pad_id = model["vocab_size"]
    y = F.pad(labels.long(), (1, 0))
    pad = torch.arange(y.shape[1], device=y.device)[None, :] > lens[:, None]
    y = torch.where(pad, pad_id, y.clamp(0, pad_id))
    return p["embed.weight"][y], pad


def predict(p, labels, lens, model: dict, prec: Precision = FLOAT32, train: bool = False,
            gen=None):
    """(B, U) labels with lengths -> (B, U+1, hid_dim) prediction-net
    outputs, SOS first, by the prediction-net part."""
    x, pad = embed_labels(p, labels, lens, model)
    return part("decoders", model["decoder_type"]).forward(p, x, pad, model, prec, train, gen)


def joint_factors(p, enc, dec, prec: Precision = FLOAT32):
    """(ax, gx) over the frames and (ay, gy) over the label positions."""
    r = prec.joint
    return (linear(r, enc, p, "fc1_x", bias=False), linear(r, enc, p, "gate_x", bias=False),
            linear(r, dec, p, "fc1_y"), linear(r, dec, p, "gate_y"))


def joint_logits(p, ax, gx, ay, gy, prec: Precision = FLOAT32):
    """Logits of aligned factor pairs: tanh(ax + ay) * sigmoid(gx + gy)
    through fc2."""
    return linear(prec.joint, torch.tanh(ax + ay) * torch.sigmoid(gx + gy), p, "fc2")
