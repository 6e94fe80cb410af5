"""The LSTM prediction net (pika's ``rnn`` decoder): ``dec_layers``
unidirectional LSTM layers of the joint's width over the embedded labels,
dropout of ``dropout`` between them."""

from __future__ import annotations

import torch

from benchmark.reference.model import FLOAT32, Precision, dropout

KEYS = ("dec_layers", "dropout")
TINY = {}


def flops(shapes: dict, model: dict) -> float:
    """``bench.py``'s term: per layer and label position, the four gates'
    input and recurrent products, the input taken at the LSTM's width."""
    return 2 * shapes["u1"] * model["dec_layers"] * 8 * model["hid_dim"] * model["hid_dim"]


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


def forward(p, x, pad, model: dict, prec: Precision = FLOAT32, train: bool = False, gen=None):
    """(B, U+1, E) embedded labels -> (B, U+1, hid_dim); ``pad`` unused: a
    position sees only those before it."""
    rate = model["dropout"] if train else 0.0
    return lstm(prec.dec, p, x, model["dec_layers"], rate, gen)
