"""Unidirectional multi-layer LSTM and its incremental step
(port of the prediction-net path of ``pika_tpu/models/lstm.py``).

Gate order is torch's (i, f, g, o) with one fused bias per layer, as in the
JAX package, so converted weights drop straight in.  The sequence pass
mirrors ``_scan_direction``: the input projection of the whole sequence is
one matmul, and only ``h @ Whh`` runs per step.  In train mode, dropout of
``dropout`` acts between layers, never after the last one, with masks
drawn from the generator passed to ``forward``.  The bidirectional encoder
LSTM with ``lengths`` masking is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pika_tpu_torch.models.transformer import dropout as _dropout


def lstm_cell_step(w_ih, w_hh, b, x, h, c):
    """One LSTM cell step: x (B, D), h/c (B, H) -> (h', c').  Weights are
    (4H, D) and (4H, H), torch layout."""
    z = F.linear(x, w_ih) + F.linear(h, w_hh) + b
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


class LSTM(nn.Module):
    """Multi-layer unidirectional LSTM over (B, T, D) inputs.

    Parameters per layer k: ``weight_ih_l{k}`` (4H, in), ``weight_hh_l{k}``
    (4H, H) and the fused ``bias_l{k}`` (4H,).  Runs from a zero state and
    returns ``(outputs, (h, c))`` with outputs (B, T, H) and h/c
    (num_layers, B, H).  ``dropout`` applies between layers in train mode.
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        for k in range(num_layers):
            in_dim = input_size if k == 0 else hidden_size
            self.register_parameter(
                f"weight_ih_l{k}", nn.Parameter(torch.empty(4 * hidden_size, in_dim, device=device)))
            self.register_parameter(
                f"weight_hh_l{k}", nn.Parameter(torch.empty(4 * hidden_size, hidden_size, device=device)))
            self.register_parameter(
                f"bias_l{k}", nn.Parameter(torch.empty(4 * hidden_size, device=device)))

    def layer_params(self, k: int):
        return (getattr(self, f"weight_ih_l{k}"), getattr(self, f"weight_hh_l{k}"),
                getattr(self, f"bias_l{k}"))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        b, t, _ = x.shape
        final_h, final_c = [], []
        out = x
        for k in range(self.num_layers):
            w_ih, w_hh, bias = self.layer_params(k)
            h = c = x.new_zeros(b, self.hidden_size)
            x_proj = F.linear(out, w_ih, bias)  # hoisted input projection (B, T, 4H)
            ys = []
            for step in range(t):
                i, f, g, o = (x_proj[:, step] + F.linear(h, w_hh)).chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                ys.append(h)
            out = torch.stack(ys, dim=1)
            if self.training and k < self.num_layers - 1:
                out = _dropout(out, self.dropout, generator)
            final_h.append(h)
            final_c.append(c)
        return out, (torch.stack(final_h), torch.stack(final_c))


def lstm_stack_step(lstm: LSTM, x, h, c):
    """Incremental one-token step through ``lstm``: x (B, D), h/c
    (num_layers, B, H) -> (top_h, new_h, new_c)."""
    new_h, new_c = [], []
    inp = x
    for k in range(lstm.num_layers):
        h_k, c_k = lstm_cell_step(*lstm.layer_params(k), inp, h[k], c[k])
        new_h.append(h_k)
        new_c.append(c_k)
        inp = h_k
    return inp, torch.stack(new_h), torch.stack(new_c)
