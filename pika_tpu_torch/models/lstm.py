"""Multi-layer LSTM, optionally bidirectional with ``lengths`` masking, and
its incremental step (port of ``pika_tpu/models/lstm.py``).

Gate order is torch's (i, f, g, o) with one fused bias per layer and
direction, as in the JAX package, so converted weights drop straight in.
The sequence pass mirrors ``_scan_direction``: the input projection of the
whole sequence is one matmul, and only ``h @ Whh`` runs per step.  With
``lengths`` the carry is frozen past each sequence's length and the
outputs there are 0 (the reference's packed sequences); the backward
direction reverses each sequence within its length.  In train mode,
dropout of ``dropout`` acts between layers, never after the last one, with
masks drawn from the generator passed to ``forward``.  The prediction net
runs it unidirectional and unmasked; the transducer's rnn encoder, the LAS
encoder and downsampler masked, bidirectional where configured.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def reverse_padded(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Reverse each (B, T, ...) sequence within its length; padding stays
    put."""
    if lengths is None:
        return x.flip(1)
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    lengths = lengths.long()[:, None]
    rev = torch.where(idx < lengths, lengths - 1 - idx, idx)
    return x.gather(1, rev.reshape(rev.shape + (1,) * (x.dim() - 2)).expand(x.shape))


class LSTM(nn.Module):
    """Multi-layer LSTM over (B, T, D) inputs.

    Parameters per layer k: ``weight_ih_l{k}`` (4H, in), ``weight_hh_l{k}``
    (4H, H) and the fused ``bias_l{k}`` (4H,), and the same with the suffix
    ``_reverse`` for the backward direction.  ``hidden_size`` is the output
    width: each direction of a bidirectional LSTM has half of it.  Returns
    ``(outputs, (h, c))`` with outputs (B, T, hidden_size) and h/c stacked
    (num_layers * num_directions, B, H_dir), torch layout.
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 dropout: float = 0.0, bidirectional: bool = False, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.dirs = 2 if bidirectional else 1
        self.hidden_size = hidden_size // self.dirs  # per direction
        h = self.hidden_size
        for k in range(num_layers):
            in_dim = input_size if k == 0 else h * self.dirs
            for suffix in ("", "_reverse")[:self.dirs]:
                self.register_parameter(
                    f"weight_ih_l{k}{suffix}", nn.Parameter(torch.empty(4 * h, in_dim, device=device)))
                self.register_parameter(
                    f"weight_hh_l{k}{suffix}", nn.Parameter(torch.empty(4 * h, h, device=device)))
                self.register_parameter(
                    f"bias_l{k}{suffix}", nn.Parameter(torch.empty(4 * h, device=device)))

    def layer_params(self, k: int, direction: int = 0):
        suffix = "_reverse" if direction else ""
        return (getattr(self, f"weight_ih_l{k}{suffix}"), getattr(self, f"weight_hh_l{k}{suffix}"),
                getattr(self, f"bias_l{k}{suffix}"))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                lengths: Optional[torch.Tensor] = None,
                initial_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        b, t, _ = x.shape
        mask = None
        if lengths is not None:
            mask = (torch.arange(t, device=x.device)[None, :] < lengths[:, None])[..., None]
        final_h, final_c = [], []
        out = x
        for k in range(self.num_layers):
            outs = []
            for d in range(self.dirs):
                w_ih, w_hh, bias = self.layer_params(k, d)
                if initial_state is not None:
                    h, c = initial_state[0][k * self.dirs + d], initial_state[1][k * self.dirs + d]
                else:
                    h = c = x.new_zeros(b, self.hidden_size)
                seq = out if d == 0 else reverse_padded(out, lengths)
                x_proj = F.linear(seq, w_ih, bias)  # hoisted input projection (B, T, 4H)
                ys = []
                for step in range(t):
                    i, f, g, o = (x_proj[:, step] + F.linear(h, w_hh)).chunk(4, dim=-1)
                    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                    h_new = torch.sigmoid(o) * torch.tanh(c_new)
                    if mask is None:
                        h, c = h_new, c_new
                        ys.append(h)
                    else:
                        keep = mask[:, step]
                        h, c = torch.where(keep, h_new, h), torch.where(keep, c_new, c)
                        ys.append(torch.where(keep, h_new, 0.0))
                y = torch.stack(ys, dim=1)
                outs.append(y if d == 0 else reverse_padded(y, lengths))
                final_h.append(h)
                final_c.append(c)
            out = outs[0] if self.dirs == 1 else torch.cat(outs, dim=-1)
            if self.training and k < self.num_layers - 1:
                out = _dropout(out, self.dropout, generator)
        return out, (torch.stack(final_h), torch.stack(final_c))


def lstm_stack_step(lstm: LSTM, x, h, c):
    """Incremental one-token step through a unidirectional ``lstm``: x
    (B, D), h/c (num_layers, B, H) -> (top_h, new_h, new_c)."""
    new_h, new_c = [], []
    inp = x
    for k in range(lstm.num_layers):
        h_k, c_k = lstm_cell_step(*lstm.layer_params(k), inp, h[k], c[k])
        new_h.append(h_k)
        new_c.append(c_k)
        inp = h_k
    return inp, torch.stack(new_h), torch.stack(new_c)
