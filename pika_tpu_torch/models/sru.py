"""SRU, "Training RNNs as Fast as CNNs" (port of ``pika_tpu/models/sru.py``).

The recurrence is diagonal and linear in c:

    c_t = g1_t * c_{t-1} + (1 - g1_t) * u0_t
    h_t = (act(c_t) - x'_t) * g2_t + x'_t

so the time dependency is a scan over affine pairs (a, b) with the
composition ``(a_l, b_l) then (a_r, b_r) = (a_l a_r, b_l a_r + b_r)``: here a
Hillis-Steele scan of log2(T) vectorised steps, where the JAX package uses
``associative_scan``.  Everything else (the projections, gates, highway) is
plain PyTorch; the JAX package has no kernel here either.

Layout is the JAX cell's: ``weight`` (n_in, k * n_out * dirs), with k = 4
when n_in differs from the output width (the fourth block is the highway
transform of x) and 3 otherwise, and ``bias`` (2 * n_out * dirs), the two
gate biases of each direction.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pika_tpu_torch.models.transformer import dropout as _dropout

_ACT = {"tanh": torch.tanh, "relu": torch.relu, "identity": lambda v: v}


def affine_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All c_t of c_t = a_t * c_{t-1} + b_t along dim 1, with c_{-1} = 0."""
    t, s = a.shape[1], 1
    while s < t:
        b = torch.cat([b[:, :s], b[:, s:] + a[:, s:] * b[:, :-s]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


class SRUCell(nn.Module):
    def __init__(self, n_in: int, n_out: int, bidirectional: bool = False,
                 activation: str = "tanh", dropout: float = 0.0, device=None):
        super().__init__()
        self.n_in, self.n_out = n_in, n_out
        self.dirs = 2 if bidirectional else 1
        self.k = 4 if n_in != n_out * self.dirs else 3
        self.act = _ACT[activation]
        self.dropout = dropout
        self.weight = nn.Parameter(torch.empty(n_in, n_out * self.k * self.dirs, device=device))
        self.bias = nn.Parameter(torch.empty(n_out * 2 * self.dirs, device=device))

    def forward(self, x: torch.Tensor, c0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """x (B, T, n_in) -> (h (B, T, n_out * dirs), c_last (B, n_out * dirs))."""
        b, t, _ = x.shape
        n, k = self.n_out, self.k
        u = x @ self.weight
        hs, c_lasts = [], []
        for d in range(self.dirs):
            ud = u[..., d * n * k:(d + 1) * n * k].reshape(b, t, n, k)
            u0 = ud[..., 0]
            g1 = torch.sigmoid(ud[..., 1] + self.bias[d * 2 * n:d * 2 * n + n])
            g2 = torch.sigmoid(ud[..., 2] + self.bias[d * 2 * n + n:(d + 1) * 2 * n])
            # k == 3 needs n_in == n_out * dirs: the highway input is the
            # direction's slice of x
            xp = ud[..., 3] if k == 4 else x[..., d * n:(d + 1) * n]
            if d == 1:
                u0, g1, g2, xp = (z.flip(1) for z in (u0, g1, g2, xp))
            bterm = (1.0 - g1) * u0
            if c0 is not None:
                bterm = torch.cat([bterm[:, :1] + g1[:, :1] * c0[:, None, d * n:(d + 1) * n],
                                   bterm[:, 1:]], dim=1)
            c = affine_scan(g1, bterm)
            val = self.act(c)
            if self.training:
                val = _dropout(val, self.dropout, generator)
            h = (val - xp) * g2 + xp
            c_lasts.append(c[:, -1])
            hs.append(h.flip(1) if d == 1 else h)
        return (hs[0] if self.dirs == 1 else torch.cat(hs, dim=-1)), torch.cat(c_lasts, dim=-1)


class SRU(nn.Module):
    """Multi-layer SRU; returns (outputs (B, T, hidden_size * dirs), the last
    c of every layer stacked (num_layers, B, hidden_size * dirs))."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 2,
                 bidirectional: bool = False, activation: str = "tanh", dropout: float = 0.0,
                 device=None):
        super().__init__()
        dirs = 2 if bidirectional else 1
        self.num_layers = num_layers
        for i in range(num_layers):
            n_in = input_size if i == 0 else hidden_size * dirs
            self.add_module(f"cell_{i}", SRUCell(n_in, hidden_size, bidirectional, activation,
                                                 dropout, device=device))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        c_finals = []
        for i in range(self.num_layers):
            x, c_last = getattr(self, f"cell_{i}")(x, generator=generator)
            c_finals.append(c_last)
        return x, torch.stack(c_finals)
