"""Convolutional-transformer prediction network, the transducer's second
decoder (port of ``pika_tpu/models/conv_transformer_lm.py``).

Per layer a causal Conv1d (kernel 5, left-padded by k-1 so that position u
sees only positions <= u) and a ReLU, then a transformer layer under the
causal mask joined with the key padding mask; a final LayerNorm and a
linear map to the joint's width.  The module names are the flax ones
(``conv_{i}``, ``transformer_{i}``, ``layer_norm``, ``linear_out``), so
``convert.py`` maps a JAX decoder onto it.  The embedding belongs to the
``Transducer``, which passes embedded tokens in.

In train mode the transformer layers drop out with ``dropout_rate``,
drawing their masks from the generator passed to ``forward``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pika_tpu_torch.models.transformer import LN_EPS, TransformerEncoderLayer, causal_mask


class ConvTransformerLM(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, d_model: int = 512,
                 num_layers: int = 2, heads: int = 8, d_ff: int = 2048,
                 dropout_rate: float = 0.1, kernel_size: int = 5,
                 max_relative_positions: int = 0, device=None):
        super().__init__()
        self.num_layers, self.kernel_size = num_layers, kernel_size
        for i in range(num_layers):
            setattr(self, f"conv_{i}", nn.Conv1d(input_dim if i == 0 else d_model, d_model,
                                                 kernel_size, device=device))
            setattr(self, f"transformer_{i}", TransformerEncoderLayer(
                d_model, heads, d_ff, dropout_rate,
                max_relative_positions=max_relative_positions, device=device))
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.linear_out = nn.Linear(d_model, output_dim, device=device)

    @classmethod
    def from_config(cls, cfg, device=None) -> "ConvTransformerLM":
        return cls(cfg.embd_dim, cfg.hid_dim, d_model=cfg.dec_d_model, num_layers=cfg.dec_layers,
                   heads=cfg.dec_heads, d_ff=cfg.dec_d_ff, dropout_rate=cfg.dropout, device=device)

    def forward(self, emb: torch.Tensor, pad_positions: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """emb (B, U, E) embedded tokens; pad_positions (B, U) bool, True at
        padding -> (B, U, output_dim)."""
        b, u, _ = emb.shape
        mask = causal_mask(u, emb.device).expand(b, u, u)
        if pad_positions is not None:
            mask = mask | pad_positions[:, None, :]
        out = emb
        for i in range(self.num_layers):
            # causal conv: left-pad k-1 over time, no padding in the conv
            conv = getattr(self, f"conv_{i}")
            padded = nn.functional.pad(out.transpose(1, 2), (self.kernel_size - 1, 0))
            out = torch.relu(conv(padded).transpose(1, 2))
            out = getattr(self, f"transformer_{i}")(out, mask=mask, generator=generator)
        return self.linear_out(self.layer_norm(out))

    def zero_state(self, lead: tuple, device, dtype) -> dict:
        return {}

    def advance(self, model, tok, state, tokens, lens):
        """The output after each row's whole prefix.  A dead beam may take
        a token past a full buffer (lens = Um + 1): its prefix ends at the
        buffer's end (the JAX gather fills NaN there)."""
        return model.predict_last(tokens.clamp(min=0), lens.clamp(max=tokens.shape[1])), {}
