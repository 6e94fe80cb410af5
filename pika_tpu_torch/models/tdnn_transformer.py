"""TDNN-Transformer transducer encoder
(port of ``pika_tpu/models/tdnn_transformer.py``).

fc_in -> ReLU -> BN, then ``tdnn_layers`` VALID dilated time convolutions
(dilations 1,1,1,3,...,3; stride 4 on the last), each followed by ReLU -> BN
and, after every 3rd, a transformer layer (heads 16/16/8); then bn_final and
fc_out.  Activations stay (B, T, C) at the module boundary; the convolutions
run in torch's (B, C, T) layout inside.  The encoder attends over padded
frames too (no mask), as the JAX encoder does.

BatchNorm follows flax's: in eval mode it uses the running statistics; in
train mode it normalizes with the batch mean and the *biased* batch
variance over (B, T) and updates ``ra = 0.9 ra + 0.1 stat`` with that same
biased variance (``torch.nn.BatchNorm1d`` would use the unbiased one).  The
transformer layers run with ``transformer_dropout`` in train mode, and
``attn_flash`` takes their attention core through K4 where the JAX layer
takes its flash kernel, ``attn_chunk`` computes it over query blocks and
``attn_cheap_dropout`` shares its probability mask across heads
(``models/transformer.py``).  ``remat`` recomputes each transformer layer
in the backward instead of keeping its activations, drawing the same
dropout masks again (``checkpoint_with_generator``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
from torch import nn

from pika_tpu_torch.models.transformer import TransformerEncoderLayer, checkpoint_with_generator

BN_MOMENTUM = 0.9  # flax's momentum: the share of the old running statistic
BN_EPS = 1e-5


def _conv_out_len(length, kernel: int, dilation: int, stride: int):
    extent = (kernel - 1) * dilation + 1
    return (length - extent) // stride + 1


def _bn(x: torch.Tensor, bn: nn.BatchNorm1d, group=None) -> torch.Tensor:
    """BatchNorm over the channel axis of a (B, T, C) tensor, as flax's
    ``nn.BatchNorm``; in train mode it also updates bn's running statistics
    in place.  In train mode the statistics and the normalization are
    computed in float32 and the result cast to x's dtype, as flax does for
    a bf16 input (the running statistics stay float32).  With a process
    ``group`` the train-mode moments are those of the batch of every rank
    (each holding the same (B, T)), all-reduced with autograd, as flax's
    over a batch sharded on the mesh."""
    if not bn.training:
        return bn(x.reshape(-1, x.shape[-1])).reshape(x.shape)
    flat = x.reshape(-1, x.shape[-1]).float()
    moments = torch.stack([flat.mean(dim=0), (flat * flat).mean(dim=0)])
    if group is not None:
        moments = dist_nn.all_reduce(moments, group=group) / dist.get_world_size(group)
    mean, mean_sq = moments
    var = torch.clamp(mean_sq - mean * mean, min=0.0)  # flax's fast variance
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var)
    return ((x.float() - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias).to(x.dtype)


class TDNNTransformerEncoder(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, tdnn_nhid: int = 1024,
                 tdnn_layers: int = 9, filter_size: int = 3,
                 heads: Sequence[int] = (16, 16, 8), transformer_dropout: float = 0.2,
                 attn_flash: bool = False, attn_chunk: int = 0, attn_cheap_dropout: bool = False,
                 remat: bool = False, device=None):
        super().__init__()
        if tdnn_layers <= 4:
            raise ValueError("tdnn_layers must be > 4")
        self.tdnn_layers = tdnn_layers
        self.remat = remat
        self.moments_group = None  # parallel/dp.py:global_batch_norm
        self.filter_size = filter_size
        nhid = tdnn_nhid
        self.fc_in = nn.Linear(input_dim, nhid, device=device)
        self.bn_in = nn.BatchNorm1d(nhid, eps=BN_EPS, device=device)
        dil, stride = self._dilations_strides()
        n_transformers = 0
        for l, (d, s) in enumerate(zip(dil, stride)):
            self.add_module(f"conv_{l}", nn.Conv1d(nhid, nhid, filter_size, stride=s,
                                                   dilation=d, device=device))
            self.add_module(f"bn_{l}", nn.BatchNorm1d(nhid, eps=BN_EPS, device=device))
            if (l + 1) % 3 == 0 and n_transformers < len(heads):
                self.add_module(f"transformer_{n_transformers}", TransformerEncoderLayer(
                    nhid, heads[n_transformers], nhid * 4, transformer_dropout, attn_flash,
                    attn_chunk, attn_cheap_dropout, device=device))
                n_transformers += 1
        self.n_transformers = n_transformers
        self.bn_final = nn.BatchNorm1d(nhid, eps=BN_EPS, device=device)
        self.fc_out = nn.Linear(nhid, output_dim, device=device)

    @classmethod
    def from_config(cls, cfg, device=None) -> "TDNNTransformerEncoder":
        return cls(cfg.input_dim, cfg.hid_dim, cfg.tdnn_nhid, cfg.tdnn_layers,
                   transformer_dropout=cfg.tdnn_transformer_dropout, attn_flash=cfg.attn_flash,
                   attn_chunk=cfg.attn_chunk, attn_cheap_dropout=cfg.attn_cheap_dropout,
                   remat=cfg.remat, device=device)

    def _dilations_strides(self):
        dil = [1] * 3 + [3] * (self.tdnn_layers - 4) + [3]
        stride = [1] * (self.tdnn_layers - 1) + [4]
        return dil, stride

    def output_length(self, in_len):
        """Output frame count given input frames (ints or tensors)."""
        dil, stride = self._dilations_strides()
        out = in_len
        for d, s in zip(dil, stride):
            out = _conv_out_len(out, self.filter_size, d, s)
        return out

    @property
    def context(self) -> int:
        """Context frames the convolutions consume: model_lctx + model_rctx."""
        dil, _ = self._dilations_strides()
        return sum(2 * d for d in dil)

    def forward(self, x: torch.Tensor, x_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, input_dim) -> (B, T', output_dim); dropout masks in train
        mode come from ``generator``.  ``x_len`` goes unread: the encoder
        sees the padded frames, as the JAX encoder does."""
        g = self.moments_group
        x = _bn(torch.relu(self.fc_in(x)), self.bn_in, g)
        t_layer = 0
        for l in range(self.tdnn_layers):
            conv = getattr(self, f"conv_{l}")
            x = torch.relu(conv(x.transpose(1, 2))).transpose(1, 2)
            x = _bn(x, getattr(self, f"bn_{l}"), g)
            if (l + 1) % 3 == 0 and t_layer < self.n_transformers:
                layer = getattr(self, f"transformer_{t_layer}")
                if self.remat:
                    x = checkpoint_with_generator(lambda y, g, layer=layer: layer(y, generator=g),
                                                  generator, x)
                else:
                    x = layer(x, generator=generator)
                t_layer += 1
        return self.fc_out(_bn(x, self.bn_final, g))
