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
(``LSTMPredictionNet``) runs it unidirectional and unmasked; the
transducer's rnn encoder (``RNNEncoder``), the LAS encoder and downsampler
masked, bidirectional where configured.

On a CUDA tensor ``forward`` runs each layer as one fused call of ATen's
LSTM (cuDNN for float32; ``forward_fused``): both directions of a layer in
the call, ragged batches as a packed sequence, the fused bias as ``b_ih``
and zeros as ``b_hh``, one layer per call so that dropout between layers
still draws from the passed generator.  Its float32 products, forward and
backward, take the precision of the loop's matmuls
(``torch.backends.cuda.matmul.allow_tf32``, off by default) and not
cuDNN's own TF32 flag (on by default).  The loop over
frames (``forward_loop``) is the plain version and the CPU path.  Neither is
reached inside a captured decode loop: the searches step the prediction
net through ``lstm_stack_step``.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence, pad_packed_sequence

from pika_tpu_torch.models.transformer import dropout as _dropout


@contextlib.contextmanager
def _aten_lstm_settings():
    """cuDNN's TF32 flag set to the matmuls' for the body, and the warning
    that a layer's separate parameters are copied into one buffer each call
    (a layer's weights, a few hundred KiB: by design) silenced there."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="RNN module weights are not part of single")
            yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _vf_lstm(batch_sizes, train: bool, bidirectional: bool, x, h0, c0, *weights):
    """One layer of ``torch._VF.lstm``, the fused bias as ``b_ih`` (the
    weights come as w_ih, w_hh, b_ih, b_hh per direction), batch-first when
    ``batch_sizes`` is None, else over a packed sequence's data."""
    if batch_sizes is None:
        return torch._VF.lstm(x, (h0, c0), weights, True, 1, 0.0, train, bidirectional, True)
    return torch._VF.lstm(x, batch_sizes, (h0, c0), weights, True, 1, 0.0, train, bidirectional)


class _AtenLSTM(torch.autograd.Function):
    """``_vf_lstm`` under ``_aten_lstm_settings`` in its forward and its
    backward alike: cuDNN reads its TF32 flag again when it builds the
    backward, so the forward keeps its own graph and the backward takes
    its gradients under the same settings."""

    @staticmethod
    def forward(ctx, batch_sizes, bidirectional, x, *params):
        ctx.leaves = [p.detach().requires_grad_(p.requires_grad) for p in (x, *params)]
        with torch.enable_grad(), _aten_lstm_settings():
            ctx.outs = _vf_lstm(batch_sizes, True, bidirectional, *ctx.leaves)
        return tuple(o.detach() for o in ctx.outs)

    @staticmethod
    def backward(ctx, *grads):
        leaves, outs = ctx.leaves, ctx.outs
        ctx.leaves = ctx.outs = None  # the inner graph goes with this backward, as any graph does
        wanted = [p for p in leaves if p.requires_grad]
        with _aten_lstm_settings():
            got = iter(torch.autograd.grad(outs, wanted, grads))
        return None, None, *(next(got) if p.requires_grad else None for p in leaves)


def aten_lstm(batch_sizes, bidirectional: bool, x, h0, c0, weights):
    """One layer of ATen's LSTM (cuDNN's on the card for float32) at the
    matmuls' precision; differentiable when autograd records."""
    params = (h0, c0, *weights)
    if torch.is_grad_enabled() and any(p.requires_grad for p in (x, *params)):
        return _AtenLSTM.apply(batch_sizes, bidirectional, x, *params)
    with _aten_lstm_settings():
        return _vf_lstm(batch_sizes, False, bidirectional, x, *params)


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
        run = self.forward_fused if x.is_cuda else self.forward_loop
        return run(x, generator, lengths, initial_state)

    def _initial(self, x: torch.Tensor, k: int, initial_state):
        """Layer ``k``'s (h0, c0), each (dirs, B, H)."""
        if initial_state is not None:
            return tuple(s[k * self.dirs:(k + 1) * self.dirs] for s in initial_state)
        zeros = x.new_zeros(self.dirs, x.shape[0], self.hidden_size)
        return zeros, zeros

    def forward_fused(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                      lengths: Optional[torch.Tensor] = None,
                      initial_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """``forward_loop``'s function with one ATen LSTM call per layer (on
        the card cuDNN's for float32, on the CPU ATen's own).  A row of
        length 0, which a packed sequence cannot hold, is packed at length 1
        and then given the loop's result: zero outputs and its initial
        state."""
        b, t, _ = x.shape
        if lengths is not None:
            host = lengths.detach().to("cpu", torch.int64)
            keep = (torch.arange(t)[None, :] < host[:, None]).to(x.device)[..., None]
            empty = (host == 0).to(x.device)[None, :, None]
            packed_lengths = host.clamp(min=1)
        final_h, final_c = [], []
        out = x
        for k in range(self.num_layers):
            weights = []
            for d in range(self.dirs):
                w_ih, w_hh, bias = self.layer_params(k, d)
                weights += [w_ih, w_hh, bias, torch.zeros_like(bias)]
            h0, c0 = self._initial(x, k, initial_state)
            if lengths is None:
                out, h, c = aten_lstm(None, self.dirs == 2, out, h0, c0, weights)
            else:
                packed = pack_padded_sequence(out, packed_lengths, batch_first=True,
                                              enforce_sorted=False)
                order = packed.sorted_indices
                data, h, c = aten_lstm(packed.batch_sizes, self.dirs == 2, packed.data,
                                       h0.index_select(1, order), c0.index_select(1, order),
                                       weights)
                out = pad_packed_sequence(
                    PackedSequence(data, packed.batch_sizes, order, packed.unsorted_indices),
                    batch_first=True, total_length=t)[0]
                out = torch.where(keep, out, 0.0)
                h = torch.where(empty, h0, h.index_select(1, packed.unsorted_indices))
                c = torch.where(empty, c0, c.index_select(1, packed.unsorted_indices))
            final_h.append(h)
            final_c.append(c)
            if self.training and k < self.num_layers - 1:
                out = _dropout(out, self.dropout, generator)
        return out, (torch.cat(final_h), torch.cat(final_c))

    def forward_loop(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                     lengths: Optional[torch.Tensor] = None,
                     initial_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """The plain version: the input projection of the whole sequence as
        one matmul, then one cell step per frame."""
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


class RNNEncoder(LSTM):
    """The transducer's ``rnn`` encoder: masked by ``x_len`` (outputs 0 past
    each length), no subsampling."""

    @classmethod
    def from_config(cls, cfg, device=None) -> "RNNEncoder":
        return cls(cfg.input_dim, cfg.hid_dim, cfg.enc_layers, cfg.dropout,
                   bidirectional=cfg.brnn, device=device)

    def forward(self, x: torch.Tensor, x_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return super().forward(x, generator, lengths=x_len)[0]

    @staticmethod
    def output_length(x_len):
        return x_len


class LSTMPredictionNet(LSTM):
    """The transducer's ``rnn`` prediction net: it carries (h, c) from token
    to token and steps by ``Transducer.predict_step``."""

    @classmethod
    def from_config(cls, cfg, device=None) -> "LSTMPredictionNet":
        return cls(cfg.embd_dim, cfg.hid_dim, cfg.dec_layers, cfg.dropout, device=device)

    def forward(self, emb: torch.Tensor, pad_positions: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``pad_positions`` goes unread: the LSTM is causal."""
        return super().forward(emb, generator)[0]

    def zero_state(self, lead: tuple, device, dtype) -> dict:
        shape = (self.num_layers, *lead, self.hidden_size)
        return {name: torch.zeros(shape, device=device, dtype=dtype) for name in ("dec_h", "dec_c")}

    def advance(self, model, tok, state, tokens, lens):
        hid, (h, c) = model.predict_step(tok, (state["dec_h"], state["dec_c"]))
        return hid, {"dec_h": h, "dec_c": c}
