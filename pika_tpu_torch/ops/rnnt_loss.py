"""RNN-T loss, forward only (port of ``pika_tpu/ops/rnnt_loss.py``).

DP convention (blank = 0):
    alpha[t, u] = logaddexp(alpha[t-1, u] + blank(t-1, u),
                            alpha[t, u-1] + emit(t, u-1))
    loss_b      = -(alpha[T_b-1, U_b] + blank(T_b-1, U_b))

The backward (``rnnt_beta``, ``rnnt_occupancy`` and the K2/K3 kernels) is not
ported yet: ``rnnt_loss_forward`` runs in inference mode, so its result
carries no autograd graph and any backward through it raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pika_tpu_torch.ops.rnnt_kernels import joint_channels, joint_channels_reference

NEG = -1e30


def rnnt_loss_numpy(log_probs: np.ndarray, labels: np.ndarray, t_len: np.ndarray,
                    u_len: np.ndarray) -> np.ndarray:
    """Literal per-element DP over a (B, T, U+1, V) log-prob lattice; the
    test oracle (copy of ``pika_tpu.ops.rnnt_loss.rnnt_loss_numpy``)."""
    b = log_probs.shape[0]
    losses = np.zeros(b, dtype=np.float64)
    for i in range(b):
        t_i, u_i = int(t_len[i]), int(u_len[i])
        lp = log_probs[i].astype(np.float64)
        alpha = np.full((t_i, u_i + 1), -np.inf)
        alpha[0, 0] = 0.0
        for t in range(t_i):
            for u in range(u_i + 1):
                cands = []
                if t > 0:
                    cands.append(alpha[t - 1, u] + lp[t - 1, u, 0])
                if u > 0:
                    cands.append(alpha[t, u - 1] + lp[t, u - 1, labels[i, u - 1]])
                if cands:
                    alpha[t, u] = np.logaddexp.reduce(cands)
        losses[i] = -(alpha[t_i - 1, u_i] + lp[t_i - 1, u_i, 0])
    return losses


def _row_update(alpha_prev, blank_prev, emit_row):
    """alpha[t, :] from alpha[t-1, :] in closed form: the recurrence
    x_u = logaddexp(f_u, x_{u-1} + g_{u-1}) with f = alpha_prev + blank_prev
    and g = emit_row has the solution x = G + logcumsumexp(f - G), where
    G_u = sum_{j<u} g_j."""
    f = alpha_prev + blank_prev
    big_g = torch.cumsum(torch.nn.functional.pad(emit_row[..., :-1], (1, 0)), dim=-1)
    return big_g + torch.logcumsumexp(f - big_g, dim=-1)


def rnnt_alpha(blank_lp: torch.Tensor, emit_lp: torch.Tensor, u_len: torch.Tensor) -> torch.Tensor:
    """Forward DP.  blank_lp, emit_lp: (B, T, U+1), where emit_lp[..., u] is
    the log-prob of emitting label u+1 (columns u >= u_len are masked).
    Returns alpha (B, T, U+1)."""
    u1 = blank_lp.shape[2]
    u_pos = torch.arange(u1, device=blank_lp.device)[None, :]
    emit_lp = torch.where(u_pos[:, None, :] < u_len[:, None, None], emit_lp, NEG)
    alpha = torch.cumsum(torch.nn.functional.pad(emit_lp[:, 0, :-1], (1, 0)), dim=-1)
    alpha = torch.where(u_pos <= u_len[:, None], alpha, NEG)
    rows = [alpha]
    for t in range(1, blank_lp.shape[1]):
        alpha = torch.clamp(_row_update(alpha, blank_lp[:, t - 1], emit_lp[:, t]), min=NEG)
        rows.append(alpha)
    return torch.stack(rows, dim=1)


@torch.inference_mode()
def rnnt_loss_forward(ax, gx, ay, gy, w2, b2, labels, t_len, u_len,
                      chunk: int = 32, backend: str = "auto") -> torch.Tensor:
    """Per-utterance RNN-T loss (B,) from the factorized joint.

    ax, gx: (B, T, H); ay, gy: (B, U+1, H); w2: (H, V); b2: (V,);
    labels: (B, U); t_len, u_len: (B,).  ``backend``: "auto" takes K1
    (``joint_channels``: the kernel on CUDA tensors, its plain version on
    CPU tensors); "plain" always takes ``joint_channels_reference`` over
    T chunks of ``chunk`` frames.  Utterances with ``t_len <= 0`` get a loss
    of exactly 0.
    """
    b = labels.shape[0]
    labels_ext = torch.nn.functional.pad(labels, (0, 1)).clamp(0, w2.shape[1] - 1)
    labels_ext = labels_ext.to(torch.int32).contiguous()
    if backend == "auto":
        lse, zb, zy = joint_channels(ax, gx, ay, gy, w2, b2, labels_ext)
    elif backend == "plain":
        lse, zb, zy = joint_channels_reference(ax, gx, ay, gy, w2, b2, labels_ext, chunk)
    else:
        raise ValueError(f"unknown loss backend {backend!r}")
    blank_lp = zb - lse
    alpha = rnnt_alpha(blank_lp, zy - lse, u_len)
    bi = torch.arange(b, device=alpha.device)
    tl = torch.clamp(t_len, min=1).long() - 1
    ul = u_len.long()
    loss = -(alpha[bi, tl, ul] + blank_lp[bi, tl, ul])
    return torch.where(t_len > 0, loss, torch.zeros_like(loss))
