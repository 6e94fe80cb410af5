"""RNN-T loss over the factorized joint, with its backward
(port of ``pika_tpu/ops/rnnt_loss.py``).

DP convention (blank = 0):
    alpha[t, u] = logaddexp(alpha[t-1, u] + blank(t-1, u),
                            alpha[t, u-1] + emit(t, u-1))
    loss_b      = -(alpha[T_b-1, U_b] + blank(T_b-1, U_b))

``RNNTLossFused`` is the port of the ``custom_vjp`` of ``rnnt_loss_fused``:
its forward is K1 (``joint_channels``) plus ``rnnt_alpha``; its backward is
``rnnt_occupancy`` (``rnnt_beta`` plus the posterior of each lattice arc),
the channel cotangents, and K2/K3 (``joint_channels_bwd``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pika_tpu_torch.ops.rnnt_kernels import (
    joint_channels,
    joint_channels_bwd,
    joint_channels_bwd_reference,
    joint_channels_reference,
)

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
    big_g = torch.cumsum(F.pad(emit_row[..., :-1], (1, 0)), dim=-1)
    return big_g + torch.logcumsumexp(f - big_g, dim=-1)


def rnnt_alpha(blank_lp: torch.Tensor, emit_lp: torch.Tensor, u_len: torch.Tensor) -> torch.Tensor:
    """Forward DP.  blank_lp, emit_lp: (B, T, U+1), where emit_lp[..., u] is
    the log-prob of emitting label u+1 (columns u >= u_len are masked).
    Returns alpha (B, T, U+1)."""
    u1 = blank_lp.shape[2]
    u_pos = torch.arange(u1, device=blank_lp.device)[None, :]
    emit_lp = torch.where(u_pos[:, None, :] < u_len[:, None, None], emit_lp, NEG)
    alpha = torch.cumsum(F.pad(emit_lp[:, 0, :-1], (1, 0)), dim=-1)
    alpha = torch.where(u_pos <= u_len[:, None], alpha, NEG)
    rows = [alpha]
    for t in range(1, blank_lp.shape[1]):
        alpha = torch.clamp(_row_update(alpha, blank_lp[:, t - 1], emit_lp[:, t]), min=NEG)
        rows.append(alpha)
    return torch.stack(rows, dim=1)


def rnnt_beta(blank_lp: torch.Tensor, emit_lp: torch.Tensor, t_len: torch.Tensor,
              u_len: torch.Tensor) -> torch.Tensor:
    """Backward DP: beta[t, u] = log P(path from (t, u) to the end), the
    final blank at (T-1, U) included; beta[0, 0] is the log-likelihood.

    Each row solves beta[t, u] = logaddexp(f_u, beta[t, u+1] + emit(t, u))
    in closed form: with u reversed, x'_v = logaddexp(f'_v, x'_{v-1} + g'_v)
    has the solution x' = G' + logcumsumexp(f' - G') with the inclusive
    G' = cumsum(g').  Emissions at invalid columns count 0 in G' (paths
    through them are already cut by f' = NEG).  A T-step loop of small ops.
    """
    u1 = blank_lp.shape[2]
    u_pos = torch.arange(u1, device=blank_lp.device)[None, :]
    g_valid = torch.where(u_pos[:, None, :] < u_len[:, None, None], emit_lp, 0.0)
    last_t = (t_len - 1)[:, None]
    beyond_u = u_pos > u_len[:, None]
    exit_u = u_pos == u_len[:, None]
    beta = torch.full_like(blank_lp[:, 0], NEG)
    rows = []
    for t in range(blank_lp.shape[1] - 1, -1, -1):
        blank_row = blank_lp[:, t]
        f = torch.where(t < last_t, blank_row + beta, NEG)
        f = torch.where((t == last_t) & exit_u, blank_row, f)
        f = torch.clamp(torch.where(beyond_u, NEG, f), min=NEG)
        f_rev, g_rev = f.flip(-1), g_valid[:, t].flip(-1)
        big_g = torch.cumsum(g_rev, dim=-1)
        beta = torch.clamp((big_g + torch.logcumsumexp(f_rev - big_g, dim=-1)).flip(-1), min=NEG)
        rows.append(beta)
    return torch.stack(rows[::-1], dim=1)


def rnnt_occupancy(blank_lp, emit_lp, t_len, u_len, alpha=None):
    """Gradients of the summed loss with respect to the channel log-probs,
    ``(g_blank, g_emit)``, each (B, T, U+1): minus the posterior occupancy
    of each blank and emit arc.  Cells outside (t_len, u_len) get 0."""
    b, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    if alpha is None:
        alpha = rnnt_alpha(blank_lp, emit_lp, u_len)
    beta = rnnt_beta(blank_lp, emit_lp, t_len, u_len)
    bi = torch.arange(b, device=dev)
    tl = torch.clamp(t_len, min=1).long() - 1  # empty utterances: `valid` zeroes every cell
    ul = u_len.long()
    log_like = alpha[bi, tl, ul] + blank_lp[bi, tl, ul]

    t_pos = torch.arange(t_max, device=dev)[None, :, None]
    u_pos = torch.arange(u1, device=dev)[None, None, :]
    valid = (t_pos < t_len[:, None, None]) & (u_pos <= u_len[:, None, None])

    # blank: alpha[t, u] + beta[t+1, u]; at the exit cell beta_next := 0
    beta_next_t = F.pad(beta[:, 1:], (0, 0, 0, 1), value=NEG)
    exit_cell = (t_pos == (t_len[:, None, None] - 1)) & (u_pos == u_len[:, None, None])
    beta_next_t = torch.where(exit_cell, 0.0, beta_next_t)
    g_blank = -torch.exp(torch.clamp(alpha + blank_lp + beta_next_t - log_like[:, None, None],
                                     NEG, 30.0))
    g_blank = torch.where(valid, g_blank, 0.0)

    # emit: alpha[t, u] + beta[t, u+1]
    beta_next_u = F.pad(beta[:, :, 1:], (0, 1), value=NEG)
    g_emit = -torch.exp(torch.clamp(alpha + emit_lp + beta_next_u - log_like[:, None, None],
                                    NEG, 30.0))
    g_emit = torch.where(valid & (u_pos < u_len[:, None, None]), g_emit, 0.0)
    return g_blank, g_emit


def plain_mm_dtype(device: torch.device) -> torch.dtype:
    """The matmul dtype of the plain loss backend on ``device``: bf16 on the
    card, as the kernels (and the JAX package's pallas backend on its chip)
    compute; float32 on the CPU, as the JAX package's XLA backend does off
    the TPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _labels_ext(labels, vocab):
    """labels with a trailing 0 column, clipped to [0, V), int32."""
    return F.pad(labels, (0, 1)).clamp(0, vocab - 1).to(torch.int32).contiguous()


class RNNTLossFused(torch.autograd.Function):
    """Per-utterance loss (B,) through the fused joint; differentiable in
    ax, gx, ay, gy, w2 and b2.  The forward saves the channels and alpha
    (as ``_fused_fwd`` does), never the (B, T, U+1, V) logits."""

    @staticmethod
    def forward(ctx, ax, gx, ay, gy, w2, b2, labels, t_len, u_len, chunk, backend):
        if backend not in ("auto", "plain"):
            raise ValueError(f"unknown loss backend {backend!r}")
        b = labels.shape[0]
        labels_ext = _labels_ext(labels, w2.shape[1])
        if backend == "auto":
            lse, zb, zy = joint_channels(ax, gx, ay, gy, w2, b2, labels_ext)
        else:
            lse, zb, zy = joint_channels_reference(ax, gx, ay, gy, w2, b2, labels_ext, chunk,
                                                   plain_mm_dtype(ax.device))
        blank_lp = zb - lse
        alpha = rnnt_alpha(blank_lp, zy - lse, u_len)
        bi = torch.arange(b, device=alpha.device)
        tl = torch.clamp(t_len, min=1).long() - 1
        ul = u_len.long()
        loss = -(alpha[bi, tl, ul] + blank_lp[bi, tl, ul])
        ctx.chunk, ctx.backend = chunk, backend
        ctx.save_for_backward(ax, gx, ay, gy, w2, b2, labels_ext, t_len, u_len,
                              lse, zb, zy, alpha)
        return torch.where(t_len > 0, loss, torch.zeros_like(loss))

    @staticmethod
    def backward(ctx, g_loss):
        ax, gx, ay, gy, w2, b2, labels_ext, t_len, u_len, lse, zb, zy, alpha = ctx.saved_tensors
        g_blank, g_emit = rnnt_occupancy(zb - lse, zy - lse, t_len, u_len, alpha=alpha)
        # the channel cotangents of L = f(zb - lse, zy - lse), per utterance
        d_zb = (g_blank * g_loss[:, None, None]).contiguous()
        d_zy = (g_emit * g_loss[:, None, None]).contiguous()
        d_lse = -(d_zb + d_zy)
        if ctx.backend == "auto":
            grads = joint_channels_bwd(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy)
        else:
            grads = joint_channels_bwd_reference(ax, gx, ay, gy, w2, b2, labels_ext, lse,
                                                 d_lse, d_zb, d_zy, ctx.chunk,
                                                 plain_mm_dtype(ax.device))
        return (*grads, None, None, None, None, None)


def rnnt_loss_fused(ax, gx, ay, gy, w2, b2, labels, t_len, u_len, chunk: int = 32,
                    backend: str = "auto") -> torch.Tensor:
    """Per-utterance RNN-T loss (B,) from the factorized joint, with autograd.

    ax, gx: (B, T, H) f32; ay, gy: (B, U+1, H) f32; w2: (H, V); b2: (V,);
    labels: (B, U); t_len, u_len: (B,).  ``backend``: "auto" takes the
    kernels K1 (forward) and K2/K3 (backward) -- launched on CUDA tensors,
    their plain versions on CPU tensors; "plain" always takes the plain
    versions over T chunks of ``chunk`` frames, computing the kernels'
    function on each device (``plain_mm_dtype``: bf16 matmuls on the card,
    float32 on the CPU).  Utterances with
    ``t_len <= 0`` get a loss of exactly 0 and zero gradients.
    """
    return RNNTLossFused.apply(ax, gx, ay, gy, w2, b2, labels, t_len, u_len, chunk, backend)


def rnnt_loss_forward(ax, gx, ay, gy, w2, b2, labels, t_len, u_len,
                      chunk: int = 32, backend: str = "auto") -> torch.Tensor:
    """``rnnt_loss_fused`` without autograd: the eval path's loss."""
    with torch.no_grad():
        return rnnt_loss_fused(ax, gx, ay, gy, w2, b2, labels, t_len, u_len, chunk, backend)
