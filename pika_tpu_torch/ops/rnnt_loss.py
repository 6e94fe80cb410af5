"""RNN-T loss over the factorized joint, with its backward
(port of ``pika_tpu/ops/rnnt_loss.py``).

DP convention (blank = 0):
    alpha[t, u] = logaddexp(alpha[t-1, u] + blank(t-1, u),
                            alpha[t, u-1] + emit(t, u-1))
    loss_b      = -(alpha[T_b-1, U_b] + blank(T_b-1, U_b))

``RNNTLossFused`` is the port of the ``custom_vjp`` of ``rnnt_loss_fused``:
its forward is K1 (``joint_channels``) plus the DP's forward (``dp_forward``:
alpha and the loss); its backward is the DP's backward (``dp_backward``:
beta, the posterior of each lattice arc and the channel cotangents) and
K2/K3 (``joint_channels_bwd``).  On CUDA tensors ``dp_forward`` and
``dp_backward`` are one launch each of ``csrc/rnnt_dp.cu``; their plain
versions, ``dp_forward_reference`` and ``dp_backward_reference``, loop over
the T rows (``rnnt_alpha``, ``rnnt_beta``, ``rnnt_occupancy``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pika_tpu_torch.ops import cuda_build
from pika_tpu_torch.ops.rnnt_kernels import (
    joint_channels,
    joint_channels_bwd,
    joint_channels_bwd_reference,
    joint_channels_reference,
)
from pika_tpu_torch.utils.profiling import span

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


def dp_forward_reference(blank_lp, emit_lp, t_len, u_len):
    """The plain version of ``dp_forward``: ``rnnt_alpha``'s row loop and
    the loss gathered from it."""
    alpha = rnnt_alpha(blank_lp, emit_lp, u_len)
    bi = torch.arange(alpha.shape[0], device=alpha.device)
    tl = torch.clamp(t_len, min=1).long() - 1
    ul = u_len.long()
    loss = -(alpha[bi, tl, ul] + blank_lp[bi, tl, ul])
    return torch.where(t_len > 0, loss, torch.zeros_like(loss)), alpha


def dp_backward_reference(blank_lp, emit_lp, t_len, u_len, alpha, loss, g_loss):
    """The plain version of ``dp_backward``: ``rnnt_occupancy`` (the beta
    loop; it takes the log-likelihood from alpha, which is ``-loss`` where
    ``t_len > 0``, so ``loss`` is not read) scaled by ``g_loss``."""
    g_blank, g_emit = rnnt_occupancy(blank_lp, emit_lp, t_len, u_len, alpha=alpha)
    # the channel cotangents of L = f(zb - lse, zy - lse), per utterance
    d_zb = (g_blank * g_loss[:, None, None]).contiguous()
    d_zy = (g_emit * g_loss[:, None, None]).contiguous()
    return d_zb, d_zy, -(d_zb + d_zy)


def _dp_inputs(what, lattices: dict, per_utt: dict, t_len, u_len):
    """Raise unless the (B, T, U+1) float32 ``lattices`` and (B,) float32
    ``per_utt`` are contiguous on one CUDA device with integer (B,) lengths;
    returns (B, T, U1) and the lengths as int32 (a device cast: no sync)."""
    first = next(iter(lattices.values()))
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    b, t, u1 = first.shape
    expect = {**{n: (x, (b, t, u1)) for n, x in lattices.items()},
              **{n: (x, (b,)) for n, x in per_utt.items()}}
    for name, (x, shape) in expect.items():
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{what}: {name} must be float32 {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    for name, x in (("t_len", t_len), ("u_len", u_len)):
        if x.device != dev or x.dtype.is_floating_point or tuple(x.shape) != (b,):
            raise ValueError(f"{what}: {name} must be integer ({b},) on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    return (b, t, u1), t_len.to(torch.int32).contiguous(), u_len.to(torch.int32).contiguous()


def dp_forward(blank_lp, emit_lp, t_len, u_len):
    """``(loss, alpha)``: the per-utterance loss (B,), exactly 0 where
    ``t_len <= 0``, and alpha (B, T, U+1), from the channel log-probs
    ``blank_lp``, ``emit_lp`` (B, T, U+1) float32 and the lengths (B,).  On
    CUDA tensors one launch of ``csrc/rnnt_dp.cu``'s forward (alpha is NEG
    in rows t >= t_len, which nothing reads; lengths past the lattice are
    clamped into it); on CPU tensors ``dp_forward_reference``."""
    if blank_lp.device.type == "cpu":
        return dp_forward_reference(blank_lp, emit_lp, t_len, u_len)
    (b, t, u1), t32, u32 = _dp_inputs("dp_forward", {"blank_lp": blank_lp, "emit_lp": emit_lp},
                                      {}, t_len, u_len)
    dev = blank_lp.device
    alpha = torch.empty((b, t, u1), dtype=torch.float32, device=dev)
    loss = torch.empty(b, dtype=torch.float32, device=dev)
    if alpha.numel() == 0:
        return loss.zero_(), alpha
    rc = cuda_build.library().pika_rnnt_dp_forward(
        dev.index, torch.cuda.current_stream(dev).cuda_stream, blank_lp.data_ptr(),
        emit_lp.data_ptr(), t32.data_ptr(), u32.data_ptr(), alpha.data_ptr(), loss.data_ptr(),
        b, t, u1)
    cuda_build.check(rc, f"dp_forward launch (B={b}, T={t}, U1={u1})")
    dp_forward.launches += 1
    return loss, alpha


def dp_backward(blank_lp, emit_lp, t_len, u_len, alpha, loss, g_loss):
    """``(d_zb, d_zy, d_lse)``, each (B, T, U+1) float32: the cotangents of
    K1's channels given the loss's cotangent ``g_loss`` (B,), from the
    inputs and outputs of ``dp_forward``; exact zeros outside each
    utterance's lattice.  On CUDA tensors one launch of
    ``csrc/rnnt_dp.cu``'s backward (beta is never written); on CPU tensors
    ``dp_backward_reference``."""
    if blank_lp.device.type == "cpu":
        return dp_backward_reference(blank_lp, emit_lp, t_len, u_len, alpha, loss, g_loss)
    g_loss = g_loss.contiguous()  # the backward of a sum hands an expanded one
    (b, t, u1), t32, u32 = _dp_inputs(
        "dp_backward", {"blank_lp": blank_lp, "emit_lp": emit_lp, "alpha": alpha},
        {"loss": loss, "g_loss": g_loss}, t_len, u_len)
    outs = [torch.empty((b, t, u1), dtype=torch.float32, device=blank_lp.device)
            for _ in range(3)]
    if outs[0].numel() == 0:
        return tuple(outs)
    dev = blank_lp.device
    rc = cuda_build.library().pika_rnnt_dp_backward(
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
        *(x.data_ptr() for x in (blank_lp, emit_lp, alpha, loss, g_loss, t32, u32, *outs)),
        b, t, u1)
    cuda_build.check(rc, f"dp_backward launch (B={b}, T={t}, U1={u1})")
    dp_backward.launches += 1
    return tuple(outs)


dp_forward.launches = 0
dp_backward.launches = 0


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
    ax, gx, ay, gy, w2 and b2.  The forward saves lse, the channel
    log-probs, alpha and the loss (as ``_fused_fwd`` saves the channels and
    alpha), never the (B, T, U+1, V) logits."""

    @staticmethod
    def forward(ctx, ax, gx, ay, gy, w2, b2, labels, t_len, u_len, chunk, backend):
        if backend not in ("auto", "plain"):
            raise ValueError(f"unknown loss backend {backend!r}")
        labels_ext = _labels_ext(labels, w2.shape[1])
        with span("loss.k1"):
            if backend == "auto":
                lse, zb, zy = joint_channels(ax, gx, ay, gy, w2, b2, labels_ext)
            else:
                lse, zb, zy = joint_channels_reference(ax, gx, ay, gy, w2, b2, labels_ext, chunk,
                                                       plain_mm_dtype(ax.device))
        with span("loss.alpha"):
            blank_lp, emit_lp = zb - lse, zy - lse
            dp = dp_forward if backend == "auto" else dp_forward_reference
            loss, alpha = dp(blank_lp, emit_lp, t_len, u_len)
        ctx.chunk, ctx.backend = chunk, backend
        ctx.save_for_backward(ax, gx, ay, gy, w2, b2, labels_ext, t_len, u_len,
                              lse, blank_lp, emit_lp, alpha, loss)
        return loss

    @staticmethod
    def backward(ctx, g_loss):
        (ax, gx, ay, gy, w2, b2, labels_ext, t_len, u_len, lse, blank_lp, emit_lp, alpha,
         loss) = ctx.saved_tensors
        with span("loss.occupancy"):
            dp = dp_backward if ctx.backend == "auto" else dp_backward_reference
            d_zb, d_zy, d_lse = dp(blank_lp, emit_lp, t_len, u_len, alpha, loss, g_loss)
        with span("loss.k23"):
            if ctx.backend == "auto":
                grads = joint_channels_bwd(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb,
                                           d_zy)
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
