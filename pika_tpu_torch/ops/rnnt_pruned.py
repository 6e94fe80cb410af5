"""Pruned RNN-T loss: the full gated joint on a per-frame band of label
positions (port of ``pika_tpu/ops/rnnt_pruned.py``, the k2/icefall pruned
transducer recipe).

1. ``simple_channels``: the additive "simple" joint ``logit(t, u, v) =
   am[t, v] + lm[u, v]`` of two linear heads; its normaliser
   ``logsumexp_v(am + lm)`` is one batched (T, V) x (V, U+1) product in exp
   space (max-subtracted), so the (B, T, U+1, V) lattice never exists.
2. ``rnnt_loss_simple``: the RNN-T DP (``rnnt_alpha``) on those channels,
   differentiable by autograd; an auxiliary term of the objective.
3. ``prune_ranges``: each frame's band start from the simple loss's
   posterior occupancy: the argmax of the windowed occupancy, an end
   envelope that keeps ``u_len`` reachable, and a monotone clip recursion
   (a loop over T) giving ``s_begin[0] = 0`` and, on feasible utterances,
   ``0 <= s_begin[t+1] - s_begin[t] <= s_range - 1``.  No gradient.
4. ``rnnt_loss_pruned``: the prediction-side factors gathered on the band,
   the full gated joint on (B, T, s_range) cells T-chunk by T-chunk (each
   chunk recomputed in the backward, ``torch.utils.checkpoint``, so the
   saved tensors stay at band size) and the banded DP with per-row shifts.

The JAX package computes all of this outside its Pallas kernels; here it is
plain PyTorch on every device.  Its gathers whose targets repeat (the
band's rows of ``ay``/``gy``, the simple joint's label logits of ``am``)
go through ``gather_rows``, whose backward sums in a fixed order, so that
a pruned training repeats to the bit on the card as the full loss does.
A band moves at most ``s_range - 1`` labels a frame, so an utterance with
``T * (s_range - 1) < U`` has no in-band path; it (like any whose band
misses the exit) gets a pruned loss of 0, and the simple loss still
trains it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pika_tpu_torch.ops.rnnt_loss import NEG, _labels_ext, rnnt_alpha, rnnt_occupancy


class _GatherRows(torch.autograd.Function):
    """``table.index_select(0, index)`` with a backward that sums the
    cotangents of rows sharing a target in a fixed order:
    ``index_put_(accumulate=True)``, which on the card sorts the targets
    (a stable sort) and adds each target's rows in index order, where the
    backward of ``gather`` or ``index_select`` adds them with atomics in
    whatever order they land."""

    @staticmethod
    def forward(ctx, table, index):
        ctx.save_for_backward(index)
        ctx.rows = table.shape[0]
        return table.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.rows, *grad.shape[1:]))
        return out.index_put_((index,), grad, accumulate=True), None


def gather_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows ``index`` (M,) int64 of ``table`` (N, ...): (M, ...), the
    values bit for bit those of indexing; differentiable in ``table`` with
    a deterministic backward (``_GatherRows``)."""
    return _GatherRows.apply(table, index)


def simple_channels(am: torch.Tensor, lm: torch.Tensor, labels: torch.Tensor):
    """(blank_lp, emit_lp), each (B, T, U+1), of the additive joint.
    am (B, T, V) and lm (B, U+1, V) float32; labels (B, U)."""
    b, t_max, v = am.shape
    labels_ext = _labels_ext(labels, v).long()
    amx, lmx = am.detach().amax(-1), lm.detach().amax(-1)
    z = torch.exp(am - amx[..., None]) @ torch.exp(lm - lmx[..., None]).transpose(1, 2)
    lse = torch.log(z.clamp(min=1e-30)) + amx[:, :, None] + lmx[:, None, :]
    # am[b, t, labels_ext[b, u]]; a label that repeats in an utterance shares its entry
    rows = torch.arange(b * t_max, device=am.device).view(b, t_max, 1) * v
    am_y = gather_rows(am.reshape(-1), (rows + labels_ext[:, None, :]).reshape(-1))
    am_y = am_y.view(b, t_max, -1)                                          # (B, T, U+1)
    lm_y = lm.gather(2, labels_ext[:, :, None])[..., 0][:, None, :]        # (B, 1, U+1)
    blank_lp = am[..., 0][:, :, None] + lm[..., 0][:, None, :] - lse
    emit_lp = am_y + lm_y - lse
    return blank_lp, emit_lp


def _exit_index(b: int, t_len: torch.Tensor, device):
    """(batch rows, last valid frame) for the final gathers (0 for t_len 0)."""
    return torch.arange(b, device=device), t_len.clamp(min=1).long() - 1


def rnnt_loss_simple(am, lm, labels, t_len, u_len):
    """Per-utterance RNN-T loss (B,) of the additive joint and its channels
    ``(blank_lp, emit_lp)``, which feed ``prune_ranges``."""
    blank_lp, emit_lp = simple_channels(am, lm, labels)
    alpha = rnnt_alpha(blank_lp, emit_lp, u_len)
    bi, tl = _exit_index(am.shape[0], t_len, am.device)
    ul = u_len.long()
    loss = -(alpha[bi, tl, ul] + blank_lp[bi, tl, ul])
    return torch.where(t_len > 0, loss, torch.zeros_like(loss)), (blank_lp, emit_lp)


@torch.no_grad()
def prune_ranges(blank_lp, emit_lp, t_len, u_len, s_range: int) -> torch.Tensor:
    """Band starts s_begin (B, T) int64 from the simple joint's posteriors.

    Guarantees (the banded DP relies on them):
      * ``s_begin[:, 0] == 0``
      * ``0 <= s_begin[:, t+1] - s_begin[:, t]``, and ``<= s_range - 1``
        when feasible (``T * (s_range - 1) >= U``; on an infeasible
        utterance the end envelope outruns the step bound, as in the JAX
        package, and its pruned loss is 0)
      * ``s_begin <= max(0, u_len + 1 - s_range)``
      * when feasible, the last valid frame's band covers ``u_len``.
    The windowed occupancy's argmax takes the first of equal windows, as
    ``jnp.argmax`` does; two windows whose sums tie to within float32
    rounding may still pick differently from the JAX package's sums."""
    b, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    g_blank, g_emit = rnnt_occupancy(blank_lp, emit_lp, t_len, u_len)
    cs = torch.cumsum(-(g_blank + g_emit), dim=2)  # cumulative posterior mass over u
    # window sum W[., s] = cs[min(s + r - 1, U)] - cs[s - 1]
    hi = (torch.arange(u1, device=dev) + s_range - 1).clamp(max=u1 - 1)
    windows = cs[..., hi] - F.pad(cs[..., :-1], (1, 0))
    s_raw = windows.argmax(dim=2)  # (B, T)

    cap = (u_len.long() + 1 - s_range).clamp(min=0)  # (B,)
    t_pos = torch.arange(t_max, device=dev)[None, :]
    remaining = (t_len.long()[:, None] - 1 - t_pos).clamp(min=0)
    env = (cap[:, None] - remaining * (s_range - 1)).clamp(min=0)
    prev = torch.zeros(b, dtype=torch.long, device=dev)
    rows = [prev]
    for t in range(1, t_max):
        lo = torch.maximum(prev, env[:, t])
        top = torch.minimum(prev + s_range - 1, cap)
        prev = torch.minimum(torch.maximum(s_raw[:, t], lo), torch.maximum(top, lo))
        rows.append(prev)
    return torch.stack(rows, dim=1)


def _band_chunk(ax_c, gx_c, sb_c, ay, gy, w2, b2, labels_ext, s_range: int):
    """The full gated joint on one T-chunk's band: (lse, z_blank, z_label),
    each (B, Tc, s_range), with the prediction-side factors gathered at
    u = s_begin + j."""
    b, tc, h = ax_c.shape
    u1 = ay.shape[1]
    u_idx = (sb_c[..., None] + torch.arange(s_range, device=sb_c.device)).clamp(0, u1 - 1)
    flat = u_idx.reshape(b, tc * s_range)
    # every (t, j) whose band covers u reads row u: rows of ay and gy shared by many cells
    rows = (torch.arange(b, device=flat.device)[:, None] * u1 + flat).reshape(-1)
    ay_b = gather_rows(ay.reshape(b * u1, h), rows).view(b, tc, s_range, h)
    gy_b = gather_rows(gy.reshape(b * u1, h), rows).view(b, tc, s_range, h)
    lbl_b = labels_ext.gather(1, flat).reshape(b, tc, s_range)
    hh = torch.tanh(ax_c[:, :, None] + ay_b) * torch.sigmoid(gx_c[:, :, None] + gy_b)
    z = hh @ w2 + b2
    return z.logsumexp(-1), z[..., 0], z.gather(-1, lbl_b[..., None])[..., 0]


def _pruned_channels(ax, gx, ay, gy, w2, b2, labels_ext, s_begin, s_range: int, chunk: int):
    """``_band_chunk`` over T in chunks of ``chunk`` frames, each recomputed
    in the backward under autograd."""
    parts = []
    for i in range(0, ax.shape[1], chunk):
        args = (ax[:, i:i + chunk], gx[:, i:i + chunk], s_begin[:, i:i + chunk], ay, gy, w2,
                b2, labels_ext, s_range)
        parts.append(checkpoint(_band_chunk, *args, use_reentrant=False)
                     if torch.is_grad_enabled() else _band_chunk(*args))
    return tuple(torch.cat(x, dim=1) for x in zip(*parts))


def rnnt_alpha_banded(blank_b, emit_b, s_begin, t_len, u_len) -> torch.Tensor:
    """Forward DP restricted to the band.  blank_b, emit_b (B, T, s): log-probs
    at lattice cell (t, u = s_begin[t] + j).  Returns alpha (B, T, s), NEG
    off every in-band path.  Row t's cell j continues row t-1's cell
    j + s_begin[t] - s_begin[t-1] by a blank; within a row the emissions
    solve in closed form as in ``rnnt_alpha``."""
    b, t_max, s = blank_b.shape
    dev = blank_b.device
    j = torch.arange(s, device=dev)
    u_grid = s_begin[..., None] + j
    cell_ok = u_grid <= u_len[:, None, None]
    emit_ok = (u_grid < u_len[:, None, None]) & cell_ok
    # invalid emits count 0 inside the row solve: their cells are NEG, and
    # u-invalidity is monotone in j, so they never carry mass to a valid cell
    g = torch.where(emit_ok, emit_b, 0.0)
    alpha = torch.cumsum(F.pad(g[:, 0, :-1], (1, 0)), dim=1)
    alpha = torch.where(cell_ok[:, 0], alpha, NEG)
    d = s_begin[:, 1:] - s_begin[:, :-1]
    rows = [alpha]
    for t in range(1, t_max):
        idx = j[None, :] + d[:, t - 1, None]
        safe = idx.clamp(0, s - 1)
        time_ok = (t < t_len)[:, None]
        f = torch.where((idx < s) & time_ok,
                        alpha.gather(1, safe) + blank_b[:, t - 1].gather(1, safe), NEG)
        f = f.clamp(min=NEG)
        big_g = torch.cumsum(F.pad(g[:, t, :-1], (1, 0)), dim=1)
        x = big_g + torch.logcumsumexp(f - big_g, dim=1)
        alpha = torch.where(cell_ok[:, t] & time_ok, x.clamp(min=NEG), NEG)
        rows.append(alpha)
    return torch.stack(rows, dim=1)


def rnnt_loss_pruned(ax, gx, ay, gy, w2, b2, labels, t_len, u_len, s_begin, s_range: int,
                     chunk: int = 64) -> torch.Tensor:
    """Per-utterance pruned RNN-T loss (B,) over the factorized gated joint
    (the factors of ``rnnt_loss_fused``): ax, gx (B, T, H), ay, gy (B, U+1,
    H), w2 (H, V), b2 (V,).  ``s_begin`` comes from ``prune_ranges`` (or
    zeros with s_range > U for the full lattice).  Differentiable by
    autograd in the six factors; utterances without an in-band path give 0."""
    b = labels.shape[0]
    labels_ext = _labels_ext(labels, w2.shape[1]).long()
    lse, zb, zy = _pruned_channels(ax, gx, ay, gy, w2, b2, labels_ext, s_begin, s_range, chunk)
    blank_b, emit_b = zb - lse, zy - lse
    alpha = rnnt_alpha_banded(blank_b, emit_b, s_begin, t_len, u_len)
    bi, tl = _exit_index(b, t_len, ax.device)
    j_exit = u_len.long() - s_begin[bi, tl]
    safe_j = j_exit.clamp(0, s_range - 1)
    a_exit, bl_exit = alpha[bi, tl, safe_j], blank_b[bi, tl, safe_j]
    ok = (j_exit >= 0) & (j_exit < s_range) & (t_len > 0) & (a_exit > NEG / 2)
    return torch.where(ok, -(a_exit + bl_exit), torch.zeros_like(a_exit))


def rnnt_loss_pruned_numpy(log_probs, labels, t_len, u_len, s_begin, s_range: int):
    """Literal banded DP over a (B, T, U+1, V) log-prob lattice: the
    full-lattice DP with the off-band cells removed; the test oracle (copy
    of ``pika_tpu.ops.rnnt_pruned.rnnt_loss_pruned_numpy``)."""
    b = log_probs.shape[0]
    losses = np.zeros(b, np.float64)
    for i in range(b):
        t_i, u_i = int(t_len[i]), int(u_len[i])
        lp = log_probs[i].astype(np.float64)
        alpha = np.full((t_i, u_i + 1), -np.inf)

        def in_band(t, u):
            return s_begin[i, t] <= u < s_begin[i, t] + s_range

        if in_band(0, 0):
            alpha[0, 0] = 0.0
        for t in range(t_i):
            for u in range(u_i + 1):
                if not in_band(t, u):
                    alpha[t, u] = -np.inf
                    continue
                cands = [alpha[t, u]] if (t, u) == (0, 0) else []
                if t > 0 and in_band(t - 1, u):
                    cands.append(alpha[t - 1, u] + lp[t - 1, u, 0])
                if u > 0 and in_band(t, u - 1):
                    cands.append(alpha[t, u - 1] + lp[t, u - 1, labels[i, u - 1]])
                if cands:
                    alpha[t, u] = np.logaddexp.reduce(cands)
        final = alpha[t_i - 1, u_i] + lp[t_i - 1, u_i, 0]
        losses[i] = -final if np.isfinite(final) else 0.0
    return losses
