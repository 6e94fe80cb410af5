"""The RNN-T loss in plain PyTorch, with the joint's lattice computed in
blocks of utterances so that the full-size batch fits.

The forward variable over the (T', U+1) lattice, row by row: within a row,
alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u], alpha[t, u-1] +
emit[t, u-1]) is a log-space linear recurrence in u, solved at once with a
cumulative log-sum-exp.  The loss of an utterance is -(alpha[T'-1, U] +
blank[T'-1, U]).  Every utterance spans all T' frames and all U labels.
"""

from __future__ import annotations

import torch

from benchmark.reference import model as M


def lattice_log_probs(p, ax, gx, ay, gy, labels, prec=M.FLOAT32):
    """Blank (B', T', U+1) and label (B', T', U) log-probabilities of a
    block, through the full (B', T', U+1, V) lattice."""
    logits = M.joint_logits(p, ax[:, :, None], gx[:, :, None], ay[:, None], gy[:, None], prec)
    lp = torch.log_softmax(logits, dim=-1)
    blank = lp[..., 0]
    idx = labels.long()[:, None, :, None].expand(-1, lp.shape[1], -1, 1)
    return blank, lp[:, :, :-1].gather(-1, idx)[..., 0]


def rnnt_nll(blank: torch.Tensor, emit: torch.Tensor) -> torch.Tensor:
    """Per-utterance negative log-likelihood from (B, T', U+1) blank and
    (B, T', U) label log-probabilities."""
    b, t, u1 = blank.shape
    zero = blank.new_zeros(b, 1)

    def row(prev, e):
        cum = torch.cat([zero, e.cumsum(-1)], dim=-1)
        return cum + torch.logcumsumexp(prev - cum, dim=-1)

    alpha = torch.cat([zero, emit[:, 0].cumsum(-1)], dim=-1)
    for i in range(1, t):
        alpha = row(alpha + blank[:, i - 1], emit[:, i])
    return -(alpha[:, -1] + blank[:, -1, -1])


def rnnt_loss_blocked(p, enc, dec, labels, block: int, prec=M.FLOAT32) -> torch.Tensor:
    """Summed loss of the batch with autograd to ``enc``, ``dec`` and the
    joint's weights, never holding more than ``block`` utterances'
    lattices.  The lattice is computed once without autograd for the
    recurrence, then again block by block for its backward; returns the
    loss (detached) after its backward has run."""
    factors = M.joint_factors(p, enc, dec, prec)
    leaves = [f.detach().requires_grad_() for f in factors]
    b = enc.shape[0]
    with torch.no_grad():
        parts = [lattice_log_probs(p, *(f[i:i + block] for f in leaves), labels[i:i + block], prec)
                 for i in range(0, b, block)]
    blank = torch.cat([x[0] for x in parts]).requires_grad_()
    emit = torch.cat([x[1] for x in parts]).requires_grad_()
    loss = rnnt_nll(blank, emit).sum()
    loss.backward()
    for i in range(0, b, block):
        bl, em = lattice_log_probs(p, *(f[i:i + block] for f in leaves), labels[i:i + block], prec)
        torch.autograd.backward([bl, em], [blank.grad[i:i + block], emit.grad[i:i + block]])
    torch.autograd.backward(list(factors), [f.grad for f in leaves])
    return loss.detach()
