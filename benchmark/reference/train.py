"""The reference's training steps: features with dither and SpecAugment,
the encoder and prediction net in train mode, the summed RNN-T loss and
its gradients, inf-norm clipping and SGD with Nesterov momentum on the
exponential-interpolation learning rate.

The random numbers of a step are drawn from the passed generator in the
program's order: the dither, SpecAugment's four numbers, then the
encoder's dropout masks layer by layer (``model.py``).

``fault="half_batch"`` plants a fault in the reference's place: each step
sees only the first half of its rows, twice over, as a step that left half
of the batch out and took the mean over the rest would.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import features as RF
from benchmark.reference import loss as RL
from benchmark.reference import model as M


def lr_at(optim: dict, n: int) -> float:
    ratio = math.log(optim["final_lr"] / optim["initial_lr"])
    return optim["initial_lr"] * math.exp(n * ratio / optim["total_batches"])


def features(batch: dict, feat: dict, traffic: dict, cmvn: tuple, gen) -> torch.Tensor:
    x = RF.splice(RF.fbank(batch["wavs"], feat, gen), feat["lctx"], feat["rctx"])
    x = (x + cmvn[0]) * cmvn[1]
    if traffic["spec_augment"]:
        x = RF.spec_augment(x, traffic["max_freq_span"], traffic["max_time_span"], gen)
    return x


@M.exact_float32()
def train_steps(state: dict, param_names: list, batches: list, seed_gen: torch.Generator,
                model: dict, feat: dict, traffic: dict, cmvn: tuple, prec=M.FLOAT32,
                fault: str = None):
    """Run ``len(batches)`` steps from ``state`` (weights and buffers,
    float32, left unchanged) on features normalized by ``cmvn`` (offset,
    scale).  Returns (the steps' summed losses, the first
    step's clipped gradient by leaf, the parameters after the last step by
    leaf)."""
    optim = traffic["optimizer"]
    p = {k: v.detach().clone() for k, v in state.items()}
    params = [p[k].requires_grad_() for k in param_names]
    momentum = [None] * len(params)
    losses, first_grad = [], None
    for n, batch in enumerate(batches):
        if fault == "half_batch":
            half = batch["wavs"].shape[0] // 2
            batch = {k: torch.cat([v[:half], v[:half]]) for k, v in batch.items()}
        x = features(batch, feat, traffic, cmvn, seed_gen)
        enc = M.encoder(p, x, model, prec, train=True, gen=seed_gen)
        labels = batch["labels"]
        lens = torch.full((labels.shape[0],), labels.shape[1], device=labels.device)
        dec = M.predict(p, labels, lens, model, prec, train=True, gen=seed_gen)
        loss = RL.rnnt_loss_blocked(p, enc, dec, labels, traffic["reference_block"], prec)
        losses.append(float(loss))
        with torch.no_grad():
            grads = [q.grad for q in params]
            inf = torch.stack([g.abs().max() for g in grads]).max()
            scale = optim["grad_clip"] / torch.clamp(inf, min=optim["grad_clip"])
            grads = [g * scale for g in grads]
            if first_grad is None:
                first_grad = {k: g.clone() for k, g in zip(param_names, grads)}
            lr = lr_at(optim, n)
            m = optim["momentum"]
            for i, (q, g) in enumerate(zip(params, grads)):
                momentum[i] = g.clone() if momentum[i] is None else m * momentum[i] + g
                q -= lr * (g + m * momentum[i])
                q.grad = None
    return losses, first_grad, {k: q.detach() for k, q in zip(param_names, params)}
