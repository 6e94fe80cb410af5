"""Learning-rate schedule, inf-norm clipping and the optimizers
(port of ``pika_tpu/train/lr.py``).

* exponential-interpolation LR: ``lr(n) = initial * exp(n * ln(final /
  initial) / total_batches)``, n counted from 0 at the first update, as
  optax counts;
* inf-norm clipping: every gradient scaled by ``clip / max(inf_norm, clip)``
  with the inf-norm taken over all of them (no 1e-6 as in
  ``torch.nn.utils.clip_grad_norm_``);
* sgd (Nesterov, persistent momentum), adam and adadelta with optax's
  defaults.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def exp_interp_schedule(initial_lr: float, final_lr: float,
                        total_batches: int) -> Callable[[int], float]:
    """The reference's per-batch exponential interpolation schedule."""
    log_ratio = math.log(final_lr / initial_lr)

    def schedule(count: int) -> float:
        return initial_lr * math.exp(count * log_ratio / total_batches)

    return schedule


@torch.no_grad()
def clip_by_inf_norm(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place so their global inf-norm is at most
    ``max_norm``; returns the inf-norm before clipping (a 0-d tensor; no
    host sync)."""
    grads = list(grads)
    # one multi-tensor reduction on the card, not two launches a gradient
    inf_norm = torch.stack(torch._foreach_norm(grads, float("inf"))).max()
    scale = max_norm / torch.clamp(inf_norm, min=max_norm)
    torch._foreach_mul_(grads, scale)
    return inf_norm


class Optimizer:
    """An optimizer stack over ``params``: optional inf-norm clipping, then
    the update with the learning rate ``schedule(n)`` for update n (from 0).

    ``step()`` applies one update from the parameters' ``.grad``;
    ``state_dict()`` / ``load_state_dict()`` carry the wrapped optimizer's
    state (momentum buffers, Adam moments) and ``count``, the schedule's
    step, so a restored optimizer continues both where they were.
    ``restart(count)`` is a fresh optimizer fast-forwarded to ``count``,
    BMUF's local optimizer at the start of a round.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], optim: str,
                 schedule: Callable[[int], float], momentum: float = 0.9,
                 grad_clip: float = -1.0):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0
        lr0 = schedule(0)
        if optim == "sgd":
            # optax.sgd(nesterov=True): trace = g + m * trace; update = g + m * trace
            # (plain SGD at m = 0, where torch allows no Nesterov flag)
            self.opt = torch.optim.SGD(self.params, lr=lr0, momentum=momentum, dampening=0.0,
                                       nesterov=momentum > 0)
        elif optim == "adam":
            self.opt = torch.optim.Adam(self.params, lr=lr0, betas=(0.9, 0.999), eps=1e-8)
        elif optim == "adadelta":
            self.opt = torch.optim.Adadelta(self.params, lr=lr0, rho=0.9, eps=1e-6)
        else:
            raise ValueError(f"unknown optimizer {optim}")

    def state_dict(self) -> dict:
        return {"optimizer": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["optimizer"])
        self.count = int(state["count"])

    def restart(self, count: int) -> None:
        """A fresh state, as the JAX BMUF round's local optimizer
        (``parallel/bmuf.py``): ``tx.init`` fast-forwarded by
        ``tree_set(..., count=count)`` where the chain holds one ``count``
        (sgd, adadelta: the schedule's), so the schedule continues from
        ``count`` while the Nesterov trace and Adadelta's accumulators start
        at 0.  Adam's chain holds two (its own and the schedule's), so
        optax's ``tree_get`` raises, the round skips the fast-forward, and
        Adam restarts at step 0 every round: its schedule and bias
        correction too."""
        self.opt.state.clear()
        self.count = 0 if isinstance(self.opt, torch.optim.Adam) else int(count)

    def adam_moments(self):
        """(first moments, second moments) of Adam, one tensor per
        parameter (zeros where no gradient has reached one yet, as optax's
        zero-initialised moments); raises for another optimizer."""
        if not isinstance(self.opt, torch.optim.Adam):
            raise ValueError("optimizer state has no Adam moments")
        state = [self.opt.state.get(p) or {} for p in self.params]
        return tuple([s.get(k, torch.zeros_like(p)) for s, p in zip(state, self.params)]
                     for k in ("exp_avg", "exp_avg_sq"))

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.grad_clip > 0:
            clip_by_inf_norm([p.grad for p in self.params if p.grad is not None], self.grad_clip)
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1


def make_optimizer(params: Iterable[torch.nn.Parameter], optim: str = "sgd",
                   initial_lr: float = 1.0, final_lr: float = 1.0, total_batches: int = 1,
                   momentum: float = 0.9, grad_clip: float = -1.0) -> Optimizer:
    """SGD+Nesterov (or Adam, Adadelta) with the exponential-interpolation
    schedule and optional inf-norm clipping: the JAX package's
    ``make_optimizer`` over torch parameters."""
    return Optimizer(params, optim, exp_interp_schedule(initial_lr, final_lr, total_batches),
                     momentum, grad_clip)
