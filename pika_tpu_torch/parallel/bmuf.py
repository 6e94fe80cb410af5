"""BMUF (block model-update filtering) across ranks (port of
``pika_tpu/parallel/bmuf.py``).

Every rank runs ``sync_period`` local optimizer steps on its rows (no
collectives), then one all-reduce of one flattened buffer exchanges the
block delta and every rank applies the same block update:

* ``bmuf``      Nesterov block momentum:
      delta      = mean_r(global - local_r)
      delta_prev = bm * delta_prev + block_lr * (1 - bm) * delta
      global    -= (1 + bm) * delta_prev
* ``blockadam`` the delta **summed** over ranks, fed as the gradient to a
  replicated Adam (``block_lr`` its learning rate);
* ``bmufadam``  the ``bmuf`` update plus the reconciliation of the ranks'
  mean Adam moments with the beta^tau / beta^rho corrections and the
  fractional step count.  As in the JAX package, the reconciled moments
  are kept (and saved) but the next round's local Adam starts again from
  zeros, so its parameters follow ``bmuf``'s.

One non-finite entry of the reduced delta skips the update on every rank
(``ok`` false; the CLIs stop).  The BatchNorm running statistics handed in
as ``buffers`` are averaged over the ranks at each sync, and the round's
metrics too.  Plain PyTorch (``torch._foreach_*`` over flat lists): the
JAX package has no Pallas kernel here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

VARIANTS = ("bmuf", "blockadam", "bmufadam")


@dataclasses.dataclass(frozen=True)
class BMUFConfig:
    variant: str = "bmuf"          # 'bmuf' | 'blockadam' | 'bmufadam'
    block_momentum: float = 0.9
    block_lr: float = 1.0
    sync_period: int = 5
    adam_betas: tuple = (0.9, 0.999)
    adam_eps: float = 1e-8


@dataclasses.dataclass
class BMUFState:
    params: List[torch.Tensor]                      # the global parameters
    delta_prev: Optional[List[torch.Tensor]] = None  # bmuf, bmufadam
    adam_mu: Optional[List[torch.Tensor]] = None     # blockadam's Adam m; bmufadam's exp_avg
    adam_nu: Optional[List[torch.Tensor]] = None     # blockadam's Adam v; bmufadam's exp_avg_sq
    adam_count: float = 0.0                          # fractional for bmufadam
    rho: float = 0.0                                 # bmufadam's correction accumulator


def bmuf_init(params: Iterable[torch.Tensor], cfg: BMUFConfig) -> BMUFState:
    """The state of a run whose global parameters start at ``params``
    (copied)."""
    params = [p.detach().clone() for p in params]

    def zeros():
        return [torch.zeros_like(p) for p in params]

    if cfg.variant == "bmuf":
        return BMUFState(params, delta_prev=zeros())
    if cfg.variant == "blockadam":
        return BMUFState(params, adam_mu=zeros(), adam_nu=zeros())
    if cfg.variant == "bmufadam":
        return BMUFState(params, delta_prev=zeros(), adam_mu=zeros(), adam_nu=zeros())
    raise ValueError(f"unknown BMUF variant {cfg.variant}")


def _momentum_update(state: BMUFState, delta, cfg: BMUFConfig) -> None:
    bm = cfg.block_momentum
    torch._foreach_mul_(state.delta_prev, bm)
    torch._foreach_add_(state.delta_prev, delta, alpha=cfg.block_lr * (1.0 - bm))
    torch._foreach_add_(state.params, state.delta_prev, alpha=-(1.0 + bm))


@torch.no_grad()
def block_update(state: BMUFState, delta: Sequence[torch.Tensor], cfg: BMUFConfig) -> None:
    """``bmuf`` and ``blockadam``'s update from the reduced delta, in place
    (``_block_update``)."""
    if cfg.variant == "bmuf":
        _momentum_update(state, delta, cfg)
        return
    if cfg.variant != "blockadam":
        raise ValueError(cfg.variant)
    (b1, b2), eps = cfg.adam_betas, cfg.adam_eps
    state.adam_count += 1.0
    torch._foreach_mul_(state.adam_mu, b1)
    torch._foreach_add_(state.adam_mu, delta, alpha=1.0 - b1)
    torch._foreach_mul_(state.adam_nu, b2)
    torch._foreach_addcmul_(state.adam_nu, delta, delta, value=1.0 - b2)
    denom = torch._foreach_div(state.adam_nu, 1.0 - b2 ** state.adam_count)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    step = torch._foreach_div(state.adam_mu, 1.0 - b1 ** state.adam_count)
    torch._foreach_div_(step, denom)
    torch._foreach_add_(state.params, step, alpha=-cfg.block_lr)


@torch.no_grad()
def bmufadam_update(state: BMUFState, delta, mu_mean, nu_mean, cfg: BMUFConfig) -> None:
    """The block update plus the moment reconciliation, in place
    (``_bmufadam_update``)."""
    bm, tau = cfg.block_momentum, cfg.sync_period
    state.rho = bm * state.rho + tau
    _momentum_update(state, delta, cfg)
    for moments, mean, beta in ((state.adam_mu, mu_mean, cfg.adam_betas[0]),
                                (state.adam_nu, nu_mean, cfg.adam_betas[1])):
        b_tau, b_rho = beta ** tau, beta ** (state.rho * bm)
        torch._foreach_mul_(moments, b_tau * (b_rho - 1.0) / (1.0 - b_tau))
        torch._foreach_add_(moments, mean, alpha=(1.0 - b_tau * b_rho) / (1.0 - b_tau))
    state.adam_count += tau + state.rho * bm


class BMUF:
    """BMUF over the live ``params`` of a model on this rank.

    ``round(optimizer, local_step, batches, step_count)`` is one round of
    ``make_bmuf_round``: the local optimizer restarted at ``step_count``
    (``train/lr.py:Optimizer.restart``), ``local_step(batch)`` on each of
    the round's batches (it updates ``params`` in place and returns a dict
    of 0-d metric tensors), then ``sync``.  ``buffers`` (float tensors, the
    BatchNorm running statistics: ``reduce_extra``) are averaged over the
    ranks at each sync.  ``group`` is the process group (the default one
    when None); the collective runs in a world of one too.
    """

    def __init__(self, params: Iterable[torch.Tensor], cfg: BMUFConfig,
                 buffers: Iterable[torch.Tensor] = (), group=None):
        if cfg.variant not in VARIANTS:
            raise ValueError(f"unknown BMUF variant {cfg.variant}")
        self.cfg = cfg
        self.params = list(params)
        self.buffers = list(buffers)
        self.group = group
        self.state = bmuf_init(self.params, cfg)

    def state_dict(self) -> dict:
        """The state but for the global parameters, which are the live
        ``params`` between rounds (a checkpoint holds them as the model's)."""
        return {k: getattr(self.state, k) for k in ("delta_prev", "adam_mu", "adam_nu",
                                                    "adam_count", "rho")}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s state; the global parameters are taken
        from the live ``params`` (restored with the model)."""
        for k in ("delta_prev", "adam_mu", "adam_nu"):
            mine = getattr(self.state, k)
            if (mine is None) != (state[k] is None):
                raise ValueError(f"BMUF state {k!r} does not match variant {self.cfg.variant}")
            if mine is not None:
                torch._foreach_copy_(mine, state[k])
        self.state.adam_count, self.state.rho = float(state["adam_count"]), float(state["rho"])
        torch._foreach_copy_(self.state.params, self.params)

    def round(self, optimizer, local_step: Callable[[object], dict], batches: Sequence,
              step_count: int):
        """Returns (ok, metrics): ``metrics[k]`` is the (sync_period,)
        tensor of metric k's per-step mean over the ranks."""
        optimizer.restart(step_count)
        steps = [local_step(b) for b in batches]
        keys = list(steps[0])
        stacked = torch.stack([torch.stack([m[k].float() for k in keys]) for m in steps])
        ok, mean = self.sync(optimizer, stacked)
        return ok, {k: mean[:, i] for i, k in enumerate(keys)}

    @torch.no_grad()
    def sync(self, optimizer=None, metrics: Optional[torch.Tensor] = None):
        """The round's end: one all-reduce of one flat buffer [delta | the
        local Adam moments (bmufadam) | buffers | metrics], the block update
        unless the reduced delta has a non-finite entry, then the global
        parameters into ``params`` and the averaged statistics into
        ``buffers``.  Returns (ok, the metrics' mean over the ranks)."""
        cfg, n = self.cfg, len(self.params)
        carried = []  # sent as they are, averaged
        if cfg.variant == "bmufadam":
            mu, nu = optimizer.adam_moments()
            carried += list(mu) + list(nu)
        carried += self.buffers
        if metrics is not None:
            carried.append(metrics.float())
        shapes = self.params + carried
        flat = torch.empty(sum(t.numel() for t in shapes), dtype=torch.float32,
                           device=self.params[0].device)
        views = [v.view_as(t) for v, t in
                 zip(flat.split([t.numel() for t in shapes]), shapes)]
        delta, rest = views[:n], views[n:]
        torch._foreach_copy_(delta, self.state.params)
        torch._foreach_sub_(delta, self.params)  # global - local
        if carried:
            torch._foreach_copy_(rest, carried)
        dist.all_reduce(flat, group=self.group)
        n_delta = sum(p.numel() for p in self.params)
        world = dist.get_world_size(self.group)
        # the mean over the ranks, but blockadam's delta stays the sum
        (flat[n_delta:] if cfg.variant == "blockadam" else flat).div_(world)
        ok = bool(torch.isfinite(flat[:n_delta]).all())
        if ok and cfg.variant == "bmufadam":
            bmufadam_update(self.state, delta, rest[:n], rest[n:2 * n], cfg)
        elif ok:
            block_update(self.state, delta, cfg)
        torch._foreach_copy_(self.params, self.state.params)
        m = len(self.buffers)
        if m:
            end = len(rest) - (metrics is not None)
            torch._foreach_copy_(self.buffers, rest[end - m:end])
        return ok, (rest[-1].clone() if metrics is not None else None)
