"""Synchronous data parallelism across ranks (port of
``pika_tpu/parallel/dp.py:jit_dp``).

Under ``jit_dp`` the JAX step differentiates the *global* summed loss over
the batch sharded on the mesh, so:

* the gradient is the **sum** over ranks (not DDP's average), taken before
  the inf-norm clip: ``SumGradients`` wraps the optimizer and all-reduces
  the gradients in one flattened buffer before its step;
* flax's BatchNorm takes its batch moments over the **global** batch, in
  the forward and the backward: ``global_batch_norm`` makes the TDNN
  encoder's BatchNorm all-reduce its moments in train mode through the
  autograd-aware ``torch.distributed.nn.functional.all_reduce``.

Both apply only in a world of more than one rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from pika_tpu_torch.models.tdnn_transformer import TDNNTransformerEncoder


class SumGradients:
    """An optimizer (``train/lr.py:Optimizer``) whose ``step()`` first sums
    the parameters' gradients over the ranks of ``group`` (one all-reduce
    of one flattened buffer); everything else is the wrapped optimizer's."""

    def __init__(self, optimizer, group=None):
        self.optimizer = optimizer
        self.group = group

    def __getattr__(self, name):
        return getattr(self.optimizer, name)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.optimizer.params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])
        self.optimizer.step()


def global_batch_norm(model: nn.Module, group=None) -> None:
    """Take the batch moments of every TDNN encoder's BatchNorm in
    ``model`` over the ranks of ``group`` in train mode (the running
    statistics then move identically on every rank)."""
    for mod in model.modules():
        if isinstance(mod, TDNNTransformerEncoder):
            mod.moments_group = group if group is not None else dist.group.WORLD
