"""Batched Levenshtein distance on the device of its inputs (port of
``pika_tpu/ops/edit_distance.py``), used by the MBR step.

The row update's within-row dependency (insertions) is solved in closed
form: with ``base[i] = min(prev[i] + 1, prev[i-1] + sub_i)``, the row is
``min(base, i + cummin(base - i))``, so each hypothesis position is one
vectorised step over all N pairs (``torch.cummin`` stands in for the JAX
associative scan).  The distances are small integers held exactly in
float32.
"""

from __future__ import annotations

import torch


def edit_distance_batch(refs: torch.Tensor, ref_lens: torch.Tensor, hyps: torch.Tensor,
                        hyp_lens: torch.Tensor) -> torch.Tensor:
    """(N, U) refs vs (N, V) hyps, padded, with their lengths -> (N,) int32
    distances.  Positions at or past a length are ignored."""
    n, u = refs.shape
    i = torch.arange(u + 1, device=refs.device, dtype=torch.float32)
    prev = i.expand(n, u + 1)  # distance to the empty hypothesis
    for j in range(hyps.shape[1]):
        sub = (refs != hyps[:, j:j + 1]).float()
        tail = torch.minimum(prev[:, 1:] + 1.0, prev[:, :-1] + sub)
        base = torch.cat([tail.new_full((n, 1), j + 1.0), tail], dim=1)
        cur = torch.minimum(base, i + torch.cummin(base - i, dim=1).values)
        prev = torch.where((hyp_lens > j)[:, None], cur, prev)
    idx = ref_lens.long().clamp(0, u)[:, None]
    return prev.gather(1, idx)[:, 0].to(torch.int32)
