"""The benchmark's weights, made on the device from the seed in one draw,
and handed alike to the program and to the reference.

One ``torch.randn`` over every weight's elements at once, from a
generator on the card; each weight is a slice of it times its scale:
1/sqrt(fan in) for dense, convolution and LSTM matrices (fan in: the
elements of one output row), 1/sqrt(width) for the embedding.  Biases and
the norms' shifts are 0, the norms' scales 1, BatchNorm's running
statistics (0, 1).  The names and shapes are those of the program's
checkpoints, read from its module on the meta device.
"""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one of a run's streams (weights, traffic, the
    step's draws) from ``--seed``."""
    words = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream]).generate_state(2)
    return int((int(words[0]) << 32 | int(words[1])) & (2 ** 63 - 1))


def _fill(name: str, shape: tuple) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return "one"
    if leaf in ("running_mean", "num_batches_tracked", "bias") or leaf.startswith("bias_"):
        return "zero"
    if len(shape) == 1:  # LayerNorm and BatchNorm scales
        return "one"
    return "normal"


def make_state(shapes: dict, seed: int, device) -> dict:
    """``shapes``: name -> (shape, dtype) of every weight and buffer.
    Returns name -> tensor on ``device``."""
    normal = [(n, s) for n, (s, _) in shapes.items() if _fill(n, s) == "normal"]
    total = sum(int(np.prod(s)) for _, s in normal)
    gen = torch.Generator(device).manual_seed(sub_seed(seed, 0))
    flat = torch.randn(total, generator=gen, device=device)
    state, at = {}, 0
    for name, (shape, dtype) in shapes.items():
        kind = _fill(name, shape)
        if kind == "normal":
            n = int(np.prod(shape))
            fan_in = shape[-1] if name.endswith("embed.weight") else n // shape[0]
            state[name] = flat[at:at + n].view(shape).mul_(fan_in ** -0.5)
            at += n
        elif kind == "one":
            state[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            state[name] = torch.zeros(shape, dtype=dtype, device=device)
    return state
