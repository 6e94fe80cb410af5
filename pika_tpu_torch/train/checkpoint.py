"""Full-state training checkpoints (port of ``pika_tpu/train/checkpoint.py``,
``torch.save`` in place of Orbax).

``directory/<step>/state.pt`` holds the model's state dict (BatchNorm
statistics included), the optimizer's (``train/lr.py:Optimizer``: momentum
and the schedule's ``count``) and the metadata (``{"epoch": N}``), so a
resume continues exactly; a BMUF run's also its block state (the global
parameters are the model's; ``delta_prev``, the Adam moments, the counts,
``rho``) and ``steps``, the global batches done.  The file is written under a temporary name and
moved into place with ``os.replace``: a run killed mid-write leaves the
previous checkpoint readable.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

STATE = "state.pt"


def save_checkpoint(directory: str, step: int, model_state: dict, optimizer_state: dict,
                    metadata: Optional[dict] = None, bmuf_state: Optional[dict] = None) -> str:
    """Write ``directory/step/state.pt`` from host or device state dicts
    (with ``bmuf_state``, a BMUF run's ``BMUF.state_dict()`` and its
    ``steps``); returns the step's directory."""
    path = os.path.join(os.path.abspath(directory), str(step))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE + ".tmp")
    state = {"model": model_state, "optimizer": optimizer_state, "metadata": metadata or {}}
    if bmuf_state is not None:
        state["bmuf"] = bmuf_state
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE))
    return path


def restore_checkpoint(directory: str, step: Optional[int] = None, map_location=None) -> dict:
    """``{"model", "optimizer", "metadata"[, "bmuf"]}`` of ``directory/step``
    (the newest step when none is given); raises FileNotFoundError without
    one."""
    directory = os.path.abspath(directory)
    if step is None:
        steps = ([int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.exists(os.path.join(directory, d, STATE))]
                 if os.path.isdir(directory) else [])
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        step = max(steps)
    return torch.load(os.path.join(directory, str(step), STATE), map_location=map_location,
                      weights_only=True)
