"""Process groups and the rows of the global batch (port of
``pika_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a device mesh whose ``data``
axis shards the batch.  The port runs one worker process per card (rank r
of world W) in a ``torch.distributed`` process group: NCCL on the card,
gloo on the CPU; the device chooses the backend.  Every rank reads the
same global batch stream and takes the rows that ``data_sharding`` gives
device r: ``[r * b, (r + 1) * b)``.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

# no collective waits longer than this: a rank that died makes the others
# fail instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


@contextlib.contextmanager
def local_rendezvous():
    """The ``init_method`` of ranks spawned on this host: a ``file://`` store
    in a fresh temporary directory, removed on exit.  No port is probed and
    released, so no other process can take it before rank 0 binds it."""
    with tempfile.TemporaryDirectory(prefix="pika-rendezvous-") as tmp:
        yield "file://" + os.path.join(tmp, "store")


@contextlib.contextmanager
def process_group(device: torch.device, rank: int = 0, world_size: int = 1,
                  init_method: Optional[str] = None):
    """The default process group for the body of the ``with``: NCCL on a
    CUDA ``device``, gloo on the CPU.  ``init_method`` is ``tcp://host:port``
    (rank 0 listens there) or ``file://path`` (``local_rendezvous``); a
    world of one needs none (an in-memory store).
    Destroyed on exit."""
    device = torch.device(device)
    kw = {"device_id": device} if device.type == "cuda" else {}
    if init_method is None:
        if world_size != 1:
            raise ValueError("a process group of more than one rank needs an init_method")
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = init_method
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", rank=rank,
                            world_size=world_size, timeout=TIMEOUT, **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rows(batch: dict, r: int, w: int) -> dict:
    """Rank ``r``'s rows of a global host batch (numpy arrays or lists with
    the batch on axis 0): ``[r * b, (r + 1) * b)`` with ``b = len / w``, as
    the JAX package's ``data_sharding`` gives device r."""
    if w == 1:
        return batch
    out = {}
    for k, v in batch.items():
        n = len(v)
        if n % w:
            raise ValueError(f"batch key {k!r}: {n} rows do not split over {w} ranks")
        b = n // w
        out[k] = v[r * b:(r + 1) * b]
    return out


@torch.no_grad()
def replicate(tensors: Iterable[torch.Tensor]) -> None:
    """Rank 0's values in every rank's ``tensors``, in place (the
    counterpart of ``replicate_tree``); nothing to do in a world of one."""
    if world_size() == 1:
        return
    for t in tensors:
        dist.broadcast(t, src=0)


def all_sum(values, device: torch.device) -> np.ndarray:
    """The sum over ranks of a host vector, as float64 (one collective on
    ``device``, the rank's own)."""
    x = torch.tensor(np.asarray(values, np.float64), device=device)
    if world_size() > 1:
        dist.all_reduce(x)
    return x.cpu().numpy()


def barrier() -> None:
    """Wait for every rank (nothing to do in a world of one)."""
    if world_size() > 1:
        dist.barrier()
