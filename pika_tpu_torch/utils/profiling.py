"""Profiling hooks (port of ``pika_tpu/utils/profiling.py``).

``trace(logdir)`` wraps a code block in ``torch.profiler`` (CPU and CUDA
activities) and writes a Chrome trace into ``logdir`` (view it in
``chrome://tracing``, Perfetto or TensorBoard's PyTorch plugin);
``annotate(name)`` adds a named region to the trace (and an NVTX range on the
card); ``StepTimer`` gives wall-clock per-step stats with correct device
syncing.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; on exit write ``logdir/<host>_<pid>.<ns>.pt.trace.json``
    (``logdir`` is made if missing).  Yields the ``torch.profiler.profile``
    (``key_averages()`` for sums by op)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """Named trace region: ``with annotate("beam_search"): ...``"""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


class StepTimer:
    """Per-step wall-clock stats; call ``stop`` with the step's result (a
    tensor or a nest of them) to wait for the devices it lives on."""

    def __init__(self):
        self.times = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        if result is not None:
            devices = {x.device for x in tree_leaves(result)
                       if isinstance(x, torch.Tensor) and x.is_cuda}
            for device in devices:
                torch.cuda.synchronize(device)
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[int(n * 0.9)],
            "max_s": ts[-1],
        }
