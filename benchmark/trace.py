"""The traced stretches: a few units of work after the window under
``torch.profiler``, reduced to device intervals, the device's busy
seconds, the heaviest device operations and the longest idle gaps named
by what the host was doing.

On a card two stretches run, each bracketed by synchronizations.  One
traces the host's operators too, which slows a host that launches many
small kernels (a training step by about a third), and only names the idle
gaps; its window is the host interval of the annotation
``bench.stretch``.  The other traces the device's activity alone, which
costs the host little: its window runs from the first device operation's
start to the last one's end, and it gives the busy share, the device
operations and the kernels' times.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Callable

import torch
from torch.autograd import DeviceType

STRETCH = "bench.stretch"


def base_name(kernel: str) -> str:
    """A kernel's identifier without return type, namespaces, template
    arguments or parameters: ``void (anonymous namespace)::dw_kernel<256>(...)``
    -> ``dw_kernel``."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = re.split(r"[(<]", name, maxsplit=1)[0].split("::")[-1].strip()
    return name[5:] if name.startswith("void ") else name or kernel


class Trace:
    """Events of one stretch: ``device`` (name, start s, end s) sorted by
    start, ``host`` (name, start s, end s), the window [t0, t1] and the
    units of work it held."""

    def __init__(self, events, units: int, seconds: float = 0.0):
        self.units = units
        self.seconds = seconds      # the stretch's host seconds, synchronizations included
        self.host_trace = None      # a stretch traced with the host, which names the gaps
        device, host, window = [], [], None
        for e in events:
            start = e.start_ns() * 1e-9
            end = start + e.duration_ns() * 1e-9
            if e.device_type() == DeviceType.CPU:
                if e.name() == STRETCH:
                    window = (start, end)
                host.append((e.name(), start, end))
            elif e.name() != STRETCH and not getattr(e, "is_user_annotation", bool)():
                device.append((e.name(), start, end))  # kernels, copies, sets: not ranges
        if window is None and device:
            window = (min(d[1] for d in device), max(d[2] for d in device))
        if window is None:
            raise RuntimeError(f"the trace holds no {STRETCH} annotation and no device event")
        self.t0, self.t1 = window
        self.device = sorted((d for d in device if d[2] > self.t0 and d[1] < self.t1),
                             key=lambda d: d[1])
        self.host = host

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> list:
        merged = []
        for _, s, e in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def top_device_ops(self, n: int = 10) -> list:
        total = defaultdict(float)
        for name, s, e in self.device:
            total[base_name(name)] += e - s
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10, longest: int = 200) -> list:
        """The ``longest`` idle gaps of the window, their seconds grouped by
        the innermost host event under each gap's midpoint (of the stretch
        traced with the host, where there is one)."""
        if self.host_trace is not None:
            return self.host_trace.idle_gaps(n, longest)
        edges = [self.t0] + [x for iv in self.busy_intervals() for x in iv] + [self.t1]
        gaps = sorted(((e - s, s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s),
                      reverse=True)[:longest]
        host = sorted((h for h in self.host if h[0] != STRETCH), key=lambda h: h[1])
        starts = [h[1] for h in host]
        total = defaultdict(float)
        for length, s, e in gaps:
            mid = (s + e) / 2
            label = "host idle"
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if host[i][2] >= mid:
                    label = host[i][0]
                    break
            total[label] += length
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]

    def kernel_seconds(self, names, owners=(), shared=()) -> float:
        """Device seconds of the kernels whose base name is in ``names``,
        plus each kernel named in ``shared`` whose next kernel among
        ``owners`` (a set that holds ``names``) is one of ``names``."""
        names, owners, shared = set(names), set(owners) | set(names), set(shared)
        total, pending = 0.0, 0.0
        for name, s, e in self.device:
            base = base_name(name)
            if base in shared:
                pending += e - s
            elif base in owners:
                if base in names:
                    total += e - s + pending
                pending = 0.0
        return total

    def found(self, names) -> bool:
        names = set(names)
        return any(base_name(n) in names for n, _, _ in self.device)


def profile_stretch(run_units: Callable[[], int], device: torch.device) -> Trace:
    """Profile ``run_units()`` (which returns the units it ran): on a card
    a stretch with the host, whose trace names the idle gaps, then one of
    the device alone, which gives the rest.  The first profiled stretch of
    a process also pays the profiler's start (its first units ran 10-25 %
    slower), so the device alone comes second.  Elsewhere one stretch with
    the host."""
    from torch.profiler import ProfilerActivity

    if device.type != "cuda":
        return _profile(run_units, device, [ProfilerActivity.CPU])
    host = _profile(run_units, device, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    tr = _profile(run_units, device, [ProfilerActivity.CUDA])
    tr.host_trace = host
    return tr


def _profile(run_units: Callable[[], int], device: torch.device, activities: list) -> Trace:
    from torch.profiler import profile, record_function

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    with profile(activities=activities) as prof:
        with record_function(STRETCH):
            sync()
            t = time.perf_counter()
            units = run_units()
            sync()
            t = time.perf_counter() - t
    return Trace(prof.profiler.kineto_results.events(), units, t)
