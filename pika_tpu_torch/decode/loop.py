"""How the decode loops run: a fixed-shape body that updates its state in
place, eagerly on the CPU and as one CUDA graph on the card.

The JAX package runs each search as one ``lax.while_loop``, one compiled
program.  Here a loop's state lives in static tensors and ``body()``
updates them in place with no host sync and no new shape.  A device flag
carries the loop's condition: the body starts with ``running &=
cond(state)`` and masks every update with it, so the steps after the JAX
loop would have stopped are exact no-ops and the host reads the flag only
every ``steps_per_check`` steps.  On a CUDA tensor the body is captured once
per shape in a CUDA graph and replayed; a failed capture raises.  On the
CPU the same body runs eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from pika_tpu_torch.models.transducer import Transducer
from pika_tpu_torch.utils.profiling import span

# replays between two reads of the device flag (chip_smoke.py times the
# flagship beam search at 1, 4, 16 and 64)
STEPS_PER_CHECK = 16

# the side stream of each device's warm-ups and captures
_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


class DecodeLoop:
    """Base of the greedy and the beam loop.  A subclass allocates its state
    in ``__init__`` (``self.state``, a dict of tensors holding a 0-d bool
    ``running``), fills it in ``reset`` and defines ``body``, which ends in
    ``commit``.  ``max_bodies`` bounds the bodies until ``running`` is
    False."""

    max_bodies: int
    state: Dict[str, torch.Tensor]

    def __init__(self):
        self.graph = None

    def reset(self, *inputs) -> None:
        raise NotImplementedError

    def body(self) -> None:
        raise NotImplementedError

    def commit(self, new: Dict[str, torch.Tensor]) -> None:
        """Write the step's new state where the loop is still running."""
        running = self.state["running"]
        for name, value in new.items():
            buf = self.state[name]
            buf.copy_(torch.where(running, value, buf))

    def capture(self) -> None:
        """Capture ``body`` in a CUDA graph, after a warm-up on the capture
        stream that allocates the library workspaces (cuBLAS, the sort).
        Every capture on a device shares one side stream: cuBLAS keeps a
        workspace for each stream it has run on, for the life of the
        process.  The warm-up moves the state: reset it before running.
        The capture forbids unsafe CUDA calls on this thread only: the
        training CLIs pin the next batches on a prefetch thread, whose host
        allocator queries CUDA events (and may allocate) at any moment, and
        in the default global mode that invalidates the capture."""
        device = self.state["running"].device
        if device not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
        stream = _CAPTURE_STREAMS[device]
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(2):
                self.body()
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
            self.body()

    def run(self, graphed: bool, steps_per_check: int, *inputs) -> None:
        """Reset to ``inputs`` and run to the end: replays of the graph
        (captured on first use) when ``graphed``, else the eager body.  The
        span ``decode.loop`` holds it all, ``decode.flag_read`` each read of
        the device flag."""
        if steps_per_check < 1:
            raise ValueError(f"steps_per_check must be positive, got {steps_per_check}")
        with span("decode.loop"):
            self.reset(*inputs)
            if graphed and self.graph is None:
                self.capture()
                self.reset(*inputs)
            step = self.graph.replay if graphed else self.body
            for _ in range(-(-self.max_bodies // steps_per_check)):
                for _ in range(steps_per_check):
                    step()
                with span("decode.flag_read"):
                    running = bool(self.state["running"])
                if not running:
                    return
        raise RuntimeError(f"decode loop still running after {self.max_bodies} steps")


def cached_loop(model: Transducer, key: tuple, dtype: torch.dtype,
                make: Callable[[Transducer], DecodeLoop]) -> DecodeLoop:
    """The loop of ``model`` for ``key`` (its shapes and settings), made by
    ``make(net)`` on first use and kept on the model, with ``net`` the
    model's ``decode_net`` in ``dtype``, refreshed from the model on every
    call."""
    loops = model.__dict__.setdefault("_decode_loops", {})
    key = key + (dtype,)
    if key not in loops:
        loops[key] = make(model.decode_net(dtype))
    loop = loops[key]
    model.load_decode_weights(loop.net)
    return loop
