"""The port's spans (``utils/profiling.py:span``) and the benchmark's
readings of them (``benchmark/spans.py``, ``benchmark/metrics/``), on the
CPU: a span does nothing with no profiler running; under one, a training
step of the benchmark's tiny model and an eager beam search give each span
the expected count and nesting; the idle metrics read the right numbers
from hand-built traces, and nothing where the spans are absent.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_spans.py -q
"""

from __future__ import annotations

import importlib.util
import json
import math
from collections import Counter

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import program, spans, trace, traffic
from benchmark.tests import tiny
from pika_tpu_torch.decode.loop import STEPS_PER_CHECK, DecodeLoop
from pika_tpu_torch.utils import profiling

CPU = torch.device("cpu")
TRAIN_COUNTS = {"train.step": 1, "features": 1, "encoder": 1, "prediction_net": 1, "loss.k1": 1,
                "loss.alpha": 1, "train.backward": 1, "loss.occupancy": 1, "loss.k23": 1,
                "optimizer": 2}
# span -> the span it lies in, in a float32 training step
TRAIN_PARENT = {"features": "train.step", "encoder": "train.step",
                "prediction_net": "train.step", "loss.k1": "train.step",
                "loss.alpha": "train.step", "train.backward": "train.step",
                "optimizer": "train.step", "loss.occupancy": "train.backward",
                "loss.k23": "train.backward"}


def tiny_config(name: str) -> dict:
    config = json.loads((tiny.BENCH / "configs" / f"{name}.json").read_text())
    config["model"].update(tiny.TINY_MODEL)
    config["features"].update(tiny.TINY_FEAT)
    return config


def tiny_mix(name: str, cell: str) -> dict:
    mix = traffic.load(tiny.BENCH / "traffic" / f"{name}.json")
    mix.update(tiny.CELLS[cell])
    return mix


@pytest.fixture(scope="module")
def train_step():
    """The benchmark's training step at the tiny tree's size, and a batch."""
    config, mix = tiny_config("pika_flagship"), tiny_mix("train_b32_10s",
                                                         "flagship.train_b32_10s")
    model, _ = program.build_model(config, 11, CPU)
    optimizer = program.make_optimizer(model.parameters(), "sgd", **mix["optimizer"])
    feat = program.featurizer(config, traffic.samples(mix), CPU, mix["spec_augment"],
                              mix["max_freq_span"], mix["max_time_span"])
    step = program.make_train_step(model, optimizer, feat, loss_chunk=mix["loss_chunk"])
    batch = traffic.make_pool(mix, config["model"]["vocab_size"], 11, CPU)[0]
    return step, batch, torch.Generator(CPU).manual_seed(3)


def named(tr, name: str) -> list:
    return [(s, e) for n, s, e in tr.host if n == name]


def inside(inner, outer) -> bool:
    return any(a <= inner[0] and inner[1] <= b for a, b in outer)


def test_span_without_a_profiler_does_nothing(monkeypatch, train_step):
    """No profiler: one shared null context, and neither ``record_function``
    nor an NVTX range is called by ``span``, alone or in a whole training
    step (where torch's optimizer opens its own ranges)."""
    def boom(*args, **kw):
        raise AssertionError("called with no profiler running")

    opened = []
    record_function = torch.autograd.profiler.record_function

    def recorder(name, *args, **kw):
        opened.append(name)
        return record_function(name, *args, **kw)

    for name in ("range", "range_push", "range_pop", "mark"):
        monkeypatch.setattr(torch.cuda.nvtx, name, boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    assert profiling.span("encoder") is profiling.span("decode.loop")
    with profiling.span("encoder"):
        pass
    monkeypatch.setattr(torch.profiler, "record_function", recorder)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", recorder)
    step, batch, gen = train_step
    assert math.isfinite(float(step(batch, gen)["loss"]))
    assert not set(opened) & set(spans.PROGRAM)


def test_training_step_spans(train_step):
    """One traced training step (the benchmark's stretch on the CPU): each
    span its count, each inside its parent."""
    step, batch, gen = train_step
    tr = trace.profile_stretch(lambda: (step(batch, gen), 1)[1], CPU)
    counts = Counter(n for n, _, _ in tr.host if n in spans.PROGRAM)
    assert dict(counts) == TRAIN_COUNTS
    for child, parent in TRAIN_PARENT.items():
        for iv in named(tr, child):
            assert inside(iv, named(tr, parent)), (child, parent)


@pytest.mark.parametrize("config", ["pika_flagship", "pika_convtf"])
def test_eager_beam_search_spans(config, monkeypatch):
    """An eager beam search: one ``decode.loop`` around every body, and a
    ``decode.flag_read`` a group of ``STEPS_PER_CHECK`` bodies."""
    cfg, mix = tiny_config(config), tiny_mix("decode_b8_beam8", "flagship.decode_b8_beam8")
    model, _ = program.build_model(cfg, 12, CPU)
    feat = program.featurizer(cfg, traffic.samples(mix), CPU)
    batch = traffic.make_pool(mix, 0, 12, CPU)[0]
    beam = program.BeamConfig(beam_size=mix["beam"], n_best=mix["n_best"],
                              sm_scale=mix["sm_scale"], max_symbols=mix["max_symbols"])
    bodies = []
    for cls in DecodeLoop.__subclasses__():
        body = cls.body
        monkeypatch.setattr(cls, "body", lambda self, body=body: (bodies.append(1), body(self)))

    def search():
        program.beam_search_features(model, *feat(batch["wavs"], batch["wav_lens"]), beam)
        return 1

    tr = trace.profile_stretch(search, CPU)
    counts = Counter(n for n, _, _ in tr.host if n in spans.PROGRAM)
    assert counts["decode.loop"] == 1 and counts["features"] == 1 and counts["encoder"] == 1
    assert len(bodies) >= 1
    assert counts["decode.flag_read"] == math.ceil(len(bodies) / STEPS_PER_CHECK)
    loop = named(tr, "decode.loop")
    assert all(inside(iv, loop) for iv in named(tr, "decode.flag_read"))
    # the LSTM net steps inside the body; the transformer net re-forwards
    # its prefixes there, once a body and once at the reset
    assert counts["prediction_net"] == (0 if config == "pika_flagship" else len(bodies) + 1)


# ---------------------------------------------------------------------------
# readings of hand-built traces
# ---------------------------------------------------------------------------

class Event:
    """The part of a profiler event that ``trace.Trace`` reads; times in ms."""

    def __init__(self, name, start_ms, end_ms, device=False, annotation=False):
        self._name, self._device, self._annotation = name, device, annotation
        self._start, self._dur = int(start_ms * 1e6), int((end_ms - start_ms) * 1e6)

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return DeviceType.CUDA if self._device else DeviceType.CPU

    def is_user_annotation(self):
        return self._annotation


KERNELS = [("lse_kernel", 5, 20), ("h_kernel", 30, 40), ("dz_kernel", 60, 90)]


def events(host_spans=(), annotations=()) -> list:
    """A 100 ms stretch with three device intervals, idle over 0-5, 20-30,
    40-60 and 90-100 ms; ``host_spans``: (name, start, end) host ranges;
    ``annotations``: the device-side ones the profiler adds for them."""
    out = [Event(trace.STRETCH, 0, 100), Event("cudaLaunchKernel", 1, 2)]
    out += [Event(n, s, e, device=True) for n, s, e in KERNELS]
    out += [Event(n, s, e) for n, s, e in host_spans]
    out += [Event(n, s, e, device=True, annotation=True) for n, s, e in annotations]
    return out


def record(host_events, units=2) -> dict:
    """A ``--trace 1`` record on a card: the device-only stretch with the
    stretch traced with the host beside it."""
    outer = trace.Trace([e for e in host_events if e.device_type() == DeviceType.CUDA], units)
    outer.host_trace = trace.Trace(host_events, units)
    return {"trace": outer, "shapes": {"batch": 32, "t_enc": 239, "u1": 41, "hid": 1024,
                                       "vocab": 6268, "frames": 1000, "nhid": 1024}}


def metric(name: str):
    spec = importlib.util.spec_from_file_location(name, tiny.BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


TRAIN_SPANS = [("train.step", 0, 95), ("loss.alpha", 10, 35), ("train.backward", 45, 80),
               ("loss.occupancy", 50, 70), ("decode.loop", 200, 300)]


def test_loss_dp_idle_ms():
    """loss.alpha over 20-30 and loss.occupancy over 50-60 ms idle: 20 ms in
    two units."""
    read = metric("loss_dp_idle_ms")
    assert read(record(events(TRAIN_SPANS))) == pytest.approx(10.0)
    assert read(record(events(TRAIN_SPANS), units=4)) == pytest.approx(5.0)


def test_decode_loop_idle_ms():
    read = metric("decode_loop_idle_ms")
    loop = [("decode.loop", 3, 97), ("decode.flag_read", 22, 24), ("decode.flag_read", 88, 92)]
    # 3-5, 20-30, 40-60, 90-97: 39 ms in two units
    assert read(record(events(loop))) == pytest.approx(19.5)


@pytest.mark.parametrize("name", ["loss_dp_idle_ms", "decode_loop_idle_ms"])
def test_idle_metrics_read_nothing_without_their_spans(name):
    read = metric(name)
    other = [s for s in TRAIN_SPANS if not s[0].startswith(name.split("_")[0])]
    assert read(record(events(other))) is None
    assert read(record(events())) is None
    assert read({"trace": None}) is None
    cpu = trace.Trace(events(TRAIN_SPANS), 2)       # no stretch traced with the host
    assert read({"trace": cpu}) is None


def test_idle_by_span():
    """Each idle second under the innermost span, the rest under none."""
    tr = record(events(TRAIN_SPANS))["trace"].host_trace
    got = spans.idle_by_span(tr)
    # idle 0-5, 20-30, 40-60, 90-100 ms under train.step 0-95 (train.backward
    # 45-80 in it, loss.occupancy 50-70 in that), loss.alpha 10-35
    want = {"train.step": 5 + 5 + 5, "loss.alpha": 10, "train.backward": 5,
            "loss.occupancy": 10, spans.NO_SPAN: 5}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v * 1e-3)
    assert sum(got.values()) == pytest.approx(tr.window_s - tr.busy_s)


def test_existing_readings_do_not_move_with_spans():
    """The spans' host ranges and their device-side annotations leave every
    reading of the device, each device metric and the device operations of
    the breakdown as they were without them."""
    names = ["k1_roofline", "k23_roofline", "device_idle_pct.train", "device_idle_pct.decode"]
    annotations = [(n, s + 1, e + 1) for n, s, e in TRAIN_SPANS]
    plain, spanned = record(events()), record(events(TRAIN_SPANS, annotations))
    for name in names:
        assert metric(name)(spanned) == metric(name)(plain)
    for a, b in ((plain["trace"], spanned["trace"]),
                 (plain["trace"].host_trace, spanned["trace"].host_trace)):
        assert (a.busy_s, a.window_s, a.device) == (b.busy_s, b.window_s, b.device)
        assert a.top_device_ops() == b.top_device_ops()
    assert metric("device_idle_pct.train")(plain) == pytest.approx(100.0 * 30 / 85)
