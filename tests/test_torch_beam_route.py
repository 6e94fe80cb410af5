"""The plain beam's route on the CPU: a CPU search runs the torch body and
never the bookkeeping kernels (``decode/beam_kernels.py``, which run only on
the card: tests/test_torch_gpu.py), the bodies are counted by route, and the
kernels' wrappers raise on what they do not take."""

import re
from pathlib import Path

import pytest
import torch

from pika_tpu_torch.decode import beam_kernels
from pika_tpu_torch.decode.beam import BODIES, BeamConfig, BeamLoop, beam_search, beam_search_eager
from pika_tpu_torch.decode.fst import _build_tables
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer

torch.set_num_threads(1)
MODEL = dict(input_dim=20, vocab_size=30, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="rnn", dec_layers=2, embd_dim=8, tdnn_nhid=16, tdnn_layers=5)
CSRC = Path(beam_kernels.__file__).resolve().parent.parent / "csrc" / "beam_step.cu"


@pytest.fixture(scope="module")
def case():
    model = init_transducer(TransducerConfig(**MODEL), torch.Generator().manual_seed(0), "cpu")
    enc = torch.randn(3, 8, MODEL["hid_dim"], generator=torch.Generator().manual_seed(1)) * 2
    return model, enc, torch.tensor([8, 4, 1])


@pytest.fixture
def no_kernels(monkeypatch):
    """The kernels' wrappers raise if called."""
    def called(*args, **kwargs):
        raise AssertionError("a CPU search called a beam kernel")
    for name in ("select", "update", "commit"):
        monkeypatch.setattr(beam_kernels, name, called)


@pytest.mark.parametrize("search,plain", [(beam_search, False), (beam_search_eager, False),
                                          (beam_search, True)])
def test_cpu_search_runs_the_torch_body(case, no_kernels, search, plain):
    model, enc, lens = case
    before = dict(BODIES)
    out = search(model, enc, lens, BeamConfig(beam_size=4, n_best=2, max_symbols=6), _plain=plain)
    assert BODIES["plain"] - before["plain"] >= int(out["steps"]) > 0
    assert BODIES["kernels"] == before["kernels"] and BODIES["fst"] == before["fst"]
    loops = [loop for key, loop in model._decode_loops.items() if key[-2] == plain]
    assert loops and all(loop.route == "plain" and loop.kernels is None for loop in loops)


def test_cpu_fst_search_counts_the_fst_route(case, no_kernels):
    model, enc, lens = case
    arcs = {0: [(label, 0.5, 0) for label in range(2, MODEL["vocab_size"] + 1)]}
    tables = _build_tables(1, arcs, {0: 0.0}, start=0, backoff_id=0)
    cfg = BeamConfig(beam_size=4, n_best=2, max_symbols=6, lm_scale=0.5)
    before = dict(BODIES)
    beam_search(model, enc, lens, cfg, tables.device_arrays("cpu"), tables.start)
    assert BODIES["fst"] > before["fst"]
    assert BODIES["kernels"] == before["kernels"] and BODIES["plain"] == before["plain"]


def _loop(beam_size=4, n_best=2):
    model = init_transducer(TransducerConfig(**MODEL), torch.Generator().manual_seed(0), "cpu")
    cfg = BeamConfig(beam_size=beam_size, n_best=n_best, max_symbols=6)
    return BeamLoop(model.decode_net(torch.float32), cfg, 3, 8, torch.device("cpu"))


@pytest.mark.parametrize("beam_size,n_best,match", [
    (4, 2, "unsupported device cpu"),
    (beam_kernels.MAX_BEAM + 1, 2, "at most"),
    (4, beam_kernels.MAX_NBEST + 1, "at most"),
    (beam_kernels.MAX_BEAM + 1, beam_kernels.MAX_NBEST + 1, "at most"),
])
def test_beam_step_raises_on_cpu_tensors_and_past_the_maximum(beam_size, n_best, match):
    loop = _loop(beam_size, n_best)
    assert loop.route == "plain"
    with pytest.raises(ValueError, match=match):
        beam_kernels.BeamStep(loop.state, loop.inputs, MODEL["vocab_size"], 0, 1.0, True)


@pytest.mark.parametrize("wrapper", ["BeamStep", "commit"])
def test_kernels_raise_on_net_state_without_a_slot(wrapper):
    """The kernels carry the net's state in fixed slots (``dec_h``,
    ``dec_c``): a state tensor without one would go ungathered, so the
    wrappers raise, on any device."""
    loop = _loop()
    extra = torch.zeros_like(loop.state["dec_h"])
    x = torch.zeros(12, MODEL["hid_dim"])
    call = {"BeamStep": lambda: beam_kernels.BeamStep(
                dict(loop.state, dec_k=extra), loop.inputs, MODEL["vocab_size"], 0, 1.0, True),
            "commit": lambda: beam_kernels.commit(None, x, x, {"dec_k": extra})}[wrapper]
    with pytest.raises(ValueError, match="no slot for the .* dec_k"):
        call()


@pytest.mark.parametrize("wrapper", ["select", "commit"])
def test_wrappers_raise_on_cpu_tensors(wrapper):
    x = torch.zeros(12, MODEL["hid_dim"])
    call = {"select": lambda: beam_kernels.select(None, x),
            "commit": lambda: beam_kernels.commit(None, x, x)}[wrapper]
    before = beam_kernels.launches()
    with pytest.raises(ValueError, match="unsupported device cpu"):
        call()
    assert beam_kernels.launches() == before


@pytest.mark.parametrize("enum,names", [("Slot", beam_kernels.SLOTS), ("Dim", beam_kernels.DIMS)])
def test_wrapper_tables_follow_the_source(enum, names):
    """SLOTS and DIMS name csrc/beam_step.cu's enums in their order."""
    body = re.search(r"enum %s \{([^}]*)\}" % enum, CSRC.read_text()).group(1)
    source = [name.strip()[1:].lower() for name in body.split(",")][:-1]  # the last is the count
    assert source == [name.replace("_", "").lower() for name in names]


def test_the_body_dispatches_by_route(monkeypatch):
    """A loop whose route is "kernels" runs ``kernel_body``; the others
    ``torch_body``; ``BODIES`` counts each."""
    loop = _loop()
    ran = []
    monkeypatch.setattr(loop, "kernel_body", lambda: ran.append("kernels"))
    monkeypatch.setattr(loop, "torch_body", lambda: ran.append("torch"))
    before = dict(BODIES)
    loop.body()
    loop.route, loop.kernels = "kernels", object()
    loop.body()
    assert ran == ["torch", "kernels"]
    assert BODIES["plain"] == before["plain"] + 1 and BODIES["kernels"] == before["kernels"] + 1


@pytest.mark.parametrize("python,source", [("MAX_BEAM", "kMaxBeam"), ("MAX_NBEST", "kMaxBest"),
                                           ("MAX_VOCAB", "kMaxVocab"),
                                           ("MAX_LAYERS", "kMaxLayers")])
def test_wrapper_limits_follow_the_source(python, source):
    """The wrappers raise where the C entry points would refuse."""
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", CSRC.read_text()))
    value = eval(consts[source], {}, {k: eval(v, {}, {}) for k, v in consts.items()
                                      if re.fullmatch(r"[\d *()]+", v)})
    assert getattr(beam_kernels, python) == value
