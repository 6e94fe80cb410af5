"""The reference's model parts, found by name (``reference/model.py:part``):
every configuration resolves its encoder and prediction net and has each
of its ``model`` keys read; an encoder added as a new file alone is taken
by the cell's shapes, the reference and the step's operation count; the
reference's outputs at the tiny sizes are the ones pinned before its
encoders and prediction nets moved into parts of their own.

    python -m pytest benchmark/tests/test_benchmark_parts.py -q
"""

from __future__ import annotations

import dataclasses
import json
import sys

import pytest
import torch

from benchmark import counts, harness, program, traffic, weights
from benchmark.reference import encoders
from benchmark.reference import decode as RD
from benchmark.reference import features as RF
from benchmark.reference import model as M
from benchmark.reference import train as RT
from benchmark.tests import tiny

CONFIGS = {c["name"]: tiny.REPO / c["file"] for c in tiny.bench()["configs"]}
FIELDS = {f.name for f in dataclasses.fields(program.TransducerConfig)}

# Readings of the reference at the tiny sizes on the CPU with one thread
# (``reference_readings`` below), taken from the commit before the parts
# moved out of ``reference/model.py``: each output's norm, then each
# utterance's; the two steps' losses; the first gradient's and the
# parameters' norms after the steps, summed over the leaves.
PINNED = {
    "pika_flagship": {
        "encoder_eval": [32.87238311767578, 19.462066650390625, 19.453384399414062,
                         17.982980728149414],
        "encoder_train": [24.50420570373535, 14.221406936645508, 13.99992561340332,
                          14.220046043395996],
        "predict_eval": [0.7182468175888062, 0.47396793961524963, 0.4210149347782135,
                         0.3376081883907318],
        "predict_train": [0.8270634412765503, 0.5231555104255676, 0.482022762298584,
                          0.4218960404396057],
        "losses": [405.0094909667969, 403.6072082519531],
        "grad_norm": 71.3076171875, "after_norm": 384.81256103515625},
    "pika_convtf": {
        "encoder_eval": [32.87238311767578, 19.462066650390625, 19.453384399414062,
                         17.982980728149414],
        "encoder_train": [24.50420570373535, 14.221406936645508, 13.99992561340332,
                          14.220046043395996],
        "predict_eval": [23.736608505249023, 13.846378326416016, 13.39384937286377,
                         13.867557525634766],
        "predict_train": [24.714168548583984, 14.058984756469727, 14.556312561035156,
                          14.186222076416016],
        "losses": [404.7137451171875, 406.3089599609375],
        "grad_norm": 113.77526092529297, "after_norm": 424.5169982910156},
}
# the cells' shapes before the encoder part gave its own
SHAPES = {
    "flagship.train_b32_10s": {"batch": 32, "frames": 998, "t_enc": 239, "u1": 41,
                               "hid": 1024, "vocab": 6268, "nhid": 1024},
    "flagship.decode_b8_beam8": {"batch": 8, "frames": 998, "t_enc": 239, "u1": 1,
                                 "hid": 1024, "vocab": 6268, "nhid": 1024},
    "convtf.decode_b8_beam8": {"batch": 8, "frames": 998, "t_enc": 239, "u1": 1,
                               "hid": 1024, "vocab": 6268, "nhid": 1024},
}
STUB = '''
from benchmark.reference.model import linear

KEYS = ("stub_stride",)
TINY = {"stub_stride": 4}


def shapes(frames, model):
    return {"t_enc": frames // model["stub_stride"], "stub_width": model["hid_dim"]}


def flops(shapes, model):
    return 2.0 * shapes["t_enc"] * model["input_dim"] * model["hid_dim"]


def forward(p, x, model, prec, train=False, gen=None):
    return linear(prec.enc, x[:, ::model["stub_stride"]], p, "stub.proj")
'''


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load(name: str) -> dict:
    return json.loads(CONFIGS[name].read_text())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_configuration_resolves_its_parts(name):
    """Each part defines what the harness and the tiny tree ask of it, and
    every ``model`` key is a field of the port or read by the reference."""
    config = load(name)
    model = config["model"]
    enc, dec = M.parts(model)
    for part in (enc, dec):
        assert callable(part.forward) and callable(part.flops)
        assert isinstance(part.KEYS, tuple) and isinstance(part.TINY, dict)
        assert set(part.TINY) <= set(part.KEYS) | FIELDS
    assert callable(enc.shapes)
    assert set(model) <= FIELDS | M.keys(model)
    assert program.transducer_config(config).encoder_type == model["encoder_type"]


def test_an_unread_key_is_refused():
    config = load("pika_flagship")
    config["model"]["conformer_blocks"] = 17
    with pytest.raises(ValueError, match="conformer_blocks"):
        program.transducer_config(config)


def test_a_kernel_the_weights_lack_is_refused():
    """The port takes the conv-transformer's kernel from its own default;
    the configuration's ``dec_kernel`` has to be the weights'."""
    config = load("pika_convtf")
    config["model"] = model = tiny.tiny_model(dict(config["model"], dec_kernel=7))
    _, layout = program.build_model(config, 1, "cpu")
    state = weights.make_state(layout["shapes"], 1, "cpu")
    with pytest.raises(ValueError, match="dec_kernel 7"):
        M.predict(state, torch.ones(1, 3, dtype=torch.long), torch.tensor([3]), model)


def test_a_missing_part_names_its_file():
    model = dict(load("pika_flagship")["model"], encoder_type="no_such_encoder")
    with pytest.raises(LookupError, match=r"encoders/no_such_encoder\.py"):
        M.encoder({}, torch.zeros(1, 4, 24), model)
    with pytest.raises(LookupError, match=r"decoders/no_such_net\.py"):
        M.part("decoders", "no_such_net")


@pytest.fixture
def stub_encoder(tmp_path, monkeypatch):
    """An encoder part that exists only as a new file, on a directory the
    encoders' package searches; gone again after the test."""
    (tmp_path / "stub_encoder.py").write_text(STUB)
    monkeypatch.setattr(encoders, "__path__", [str(tmp_path)] + list(encoders.__path__))
    yield "stub_encoder"
    sys.modules.pop(f"{encoders.__name__}.stub_encoder", None)


def test_a_new_encoder_is_only_a_new_file(stub_encoder):
    config = load("pika_flagship")
    config["model"] = model = dict(config["model"], encoder_type=stub_encoder, stub_stride=4)
    with pytest.raises(ValueError, match="encoder_heads"):   # the TDNN's, read by no part now
        program.transducer_config(config)
    del model["encoder_heads"]
    mix = traffic.load(tiny.BENCH / "traffic" / "train_b32_10s.json")
    shapes = harness.shapes_of(config, mix)
    assert shapes == {"batch": 32, "frames": 998, "u1": 41, "hid": 1024, "vocab": 6268,
                      "t_enc": 249, "stub_width": 1024}
    assert "stub_stride" in M.keys(model)
    assert program.transducer_config(config).encoder_type == stub_encoder
    assert tiny.tiny_model(model)["stub_stride"] == 4
    gen = torch.Generator().manual_seed(3)
    p = {"stub.proj.weight": torch.randn(8, 24, generator=gen), "stub.proj.bias": torch.zeros(8)}
    x = torch.randn(2, 12, 24, generator=gen)
    out = M.encoder(p, x, dict(model, input_dim=24))
    assert torch.equal(out, x[:, ::4] @ p["stub.proj.weight"].t())
    lstm = 2 * 41 * model["dec_layers"] * 8 * 1024 * 1024
    joint = 2.0 * 249 * 41 * 1024 * 6268   # over the stub's 249 output frames
    assert counts.train_step_flops(shapes, model) == pytest.approx(
        3.0 * (2.0 * 249 * 240 * 1024 + lstm + joint) * 32, rel=1e-12)


def test_shapes_of_the_cells():
    """Key for key and value for value what they were before the parts."""
    for workload, shapes in SHAPES.items():
        assert harness.make_ctx(tiny.REPO, workload, 1, "cpu").shapes == shapes


def test_step_flops_by_part():
    """The joint's projection is counted once, outside the parts: the two
    configurations differ by their prediction nets alone (the
    conv-transformer 0.694 GFLOP an utterance forward, the LSTM 1.376)."""
    shapes = harness.make_ctx(tiny.REPO, "flagship.train_b32_10s", 1, "cpu").shapes
    flagship, convtf = load("pika_flagship")["model"], load("pika_convtf")["model"]
    step = {name: counts.train_step_flops(shapes, m) for name, m in
            (("flagship", flagship), ("convtf", convtf))}
    assert step["flagship"] / 1e12 == pytest.approx(22.9502, abs=5e-5)
    assert step["convtf"] / 1e12 == pytest.approx(22.8848, abs=5e-5)
    pred = {name: M.part("decoders", m["decoder_type"]).flops(shapes, m) for name, m in
            (("flagship", flagship), ("convtf", convtf))}
    assert step["flagship"] - step["convtf"] == pytest.approx(
        3.0 * 32 * (pred["flagship"] - pred["convtf"]), rel=1e-9)
    assert (pred["flagship"] / 1e9, pred["convtf"] / 1e9) == pytest.approx((1.376, 0.694),
                                                                           abs=5e-4)


def norms(t: torch.Tensor) -> list:
    return [float(t.norm())] + [float(r.norm()) for r in t]


def reference_readings(name: str) -> dict:
    """The reference's encoder and prediction net in eval and train mode on
    seeded inputs (ragged label lengths), and two training steps."""
    seed = 2 ** 31 + 5
    config = load(name)
    config["model"] = model = tiny.tiny_model(config["model"])
    config["features"].update(tiny.TINY_FEAT)
    _, layout = program.build_model(config, seed, "cpu")
    state = weights.make_state(layout["shapes"], seed, "cpu")
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 60, model["input_dim"], generator=g)
    labels = torch.randint(1, model["vocab_size"], (3, 5), generator=g)
    lens = torch.tensor([5, 3, 4])
    with torch.no_grad():
        out = {"encoder_eval": norms(M.encoder(state, x, model)),
               "encoder_train": norms(M.encoder(state, x, model, train=True,
                                                gen=torch.Generator().manual_seed(8))),
               "predict_eval": norms(M.predict(state, labels, lens, model)),
               "predict_train": norms(M.predict(state, labels, lens, model, train=True,
                                                gen=torch.Generator().manual_seed(9)))}
    mix = traffic.load(tiny.BENCH / "traffic" / "train_b32_10s.json")
    mix.update(tiny.TINY_TRAIN)
    pool = traffic.make_pool(mix, model["vocab_size"], seed, "cpu")
    cmvn = RF.global_cmvn(pool[0]["wavs"], config["features"])
    losses, grad, after = RT.train_steps(state, layout["names"], pool[:2],
                                         torch.Generator().manual_seed(10), model,
                                         config["features"], mix, cmvn)
    out.update(losses=losses, grad_norm=float(sum(v.norm() for v in grad.values())),
               after_norm=float(sum(v.norm() for v in after.values())))
    return out


@pytest.mark.parametrize("name", sorted(PINNED))
def test_reference_outputs_as_pinned(name):
    got = reference_readings(name)
    for key, want in PINNED[name].items():
        assert got[key] == pytest.approx(want, rel=1e-6, abs=0), key


def test_the_reference_computes_without_tf32(monkeypatch):
    """The harness turns TF32 on for the program where the configuration
    says so; inside the reference's entries it is off, after them as it
    was."""
    seen = []
    encoder = M.encoder

    def spy(*args, **kw):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return encoder(*args, **kw)

    monkeypatch.setattr(M, "encoder", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    reference_readings("pika_flagship")   # two direct calls, then two training steps
    config = load("pika_flagship")
    model = tiny.tiny_model(config["model"])
    feat = dict(config["features"], **tiny.TINY_FEAT)
    _, layout = program.build_model(dict(config, model=model), 1, "cpu")
    state = weights.make_state(layout["shapes"], 1, "cpu")
    RD.encode(state, 1000.0 * torch.randn(1, 16000, generator=torch.Generator().manual_seed(1)),
              model, feat, (0.0, 1.0))
    assert seen == [(True, True)] * 2 + [(False, False)] * 3
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
