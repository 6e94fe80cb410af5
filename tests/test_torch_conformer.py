"""The Conformer encoder (``models/conformer.py``) against the benchmark's
plain reference (``benchmark/reference/encoders/conformer.py``) on the CPU,
at a tiny size, on the benchmark's seeded random weights
(``benchmark/weights.py``): the eval forward, a train-mode forward from
one generator (dropout, BatchNorm's batch and running statistics), every
leaf's gradient of the full loss, the output lengths and ragged batches,
the state's layout; and planted faults that the tolerances catch.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_conformer.py -q

The tolerances compare the port, whose attention rounds q + u, q + v, k, p,
v and the probabilities to bf16 as the configuration states, with the
float32 reference.  Each gap is the norm of the difference over the
reference's norm; on the weights of seeds 2^31 + 0..7 (the reference with
every encoder product in bf16 in brackets): the eval forward 0.7e-3 to
2.1e-3 (4.2e-3 to 7.9e-3), u and v swapped 0.07-0.29, the depthwise
padding flipped 0.11-0.65; a ragged batch's rows 0.9e-3 to 2.2e-3 (3.5e-3
to 6.8e-3); the train-mode forward 1.5e-3 to 2.7e-3 (5.9e-3 to 1.2e-2);
the worst leaf's gradient 4.1e-3 to 6.7e-3 (2.6e-2 to 6.1e-2).
"""

from __future__ import annotations

import statistics

import pytest
import torch

from benchmark import weights
from benchmark.reference import loss as RL
from benchmark.reference import model as M
from benchmark.reference.encoders import conformer as RC
from pika_tpu_torch.models.conformer import ConformerEncoder
from pika_tpu_torch.models.transducer import Transducer, TransducerConfig
from pika_tpu_torch.train.step import transducer_loss

MODEL = dict(input_dim=16, vocab_size=12, hid_dim=24, encoder_type="conformer",
             decoder_type="rnn", dec_layers=1, embd_dim=8, dropout=0.1, conformer_layers=2,
             conformer_d_model=16, conformer_heads=4, conformer_d_ff=32, conformer_kernel=6,
             conformer_dropout=0.1, attn_cheap_dropout=False)
SEED = 2 ** 31 + 7
# the eval forward, whole or a ragged batch's row: over the sound gap, under
# every planted fault's and the bf16 encoder's (module docstring)
FORWARD_TOL = 3e-3
# a train-mode forward: dropout's 1 / 0.9 on the kept values, BatchNorm's
# batch moments
TRAIN_TOL = 5e-3
# each leaf's gradient over the larger of its norm and the median leaf's
GRAD_TOL = 1.5e-2
# the summed loss: 1e-5 to 1e-4 on the seeds above
LOSS_TOL = 5e-4
# BatchNorm's running statistics over inputs that carry the attention's
# rounding (up to 2.3e-3 on the seeds above)
STATS_TOL = 5e-3


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def build(model: dict = MODEL, seed: int = SEED):
    """The port's Transducer with the benchmark's weights for ``seed``, in
    eval mode, and those weights by name."""
    net = Transducer(TransducerConfig(**model), device="cpu")
    shapes = {n: (tuple(t.shape), t.dtype) for n, t in net.state_dict().items()}
    state = weights.make_state(shapes, seed, "cpu")
    net.load_state_dict(state)
    return net.eval(), state


def features(batch=3, frames=60, seed=1):
    return torch.randn(batch, frames, MODEL["input_dim"],
                       generator=torch.Generator().manual_seed(seed))


def gap(got, ref) -> float:
    return float((got - ref).norm() / ref.norm())


def swapped_uv(state: dict) -> dict:
    out = dict(state)
    for k in state:
        if k.endswith("pos_bias_u"):
            v = k[:-1] + "v"
            out[k], out[v] = state[v], state[k]
    return out


def test_eval_forward_matches_the_reference():
    net, state = build()
    x = features()
    with torch.no_grad():
        got = net.encode(x, torch.full((3,), 60))
        assert got.shape == (3, RC.output_frames(60), MODEL["hid_dim"])
        assert gap(got, RC.forward(state, x, MODEL)) < FORWARD_TOL


def test_planted_faults_fail_the_tolerance(monkeypatch):
    """u and v swapped, the even kernel's SAME padding flipped to put the
    odd frame before, and every encoder product in bf16: each reads over
    the tolerance that the port passes."""
    net, state = build()
    x = features()
    with torch.no_grad():
        ref = RC.forward(state, x, MODEL)
        assert gap(net.encode(x), ref) < FORWARD_TOL
        assert gap(RC.forward(swapped_uv(state), x, MODEL), ref) > FORWARD_TOL
        assert gap(RC.forward(state, x, MODEL, M.Precision(enc="bfloat16")), ref) > FORWARD_TOL
        net.load_state_dict(swapped_uv(state))
        assert gap(net.encode(x), ref) > FORWARD_TOL
        monkeypatch.setattr(RC, "same_padding", lambda k: (k // 2, (k - 1) // 2))
        assert gap(RC.forward(state, x, MODEL), ref) > FORWARD_TOL


def test_train_forward_draws_as_the_reference():
    """One generator each, seeded alike: dropout after the subsampling, in
    the FFNs, on the probabilities and after the attention and the conv
    module, in the program's order; BatchNorm on the batch's moments, its
    running statistics moved by a tenth towards them."""
    net, state = build()
    x = features()
    lens = torch.full((3,), 60)
    net.train()
    stats = {}
    with torch.no_grad():
        got = net.encode(x, lens, torch.Generator().manual_seed(5))
        ref = RC.forward(state, x, MODEL, train=True, gen=torch.Generator().manual_seed(5),
                         stats=stats)
    assert gap(got, ref) < TRAIN_TOL
    # eval mode draws nothing and is far from the train-mode output
    assert gap(RC.forward(state, x, MODEL), ref) > 0.1
    assert len(stats) == MODEL["conformer_layers"]
    frames = 3 * RC.output_frames(60)
    for name, (mean, var) in stats.items():
        bn = net.get_submodule(name)
        assert gap(bn.running_mean, 0.1 * mean) < STATS_TOL, name
        # PyTorch's BatchNorm: the running variance moves towards the unbiased one
        assert gap(bn.running_var, 0.9 + 0.1 * var * frames / (frames - 1)) < STATS_TOL, name


def test_head_shared_dropout_draws_as_the_reference():
    model = dict(MODEL, attn_cheap_dropout=True)
    net, state = build(model)
    x = features()
    net.train()
    with torch.no_grad():
        got = net.encode(x, None, torch.Generator().manual_seed(6))
        ref = RC.forward(state, x, model, train=True, gen=torch.Generator().manual_seed(6))
        per_head = RC.forward(state, x, MODEL, train=True, gen=torch.Generator().manual_seed(6))
    assert gap(got, ref) < TRAIN_TOL
    assert gap(per_head, ref) > 0.1


def test_every_gradient_of_the_full_loss():
    """The summed RNN-T loss in train mode through the port's
    ``transducer_loss`` (the plain loss on the CPU) and the reference's,
    from one generator each: the loss and every leaf's gradient."""
    net, state = build()
    x = features(frames=64)
    labels = torch.randint(1, MODEL["vocab_size"], (3, 4),
                           generator=torch.Generator().manual_seed(2))
    net.train()
    loss = transducer_loss(net, x, torch.full((3,), 64), labels, torch.full((3,), 4),
                           generator=torch.Generator().manual_seed(9))
    loss.backward()
    grads = {n: q.grad for n, q in net.named_parameters()}
    p = {k: v.clone().requires_grad_(k in grads) for k, v in state.items()}
    gen = torch.Generator().manual_seed(9)
    enc = RC.forward(p, x, MODEL, train=True, gen=gen)
    dec = M.predict(p, labels, torch.full((3,), 4), MODEL, train=True, gen=gen)
    ref_loss = RL.rnnt_loss_blocked(p, enc, dec, labels, 2)
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=LOSS_TOL)
    norms = {n: float(p[n].grad.norm()) for n in grads}
    median = statistics.median(norms.values())
    assert median > 0 and all(p[n].grad is not None for n in grads)
    for n, g in grads.items():
        assert float((g - p[n].grad).norm()) / max(norms[n], median) < GRAD_TOL, n
    # the encoder's products in bf16 miss it
    low = {k: v.clone().requires_grad_(k in grads) for k, v in state.items()}
    gen = torch.Generator().manual_seed(9)
    enc = RC.forward(low, x, MODEL, M.Precision(enc="bfloat16"), train=True, gen=gen)
    dec = M.predict(low, labels, torch.full((3,), 4), MODEL, train=True, gen=gen)
    RL.rnnt_loss_blocked(low, enc, dec, labels, 2)
    assert max(float((low[n].grad - p[n].grad).norm()) / max(norms[n], median)
               for n in grads) > GRAD_TOL


def test_output_lengths():
    net, _ = build()
    assert ConformerEncoder.output_length(998) == RC.output_frames(998) == 248
    lens = torch.tensor([998, 60, 7, 31])
    assert torch.equal(net.encoder_out_len(lens), RC.output_frames(lens))
    assert net.encode(features(frames=31)).shape[1] == int(RC.output_frames(31))


def test_ragged_batch_masks_past_each_length():
    """Frames past each length (filled with large noise here) change no
    output within the length: the keys and the depthwise convolution's
    inputs past it are hidden; the reference, told the lengths, agrees."""
    net, state = build()
    lens = torch.tensor([60, 45, 31])
    x = features()
    for b, n in enumerate(lens.tolist()):
        x[b, n:] = 100.0 * torch.randn(60 - n, MODEL["input_dim"])
    out_lens = net.encoder_out_len(lens)
    with torch.no_grad():
        got = net.encode(x, lens)
        ref = RC.forward(state, x, MODEL, lens=lens)
        for b, (n, m) in enumerate(zip(lens.tolist(), out_lens.tolist())):
            alone = net.encode(x[b:b + 1, :n], lens[b:b + 1])
            # one bf16 rounding of the attention may fall the other way
            assert gap(got[b, :m], alone[0]) < 1e-3, b
            assert gap(got[b, :m], ref[b, :m]) < FORWARD_TOL, b
        unmasked = net.encode(x)
    assert gap(unmasked[1, :out_lens[1]], got[1, :out_lens[1]]) > 0.1


def test_state_layout():
    """No positional table among the state (it is computed); u and v are
    (heads, d_head) parameters, which the benchmark's weights draw from
    the seed like any matrix."""
    net, state = build()
    buffers = [n for n, _ in net.named_buffers()]
    assert all(n.rsplit(".", 1)[-1] in ("running_mean", "running_var", "num_batches_tracked")
               for n in buffers)
    d_head = MODEL["conformer_d_model"] // MODEL["conformer_heads"]
    for i in range(MODEL["conformer_layers"]):
        u, v = (net.get_parameter(f"encoder.blocks.{i}.mhsa.pos_bias_{c}") for c in "uv")
        assert u.shape == v.shape == (MODEL["conformer_heads"], d_head)
        assert weights._fill(f"encoder.blocks.{i}.mhsa.pos_bias_u", u.shape) == "normal"
        assert u.std() > 0.1 and not torch.equal(u, v)


def test_spans_in_a_traced_training_step():
    """The benchmark's tiny conformer cell, one training step traced:
    ``conformer.subsample`` once, ``conformer.ffn`` twice a block,
    ``conformer.mhsa`` and ``conformer.conv`` once a block, all inside
    ``encoder``."""
    from collections import Counter

    from benchmark import program, trace, traffic
    from test_torch_spans import inside, named, tiny_config, tiny_mix

    config = tiny_config("conformer_l")
    mix = tiny_mix("train_b32_10s", "conformer_l.train_b32_10s")
    model, _ = program.build_model(config, 13, "cpu")
    optimizer = program.make_optimizer(model.parameters(), "sgd", **mix["optimizer"])
    feat = program.featurizer(config, traffic.samples(mix), "cpu", mix["spec_augment"],
                              mix["max_freq_span"], mix["max_time_span"])
    step = program.make_train_step(model, optimizer, feat, loss_chunk=mix["loss_chunk"])
    batch = traffic.make_pool(mix, config["model"]["vocab_size"], 13, "cpu")[0]
    tr = trace.profile_stretch(lambda: (step(batch, torch.Generator().manual_seed(3)), 1)[1],
                               torch.device("cpu"))
    layers = config["model"]["conformer_layers"]
    counts = Counter(n for n, _, _ in tr.host if n.startswith("conformer."))
    assert dict(counts) == {"conformer.subsample": 1, "conformer.ffn": 2 * layers,
                            "conformer.mhsa": layers, "conformer.conv": layers}
    encoder = named(tr, "encoder")
    assert all(inside(iv, encoder) for n in counts for iv in named(tr, n))


def test_conformer_idle_ms_on_hand_built_traces():
    """Idle 1-5 ms under ``conformer.subsample`` and ``conformer.ffn``,
    20-30 under ``conformer.mhsa`` and 40-60 under ``conformer.conv``, in
    two units: 17 ms a unit; nothing without the spans or without a stretch
    traced with the host."""
    from test_torch_spans import TRAIN_SPANS, events, metric, record

    read = metric("conformer_idle_ms")
    spans = [("encoder", 0, 90), ("conformer.subsample", 1, 4), ("conformer.ffn", 4, 20),
             ("conformer.mhsa", 20, 30), ("conformer.conv", 40, 60)]
    assert read(record(events(spans))) == pytest.approx(17.0)
    assert read(record(events(TRAIN_SPANS))) is None
    assert read({"trace": None}) is None
