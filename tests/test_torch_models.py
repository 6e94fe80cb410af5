"""The port's models (pika_tpu_torch.models) against the JAX package, with
weights copied by pika_tpu_torch.convert.  Tolerances: float32 modules 1e-5
relative; modules with attention 1e-3 relative L2, because q, k, v and the
softmax probabilities are rounded to bf16 and summation order may flip a
rounding."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pika_tpu.models import lstm as lstm_jax
from pika_tpu.models import transducer as transducer_jax
from pika_tpu.models.tdnn_transformer import TDNNTransformerEncoder as TDNNJax
from pika_tpu.models.transformer import TransformerEncoderLayer as LayerJax
from pika_tpu_torch import convert
from pika_tpu_torch.models import lstm as lstm_pt
from pika_tpu_torch.models import transducer as transducer_pt
from pika_tpu_torch.models.tdnn_transformer import TDNNTransformerEncoder as TDNNPt
from pika_tpu_torch.models.transformer import TransformerEncoderLayer as LayerPt

torch.set_num_threads(1)

TINY = dict(input_dim=12, vocab_size=20, hid_dim=16, encoder_type="tdnn_transformer",
            decoder_type="rnn", dec_layers=2, embd_dim=8, tdnn_nhid=32, tdnn_layers=5)


def _np(variables):
    return jax.tree.map(np.asarray, variables)


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _stats(tree, rng):
    """Recursively replace every BatchNorm mean/var with random values."""
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = _stats(x, rng)
        elif k == "mean":
            out[k] = (rng.standard_normal(x.shape) * 0.3).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    return out


@pytest.fixture
def tiny(rng):
    """(flax model, numpy variables with random BN stats, torch model)."""
    cfg = transducer_jax.TransducerConfig(**TINY)
    model = transducer_jax.Transducer(cfg)
    variables = jax.jit(lambda k: transducer_jax.init_transducer(k, cfg, max_t=64)[1])(
        jax.random.PRNGKey(0))  # under jit: eager init takes seconds here
    v = _np(variables)
    v["batch_stats"] = _stats(v["batch_stats"], rng)
    pt = transducer_pt.init_transducer(transducer_pt.TransducerConfig(**TINY),
                                       torch.Generator().manual_seed(0), device="cpu")
    convert.load_flax_variables(pt, v)
    return model, v, pt


def test_converter_consumes_every_leaf(tiny):
    _, v, pt = tiny
    sd = convert.state_dict_from_flax(v)
    n_leaves = len(jax.tree.leaves(v))
    n_bn = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) - n_bn == n_leaves
    assert set(sd) == set(pt.state_dict())
    for k, x in pt.state_dict().items():
        assert x.shape == sd[k].shape, k
        torch.testing.assert_close(x, sd[k], rtol=0, atol=0)
    # layout: dense (in, out) -> (out, in); conv (k, in, out) -> (out, in, k)
    np.testing.assert_array_equal(sd["fc2.weight"].numpy(), v["params"]["fc2"]["kernel"].T)
    np.testing.assert_array_equal(sd["encoder.conv_0.weight"].numpy(),
                                  v["params"]["encoder"]["conv_0"]["kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["decoder.weight_hh_l1"].numpy(),
                                  v["params"]["decoder"]["l1_d0_whh"].T)


def test_converter_rejects_mismatch(tiny):
    _, v, pt = tiny
    v["params"]["fc2"]["kernel"] = v["params"]["fc2"]["kernel"][:, :-1]
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.load_flax_variables(pt, v)
    del v["params"]["fc1_x"]
    with pytest.raises(ValueError, match="missing"):
        convert.load_flax_variables(pt, v)


def test_transformer_layer(rng):
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    layer = LayerJax(32, 4, 64, 0.1)
    variables = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(layer.apply(variables, jnp.asarray(x)))
    pt = convert.load_flax_variables(LayerPt(32, 4, 64).eval(), _np(variables))
    got = pt(torch.from_numpy(x)).detach().numpy()
    assert _rel_l2(got, ref) < 1e-3


def test_tdnn_transformer_encoder(rng):
    x = rng.standard_normal((2, 40, 12)).astype(np.float32)
    enc = TDNNJax(output_dim=16, tdnn_nhid=32, tdnn_layers=5)
    variables = _np(enc.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    variables["batch_stats"] = _stats(variables["batch_stats"], rng)
    ref = np.asarray(enc.apply(variables, jnp.asarray(x)))
    pt = convert.load_flax_variables(TDNNPt(12, 16, 32, 5).eval(), variables)
    got = pt(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (2, enc.output_length(40), 16)
    assert pt.output_length(40) == enc.output_length(40)
    assert _rel_l2(got, ref) < 1e-3


def test_lstm_and_stack_step(rng):
    x = rng.standard_normal((3, 7, 8)).astype(np.float32)
    lstm = lstm_jax.LSTM(16, num_layers=2)
    variables = lstm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    variables = _np(variables)
    variables["params"] = jax.tree.map(lambda p: p + 0.1 * rng.standard_normal(p.shape)
                                       .astype(np.float32), variables["params"])
    ref, (ref_h, ref_c) = lstm.apply(variables, jnp.asarray(x))
    pt = convert.load_flax_variables(lstm_pt.LSTM(8, 16, 2), variables)
    with torch.no_grad():
        got, (h, c) = pt(torch.from_numpy(x))
        for g, r in ((got, ref), (h, ref_h), (c, ref_c)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
        h0, c0 = (rng.standard_normal((2, 3, 16)).astype(np.float32) for _ in range(2))
        ref_step = lstm_jax.lstm_stack_step(variables["params"], 2, jnp.asarray(x[:, 0]),
                                            jnp.asarray(h0), jnp.asarray(c0))
        got_step = lstm_pt.lstm_stack_step(pt, *map(torch.from_numpy, (x[:, 0], h0, c0)))
        for g, r in zip(got_step, ref_step):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_predict_padded_labels(tiny, rng):
    model, v, pt = tiny
    y = rng.integers(1, 20, (3, 6)).astype(np.int32)
    y_len = np.array([6, 2, 0], np.int32)
    ref = model.apply(v, jnp.asarray(y), jnp.asarray(y_len),
                      method=transducer_jax.Transducer.predict)
    with torch.no_grad():
        got = pt.predict(torch.from_numpy(y), torch.from_numpy(y_len))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        tok = torch.tensor([0, 5, 19])
        h0, c0 = (torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(np.float32))
                  for _ in range(2))
        ref_out, (ref_h, ref_c) = model.apply(
            v, jnp.asarray(tok.numpy()), (jnp.asarray(h0.numpy()), jnp.asarray(c0.numpy())),
            method=transducer_jax.Transducer.predict_step)
        out, (h, c) = pt.predict_step(tok, (h0, c0))
        for g, r in ((out, ref_out), (h, ref_h), (c, ref_c)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("decoder_type", ["rnn", "transformer"])
def test_advance_from_dec_state(decoder_type):
    """``advance`` from ``dec_state`` is the net's own step on the same
    inputs, bit for bit, two tokens running: ``predict_step`` for the LSTM
    net, ``predict_last`` for the transformer net (a length past the buffer
    reads as the buffer's, a dead beam's); every state tensor is
    (L, *lead, H) at the rows' lead."""
    cfg = transducer_pt.TransducerConfig(**dict(TINY, decoder_type=decoder_type, dec_d_model=8,
                                                dec_heads=2, dec_d_ff=16))
    pt = transducer_pt.init_transducer(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    lead, um = (3, 2), 5
    state = pt.dec_state(lead, "cpu", torch.float32)
    assert set(state) == ({"dec_h", "dec_c"} if decoder_type == "rnn" else set())
    for x in state.values():
        assert x.shape == (TINY["dec_layers"], *lead, TINY["hid_dim"]) and not x.any()
    rows = {name: x.flatten(1, 2) for name, x in state.items()}
    lens = torch.tensor([0, 1, 3, 5, 6, 2])
    tokens = torch.randint(1, TINY["vocab_size"], (6, um), generator=g)
    with torch.no_grad():
        for tok in torch.randint(0, TINY["vocab_size"], (2, 6), generator=g):
            buf = torch.where(torch.arange(um) < lens[:, None], tokens, -1)
            out, new = pt.advance(tok, rows, buf, lens)
            if decoder_type == "rnn":
                ref, (h, c) = pt.predict_step(tok, (rows["dec_h"], rows["dec_c"]))
                ref_state = {"dec_h": h, "dec_c": c}
            else:
                ref, ref_state = pt.predict_last(buf, lens.clamp(max=um)), {}
            assert torch.equal(out, ref)
            assert new.keys() == ref_state.keys()
            for name, x in new.items():
                assert x.shape == (TINY["dec_layers"], 6, TINY["hid_dim"])
                assert torch.equal(x, ref_state[name]), name
            rows, lens = new, (lens + 1).clamp(max=um + 1)


def test_joint(tiny, rng):
    model, v, pt = tiny
    enc = rng.standard_normal((2, 5, 16)).astype(np.float32)
    dec = rng.standard_normal((2, 4, 16)).astype(np.float32)
    ref = model.apply(v, jnp.asarray(enc), jnp.asarray(dec),
                      method=transducer_jax.Transducer.joint_factors)
    with torch.no_grad():
        got = pt.joint_factors(torch.from_numpy(enc), torch.from_numpy(dec))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
        # the full lattice through broadcasting: (B, T, 1, H) with (B, 1, U+1, H)
        ref_logits = model.apply(v, ref[0][:, :, None], ref[1][:, :, None], ref[2][:, None],
                                 ref[3][:, None], method=transducer_jax.Transducer.joint_from_factors)
        logits = pt.joint_from_factors(got[0][:, :, None], got[1][:, :, None], got[2][:, None],
                                       got[3][:, None])
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-5, atol=1e-5)
        w2, b2 = pt.joint_params()
        np.testing.assert_array_equal(w2.numpy(), v["params"]["fc2"]["kernel"])
        np.testing.assert_array_equal(b2.numpy(), v["params"]["fc2"]["bias"])


def test_unported_options_raise():
    """Every model option of the JAX package builds (none raises any more):
    the transformer prediction net, the pruned loss's simple heads, the
    chunked attention and the rnn encoder."""
    model = transducer_pt.Transducer(transducer_pt.TransducerConfig(
        **dict(TINY, decoder_type="transformer", dec_d_model=8, dec_heads=2, dec_d_ff=16)))
    assert model.decoder.conv_0.weight.shape == (8, TINY["embd_dim"], 5)
    assert model.decoder.linear_out.weight.shape == (TINY["hid_dim"], 8)
    model = transducer_pt.Transducer(transducer_pt.TransducerConfig(**dict(TINY, simple_joint=True)))
    assert model.simple_am.weight.shape == model.simple_lm.weight.shape == (
        TINY["vocab_size"], TINY["hid_dim"])
    model = transducer_pt.Transducer(transducer_pt.TransducerConfig(**dict(TINY, attn_chunk=64)))
    assert model.encoder.transformer_0.self_attn.q_chunk == 64
    model = transducer_pt.Transducer(transducer_pt.TransducerConfig(**dict(TINY, encoder_type="rnn",
                                                                           brnn=True)))
    assert model.encoder.dirs == 2


@pytest.mark.parametrize("options,match", [
    (dict(encoder_type="lstm"), "unknown encoder_type 'lstm'"),
    (dict(decoder_type="lstm"), "unknown decoder_type 'lstm'"),
    (dict(encoder_type="conformer", attn_flash=True), "takes none of"),
    (dict(encoder_type="conformer", attn_chunk=64), "takes none of"),
    (dict(encoder_type="conformer", remat=True), "takes none of"),
])
def test_part_tables_raise(options, match):
    """A part type missing from ``ENCODERS`` or ``PREDICTION_NETS``, and the
    conformer's ``from_config`` given an option of the TDNN encoder's, raise."""
    with pytest.raises(ValueError, match=match):
        transducer_pt.Transducer(transducer_pt.TransducerConfig(**dict(TINY, **options)))


def test_init_is_seeded():
    cfg = transducer_pt.TransducerConfig(**TINY)
    a, b, c = (transducer_pt.init_transducer(cfg, torch.Generator().manual_seed(s), device="cpu")
               for s in (0, 0, 1))
    for (k, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y), k
    assert not torch.equal(a.fc2.weight, c.fc2.weight)
    assert not a.training
