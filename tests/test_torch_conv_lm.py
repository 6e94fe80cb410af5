"""The port's transformer prediction net against the JAX package on the
CPU, at a tiny width (d_model 8, 2 heads, d_ff 16), from the same weights
(JAX init through ``load_flax_variables``) and the same numpy inputs:

* ``causal_mask`` and ``padding_mask`` equal;
* ``MultiHeadedAttention`` and ``TransformerEncoderLayer`` with clipped
  relative positions (m = 2 and 3) on the full and the query-blocked path,
  with and without a mask;
* ``ConvTransformerLM`` on ragged padding, and the transducer's
  ``predict``, ``predict_last`` and lattice log-probs;
* greedy, beam 1 and beam 4 against JAX ``greedy_decode`` and
  ``beam_search``, also with FST fusion on a tiny bigram.

Tolerances.  With float32 attention on both sides (``f32_attention``: the
JAX layer's ``mm_dtype`` None, the port's bf16 rounding the identity) the
modules agree to float32 sums in another order: 1e-5 relative (atol 1e-5
for entries near 0), the lattice log-probs through the encoder 1e-4; the
N-best tokens, lengths and alignments are identical and the scores within
rtol 1e-5.  With the real bf16 attention a flipped rounding moves a value
by 2^-8 of one term: 1e-3 relative L2.  Dropout stays 0 (the random draws
cannot match JAX's).  The train steps and the CLIs:
``tests/test_torch_conv_lm_train.py``."""

import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pika_tpu.models.transformer as transformer_jax
from pika_tpu.decode.beam import BeamConfig as BeamConfigJax, beam_search as beam_search_jax
from pika_tpu.decode.fst import _build_tables as build_tables_jax
from pika_tpu.decode.greedy import greedy_decode as greedy_jax
from pika_tpu.models.conv_transformer_lm import ConvTransformerLM as LMJax
from pika_tpu.models.transducer import (
    Transducer as TransducerJax,
    TransducerConfig as ConfigJax,
    init_transducer as init_jax,
)
import pika_tpu_torch.models.transformer as transformer_pt
from pika_tpu_torch import convert
from pika_tpu_torch.decode.beam import NEG, BeamConfig, beam_search
from pika_tpu_torch.decode.fst import _build_tables as build_tables
from pika_tpu_torch.decode.greedy import greedy_decode
from pika_tpu_torch.models.conv_transformer_lm import ConvTransformerLM
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.train.bundle import load_bundle, save_bundle

torch.set_num_threads(1)

VOCAB = 10
# d_head 4: both packages scale q by sqrt(d_head) rounded to q's dtype,
# which float32 attention keeps apart (bf16 in the port) unless it is exact
D_MODEL, HEADS, D_FF = 8, 2, 16
MODEL = dict(input_dim=12, vocab_size=VOCAB, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="transformer", dec_layers=2, embd_dim=8, tdnn_nhid=32,
             tdnn_layers=5, dec_d_model=D_MODEL, dec_heads=HEADS, dec_d_ff=D_FF,
             tdnn_transformer_dropout=0.0)
ENC_LENS = np.array([7, 4, 1], np.int32)


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32_attention(monkeypatch):
    """Attention in float32 in both packages (the JAX layer's ``mm_dtype``
    default set to None, the port's bf16 rounding made the identity)."""
    init = transformer_jax.MultiHeadedAttention.__init__.__wrapped__
    names = [n for n in inspect.signature(init).parameters if n != "self"]
    defaults = list(init.__defaults__)
    defaults[names.index("mm_dtype") - (len(names) - len(defaults))] = None
    monkeypatch.setattr(init, "__defaults__", tuple(defaults))
    monkeypatch.setattr(transformer_pt, "_bf16", lambda x: x)


@pytest.fixture
def f32_attention(monkeypatch):
    _f32_attention(monkeypatch)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX transducer with the transformer decoder and its variables
    (``init_transducer`` under jit: eager init takes seconds here)."""
    cfg = ConfigJax(**MODEL)
    variables = jax.jit(lambda k: init_jax(k, cfg, max_t=64)[1])(jax.random.PRNGKey(3))
    return TransducerJax(cfg), _np(variables)


def _port(v, blank_bias=0.0, **kw):
    """The port's transducer on the JAX weights (``blank_bias`` added to the
    blank's output bias)."""
    v = jax.tree.map(np.array, v)
    v["params"]["fc2"]["bias"][0] += blank_bias
    pt = init_transducer(TransducerConfig(**dict(MODEL, **kw)), torch.Generator().manual_seed(0),
                         device="cpu")
    convert.load_flax_variables(pt, v)
    return pt, v


# ---------------------------------------------------------------------------
# masks, attention with relative positions, the decoder module
# ---------------------------------------------------------------------------

def test_masks_match_jax():
    tokens = np.array([[3, 1, 9, 9], [9, 2, 4, 9]], np.int32)
    np.testing.assert_array_equal(transformer_pt.causal_mask(5).numpy(),
                                  np.asarray(transformer_jax.causal_mask(5)))
    np.testing.assert_array_equal(
        transformer_pt.padding_mask(torch.from_numpy(tokens), 9).numpy(),
        np.asarray(transformer_jax.padding_mask(jnp.asarray(tokens), 9)))
    np.testing.assert_array_equal(transformer_pt.relative_positions_matrix(6, 2).numpy(),
                                  np.asarray(transformer_jax.relative_positions_matrix(6, 2)))


def _attention_case(rng, module, m, chunk, masked):
    """(JAX module, torch module, inputs) of one attention or layer case."""
    t = 9
    x = rng.standard_normal((2, t, D_MODEL)).astype(np.float32)
    mask = None
    if masked:  # causal and a ragged key padding: no row fully masked
        pad = np.arange(t)[None, :] >= np.array([[t], [5]])
        mask = np.triu(np.ones((t, t), bool), 1)[None] | pad[:, None, :]
    if module == "attention":
        ref_mod = transformer_jax.MultiHeadedAttention(HEADS, D_MODEL, 0.0, m, q_chunk=chunk)
        pt_mod = transformer_pt.MultiHeadedAttention(HEADS, D_MODEL, 0.0, q_chunk=chunk,
                                                     max_relative_positions=m)
        args = (x, x, x)
    else:
        ref_mod = transformer_jax.TransformerEncoderLayer(D_MODEL, HEADS, D_FF, 0.0, m,
                                                          attn_q_chunk=chunk)
        pt_mod = transformer_pt.TransformerEncoderLayer(D_MODEL, HEADS, D_FF, 0.0,
                                                        attn_q_chunk=chunk,
                                                        max_relative_positions=m)
        args = (x,)
    return ref_mod, pt_mod, args, mask


@pytest.mark.parametrize("module", ["attention", "layer"])
@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_relative_positions_match_jax(rng, f32_attention, module, m, chunk, masked):
    """Clipped relative positions on the full path and the query-blocked one
    (blocks of 4 over T = 9: a short last block), with and without a mask:
    output and every parameter's gradient (the relative-position table's
    included) within 1e-5 relative; with the real bf16 attention the
    output within 1e-3 relative L2."""
    ref_mod, pt_mod, args, mask = _attention_case(rng, module, m, chunk, masked)
    jargs = tuple(map(jnp.asarray, args))
    jmask = None if mask is None else jnp.asarray(mask)
    v = _np(jax.jit(lambda k: ref_mod.init(k, *jargs, mask=jmask))(jax.random.PRNGKey(1)))
    table = (v["params"] if module == "attention" else v["params"]["self_attn"])[
        "relative_positions_embeddings"]["embedding"]
    assert table.shape == (2 * m + 1, D_MODEL // HEADS)
    convert.load_flax_variables(pt_mod, v)
    tmask = None if mask is None else torch.from_numpy(mask)

    def loss_jax(params):
        out = ref_mod.apply({"params": params}, *jargs, mask=jmask)
        return jnp.sum(out * jnp.cos(out)), out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss_jax, has_aux=True))(v["params"])
    out = pt_mod(*map(torch.from_numpy, args), mask=tmask)
    torch.sum(out * torch.cos(out)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    ref_g = convert.state_dict_from_flax({"params": _np(grads)})
    for name, p in pt_mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_g[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("m", [2, 3])
def test_relative_positions_bf16_match_jax(rng, m):
    """The real configuration (bf16 q, k, v and probabilities) on both
    attention paths: 1e-3 relative L2."""
    for chunk in (0, 4):
        ref_mod, pt_mod, args, mask = _attention_case(rng, "layer", m, chunk, True)
        jargs = tuple(map(jnp.asarray, args))
        v = _np(jax.jit(lambda k: ref_mod.init(k, *jargs, mask=jnp.asarray(mask)))(
            jax.random.PRNGKey(2)))
        convert.load_flax_variables(pt_mod, v)
        ref = ref_mod.apply(v, *jargs, mask=jnp.asarray(mask))
        with torch.no_grad():
            got = pt_mod(*map(torch.from_numpy, args), mask=torch.from_numpy(mask))
        assert _rel_l2(got.numpy(), ref) < 1e-3


def test_relative_positions_keep_the_flash_path_off(rng, monkeypatch):
    """K4 is taken only without a mask and without relative positions (the
    JAX layer's condition): with m > 0 the exact path runs."""
    calls = []
    monkeypatch.setattr(transformer_pt, "flash_attention",
                        lambda q, k, v: calls.append(1) or torch.zeros_like(q, dtype=torch.float32))
    x = torch.from_numpy(rng.standard_normal((1, 6, D_MODEL)).astype(np.float32))
    with torch.no_grad():
        for m in (0, 2):
            transformer_pt.MultiHeadedAttention(HEADS, D_MODEL, use_flash=True,
                                                max_relative_positions=m)(x, x, x)
    assert len(calls) == 1


@pytest.mark.parametrize("layers", [1, 2])
def test_conv_transformer_lm_matches_jax(rng, f32_attention, layers):
    """The decoder on ragged padding (pad positions 5.., 3.., none): every
    position's output, the padded ones included, within 1e-5 relative."""
    emb = rng.standard_normal((3, 7, 8)).astype(np.float32)
    pad = np.arange(7)[None, :] >= np.array([[5], [3], [7]])
    ref_mod = LMJax(16, D_MODEL, layers, HEADS, D_FF, 0.0)
    v = _np(jax.jit(lambda k: ref_mod.init(k, jnp.asarray(emb), jnp.asarray(pad)))(
        jax.random.PRNGKey(layers)))
    assert v["params"]["conv_0"]["kernel"].shape == (5, 8, D_MODEL)
    pt_mod = ConvTransformerLM(8, 16, D_MODEL, layers, HEADS, D_FF, 0.0)
    convert.load_flax_variables(pt_mod, v)
    ref = ref_mod.apply(v, jnp.asarray(emb), jnp.asarray(pad))
    with torch.no_grad():
        got = pt_mod(torch.from_numpy(emb), torch.from_numpy(pad))
        whole = pt_mod(torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # causal: a prefix's outputs do not depend on what follows it
    with torch.no_grad():
        prefix = pt_mod(torch.from_numpy(emb[:, :4]))
    np.testing.assert_allclose(prefix.numpy(), whole[:, :4].numpy(), rtol=1e-5, atol=1e-6)


def test_transducer_methods_match_jax(jax_model, f32_attention):
    """predict (ragged lengths), predict_last and the full lattice's
    log-probs against the JAX methods; the converter consumes every leaf."""
    model, v = jax_model
    pt, _ = _port(v)
    assert set(convert.state_dict_from_flax(v)) == set(pt.state_dict())
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, VOCAB, (3, 6)).astype(np.int32)
    lens = np.array([6, 2, 0], np.int32)
    x = rng.standard_normal((2, 40, 12)).astype(np.float32)
    apply = jax.jit(model.apply, static_argnames=("method",))
    with torch.no_grad():
        for name, args, ref_fn, fn in (
                ("predict", (tokens, lens), TransducerJax.predict, pt.predict),
                ("predict_last", (tokens, lens), TransducerJax.predict_last, pt.predict_last)):
            ref = apply(v, *map(jnp.asarray, args), method=ref_fn)
            got = fn(*map(torch.from_numpy, args))
            assert got.shape == ref.shape, name
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        ref = jax.jit(model.apply)(v, jnp.asarray(x), jnp.asarray(tokens[:2, :4]),
                                   jnp.asarray([40, 31]), jnp.asarray([4, 2]))
        got = pt(torch.from_numpy(x), torch.from_numpy(tokens[:2, :4]),
                 torch.tensor([40, 31]), torch.tensor([4, 2]))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_transducer_bf16_attention_matches_jax(jax_model):
    """predict with the real bf16 attention: 1e-3 relative L2."""
    model, v = jax_model
    pt, _ = _port(v)
    tokens = np.random.default_rng(2).integers(1, VOCAB, (3, 6)).astype(np.int32)
    lens = np.array([6, 3, 1], np.int32)
    ref = jax.jit(model.apply, static_argnames=("method",))(
        v, jnp.asarray(tokens), jnp.asarray(lens), method=TransducerJax.predict)
    with torch.no_grad():
        got = pt.predict(torch.from_numpy(tokens), torch.from_numpy(lens))
    assert _rel_l2(got.numpy(), ref) < 1e-3


def test_bundle_round_trip(tmp_path):
    """A bundle of a transformer-decoder model with the simple heads keeps
    the decoder's widths and ``simple_joint`` through save and load."""
    cfg = TransducerConfig(**dict(MODEL, simple_joint=True))
    pt = init_transducer(cfg, torch.Generator().manual_seed(1), device="cpu")
    model, meta = load_bundle(save_bundle(str(tmp_path / "b"), pt, {"epoch": 3}), device="cpu")
    assert model.config == cfg and meta == {"epoch": 3}
    for (name, x), y in zip(pt.state_dict().items(), model.state_dict().values()):
        assert torch.equal(x, y), name


# ---------------------------------------------------------------------------
# greedy and beam search
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def enc_out():
    return (np.random.default_rng(0).standard_normal((3, 7, 16)) * 2).astype(np.float32)


def _assert_same(ref, got):
    for name in ("tokens", "lens", "aligns", "align_lens"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    live = ref["scores"] > NEG / 2
    np.testing.assert_allclose(got["scores"][live], ref["scores"][live], rtol=1e-5)
    assert (got["scores"][~live] <= NEG / 2).all()


@pytest.mark.parametrize("blank_bias", [0.0, -1.0])
def test_greedy_matches_jax(jax_model, enc_out, f32_attention, blank_bias):
    """Greedy search re-forwarding each prefix: hypotheses and lengths equal
    to JAX ``greedy_decode``'s."""
    model, v = jax_model
    pt, v = _port(v, blank_bias)
    ref_h, ref_l = greedy_jax(model, v, jnp.asarray(enc_out), jnp.asarray(ENC_LENS),
                              max_symbols=6)
    hyps, lens = greedy_decode(pt, torch.from_numpy(enc_out), torch.from_numpy(ENC_LENS),
                               max_symbols=6)
    np.testing.assert_array_equal(hyps.numpy(), np.asarray(ref_h))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_l))
    assert lens.max() > 0
    loop = next(iter(pt._decode_loops.values()))
    assert "dec_h" not in loop.state  # no LSTM state


@pytest.mark.parametrize("beam,n_best", [(1, 1), (4, 4)])
def test_beam_matches_jax(jax_model, enc_out, f32_attention, beam, n_best):
    """Beam 1 and beam 4 (the token buffer re-forwarded every step) against
    the JAX beam: tokens, lengths and alignments equal, scores within rtol
    1e-5.  Beam 1 gives greedy's hypothesis or a prefix of it: where greedy
    goes on emitting at a row's last frame, beam 1 keeps the hypothesis
    finished there by a blank when it scores higher (in the JAX package
    too)."""
    model, v = jax_model
    pt, v = _port(v, 1.0)
    cfg = dict(beam_size=beam, n_best=n_best, max_symbols=6)
    ref = beam_search_jax(model, v, jnp.asarray(enc_out), jnp.asarray(ENC_LENS),
                          BeamConfigJax(**cfg))
    got = beam_search(pt, torch.from_numpy(enc_out), torch.from_numpy(ENC_LENS),
                      BeamConfig(**cfg))
    _assert_same({k: np.asarray(x) for k, x in ref.items()}, {k: x.numpy() for k, x in got.items()})
    assert got["lens"].max() > 0
    if beam == 1:  # beam 1's top-1 is greedy's hypothesis or a prefix of it
        hyps, lens = greedy_decode(pt, torch.from_numpy(enc_out), torch.from_numpy(ENC_LENS),
                                   max_symbols=6)
        for row in range(3):
            n = int(got["lens"][row, 0])
            assert n <= int(lens[row])
            assert torch.equal(got["tokens"][row, 0, :n], hyps[row, :n].long())
        assert (got["lens"][:, 0] == lens).any() and lens.max() > 0


def _bigram(seed):
    """A random bigram automaton over the vocabulary (state 0 the unigram
    backoff state; state v the context of token v) built by both packages'
    ``_build_tables``."""
    rng = np.random.default_rng(seed)
    arcs = {0: [(t + 1, float(rng.uniform(0, 3)), t) for t in range(1, VOCAB)]}
    finals = {0: 0.5}
    for s in range(1, VOCAB):
        nxt = rng.choice(np.arange(1, VOCAB), size=3, replace=False)
        arcs[s] = [(int(t) + 1, float(rng.uniform(0, 2)), int(t)) for t in nxt]
        arcs[s].append((0, float(rng.uniform(0.2, 1.0)), 0))
        finals[s] = float(rng.uniform(0, 1))
    return tuple(build(VOCAB, arcs, finals, start=0, backoff_id=0)
                 for build in (build_tables_jax, build_tables))


def test_beam_fst_matches_jax(jax_model, enc_out, f32_attention):
    """Per-token top-4 FST fusion on a tiny bigram with the transformer
    decoder: the same N-best as the JAX beam."""
    model, v = jax_model
    pt, v = _port(v, 1.0)
    tj, tp = _bigram(5)
    cfg = dict(beam_size=4, n_best=4, max_symbols=6, lm_scale=0.7, lm_per_token=True,
               lm_topm=4, nonblk_reward=0.3)
    ref = beam_search_jax(model, v, jnp.asarray(enc_out), jnp.asarray(ENC_LENS),
                          BeamConfigJax(**cfg), fst_tables=tj.device_arrays(),
                          fst_start=tj.start)
    got = beam_search(pt, torch.from_numpy(enc_out), torch.from_numpy(ENC_LENS),
                      BeamConfig(**cfg), fst_tables=tp.device_arrays("cpu"), fst_start=tp.start)
    _assert_same({k: np.asarray(x) for k, x in ref.items()}, {k: x.numpy() for k, x in got.items()})


def test_beam_bf16_is_finite(jax_model, enc_out):
    """Under ``mm_dtype="bfloat16"`` the re-forward runs on bf16 casts (the
    LSTM's rule): finite scores and a valid N-best."""
    _, v = jax_model
    pt, _ = _port(v, 1.0)
    got = beam_search(pt, torch.from_numpy(enc_out), torch.from_numpy(ENC_LENS),
                      BeamConfig(beam_size=4, n_best=2, max_symbols=6, mm_dtype="bfloat16"))
    assert torch.isfinite(got["scores"][:, 0]).all()
    loop = next(iter(pt._decode_loops.values()))
    assert loop.net.decoder.conv_0.weight.dtype == torch.bfloat16
