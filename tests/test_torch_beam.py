"""The port's beam search and the model methods it needs, against the JAX
package on the CPU: the same weights (JAX ``init_transducer`` through
``load_flax_variables``) and the same numpy encoder output through both
searches.  At float32 tokens, lengths and alignments are identical, scores
within rtol 1e-5; at bf16 the top-1 hypotheses are identical.  With FST
shallow fusion both take one LM through their own ``_build_tables``."""

import dataclasses
import functools
import inspect
import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pika_tpu.models.transformer as transformer_jax
from pika_tpu.decode.beam import BeamConfig as BeamConfigJax, _dup_mask as dup_mask_jax
from pika_tpu.decode.beam import beam_search as beam_search_jax
from pika_tpu.decode.fst import _build_tables as build_tables_jax
from pika_tpu.models.transducer import (
    Transducer as TransducerJax,
    TransducerConfig as ConfigJax,
    init_transducer as init_jax,
)
import pika_tpu_torch.models.transformer as transformer_pt
from pika_tpu_torch.convert import load_flax_variables
from pika_tpu_torch.decode.beam import NEG, BeamConfig, _dup_mask, beam_search, top_k
from pika_tpu_torch.decode.fst import _build_tables as build_tables
from pika_tpu_torch.decode.greedy import greedy_decode
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer

torch.set_num_threads(1)

VOCAB = 20
MODEL = dict(input_dim=12, vocab_size=VOCAB, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="rnn", dec_layers=2, embd_dim=8, tdnn_nhid=32, tdnn_layers=5)
ENC_LENS = np.array([7, 4, 1], np.int32)  # ragged, one row of a single frame
# the bf16 loops against each other: both round the prediction net's and
# the joint's products and the LSTM state to bf16, at other points (XLA
# fuses elementwise work in float32), so scores agree to bf16 rounding of
# sums over a few dozen steps
BF16_SCORE_RTOL = 2e-2


@functools.lru_cache(maxsize=1)
def _init_jax():
    """``init_transducer`` under jit (eager init takes seconds here)."""
    cfg = ConfigJax(**MODEL)
    variables = jax.jit(lambda key: init_jax(key, cfg, max_t=64)[1])(jax.random.PRNGKey(4))
    return TransducerJax(cfg), variables


def _models(blank_bias=0.0, blank=0):
    """The JAX model and variables and the port's model from the same
    weights; ``blank_bias`` is added to the blank's output bias on both
    sides (a model that emits less, so the search's stop rule ends it)."""
    model, variables = _init_jax()
    v = jax.tree.map(np.array, variables)
    v["params"]["fc2"]["bias"][blank] += blank_bias
    pt = init_transducer(TransducerConfig(**MODEL), torch.Generator().manual_seed(0), device="cpu")
    load_flax_variables(pt, v)
    return model, v, pt


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def enc_out():
    return (np.random.default_rng(0).standard_normal((3, 7, 16)) * 2).astype(np.float32)


def _run_both(model, v, pt, enc, lens, **cfg):
    ref = beam_search_jax(model, v, jnp.asarray(enc), jnp.asarray(lens), BeamConfigJax(**cfg))
    got = beam_search(pt, torch.from_numpy(enc), torch.from_numpy(lens), BeamConfig(**cfg))
    return {k: np.asarray(x) for k, x in ref.items()}, {k: x.numpy() for k, x in got.items()}


def _assert_same(ref, got):
    for name in ("tokens", "lens", "aligns", "align_lens"):
        assert got[name].dtype == np.int32, name
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    live = ref["scores"] > NEG / 2
    np.testing.assert_allclose(got["scores"][live], ref["scores"][live], rtol=1e-5)
    assert (got["scores"][~live] <= NEG / 2).all()


@pytest.fixture
def f32_attention(monkeypatch):
    """Attention in float32 in both packages (the JAX layer's ``mm_dtype``
    default set to None, the port's bf16 rounding made the identity), so
    the full forward compares at float32."""
    init = transformer_jax.MultiHeadedAttention.__init__.__wrapped__
    names = [n for n in inspect.signature(init).parameters if n != "self"]
    defaults = list(init.__defaults__)
    defaults[names.index("mm_dtype") - (len(names) - len(defaults))] = None
    monkeypatch.setattr(init, "__defaults__", tuple(defaults))
    monkeypatch.setattr(transformer_pt, "_bf16", lambda x: x)


def test_model_methods_match_jax(models, f32_attention):
    """predict_last, joint_step and joint_logits against the JAX methods,
    rtol 1e-5 (atol 1e-5 for entries near 0); the full forward, which adds
    the TDNN-Transformer encoder's float32 sums in another order (measured:
    4.8e-5 absolute on logits and log-probs), rtol and atol 1e-4."""
    model, v, pt = models
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, VOCAB, (3, 6)).astype(np.int32)
    lens = np.array([6, 2, 0], np.int32)
    enc = rng.standard_normal((3, 5, 16)).astype(np.float32)
    dec = rng.standard_normal((3, 4, 16)).astype(np.float32)
    x = rng.standard_normal((2, 40, 12)).astype(np.float32)
    x_len = np.array([40, 31], np.int32)
    y_len = np.array([4, 2], np.int32)
    cases = [
        ("predict_last", (tokens, lens), TransducerJax.predict_last, pt.predict_last),
        ("joint_step", (enc, dec[:, :1].repeat(5, 1)), TransducerJax.joint_step, pt.joint_step),
        ("joint_logits", (enc, dec), TransducerJax.joint_logits, pt.joint_logits),
    ]
    apply = jax.jit(model.apply, static_argnames=("method", "softmax"))
    with torch.no_grad():
        for name, args, ref_fn, fn in cases:
            ref = apply(v, *map(jnp.asarray, args), method=ref_fn)
            got = fn(*map(torch.from_numpy, args))
            assert got.shape == ref.shape, name
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        for softmax in (True, False):
            ref = apply(v, jnp.asarray(x), jnp.asarray(tokens[:2, :4]), jnp.asarray(x_len),
                        jnp.asarray(y_len), softmax=softmax)
            got = pt(torch.from_numpy(x), torch.from_numpy(tokens[:2, :4]),
                     torch.from_numpy(x_len), torch.from_numpy(y_len), softmax=softmax)
            assert got.shape == ref.shape == (2, pt.encoder_out_len(40), 5, VOCAB)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_dup_mask_matches_jax():
    """The forged-collision case of tests/test_beam.py (equal hash and
    length, different tokens: not merged; a genuine duplicate: merged) and
    random buffers with many collisions, against the JAX ``_dup_mask``."""
    um = 4
    tokens = np.full((1, 4, um), -1, np.int64)
    tokens[0, 0, :2], tokens[0, 1, :2], tokens[0, 2, :2], tokens[0, 3, :2] = \
        [1, 2], [3, 1], [2, 2], [2, 2]
    cases = [(np.array([[7, 7, 9, 9]]), np.full((1, 4), 2), tokens),
             (np.zeros((1, 4)), np.zeros((1, 4)), np.full((1, 4, um), -1))]
    rng = np.random.default_rng(2)
    lens = rng.integers(0, 3, (5, 6))
    rand_tokens = np.where(np.arange(um) < lens[..., None], rng.integers(1, 3, (5, 6, um)), -1)
    cases.append((rng.integers(0, 2, (5, 6)), lens, rand_tokens))
    for hashes, lens, toks in cases:
        ref = np.asarray(dup_mask_jax(jnp.asarray(hashes, jnp.uint32), jnp.asarray(lens, jnp.int32),
                                      jnp.asarray(toks, jnp.int32)))
        got = _dup_mask(*(torch.from_numpy(np.asarray(a, np.int64)) for a in (hashes, lens, toks)))
        np.testing.assert_array_equal(got.numpy(), ref)
    assert got.any() and not got.all()  # the random case has both outcomes
    first = _dup_mask(*(torch.from_numpy(np.asarray(a, np.int64)) for a in cases[0]))
    assert first.tolist() == [[False, False, False, True]]


def test_top_k_tie_rule():
    """``top_k`` orders equal values by index, lower first, as
    ``jax.lax.top_k`` does (the NEG ties of dead beams)."""
    x = np.random.default_rng(3).integers(0, 4, (6, 50)).astype(np.float32)
    x[0] = NEG
    for k in (1, 5, 50):
        ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))


# (beam, n_best, blank, sm_scale, max_symbols, blank bias): every value of
# the grid; bias 0 emits until the cap (max_symbols 3 hits it early), bias 3
# ends by the stop rule
GRID = [(1, 1, 0, 1.0, 12, 0.0), (4, 4, 0, 1.0, 12, 3.0), (8, 4, 2, 0.5, 12, 3.0),
        (8, 1, 0, 0.5, 12, 0.0), (4, 1, 2, 1.0, 12, 0.0), (8, 4, 0, 1.0, 3, 0.0),
        (1, 4, 2, 0.5, 12, 3.0)]


@pytest.mark.parametrize("beam,n_best,blank,sm_scale,max_symbols,bias", GRID)
def test_beam_search_matches_jax(enc_out, beam, n_best, blank, sm_scale, max_symbols, bias):
    model, v, pt = _models(bias, blank)
    ref, got = _run_both(model, v, pt, enc_out, ENC_LENS, beam_size=beam, n_best=n_best,
                         blank=blank, sm_scale=sm_scale, max_symbols=max_symbols)
    _assert_same(ref, got)
    assert got["tokens"].shape == (3, n_best, max_symbols)
    assert got["aligns"].shape == (3, n_best, 7 + max_symbols)
    assert got["lens"].max() > 0  # the comparison exercised emissions
    if max_symbols == 3:
        assert (got["lens"][:2, 0] == 3).all()  # the full-beam cap


def test_beam_bf16_matches_jax(enc_out):
    """``mm_dtype="bfloat16"`` in both: top-1 hypotheses identical, scores
    within BF16_SCORE_RTOL; the port's loop carries bf16 LSTM state."""
    model, v, pt = _models(3.0)
    cfg = dict(beam_size=4, n_best=4, max_symbols=12, mm_dtype="bfloat16")
    ref, got = _run_both(model, v, pt, enc_out, ENC_LENS, **cfg)
    np.testing.assert_array_equal(got["lens"][:, 0], ref["lens"][:, 0])
    np.testing.assert_array_equal(got["tokens"][:, 0], ref["tokens"][:, 0])
    np.testing.assert_allclose(got["scores"][:, 0], ref["scores"][:, 0], rtol=BF16_SCORE_RTOL)
    loop = next(x for key, x in pt._decode_loops.items() if key[-1] == torch.bfloat16)
    assert loop.state["dec_h"].dtype == loop.net.fc2.weight.dtype == torch.bfloat16
    auto, f32 = (beam_search(pt, torch.from_numpy(enc_out), torch.from_numpy(ENC_LENS),
                             BeamConfig(**dict(cfg, mm_dtype=d))) for d in ("auto", None))
    for name in auto:  # "auto" is float32 on the CPU
        assert torch.equal(auto[name], f32[name]), name


def test_decode_net_shares_or_refreshes(enc_out):
    """At the model's own dtype the loops run the model's modules; in bf16
    they run a copy, refreshed from the model before each search, so new
    weights loaded into the model reach a loop made before."""
    _, _, pt = _models(3.0)
    assert pt.decode_net(torch.float32).fc2 is pt.fc2
    net = pt.decode_net(torch.bfloat16)
    assert net.fc2 is not pt.fc2 and net.fc2.weight.dtype == torch.bfloat16
    assert not hasattr(net, "encoder")
    enc, lens = torch.from_numpy(enc_out), torch.from_numpy(ENC_LENS)
    _, _, fresh = _models(0.0)
    for dtype in ("bfloat16", None):
        cfg = BeamConfig(beam_size=4, n_best=4, max_symbols=12, mm_dtype=dtype)
        before = beam_search(pt, enc, lens, cfg)
        pt.load_state_dict(fresh.state_dict())
        after, ref = beam_search(pt, enc, lens, cfg), beam_search(fresh, enc, lens, cfg)
        assert not torch.equal(before["scores"], after["scores"])
        for name in ref:
            assert torch.equal(after[name], ref[name]), name
        pt = _models(3.0)[2]


@pytest.mark.parametrize("blank", [0, 2])
def test_beam1_equals_greedy(enc_out, blank):
    """At full lengths (a shorter row lets beam 1 finish on a blank at its
    last frame while greedy goes on emitting there, in the JAX package too)."""
    _, _, pt = _models(1.0, blank)
    enc, lens = torch.from_numpy(enc_out), torch.full((3,), 7)
    hyps, hyp_lens = greedy_decode(pt, enc, lens, max_symbols=12, blank=blank)
    out = beam_search(pt, enc, lens, BeamConfig(beam_size=1, n_best=1, max_symbols=12,
                                                blank=blank))
    np.testing.assert_array_equal(out["lens"][:, 0].numpy(), hyp_lens.numpy())
    np.testing.assert_array_equal(out["tokens"][:, 0].numpy(), hyps.numpy())


def _path_logprob(pt, enc_row, labels):
    """Best single-alignment log-prob of a label sequence through the port's
    own lattice (``joint_logits``), by exhaustive max-plus DP."""
    t_max, u_max = enc_row.shape[0], len(labels)
    with torch.no_grad():
        dec = pt.predict(torch.tensor([labels], dtype=torch.long).reshape(1, u_max))
        lp = torch.log_softmax(pt.joint_logits(enc_row[None], dec), -1)[0].double().numpy()
    dp = np.full((t_max, u_max + 1), -1e30)
    dp[0, 0] = 0.0
    for t in range(t_max):
        for u in range(u_max + 1):
            if t > 0:
                dp[t, u] = max(dp[t, u], dp[t - 1, u] + lp[t - 1, u, 0])
            if u > 0:
                dp[t, u] = max(dp[t, u], dp[t, u - 1] + lp[t, u - 1, labels[u - 1]])
    return dp[t_max - 1, u_max] + lp[t_max - 1, u_max, 0]


def test_beam_finds_viterbi_best():
    """With a beam wide enough, the top hypothesis is the label sequence of
    the highest Viterbi path score among all sequences (vocabulary 3)."""
    cfg = TransducerConfig(**dict(MODEL, vocab_size=3))
    pt = init_transducer(cfg, torch.Generator().manual_seed(7), device="cpu")
    enc = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 3, 16))
                           .astype(np.float32))
    out = beam_search(pt, enc, torch.tensor([3]), BeamConfig(beam_size=16, n_best=4,
                                                             max_symbols=4))
    best_score, best_seq = -1e30, None
    for length in range(0, 4):
        for seq in itertools.product([1, 2], repeat=length):
            s = _path_logprob(pt, enc[0], list(seq))
            if s > best_score:
                best_score, best_seq = s, list(seq)
    got_len = int(out["lens"][0, 0])
    assert out["tokens"][0, 0, :got_len].tolist() == best_seq
    np.testing.assert_allclose(float(out["scores"][0, 0]), best_score, rtol=1e-4)


def test_steps_per_check_gives_identical_results(models, enc_out):
    """The masked body: the steps after the loop's end are no-ops, so any
    check interval gives the same bits and the same step count."""
    _, _, pt = models
    cfg = BeamConfig(beam_size=4, n_best=4, max_symbols=12)
    enc, lens = torch.from_numpy(enc_out), torch.from_numpy(ENC_LENS)
    a, b = (beam_search(pt, enc, lens, cfg, steps_per_check=s) for s in (1, 7))
    for name in a:
        assert torch.equal(a[name], b[name]), name
    with pytest.raises(ValueError):
        beam_search(pt, enc, lens, cfg, steps_per_check=0)


def _lm(seed, negative=False, backoff=True, disambig=False, n_states=10):
    """One random LM automaton as the JAX package's and the port's
    ``FstTables`` (the same arcs through each ``_build_tables``): state 0 a
    final unigram state with arcs on most tokens' ilabels (token + 1), the
    others contexts with a few arcs, backing off to 0 (``backoff``; without
    it a grammar whose sets die on other tokens), some final; ``negative``
    draws weights below 0 (bonuses), ``disambig`` adds disambig arcs."""
    rng = np.random.default_rng(seed)
    lo, hi = (-1.0, 2.5) if negative else (0.0, 3.0)
    dis_ids = [VOCAB + 5, VOCAB + 6] if disambig else None
    arcs, finals = {}, {0: float(rng.uniform(0.0, 1.0))}
    for s in range(n_states):
        n_arcs = VOCAB - 4 if s == 0 else int(rng.integers(2, VOCAB // 2))
        labels = rng.choice(np.arange(2, VOCAB + 1), size=n_arcs, replace=False)
        arcs[s] = [(int(l), float(rng.uniform(lo, hi)), int(rng.integers(1, n_states)))
                   for l in labels]
        if s and backoff:
            arcs[s].append((0, float(rng.uniform(lo / 2, 1.0)), 0))
        if disambig and rng.random() < 0.5:
            arcs[s].append((int(rng.choice(dis_ids)), float(rng.uniform(lo, hi)),
                            int(rng.integers(0, n_states))))
        if s and rng.random() < 0.5:
            finals[s] = float(rng.uniform(lo, hi))
    return tuple(build(n_states, arcs, finals, start=int(backoff), backoff_id=0,
                       disambig_ids=dis_ids) for build in (build_tables_jax, build_tables))


def _run_fst(model, v, pt, enc, lens, tables, cached, **cfg):
    tj, tp = tables
    kw = dict(n_ilabels=VOCAB + 1, cache_max_bytes=1 << 20) if cached else {}
    ref = beam_search_jax(model, v, jnp.asarray(enc), jnp.asarray(lens), BeamConfigJax(**cfg),
                          fst_tables=tj.device_arrays(**kw), fst_start=tj.start)
    got = beam_search(pt, torch.from_numpy(enc), torch.from_numpy(lens), BeamConfig(**cfg),
                      fst_tables=tp.device_arrays("cpu", **kw), fst_start=tp.start)
    return {k: np.asarray(x) for k, x in ref.items()}, {k: x.numpy() for k, x in got.items()}


# (LM kind, advance cache, config): the three selection modes, each
# cached and walked where both exist, with nonblk_reward, negative weights
# and disambig arcs, a grammar whose state sets die (per-beam: the beam is
# killed; per-token: the candidate) and state sets of capacity 1 and 4
FST_GRID = [
    ("backoff", False, dict()),
    ("backoff", True, dict(nonblk_reward=0.4)),
    ("backoff", False, dict(lm_per_token=True, lm_topm=4)),
    ("backoff", True, dict(lm_per_token=True, lm_topm=4, nonblk_reward=0.4)),
    ("backoff", True, dict(lm_per_token=True, lm_topm=0)),
    ("negative", True, dict(lm_per_token=True, lm_topm=0, nonblk_reward=0.3)),
    ("negative", False, dict(nonblk_reward=0.3, lm_scale=1.5)),
    ("disambig", False, dict(lm_per_token=True, lm_topm=3)),
    ("disambig", True, dict(lm_per_token=True, lm_topm=0)),
    ("grammar", False, dict()),
    ("grammar", True, dict(lm_per_token=True, lm_topm=0)),
    ("grammar", False, dict(lm_per_token=True, lm_topm=4)),
    ("backoff", False, dict(lm_per_token=True, lm_topm=4, max_fst_states=1)),
    ("backoff", True, dict(max_fst_states=1)),
]


@pytest.mark.parametrize("kind,cached,fusion", FST_GRID)
def test_fst_beam_matches_jax(enc_out, kind, cached, fusion):
    """FST shallow fusion in every mode against the JAX beam on the same
    weights, encoder output and LM: tokens, lengths and alignments
    identical, scores within rtol 1e-5."""
    model, v, pt = _models(1.0)
    tables = _lm(3, negative=kind == "negative", backoff=kind != "grammar",
                 disambig=kind == "disambig")
    cfg = dict(dict(beam_size=4, n_best=4, max_symbols=6, lm_scale=0.7), **fusion)
    ref, got = _run_fst(model, v, pt, enc_out, ENC_LENS, tables, cached, **cfg)
    _assert_same(ref, got)
    assert got["lens"].max() > 0 and (got["scores"][:, 0] > NEG / 2).any()
    loop = next(iter(pt._decode_loops.values()))
    assert loop.state["fst_states"].shape == (3, 4, cfg.get("max_fst_states", 4))


@pytest.mark.parametrize("per_token", [False, True])
def test_fst_fusion_steers_against_plain(models, enc_out, per_token):
    """An LM whose every token costs 0 (one final state with a free
    self-loop on every ilabel) leaves the plain search's N-best; a strong
    LM changes it (the fusion acts)."""
    model, v, pt = models
    enc, lens = torch.from_numpy(enc_out), torch.from_numpy(ENC_LENS)
    base = dict(beam_size=4, n_best=4, max_symbols=6)
    plain = beam_search(pt, enc, lens, BeamConfig(**base))
    free = build_tables(1, {0: [(il, 0.0, 0) for il in range(1, VOCAB + 1)]}, {0: 0.0}, 0, 0)
    fusion = dict(lm_per_token=per_token, lm_topm=0)
    got = beam_search(pt, enc, lens, BeamConfig(**base, lm_scale=2.0, **fusion),
                      fst_tables=free.device_arrays("cpu", VOCAB + 1, 1 << 20))
    for name in plain:
        assert torch.equal(got[name], plain[name]), name
    strong = _run_fst(model, v, pt, enc_out, ENC_LENS, _lm(4), True, lm_scale=3.0, **base,
                      **fusion)[1]
    assert not np.array_equal(strong["tokens"], plain["tokens"].numpy())


def test_fst_loops_keyed_by_lm(enc_out):
    """Two LMs of one shape decoded in turn through one model give what
    fresh models give: each LM has its own loop (keyed by the tables'
    content fingerprint), so a loop made for one never reads the other."""
    first = _lm(5)[1]
    tables = [first, dataclasses.replace(first, arc_weight=first.arc_weight[::-1].copy())]
    cfg = BeamConfig(beam_size=4, n_best=4, max_symbols=6, lm_scale=1.0, lm_per_token=True,
                     lm_topm=0)
    enc, lens = torch.from_numpy(enc_out), torch.from_numpy(ENC_LENS)

    def decode(pt, tp):
        dev = tp.device_arrays("cpu", n_ilabels=VOCAB + 1, cache_max_bytes=1 << 20)
        return beam_search(pt, enc, lens, cfg, fst_tables=dev, fst_start=tp.start)

    pt = _models(1.0)[2]
    shared = [decode(pt, tables[i % 2]) for i in range(3)]
    fresh = [decode(_models(1.0)[2], t) for t in tables]
    assert len(pt._decode_loops) == 2
    for got, ref in zip(shared, fresh + fresh[:1]):
        for name in ref:
            assert torch.equal(got[name], ref[name]), name
    assert not torch.equal(fresh[0]["scores"], fresh[1]["scores"])


def test_fst_config_errors(models, enc_out):
    """Exact per-token fusion without the advance cache raises, as in the
    JAX beam; tables not made by ``device_arrays`` (no fingerprint) raise;
    with no tables the FST fields change nothing."""
    _, _, pt = models
    enc, lens = torch.from_numpy(enc_out), torch.from_numpy(ENC_LENS)
    tp = _lm(7)[1]
    cfg = BeamConfig(beam_size=2, max_symbols=4, lm_scale=0.5, lm_per_token=True, lm_topm=0)
    with pytest.raises(ValueError, match="advance cache"):
        beam_search(pt, enc, lens, cfg, fst_tables=tp.device_arrays("cpu"), fst_start=tp.start)
    with pytest.raises(TypeError, match="device_arrays"):
        beam_search(pt, enc, lens, cfg, fst_tables=dict(tp.device_arrays("cpu")))
    plain = beam_search(pt, enc, lens, BeamConfig(beam_size=2, max_symbols=4))
    for name, x in beam_search(pt, enc, lens, cfg).items():
        assert torch.equal(x, plain[name]), name
