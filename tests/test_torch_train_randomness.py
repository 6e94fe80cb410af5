"""The training recipe's train-mode randomness in the port against the JAX
package on the CPU: dither 1.0 and the TDNN-Transformer layers' dropout at
0.1 (``egs/mini_grammar.sh``'s rates; the LSTM prediction net's dropout is
inert at one layer in both packages).  The two packages draw from different
streams (JAX keys, ``torch.Generator``), so no draw can match bit for bit;
what is held is where the noise acts and its statistics.

(a) the dropout sites: every dropout application of one train-mode forward,
    with its rate and the shape it masks, recorded on the JAX side through
    ``flax.linen.intercept_methods`` and on the port's through a counter
    around its dropout functions; the two lists are equal, in order.
(b) the distribution of the summed train-mode loss and of the global
    gradient norm over N = 48 draws (JAX keys 0..47, generators 0..47),
    under dither alone, dropout alone and both: the means within 4 pooled
    standard errors, the standard deviations within a ratio of [0.7, 1.4].
(c) the dither: the per-bin mean and variance of the fbank difference
    between dither 1 and dither 0 on the same waveforms, over the same draws
    and every valid frame, held the same way.

The weights are the JAX model's, carried into the port by
``pika_tpu_torch/convert.py``; the JAX side is jitted."""

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as flax_nn
import pytest
import torch

from pika_tpu.features.fbank import FbankConfig as FbankJax, make_fbank_fn as fbank_jax
from pika_tpu.models.transducer import (
    Transducer as TransducerJax,
    TransducerConfig as ConfigJax,
    init_transducer as init_jax,
)
from pika_tpu.train.step import (
    FeaturizerConfig as FeatJax,
    make_featurizer as featurizer_jax,
    transducer_loss as loss_jax,
)
import pika_tpu_torch.models.lstm as lstm_pt
import pika_tpu_torch.models.transformer as transformer_pt
from pika_tpu_torch import convert
from pika_tpu_torch.features.fbank import FbankConfig, make_fbank_fn
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.train.step import FeaturizerConfig, make_featurizer, transducer_loss

torch.set_num_threads(1)

N = 48                 # draws on each side
MEAN_SE = 4.0          # |mean difference| <= 4 pooled standard errors
STD_RATIO = (0.7, 1.4)  # port std / JAX std
MEL, SAMPLES = 40, 16000
# the recipe's model family at a tiny width: one transformer layer
# (tdnn_layers 5), the recipe's rates
MODEL = dict(input_dim=3 * MEL, vocab_size=12, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="rnn", dec_layers=1, embd_dim=8, tdnn_nhid=32, tdnn_layers=5,
             dropout=0.1, tdnn_transformer_dropout=0.1)
NO_DROPOUT = dict(dropout=0.0, tdnn_transformer_dropout=0.0)
FBANK = dict(sample_frequency=16000, window_type="hamming", low_freq=40.0, high_freq=-200.0,
             num_mel_bins=MEL)
CASES = {"dither": (1.0, NO_DROPOUT), "dropout": (0.0, {}), "both": (1.0, {})}


@pytest.fixture(scope="module")
def setup():
    """One numpy batch (the recipe corpus's loud frames and exact-zero
    runs, where dither decides the features), CMVN from its dithered
    features (as ``compute_global_cmvn`` takes it), and the JAX weights."""
    rng = np.random.default_rng(15)
    wav_lens = np.array([16000, 13000, 10000, 7000], np.int32)
    wavs = np.zeros((4, SAMPLES), np.float32)
    for i, n in enumerate(wav_lens):
        wavs[i, :n] = np.round(rng.standard_normal(n) * 2000)
        wavs[i, 2000:4400] = 0.0  # an exact-zero run
    labels = rng.integers(1, MODEL["vocab_size"], (4, 5)).astype(np.int32)
    label_lens = np.array([5, 3, 4, 2], np.int32)
    fcfg = FeaturizerConfig(fbank=FbankConfig(dither=1.0, **FBANK), max_samples=SAMPLES,
                            lctx=1, rctx=1)
    feats, lens = make_featurizer(fcfg, device="cpu")(
        torch.from_numpy(wavs), torch.from_numpy(wav_lens), torch.Generator().manual_seed(99))
    valid = torch.cat([f[:n] for f, n in zip(feats, lens.tolist())]).numpy()
    offset = -valid.mean(0).astype(np.float32)
    scale = (1.0 / valid.std(0)).astype(np.float32)
    variables = jax.jit(lambda key: init_jax(key, ConfigJax(**MODEL), max_t=64)[1])(
        jax.random.PRNGKey(5))
    return dict(wavs=wavs, wav_lens=wav_lens, labels=labels, label_lens=label_lens,
                offset=offset, scale=scale, variables=jax.tree.map(np.asarray, variables))


def _jax_model(**overrides):
    return TransducerJax(ConfigJax(**{**MODEL, **overrides}))


def _port_model(variables, **overrides):
    model = init_transducer(TransducerConfig(**{**MODEL, **overrides}),
                            torch.Generator().manual_seed(0), device="cpu")
    return convert.load_flax_variables(model, variables).train()


def _jax_featurizer(s, dither):
    cfg = FeatJax(fbank=FbankJax(dither=dither, **FBANK), max_samples=SAMPLES, lctx=1, rctx=1)
    return featurizer_jax(cfg, jnp.asarray(s["offset"]), jnp.asarray(s["scale"]))


def _port_featurizer(s, dither):
    return make_featurizer(FeaturizerConfig(fbank=FbankConfig(dither=dither, **FBANK),
                                            max_samples=SAMPLES, lctx=1, rctx=1),
                           torch.from_numpy(s["offset"]), torch.from_numpy(s["scale"]),
                           device="cpu")


def _jax_draws(s, dither, overrides):
    """(loss, global gradient norm) of the train-mode forward for keys
    0..N-1, split as the JAX train step splits its key."""
    model = _jax_model(**overrides)
    featurize = _jax_featurizer(s, dither)
    batch = {k: jnp.asarray(s[k]) for k in ("wavs", "wav_lens", "labels", "label_lens")}

    @jax.jit
    def draw(params, key):
        kf, kd = jax.random.split(key)

        def loss(p):
            feats, feat_lens = featurize(kf, batch["wavs"], batch["wav_lens"], True)
            value, _ = loss_jax(model, p, s["variables"]["batch_stats"], feats, feat_lens,
                                batch["labels"], batch["label_lens"], train=True,
                                dropout_key=kd, loss_chunk=8)
            return value

        value, grads = jax.value_and_grad(loss)(params)
        norm = jnp.sqrt(sum(jnp.sum(g.astype(jnp.float32) ** 2)
                            for g in jax.tree.leaves(grads)))
        return value, norm

    out = [draw(s["variables"]["params"], jax.random.PRNGKey(i)) for i in range(N)]
    return np.array([[float(v), float(g)] for v, g in out])


def _port_draws(s, dither, overrides):
    """The same over ``torch.Generator``s seeded 0..N-1."""
    model = _port_model(s["variables"], **overrides)
    featurize = _port_featurizer(s, dither)
    wavs, wav_lens = torch.from_numpy(s["wavs"]), torch.from_numpy(s["wav_lens"])
    labels, label_lens = torch.from_numpy(s["labels"]), torch.from_numpy(s["label_lens"])
    out = []
    for i in range(N):
        g = torch.Generator().manual_seed(i)
        model.zero_grad(set_to_none=True)
        feats, feat_lens = featurize(wavs, wav_lens, g)
        loss = transducer_loss(model, feats, feat_lens, labels, label_lens, loss_chunk=8,
                               generator=g)
        loss.backward()
        norm = torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.parameters()
                              if p.grad is not None))
        out.append([float(loss.detach()), float(norm)])
    return np.array(out)


def _hold(got, ref, what):
    """The distribution check of (b) and (c): means within ``MEAN_SE``
    pooled standard errors, standard deviations within ``STD_RATIO``."""
    n_g, n_r = len(got), len(ref)
    se = np.sqrt(got.var(ddof=1) / n_g + ref.var(ddof=1) / n_r)
    gap = abs(got.mean() - ref.mean())
    assert gap <= MEAN_SE * se, f"{what}: means {got.mean()} vs {ref.mean()} (se {se})"
    ratio = got.std(ddof=1) / ref.std(ddof=1)
    assert STD_RATIO[0] <= ratio <= STD_RATIO[1], f"{what}: std ratio {ratio}"


# ---------------------------------------------------------------------------
# (a) the dropout sites
# ---------------------------------------------------------------------------

def test_dropout_sites_and_rates_match_jax(setup):
    """One train-mode forward in each package: the dropout applications
    (rate, masked shape) are the same list, in the same order: per
    transformer layer the attention probabilities (B, H, T, T), the
    attention output and the feed-forward's two (B, T, d); none in the
    one-layer LSTM."""
    s = setup
    jax_sites = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, flax_nn.Dropout) and context.method_name == "__call__":
            det = kwargs.get("deterministic", args[1] if len(args) > 1 else None)
            det = context.module.deterministic if det is None else det
            if not det and context.module.rate > 0:
                jax_sites.append((round(float(context.module.rate), 6), tuple(args[0].shape)))
        return next_fun(*args, **kwargs)

    model = _jax_model()
    featurize = _jax_featurizer(s, 1.0)

    def forward(key):
        kf, kd = jax.random.split(key)
        feats, feat_lens = featurize(kf, jnp.asarray(s["wavs"]), jnp.asarray(s["wav_lens"]),
                                     True)
        with flax_nn.intercept_methods(interceptor):
            return loss_jax(model, s["variables"]["params"], s["variables"]["batch_stats"],
                            feats, feat_lens, jnp.asarray(s["labels"]),
                            jnp.asarray(s["label_lens"]), train=True, dropout_key=kd,
                            loss_chunk=8)

    jax.eval_shape(forward, jax.random.PRNGKey(0))  # the sites are recorded while tracing

    port_sites = []

    def counted(fn):
        def wrapper(x, rate, generator):
            if rate > 0:
                port_sites.append((round(float(rate), 6), tuple(x.shape)))
            return fn(x, rate, generator)
        return wrapper

    pt = _port_model(s["variables"])
    feats_pt, lens_pt = _port_featurizer(s, 1.0)(
        torch.from_numpy(s["wavs"]), torch.from_numpy(s["wav_lens"]), torch.Generator())
    patches = [(transformer_pt, "dropout"), (transformer_pt, "head_shared_dropout"),
               (lstm_pt, "_dropout")]
    saved = [getattr(m, n) for m, n in patches]
    try:
        for m, n in patches:
            setattr(m, n, counted(getattr(m, n)))
        with torch.no_grad():
            transducer_loss(pt, feats_pt, lens_pt, torch.from_numpy(s["labels"]),
                            torch.from_numpy(s["label_lens"]), loss_chunk=8,
                            generator=torch.Generator().manual_seed(0))
    finally:
        for (m, n), f in zip(patches, saved):
            setattr(m, n, f)
    assert len(jax_sites) == 4, jax_sites
    assert port_sites == jax_sites


# ---------------------------------------------------------------------------
# (b) the loss and gradient-norm distributions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grad_norm_distributions_match_jax(setup, case):
    """N train-mode losses and gradient norms on each side: means within 4
    pooled standard errors, standard deviations within [0.7, 1.4]; and the
    noise is real on both sides (each side's draws differ)."""
    dither, overrides = CASES[case]
    ref = _jax_draws(setup, dither, overrides)
    got = _port_draws(setup, dither, overrides)
    assert np.all(np.isfinite(ref)) and np.all(np.isfinite(got))
    for col, what in enumerate(("loss", "gradient norm")):
        assert ref[:, col].std() > 0 and got[:, col].std() > 0, what
        _hold(got[:, col], ref[:, col], f"{case} {what}")


# ---------------------------------------------------------------------------
# (c) the dither
# ---------------------------------------------------------------------------

def test_dither_statistics_match_jax(setup):
    """Per mel bin, the fbank difference between dither 1 and dither 0 on
    the same waveforms over N draws, pooled over the frames of one kind:
    the exact-zero runs' frames (at the log floor without dither, so the
    difference is the log energy of the dither itself) and the loud frames
    (where dither is a small perturbation).  Its mean within 4 pooled
    standard errors of JAX's, its standard deviation within [0.7, 1.4] of
    JAX's, for each kind and bin."""
    s = setup
    fb_j = jax.jit(fbank_jax(FbankJax(dither=1.0, **FBANK), SAMPLES))
    fb_p = make_fbank_fn(FbankConfig(dither=1.0, **FBANK), SAMPLES, device="cpu")
    wavs_j, lens_j = jnp.asarray(s["wavs"]), jnp.asarray(s["wav_lens"])
    wavs_p, lens_p = torch.from_numpy(s["wavs"]), torch.from_numpy(s["wav_lens"])
    clean_j, _ = fb_j(wavs_j, lens_j, None)
    clean_p, frames_p = fb_p(wavs_p, lens_p)
    np.testing.assert_allclose(clean_p.numpy(), np.asarray(clean_j), rtol=1e-4, atol=1e-3)
    valid = np.arange(clean_p.shape[1])[None, :] < frames_p.numpy()[:, None]
    floor = np.all(clean_p.numpy() < -15.0, axis=-1)  # the zero runs' frames
    kinds = {"silent": valid & floor, "loud": valid & ~floor}
    assert kinds["silent"].sum() >= 4 * 12 and kinds["loud"].sum() >= 100
    diffs = {k: ([], []) for k in kinds}
    for i in range(N):
        d_j, _ = fb_j(wavs_j, lens_j, jax.random.PRNGKey(i))
        d_p, _ = fb_p(wavs_p, lens_p, torch.Generator().manual_seed(i))
        d_j, d_p = np.asarray(d_j) - np.asarray(clean_j), (d_p - clean_p).numpy()
        for k, where in kinds.items():
            diffs[k][0].append(d_j[where])
            diffs[k][1].append(d_p[where])
    for k, (d_j, d_p) in diffs.items():
        d_j, d_p = np.concatenate(d_j).astype(np.float64), np.concatenate(d_p).astype(np.float64)
        for b in range(MEL):
            _hold(d_p[:, b], d_j[:, b], f"{k} frames, bin {b}")
    # dither lifts the silent frames off the log floor on both sides
    assert np.concatenate(diffs["silent"][1]).mean() > 10.0
