"""The port's training slice (pika_tpu_torch) against the JAX package, on the
same numpy inputs: SpecAugment, dropout, the schedule, clipping and
optimizers, train-mode BatchNorm, and whole train steps from identical
weights (the loss's backward: tests/test_torch_loss_bwd.py).

Tolerances: float32 arithmetic in another order, 1e-5 relative unless a test
says otherwise; anything downstream of the encoder's attention to bf16
rounding (q, k, v and the probabilities are rounded to bf16 in both
packages, so a flipped rounding moves a value by 2^-8 relative).  The
random draws (dither, SpecAugment, dropout) cannot match JAX's: the step
parity runs with them off, and they are tested by their statistics and by
feeding both sides the same span numbers.  Kernels K2/K3 themselves run
only on the card: tests/test_torch_gpu.py."""

import inspect

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pika_tpu.features.fbank import FbankConfig as FbankJax
from pika_tpu.features.pipeline import spec_augment as spec_augment_jax
from pika_tpu.models.tdnn_transformer import TDNNTransformerEncoder as TDNNJax
from pika_tpu.models.transducer import (
    Transducer as TransducerJax,
    TransducerConfig as ConfigJax,
    init_transducer as init_jax,
)
from pika_tpu.train import lr as lr_jax
from pika_tpu.train.step import (
    FeaturizerConfig as FeatJax,
    TrainState,
    make_featurizer as featurizer_jax,
    make_train_step as train_step_jax,
)
from pika_tpu_torch import convert
from pika_tpu_torch.features.fbank import FbankConfig
from pika_tpu_torch.features.pipeline import spec_augment, spec_augment_mask
from pika_tpu_torch.models.tdnn_transformer import TDNNTransformerEncoder as TDNNPt
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.models.transformer import TransformerEncoderLayer, dropout
from pika_tpu_torch.train.lr import clip_by_inf_norm, exp_interp_schedule, make_optimizer
from pika_tpu_torch.train.step import FeaturizerConfig, make_featurizer, make_train_step

torch.set_num_threads(1)


def _init_jax_jit(key, cfg):
    """``init_transducer`` under jit (eager init takes seconds here)."""
    return TransducerJax(cfg), jax.jit(lambda k: init_jax(k, cfg, max_t=64)[1])(key)


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


# ---------------------------------------------------------------------------
# SpecAugment and dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("dims,spans", [((40, 12), (15, 35)), ((7, 5), (5, 7))])
def test_spec_augment_mask_matches_jax(rng, seed, dims, spans):
    """The port's mask, fed the spans and starts JAX's spec_augment draws
    from its key (re-derived here the same way), gives JAX's output."""
    t, d = dims
    max_f, max_t = spans
    feats = rng.standard_normal((2, t, d)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(spec_augment_jax(key, jnp.asarray(feats), max_f, max_t))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    f_span = int(jax.random.randint(k1, (), 0, max_f + 1))
    t_span = int(jax.random.randint(k2, (), 0, max_t + 1))
    f_start = int(jax.random.randint(k3, (), 0, max(1, d - f_span + 1)))
    t_start = int(jax.random.randint(k4, (), 0, max(1, t - t_span + 1)))
    keep = spec_augment_mask(t, d, f_span, t_span, f_start, t_start)
    np.testing.assert_array_equal((torch.from_numpy(feats) * keep).numpy(), ref)
    keep_t = spec_augment_mask(t, d, *map(torch.tensor, (f_span, t_span, f_start, t_start)))
    assert torch.equal(keep, keep_t)


def test_spec_augment_statistics():
    """Spans uniform over [0, max]; starts over [0, dim - span] inclusive, so
    the last bin and the last frame are reachable; one mask for the batch."""
    t, d, max_f, max_t = 20, 10, 4, 6
    g = torch.Generator().manual_seed(0)
    feats = torch.ones(3, t, d)
    n = 3000
    f_spans, t_spans = np.zeros(n, int), np.zeros(n, int)
    last_bin = last_frame = 0
    for i in range(n):
        out = spec_augment(feats, max_f, max_t, g)
        assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])
        zero = out[0] == 0
        cols, rows = zero.all(0), zero.all(1)
        full_rows = int(rows.sum())
        f_spans[i] = int(cols.sum()) if full_rows < t else 0
        t_spans[i] = full_rows if int(cols.sum()) < d else 0
        last_bin += bool(cols[-1]) and full_rows < t
        last_frame += bool(rows[-1]) and int(cols.sum()) < d
    for spans, mx in ((f_spans, max_f), (t_spans, max_t)):
        counts = np.bincount(spans, minlength=mx + 1)
        assert len(counts) == mx + 1 and (counts > 0).all()
        expect = n / (mx + 1)  # within 5 standard deviations of uniform
        assert np.all(np.abs(counts - expect) < 5 * np.sqrt(expect))
    assert last_bin > 0 and last_frame > 0


def test_dropout_statistics():
    """Mean preserved (inverted dropout) and the drop rate within 5 standard
    deviations; the same generator seed gives the same mask; rate 0 and eval
    mode are the identity."""
    x = torch.full((200, 500), 3.0)
    for rate in (0.2, 0.5):
        out = dropout(x, rate, torch.Generator().manual_seed(1))
        dropped = float((out == 0).float().mean())
        sd = np.sqrt(rate * (1 - rate) / x.numel())
        assert abs(dropped - rate) < 5 * sd
        assert abs(float(out.mean()) - 3.0) < 5 * 3.0 * np.sqrt(rate / (1 - rate) / x.numel())
        assert torch.equal(out, dropout(x, rate, torch.Generator().manual_seed(1)))
    assert dropout(x, 0.0, None) is x
    xb = x.to(torch.bfloat16)  # the probabilities' dtype: scaled in bf16
    assert dropout(xb, 0.2, torch.Generator().manual_seed(1)).dtype == torch.bfloat16
    layer = TransformerEncoderLayer(16, 4, 32, dropout_rate=0.3)
    inp = torch.randn(2, 7, 16, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = layer.eval()(inp)
        layer.train()
        a = layer(inp, generator=torch.Generator().manual_seed(3))
        b = layer(inp, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.allclose(a, ref)


# ---------------------------------------------------------------------------
# schedule, clipping, optimizers
# ---------------------------------------------------------------------------

def test_schedule_and_clip_match_optax():
    ref = lr_jax.exp_interp_schedule(0.003, 0.0001, 100000)
    got = exp_interp_schedule(0.003, 0.0001, 100000)
    for n in (0, 1, 7, 5000, 100000):
        np.testing.assert_allclose(got(n), float(ref(n)), rtol=1e-6)
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32) * 4,
            "b": rng.standard_normal(5).astype(np.float32)}
    for clip in (1.0, 3.0, 100.0):
        ref_out, _ = lr_jax.clip_by_inf_norm(clip).update(jax.tree.map(jnp.asarray, tree), None)
        grads = [torch.from_numpy(tree[k].copy()) for k in ("a", "b")]
        norm = clip_by_inf_norm(grads, clip)
        assert float(norm) == pytest.approx(max(np.abs(v).max() for v in tree.values()))
        for k, g in zip(("a", "b"), grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(ref_out[k]), rtol=1e-6)


@pytest.mark.parametrize("optim", ["sgd", "adam", "adadelta"])
@pytest.mark.parametrize("clip", [-1.0, 0.5])
def test_optimizer_matches_optax_over_3_steps(optim, clip):
    """Three updates from the same gradients: the schedule at optax's count
    (0 for the first update), Nesterov momentum from the first gradient."""
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    kw = dict(initial_lr=0.1, final_lr=0.01, total_batches=4, momentum=0.9, grad_clip=clip)
    tx = lr_jax.make_optimizer(optim, **kw)
    p_jax = jax.tree.map(jnp.asarray, params)
    state = tx.init(p_jax)
    p_pt = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(p_pt.values(), optim, **kw)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, p_jax)
        p_jax = optax.apply_updates(p_jax, updates)
        for k, p in p_pt.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in p_pt.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_jax[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{optim} {k}")
    assert opt.count == 3


# ---------------------------------------------------------------------------
# train-mode BatchNorm
# ---------------------------------------------------------------------------

def test_batchnorm_train_mode_matches_flax(rng):
    """The encoder in train mode (dropout 0): output, and the running
    statistics after one forward, against flax with mutable batch_stats.
    The running variance takes the biased batch variance, as flax's does."""
    x = rng.standard_normal((3, 40, 12)).astype(np.float32) * 2 + 0.5
    enc = TDNNJax(output_dim=16, tdnn_nhid=32, tdnn_layers=5, transformer_dropout=0.0)
    variables = jax.tree.map(np.asarray, enc.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    ref, new_vars = enc.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    pt = convert.load_flax_variables(TDNNPt(12, 16, 32, 5, transformer_dropout=0.0), variables)
    got = pt.train()(torch.from_numpy(x))
    assert _rel_l2(got.detach().numpy(), np.asarray(ref)) < 1e-3  # attention: bf16
    sd = convert.state_dict_from_flax({"params": variables["params"],
                                       "batch_stats": jax.tree.map(np.asarray,
                                                                   new_vars["batch_stats"])})
    n = 0
    for name, buf in pt.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), sd[name].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=name)
            n += 1
    assert n == 2 * 7  # bn_in, bn_0..bn_4, bn_final


# ---------------------------------------------------------------------------
# whole train steps against JAX make_train_step
# ---------------------------------------------------------------------------

MEL = 23
MODEL = dict(input_dim=3 * MEL, vocab_size=20, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="rnn", dec_layers=2, embd_dim=8, tdnn_nhid=32, tdnn_layers=5,
             tdnn_transformer_dropout=0.0)
FBANK = dict(sample_frequency=16000, window_type="hamming", dither=0.0, num_mel_bins=MEL)
MAX_SAMPLES = 16000
OPTIM = dict(initial_lr=0.003, final_lr=0.0001, total_batches=100000, momentum=0.9, grad_clip=3.0)


def _check_state(model, ref_sd, init_sd, update_tol, stats_tol):
    """Every parameter's change since init against JAX's (relative L2,
    ``update_tol(name)``) and every BatchNorm statistic (``stats_tol``).
    Quantities whose true value is 0 (the gradient of a key bias through
    softmax, of a BatchNorm's affine feeding another BatchNorm, the mean of
    a BatchNorm's output) are float noise on both sides: held to 1e-6
    absolute instead."""
    checked = 0
    for name, x in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = x.numpy(), ref_sd[name].numpy()
        assert np.isfinite(got).all(), name
        if name.endswith(("running_mean", "running_var")):
            got_d, ref_d, tol = got, ref, stats_tol
        else:
            init = init_sd[name].numpy()
            got_d, ref_d, tol = got - init, ref - init, update_tol(name)
        if np.abs(ref_d).max() < 1e-6:
            assert np.abs(got_d - ref_d).max() < 1e-6, name
            continue
        assert _rel_l2(got_d, ref_d) < tol, (name, _rel_l2(got_d, ref_d), tol)
        checked += 1
    assert checked > 50


@pytest.fixture
def f32_attention(monkeypatch):
    """Attention in float32 in both packages: the JAX layer's ``mm_dtype``
    default set to None for this test (the TDNN encoder has no option for
    it) and the port's bf16 rounding made the identity."""
    import pika_tpu.models.transformer as transformer_jax
    import pika_tpu_torch.models.transformer as transformer_pt

    init = transformer_jax.MultiHeadedAttention.__init__.__wrapped__
    names = [n for n in inspect.signature(init).parameters if n != "self"]
    defaults = list(init.__defaults__)
    defaults[names.index("mm_dtype") - (len(names) - len(defaults))] = None
    monkeypatch.setattr(init, "__defaults__", tuple(defaults))
    monkeypatch.setattr(transformer_pt, "_bf16", lambda x: x)


@pytest.fixture(scope="module")
def step_inputs():
    rng = np.random.default_rng(11)
    wav_lens = np.array([16000, 12000, 9000, 4000], np.int32)
    wavs = np.zeros((4, MAX_SAMPLES), np.float32)
    for i, n in enumerate(wav_lens):
        wavs[i, :n] = np.round(rng.standard_normal(n) * 3000)
    batches = []
    for _ in range(3):
        labels = rng.integers(1, 20, (4, 5)).astype(np.int32)
        batches.append(dict(wavs=wavs, wav_lens=wav_lens, labels=labels,
                            label_lens=np.array([5, 3, 0, 2], np.int32)))
    # CMVN from the valid frames, so every fc_in unit sees varied, centred
    # inputs: a ReLU unit alive on only a frame or two feeds BatchNorm a
    # variance near its eps, which makes the gradient jump (in both packages)
    # with the last bit of its input
    plain = make_featurizer(FeaturizerConfig(fbank=FbankConfig(**FBANK), max_samples=MAX_SAMPLES,
                                             lctx=1, rctx=1), device="cpu")
    feats, lens = plain(torch.from_numpy(wavs), torch.from_numpy(wav_lens))
    valid = torch.cat([f[:n] for f, n in zip(feats, lens.tolist())]).numpy()
    offset = -valid.mean(0).astype(np.float32)
    scale = (1.0 / valid.std(0)).astype(np.float32)
    model, variables = _init_jax_jit(jax.random.PRNGKey(4), ConfigJax(**MODEL))
    return dict(batches=batches, offset=offset, scale=scale, model=model,
                variables=jax.tree.map(np.asarray, variables))


def _jax_steps(s, n):
    """The JAX step over the first ``n`` batches: for each step i, (losses
    of steps 1..i, state dict after step i, step i's metrics)."""
    featurizer = featurizer_jax(
        FeatJax(fbank=FbankJax(**FBANK), max_samples=MAX_SAMPLES, lctx=1, rctx=1),
        jnp.asarray(s["offset"]), jnp.asarray(s["scale"]))
    tx = lr_jax.make_optimizer("sgd", **OPTIM)
    v = s["variables"]
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       opt_state=tx.init(v["params"]), batch_stats=v["batch_stats"])
    step = train_step_jax(s["model"], tx, featurizer, loss_chunk=8, loss_backend="xla",
                          donate=False)
    losses, out = [], []
    for i in range(n):
        batch = {k: jnp.asarray(x) for k, x in s["batches"][i].items()}
        state, metrics = step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
        sd = convert.state_dict_from_flax(jax.tree.map(
            np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
        out.append((list(losses), sd, metrics))
    return out


@pytest.fixture(scope="module")
def jax_steps():
    """``_jax_steps``'s result after n steps, shared by the tests of this
    module: the 3 steps run once per attention precision (``f32``)."""
    runs = {}

    def get(s, n, f32):
        if f32 not in runs:
            runs[f32] = _jax_steps(s, 3)
        return runs[f32][n - 1]

    return get


def _port_steps(s, n, backend="auto"):
    model = init_transducer(TransducerConfig(**MODEL), torch.Generator().manual_seed(0),
                            device="cpu")
    convert.load_flax_variables(model, s["variables"])
    featurizer = make_featurizer(
        FeaturizerConfig(fbank=FbankConfig(**FBANK), max_samples=MAX_SAMPLES, lctx=1, rctx=1),
        torch.from_numpy(s["offset"]), torch.from_numpy(s["scale"]), device="cpu")
    step = make_train_step(model, make_optimizer(model.parameters(), "sgd", **OPTIM),
                           featurizer, loss_chunk=8, loss_backend=backend)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for i in range(n):
        out = step({k: torch.from_numpy(x) for k, x in s["batches"][i].items()}, gen)
        losses.append(out["loss"].item())
    assert not model.training  # the step restores eval mode
    return losses, model, out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax_f32_attention(step_inputs, f32_attention, jax_steps, n_steps):
    """n steps from identical weights with attention in float32 on both
    sides and the RNG off: the algorithm itself.  Losses to 1e-5 relative;
    every parameter's change and BatchNorm statistic to 2e-3 relative L2
    (measured: at most 4e-4, float32 sums in another order)."""
    s = step_inputs
    ref_losses, ref_sd, ref_metrics = jax_steps(s, n_steps, True)
    losses, model, out = _port_steps(s, n_steps)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert int(out["num_labels"]) == int(ref_metrics["num_labels"])
    assert int(out["num_frames"]) == int(ref_metrics["num_frames"])
    _check_state(model, ref_sd, convert.state_dict_from_flax(s["variables"]),
                 lambda name: 2e-3, 2e-3)


def _bf16_update_tol(name):
    """The encoder's parameters take gradients through the bf16-rounded
    attention (measured: up to 5e-2 relative L2 over 3 steps); the
    prediction net and the joint see the encoder only through the loss."""
    return 1e-1 if name.startswith("encoder.") else 1e-2


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(step_inputs, jax_steps, n_steps):
    """n steps from identical weights in the real configuration (bf16
    attention), RNG off (dither 0, SpecAugment off, dropout 0): losses to
    1e-3 relative, parameter changes and BatchNorm statistics to the bf16
    tolerances above, the metrics equal."""
    s = step_inputs
    ref_losses, ref_sd, ref_metrics = jax_steps(s, n_steps, False)
    losses, model, out = _port_steps(s, n_steps)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-3)
    assert int(out["num_labels"]) == int(ref_metrics["num_labels"])
    assert int(out["num_frames"]) == int(ref_metrics["num_frames"])
    _check_state(model, ref_sd, convert.state_dict_from_flax(s["variables"]),
                 _bf16_update_tol, 1e-2)


def test_train_step_plain_backend_matches_auto(step_inputs):
    """On CPU both backends take plain versions, by different code paths
    (the K2/K3 wrapper and the chunked vjp): identical losses, parameters
    to float32 summation order."""
    s = step_inputs
    la, ma, _ = _port_steps(s, 2, "auto")
    lp, mp, _ = _port_steps(s, 2, "plain")
    np.testing.assert_allclose(la, lp, rtol=1e-6)
    for (name, a), b in zip(ma.state_dict().items(), mp.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)


def test_train_step_randomness_is_seeded(step_inputs):
    """Dither, SpecAugment and dropout on: the same generator seed gives the
    same step, another seed another; the loss is finite."""
    s = step_inputs
    cfg = TransducerConfig(**dict(MODEL, tdnn_transformer_dropout=0.2))
    featurizer = make_featurizer(
        FeaturizerConfig(fbank=FbankConfig(**dict(FBANK, dither=1.0)), max_samples=MAX_SAMPLES,
                         lctx=1, rctx=1, spec_augment=True),
        torch.from_numpy(s["offset"]), torch.from_numpy(s["scale"]), device="cpu")
    batch = {k: torch.from_numpy(x) for k, x in s["batches"][0].items()}
    results = []
    for seed in (5, 5, 6):
        model = init_transducer(cfg, torch.Generator().manual_seed(0), device="cpu")
        step = make_train_step(model, make_optimizer(model.parameters(), "sgd", **OPTIM),
                               featurizer, loss_chunk=8)
        loss = step(batch, torch.Generator().manual_seed(seed))["loss"]
        assert torch.isfinite(loss)
        results.append((loss.item(), model.fc2.weight.detach().clone()))
    assert results[0][0] == results[1][0] and torch.equal(results[0][1], results[1][1])
    assert results[0][0] != results[2][0]


def test_unported_train_options_raise(step_inputs):
    """LSTM dropout, the cheap attention dropout and remat, once raising in
    train mode, now run there: eval mode is unchanged by them, train mode
    draws from the generator (tests/test_torch_train_options.py holds them
    to the JAX package); the pruned loss's heads, once raising, build."""
    x = torch.randn(2, 64, 3 * MEL, generator=torch.Generator().manual_seed(1))
    y = torch.randint(1, 20, (2, 5), generator=torch.Generator().manual_seed(2))
    base = init_transducer(TransducerConfig(**MODEL), torch.Generator().manual_seed(0),
                           device="cpu")
    with torch.no_grad():
        ref = base.encode(x), base.predict(y)
    for kw in (dict(dropout=0.1, dec_layers=2), dict(attn_cheap_dropout=True,
                                                     tdnn_transformer_dropout=0.2),
               dict(remat=True)):
        model = init_transducer(TransducerConfig(**dict(MODEL, **kw)),
                                torch.Generator().manual_seed(0), device="cpu")
        with torch.no_grad():
            assert torch.equal(model.encode(x), ref[0]) and torch.equal(model.predict(y), ref[1])
            model.train()
            gen = torch.Generator().manual_seed(3)
            enc, dec = model.encode(x, generator=gen), model.predict(y, generator=gen)
        assert torch.isfinite(enc).all() and torch.isfinite(dec).all()
    # the pruned loss's heads build too, and leave encode and predict as they were
    model = init_transducer(TransducerConfig(**dict(MODEL, simple_joint=True)),
                            torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        assert torch.equal(model.encode(x), ref[0]) and torch.equal(model.predict(y), ref[1])
