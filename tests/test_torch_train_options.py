"""The model and step options the training recipe turns on, in the port
against the JAX package on the CPU: the prediction net's LSTM dropout
(placement and statistics), the head-shared cheap attention dropout
(unbiased, one mask across heads), the query-chunked attention (against
the full path and the JAX chunked layer, forward and gradients to 1e-5),
``remat`` (gradients bit for bit with and without it, dropout on), the
bf16-compute train step against the JAX bf16 step (loss to 1e-2 relative,
the parameter updates' cosine above 0.98, float32 masters), the encoder's
``context``, the optimizer's state dict and the checkpoint files."""

import inspect
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pika_tpu.models.transformer as transformer_jax
from pika_tpu.features.fbank import FbankConfig as FbankJax
from pika_tpu.models.lstm import LSTM as LSTMJax
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
import pika_tpu_torch.models.lstm as lstm_pt
import pika_tpu_torch.models.transformer as transformer_pt
from pika_tpu_torch import convert
from pika_tpu_torch.features.fbank import FbankConfig
from pika_tpu_torch.models.lstm import LSTM
from pika_tpu_torch.models.tdnn_transformer import TDNNTransformerEncoder
from pika_tpu_torch.models.transducer import Transducer, TransducerConfig, init_transducer
from pika_tpu_torch.models.transformer import (
    MultiHeadedAttention,
    TransformerEncoderLayer,
    head_shared_dropout,
)
from pika_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from pika_tpu_torch.train.lr import make_optimizer
from pika_tpu_torch.train.step import FeaturizerConfig, make_featurizer, make_train_step

torch.set_num_threads(1)


def _init_jax(seed, cfg):
    """``init_transducer`` under jit (eager init takes seconds here)."""
    variables = jax.jit(lambda key: init_jax(key, cfg, max_t=64)[1])(jax.random.PRNGKey(seed))
    return TransducerJax(cfg), variables


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.fixture
def f32_attention(monkeypatch):
    """Attention in float32 in both packages (the JAX layer's ``mm_dtype``
    default set to None, the port's bf16 rounding made the identity)."""
    init = transformer_jax.MultiHeadedAttention.__init__.__wrapped__
    names = [n for n in inspect.signature(init).parameters if n != "self"]
    defaults = list(init.__defaults__)
    defaults[names.index("mm_dtype") - (len(names) - len(defaults))] = None
    monkeypatch.setattr(init, "__defaults__", tuple(defaults))
    monkeypatch.setattr(transformer_pt, "_bf16", lambda x: x)


# ---------------------------------------------------------------------------
# LSTM dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [1, 3])
def test_lstm_dropout_placement_matches_jax(rng, monkeypatch, layers):
    """Eval mode is the JAX LSTM's deterministic pass; in train mode dropout
    acts between layers and never after the last one: a 1-layer LSTM in
    train mode is the JAX LSTM's train pass (which drops nothing either),
    and the layers' masks are the recorded dropout calls, applied to
    layer outputs 0..L-2 only."""
    x = rng.standard_normal((2, 7, 5)).astype(np.float32)
    m = LSTMJax(6, num_layers=layers, dropout_rate=0.4)
    v = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    ref_eval, _ = m.apply(v, jnp.asarray(x), deterministic=True)
    pt = convert.load_flax_variables(LSTM(5, 6, layers, dropout=0.4), v)
    got_eval, _ = pt.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got_eval.detach().numpy(), np.asarray(ref_eval), rtol=1e-5,
                               atol=1e-6)
    calls = []
    original = lstm_pt._dropout

    def record(y, rate, generator):
        out = original(y, rate, generator)
        calls.append((y, out))
        return out

    monkeypatch.setattr(lstm_pt, "_dropout", record)
    got_train, (h, _) = pt.train()(torch.from_numpy(x), torch.Generator().manual_seed(3))
    assert len(calls) == layers - 1
    if layers == 1:
        ref_train, _ = m.apply(v, jnp.asarray(x), deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(4)})
        np.testing.assert_allclose(got_train.detach().numpy(), np.asarray(ref_train),
                                   rtol=1e-5, atol=1e-6)
    else:
        # the top layer's output is not dropped: it is the last hidden state
        assert torch.equal(got_train[:, -1], h[-1])
        for y, out in calls:
            kept = out != 0
            assert torch.allclose(out[kept], y[kept] / 0.6)
            assert 0.2 < float((~kept).float().mean()) < 0.6


def test_lstm_dropout_statistics():
    """Unbiased and at its rate: over many draws the dropped fraction of
    the inter-layer activations is the rate and their mean is preserved."""
    pt = LSTM(4, 32, 2, dropout=0.3)
    torch.nn.init.uniform_(pt.weight_ih_l0, -0.3, 0.3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in (pt.weight_hh_l0, pt.bias_l0, pt.weight_ih_l1, pt.weight_hh_l1, pt.bias_l1):
            p.normal_(0, 0.3, generator=torch.Generator().manual_seed(p.numel()))
    x = torch.randn(64, 20, 4, generator=torch.Generator().manual_seed(1))
    seen = []
    original = lstm_pt._dropout
    lstm_pt._dropout = lambda y, r, g: seen.append((y, original(y, r, g))) or seen[-1][1]
    try:
        with torch.no_grad():
            pt.train()(x, torch.Generator().manual_seed(2))
    finally:
        lstm_pt._dropout = original
    (y, out), = seen
    n = y.numel()
    dropped = float((out == 0).float().mean())
    assert abs(dropped - 0.3) < 5 * np.sqrt(0.3 * 0.7 / n)
    assert abs(float(out.mean() - y.mean())) < 5 * float(y.abs().mean()) * np.sqrt(0.3 / 0.7 / n)


# ---------------------------------------------------------------------------
# cheap (head-shared) attention dropout
# ---------------------------------------------------------------------------

def test_head_shared_mask_statistics():
    """One mask for every head, dropped at the rate, kept values divided by
    keep in the probabilities' dtype (bf16); the same seed draws the same
    mask."""
    attn = torch.rand(3, 4, 50, 60, generator=torch.Generator().manual_seed(0)).bfloat16()
    out = head_shared_dropout(attn, 0.2, torch.Generator().manual_seed(1))
    assert out.dtype == torch.bfloat16
    zero = out == 0
    assert torch.equal(zero, zero[:, :1].expand_as(zero))  # shared across heads
    n = zero[:, 0].numel()
    assert abs(float(zero[:, 0].float().mean()) - 0.2) < 5 * np.sqrt(0.16 / n)
    assert torch.equal(out[~zero], (attn / 0.8)[~zero])
    assert torch.equal(out, head_shared_dropout(attn, 0.2, torch.Generator().manual_seed(1)))


def test_cheap_dropout_unbiased_like_jax():
    """The JAX layer's expectation check, on both packages from the same
    weights: over many draws the mean output of the layer with the cheap
    mask approaches its deterministic output (the final linear is affine,
    so unbiased probabilities give an unbiased output); the deterministic
    outputs agree."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 8, 16)).astype(np.float32)
    m = transformer_jax.MultiHeadedAttention(4, 16, 0.3, cheap_dropout=True)
    v = jax.tree.map(np.asarray, m.init({"params": jax.random.PRNGKey(1),
                                         "dropout": jax.random.PRNGKey(2)}, x, x, x))
    ref = np.asarray(m.apply(v, x, x, x, deterministic=True))
    train = jax.jit(lambda key: m.apply(v, x, x, x, deterministic=False, rngs={"dropout": key}))
    jax_mean = np.mean([np.asarray(train(jax.random.PRNGKey(100 + i))) for i in range(300)],
                       axis=0)
    pt = convert.load_flax_variables(MultiHeadedAttention(4, 16, 0.3, cheap_dropout=True), v)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        det = pt.eval()(xt, xt, xt).numpy()
        g = torch.Generator().manual_seed(5)
        pt_mean = np.mean([pt.train()(xt, xt, xt, generator=g).numpy() for _ in range(300)],
                          axis=0)
    np.testing.assert_allclose(det, ref, rtol=1e-3, atol=1e-3)
    for mean in (jax_mean, pt_mean):
        np.testing.assert_allclose(mean, ref, atol=0.15)


# ---------------------------------------------------------------------------
# chunked attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 7, 16])
def test_chunked_attention_matches_full_and_jax(rng, f32_attention, chunk):
    """An encoder layer over T = 23 frames with query blocks of ``chunk``
    rows (ragged last block): forward and every gradient against the full
    path of the port and the JAX chunked layer, to 1e-5 relative (absolute
    1e-5 of the largest gradient: the key bias's gradient is 0 but for
    float noise)."""
    x = rng.standard_normal((2, 23, 16)).astype(np.float32)
    cot = rng.standard_normal((2, 23, 16)).astype(np.float32)
    layer = transformer_jax.TransformerEncoderLayer(16, 4, 32, 0.0, attn_q_chunk=chunk)
    v = jax.tree.map(np.asarray, layer.init(jax.random.PRNGKey(3), jnp.asarray(x)))

    def f(params, xx):
        return jnp.sum(layer.apply({"params": params}, xx) * cot)

    ref_out = jax.jit(layer.apply)(v, jnp.asarray(x))
    ref_gp, ref_gx = jax.jit(jax.grad(f, argnums=(0, 1)))(v["params"], jnp.asarray(x))
    ref_sd = convert.state_dict_from_flax({"params": jax.tree.map(np.asarray, ref_gp)})
    atol = 1e-5 * max(float(np.abs(g.numpy()).max()) for g in ref_sd.values())
    results = []
    for q_chunk in (chunk, 0):
        pt = convert.load_flax_variables(TransformerEncoderLayer(16, 4, 32, 0.0,
                                                                 attn_q_chunk=q_chunk), v)
        xt = torch.from_numpy(x).requires_grad_()
        out = pt.train()(xt)
        (out * torch.from_numpy(cot)).sum().backward()
        results.append((out.detach(), xt.grad, {n: p.grad for n, p in pt.named_parameters()}))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_gx), rtol=1e-5, atol=1e-5)
        for n, p in pt.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), ref_sd[n].numpy(), rtol=1e-5, atol=atol,
                                       err_msg=n)
    (oc, gc, pc), (of, gf, pf) = results
    torch.testing.assert_close(oc, of, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gc, gf, rtol=1e-5, atol=1e-6)
    for n in pc:
        torch.testing.assert_close(pc[n], pf[n], rtol=1e-5, atol=atol, msg=n)


def test_chunked_attention_bf16_matches_full(rng):
    """With the bf16 rounding of q, k, v and the probabilities (the real
    configuration) the chunked core is the full core's function."""
    x = torch.from_numpy(rng.standard_normal((2, 30, 32)).astype(np.float32))
    full = MultiHeadedAttention(4, 32)
    chunked = MultiHeadedAttention(4, 32, q_chunk=8)
    chunked.load_state_dict(full.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(chunked(x, x, x), full(x, x, x), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _encoder_grads(remat, chunk, cheap, x, cot, sd):
    enc = TDNNTransformerEncoder(12, 8, 32, 5, transformer_dropout=0.3, attn_chunk=chunk,
                                 attn_cheap_dropout=cheap, remat=remat)
    enc.load_state_dict(sd)
    g = torch.Generator().manual_seed(9)
    xt = x.clone().requires_grad_()
    out = enc.train()(xt, generator=g)
    (out * cot).sum().backward()
    after = torch.rand(4, generator=g)  # where later draws start
    return out.detach(), xt.grad, [p.grad for p in enc.parameters()], enc.state_dict(), after


@pytest.mark.parametrize("chunk,cheap", [(0, False), (0, True), (6, False)])
def test_remat_gradients_bit_for_bit(chunk, cheap):
    """The encoder with dropout on (transformer rate 0.3; per-element,
    head-shared or chunked masks) from one generator seed: output, input
    and parameter gradients, BatchNorm statistics and the generator's later
    draws identical with and without remat."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 40, 12, generator=gen)
    base = TDNNTransformerEncoder(12, 8, 32, 5, transformer_dropout=0.3)
    with torch.no_grad():
        for p in base.parameters():
            p.normal_(0, 0.3, generator=gen)
    sd = base.state_dict()
    cot = torch.randn(base(x).shape, generator=gen)
    ref = _encoder_grads(False, chunk, cheap, x, cot, sd)
    got = _encoder_grads(True, chunk, cheap, x, cot, sd)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert all(torch.equal(a, b) for a, b in zip(got[2], ref[2]))
    assert all(torch.equal(a, ref[3][k]) for k, a in got[3].items())
    assert torch.equal(got[4], ref[4])
    # dropout was live: another seed gives another output
    enc = TDNNTransformerEncoder(12, 8, 32, 5, transformer_dropout=0.3, remat=True)
    enc.load_state_dict(sd)
    assert not torch.equal(enc.train()(x, generator=torch.Generator().manual_seed(10)), ref[0])


def test_context_matches_jax():
    for layers in (5, 9, 12):
        enc = TDNNJax(output_dim=8, tdnn_layers=layers)
        assert TDNNTransformerEncoder(4, 8, 16, layers).context == enc.context
    assert TDNNTransformerEncoder(4, 8, 16, 9).context == 42  # --model_lctx 21 --model_rctx 21


# ---------------------------------------------------------------------------
# bf16 compute
# ---------------------------------------------------------------------------

MEL = 23
MODEL = dict(input_dim=3 * MEL, vocab_size=20, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="rnn", dec_layers=2, embd_dim=8, tdnn_nhid=32, tdnn_layers=5,
             tdnn_transformer_dropout=0.0)
FBANK = dict(sample_frequency=16000, window_type="hamming", dither=0.0, num_mel_bins=MEL)
OPTIM = dict(initial_lr=0.003, final_lr=0.0001, total_batches=1000, momentum=0.9, grad_clip=3.0)


@pytest.fixture(scope="module")
def bf16_inputs():
    rng = np.random.default_rng(12)
    wav_lens = np.array([16000, 12000, 9000, 6000], np.int32)
    wavs = np.zeros((4, 16000), np.float32)
    for i, n in enumerate(wav_lens):
        wavs[i, :n] = np.round(rng.standard_normal(n) * 3000)
    batch = dict(wavs=wavs, wav_lens=wav_lens, labels=rng.integers(1, 20, (4, 5)).astype(np.int32),
                 label_lens=np.array([5, 3, 4, 2], np.int32))
    plain = make_featurizer(FeaturizerConfig(fbank=FbankConfig(**FBANK), max_samples=16000,
                                             lctx=1, rctx=1), device="cpu")
    feats, lens = plain(torch.from_numpy(wavs), torch.from_numpy(wav_lens))
    valid = torch.cat([f[:n] for f, n in zip(feats, lens.tolist())]).numpy()
    offset = -valid.mean(0).astype(np.float32)
    scale = (1.0 / valid.std(0)).astype(np.float32)
    model, variables = _init_jax(4, ConfigJax(**MODEL))
    return dict(batch=batch, offset=offset, scale=scale, model=model,
                variables=jax.tree.map(np.asarray, variables))


def test_bf16_step_matches_jax(bf16_inputs):
    """One step at compute_dtype bf16 in both packages from the same
    weights (RNG off): the loss to 1e-2 relative, the cosine of the
    parameter updates above 0.98, the master parameters, their gradients'
    targets and the BatchNorm statistics float32; the float32 step is
    another function (the bf16 one is not a no-op)."""
    s = bf16_inputs
    featurizer = featurizer_jax(
        FeatJax(fbank=FbankJax(**FBANK), max_samples=16000, lctx=1, rctx=1),
        jnp.asarray(s["offset"]), jnp.asarray(s["scale"]))
    tx = lr_jax.make_optimizer("sgd", **OPTIM)
    v = s["variables"]
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       opt_state=tx.init(v["params"]), batch_stats=v["batch_stats"])
    step = train_step_jax(s["model"], tx, featurizer, loss_chunk=8, loss_backend="xla",
                          compute_dtype=jnp.bfloat16, donate=False)
    state, metrics = step(state, {k: jnp.asarray(x) for k, x in s["batch"].items()},
                          jax.random.PRNGKey(0))
    ref_sd = convert.state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    init_sd = convert.state_dict_from_flax(v)

    losses = {}
    for dtype in (torch.bfloat16, None):
        model = init_transducer(TransducerConfig(**MODEL), torch.Generator().manual_seed(0),
                                device="cpu")
        convert.load_flax_variables(model, v)
        pt_featurizer = make_featurizer(
            FeaturizerConfig(fbank=FbankConfig(**FBANK), max_samples=16000, lctx=1, rctx=1),
            torch.from_numpy(s["offset"]), torch.from_numpy(s["scale"]), device="cpu")
        pt_step = make_train_step(model, make_optimizer(model.parameters(), "sgd", **OPTIM),
                                  pt_featurizer, loss_chunk=8, compute_dtype=dtype)
        out = pt_step({k: torch.from_numpy(x) for k, x in s["batch"].items()},
                      torch.Generator().manual_seed(0))
        losses[dtype] = float(out["loss"])
        if dtype is not None:
            sd = model.state_dict()
            assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                       for p in model.parameters())
            assert all(b.dtype == torch.float32 for n, b in sd.items()
                       if not n.endswith("num_batches_tracked"))
            names = [n for n, _ in model.named_parameters()]
            got = np.concatenate([(sd[n] - init_sd[n]).numpy().ravel() for n in names])
            ref = np.concatenate([(ref_sd[n] - init_sd[n]).numpy().ravel() for n in names])
            cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
            assert cos > 0.98, cos
            for n in sd:
                if n.endswith("running_var"):
                    np.testing.assert_allclose(sd[n].numpy(), ref_sd[n].numpy(), rtol=2e-2)
    ref_loss = float(metrics["loss"])
    assert abs(losses[torch.bfloat16] - ref_loss) <= 1e-2 * abs(ref_loss)
    assert losses[torch.bfloat16] != losses[None]
    assert abs(losses[None] - ref_loss) <= 1e-2 * abs(ref_loss)


def test_bf16_step_with_remat_and_chunk_runs(bf16_inputs):
    """bf16 compute with remat, chunked attention, LSTM and cheap dropout:
    the recomputation sees the bf16 casts (the step's backward runs inside
    the cast), the loss is finite and the parameters stay float32."""
    s = bf16_inputs
    cfg = TransducerConfig(**dict(MODEL, remat=True, attn_chunk=16, dropout=0.3,
                                  tdnn_transformer_dropout=0.2, attn_cheap_dropout=True))
    model = init_transducer(cfg, torch.Generator().manual_seed(0), device="cpu")
    featurizer = make_featurizer(
        FeaturizerConfig(fbank=FbankConfig(**FBANK), max_samples=16000, lctx=1, rctx=1),
        torch.from_numpy(s["offset"]), torch.from_numpy(s["scale"]), device="cpu")
    step = make_train_step(model, make_optimizer(model.parameters(), "sgd", **OPTIM), featurizer,
                           loss_chunk=8, compute_dtype=torch.bfloat16)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = step({k: torch.from_numpy(x) for k, x in s["batch"].items()},
               torch.Generator().manual_seed(1))
    assert torch.isfinite(out["loss"]) and out["loss"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert sum(not torch.equal(p, before[n]) for n, p in model.named_parameters()) > 30


def test_simple_joint_still_raises():
    """``simple_joint`` (the pruned loss's heads) no longer raises: it builds
    the two heads, and ``simple_factors`` gives (B, T, V) and (B, U+1, V)."""
    model = Transducer(TransducerConfig(**dict(MODEL, simple_joint=True)))
    enc, dec = torch.zeros(2, 7, MODEL["hid_dim"]), torch.zeros(2, 4, MODEL["hid_dim"])
    am, lm = model.simple_factors(enc, dec)
    assert am.shape == (2, 7, MODEL["vocab_size"]) and lm.shape == (2, 4, MODEL["vocab_size"])


# ---------------------------------------------------------------------------
# optimizer state, checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optim", ["sgd", "adam"])
def test_optimizer_state_dict_continues_bit_for_bit(optim):
    """Two updates, a state dict, a fresh optimizer restored from it: the
    next two updates (schedule step and momentum or moments) equal the
    uninterrupted optimizer's, bit for bit."""
    gen = torch.Generator().manual_seed(3)
    init = [torch.randn(4, 3, generator=gen), torch.randn(3, generator=gen)]
    grads = [[torch.randn(x.shape, generator=gen) for x in init] for _ in range(4)]
    kw = dict(initial_lr=0.1, final_lr=0.01, total_batches=4, momentum=0.9, grad_clip=0.5)

    def run(params, opt, gs):
        for g in gs:
            for p, x in zip(params, g):
                p.grad = x.clone()
            opt.step()

    ref = [torch.nn.Parameter(x.clone()) for x in init]
    ref_opt = make_optimizer(ref, optim, **kw)
    run(ref, ref_opt, grads)
    first = [torch.nn.Parameter(x.clone()) for x in init]
    opt = make_optimizer(first, optim, **kw)
    run(first, opt, grads[:2])
    state = opt.state_dict()
    assert state["count"] == 2
    second = [torch.nn.Parameter(x.detach().clone()) for x in first]
    opt2 = make_optimizer(second, optim, **kw)
    opt2.load_state_dict(state)
    assert opt2.count == 2
    run(second, opt2, grads[2:])
    assert opt2.count == ref_opt.count == 4
    assert all(torch.equal(a, b) for a, b in zip(second, ref))


def test_checkpoint_round_trip(tmp_path):
    """The newest step when none is named, the file replaced atomically,
    FileNotFoundError without a checkpoint."""
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"))
    for step in (0, 3, 1):
        save_checkpoint(str(tmp_path / "ckpt"), step, {"w": torch.full((2,), float(step))},
                        {"count": step}, {"epoch": step})
    newest = restore_checkpoint(str(tmp_path / "ckpt"))
    assert newest["metadata"] == {"epoch": 3} and newest["optimizer"] == {"count": 3}
    assert torch.equal(newest["model"]["w"], torch.full((2,), 3.0))
    assert restore_checkpoint(str(tmp_path / "ckpt"), 1)["metadata"] == {"epoch": 1}
    assert sorted(os.listdir(tmp_path / "ckpt" / "3")) == ["state.pt"]
