"""K4, the port's flash-attention path (``attn_flash``), against the JAX
package's own ``_flash`` path on the CPU, on the same numpy inputs.

The JAX side takes its flash path only on a TPU backend and runs the
library's Pallas TPU kernels.  Here both are arranged with pytest's
monkeypatch, scoped to two module globals: ``pika_tpu.models.transformer``
sees a proxy of ``jax`` whose ``default_backend()`` says "tpu", and the
library module ``jax.experimental.pallas.ops.tpu.flash_attention`` sees a
proxy of ``pl`` whose ``pallas_call`` runs in interpret mode.  The shared
``jax.default_backend`` and ``pallas_call`` themselves stay untouched, so the
RNN-T loss keeps its XLA path.  The port's side runs K4's plain version
(CPU tensors); the kernels themselves run only on the card
(tests/test_torch_gpu.py).

Tolerances: both sides round p to bf16, but at other points -- the library
kernel relative to the running max of its key blocks (and, when T fits one
block, after normalizing), the plain version relative to the row max before
normalizing -- so outputs and gradients agree to bf16 rounding: 1e-2
relative L2 and 1e-2 of the largest entry (measured: at most 3.5e-3 and
5.3e-3).  Modules downstream of the attention: as tests/test_torch_models.py
and tests/test_torch_train.py state for the bf16 attention."""

import functools

import numpy as np
import jax
import jax.experimental.pallas.ops.tpu.flash_attention as flash_lib
import jax.numpy as jnp
import pytest
import torch

import pika_tpu.models.transformer as transformer_jax
import pika_tpu_torch.models.transformer as transformer_pt
from pika_tpu.features.fbank import FbankConfig as FbankJax
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
from pika_tpu_torch.features.fbank import FbankConfig, make_fbank_fn
from pika_tpu_torch.models.tdnn_transformer import TDNNTransformerEncoder as TDNNPt
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_reference,
    FlashAttention,
    pad_head,
)
from pika_tpu_torch.train.lr import make_optimizer
from pika_tpu_torch.train.step import FeaturizerConfig, make_featurizer, make_train_step

torch.set_num_threads(1)

K4_REL_L2 = K4_MAX_REL = 1e-2


class _Proxy:
    """A module's attributes, with some replaced."""

    def __init__(self, module, **replaced):
        self._module = module
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _init_jax_jit(key, cfg):
    """``init_transducer`` under jit (eager init takes seconds here)."""
    return TransducerJax(cfg), jax.jit(lambda k: init_jax(k, cfg, max_t=64)[1])(key)


@pytest.fixture
def jax_flash(monkeypatch):
    """Route the JAX layer onto its flash path, the library kernels in
    interpret mode; returns a dict counting the layer's traces that take the
    flash path (the backend is asked last, once every other condition
    holds)."""
    calls = {"flash": 0}

    def tpu():
        calls["flash"] += 1
        return "tpu"

    monkeypatch.setattr(transformer_jax, "jax", _Proxy(jax, default_backend=tpu))
    monkeypatch.setattr(flash_lib, "pl", _Proxy(
        flash_lib.pl, pallas_call=functools.partial(flash_lib.pl.pallas_call, interpret=True)))
    return calls


@pytest.fixture
def port_flash(monkeypatch):
    """Count the port layer's calls of K4."""
    calls = {"k4": 0}

    def counted(q, k, v):
        calls["k4"] += 1
        return flash_attention(q, k, v)

    monkeypatch.setattr(transformer_pt, "flash_attention", counted)
    return calls


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _assert_k4_close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert _rel_l2(got, ref) < K4_REL_L2, (what, _rel_l2(got, ref))
    assert np.abs(got - ref).max() <= K4_MAX_REL * np.abs(ref).max(), what


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _bf16_inputs(rng, b, h, t, d):
    """q (scaled as the layer scales it), k, v and an output cotangent, as
    bf16-representable float32 arrays."""
    q, k, v, do = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(4))
    q *= 1.5 / np.sqrt(d)
    return [_np(jnp.asarray(x, jnp.bfloat16)) for x in (q, k, v, do)]


# ---------------------------------------------------------------------------
# the plain K4 against the library kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("t", [37, 130])
def test_plain_k4_matches_pallas_flash(jax_flash, rng, t, d):
    """Forward and the three gradients of ``flash_attention`` (its plain
    version on CPU tensors) against ``_flash`` through the library's Pallas
    kernels: T = 37 pads to one 128 block, T = 130 to two."""
    b, h = 2, 2
    q, k, v, do = _bf16_inputs(rng, b, h, t, d)
    mha = transformer_jax.MultiHeadedAttention(h, h * d)
    ref_o, vjp = jax.vjp(lambda *x: mha._flash(*x, b, t, d, jnp.bfloat16),
                         *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do, jnp.bfloat16))

    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    o = flash_attention(*leaves)
    o.backward(torch.from_numpy(do).to(torch.bfloat16))
    assert o.dtype == torch.bfloat16 and all(x.grad.dtype == torch.bfloat16 for x in leaves)
    for name, got, ref in zip(("o", "dq", "dk", "dv"), [o.detach()] + [x.grad for x in leaves],
                              [ref_o, *ref_grads]):
        _assert_k4_close(got.float().numpy(), _np(ref), name)


def test_k4_wrappers_on_cpu_are_the_plain_versions(rng):
    """On CPU tensors every wrapper returns its plain version, launches
    nothing, and the plain forward's lse is the scores' logsumexp."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _bf16_inputs(rng, 1, 2, 19, 8))
    launches = (flash_attention_fwd.launches, flash_attention_bwd_dkv.launches,
                flash_attention_bwd_dq.launches)
    o, lse = flash_attention_reference(q, k, v)
    got_o, got_lse = flash_attention_fwd(q, k, v)
    assert torch.equal(got_o, o) and torch.equal(got_lse, lse)
    torch.testing.assert_close(lse, torch.logsumexp(q.float() @ k.float().transpose(-1, -2), -1))
    ref = flash_attention_bwd_reference(q, k, v, o, lse, do)
    for got, r in zip(flash_attention_bwd(q, k, v, o, lse, do), ref):
        assert torch.equal(got, r)
    dk, dv = flash_attention_bwd_dkv(q, k, v, o, lse, do)
    assert torch.equal(dk, ref[1]) and torch.equal(dv, ref[2])
    assert torch.equal(flash_attention_bwd_dq(q, k, v, o, lse, do), ref[0])
    assert launches == (flash_attention_fwd.launches, flash_attention_bwd_dkv.launches,
                        flash_attention_bwd_dq.launches)
    with torch.inference_mode():  # the eval step's mode: forward only
        assert torch.equal(flash_attention(q, k, v), o)


@pytest.mark.parametrize("d", [136, 200, 256])
def test_k4_padded_to_256_matches_jax_layer(port_flash, monkeypatch, rng, d):
    """Head widths in (128, 256]: the port's flash layer through
    ``pad_head`` (the card's dispatch: zero-padded to the d = 256 kernels'
    width, here their plain version) against the JAX layer's exact path on
    the same weights, to K4's tolerance; and the padded K4's gradients
    against the unpadded plain K4's."""
    t, heads = 45, 2
    x = rng.standard_normal((2, t, heads * d)).astype(np.float32)
    layer = transformer_jax.MultiHeadedAttention(heads, heads * d)
    variables = jax.tree.map(np.asarray, layer.init(jax.random.PRNGKey(3), x, x, x))
    ref = np.asarray(layer.apply(variables, x, x, x))
    widths = []

    def padded(q, k, v):
        widths.append(q.shape[-1])
        return pad_head(FlashAttention.apply, q, k, v)

    monkeypatch.setattr(transformer_pt, "flash_attention", padded)
    pt = convert.load_flax_variables(
        transformer_pt.MultiHeadedAttention(heads, heads * d, use_flash=True).eval(), variables)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = pt(xt, xt, xt).numpy()
    assert widths == [d]
    assert _rel_l2(got, ref) < K4_REL_L2, _rel_l2(got, ref)

    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _bf16_inputs(rng, 1, 2, t, d))
    grads = []
    for fn in (lambda *a: pad_head(FlashAttention.apply, *a), FlashAttention.apply):
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        o = fn(*leaves)
        o.backward(do)
        assert o.shape == q.shape
        grads.append([o.detach()] + [a.grad for a in leaves])
    for name, got_g, ref_g in zip(("o", "dq", "dk", "dv"), *grads):
        _assert_k4_close(got_g.float().numpy(), ref_g.float().numpy(), name)


# ---------------------------------------------------------------------------
# the flash layer, the flash encoder, one flash train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [37, 130])
def test_flash_attention_layer_matches_jax(jax_flash, port_flash, rng, t):
    """``MultiHeadedAttention(use_flash=True)`` in eval mode against the JAX
    layer on its flash path (d_head 64), weights copied by convert."""
    x = rng.standard_normal((2, t, 128)).astype(np.float32)
    layer = transformer_jax.MultiHeadedAttention(2, 128, use_flash=True)
    variables = jax.tree.map(np.asarray, layer.init(jax.random.PRNGKey(1), x, x, x))
    jax_flash["flash"] = 0  # count the apply only
    ref = np.asarray(layer.apply(variables, x, x, x))
    assert jax_flash["flash"] == 1
    pt = convert.load_flax_variables(
        transformer_pt.MultiHeadedAttention(2, 128, use_flash=True).eval(), variables)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = pt(xt, xt, xt).numpy()
    assert port_flash["k4"] == 1
    assert _rel_l2(got, ref) < K4_REL_L2


def test_flash_encoder_matches_jax(jax_flash, port_flash, rng):
    """The TDNN encoder with ``attn_flash`` in eval mode, random BatchNorm
    statistics: all three transformer layers take K4 on both sides; output
    to K4's 1e-2 relative L2 (measured 2.0e-3: at these short T the library
    kernel rounds p after normalizing, the plain K4 before).  The flash
    encoder has the exact one's parameters: convert fills it."""
    x = rng.standard_normal((2, 60, 12)).astype(np.float32)
    enc = TDNNJax(output_dim=16, tdnn_nhid=32, tdnn_layers=9, attn_flash=True)
    variables = jax.tree.map(np.asarray, enc.init(jax.random.PRNGKey(2), x))
    variables["batch_stats"] = jax.tree.map(
        lambda s: s + rng.uniform(0.0, 0.3, s.shape).astype(np.float32), variables["batch_stats"])
    jax_flash["flash"] = 0  # count the apply only
    ref = np.asarray(enc.apply(variables, x))
    assert jax_flash["flash"] == 3
    pt = TDNNPt(12, 16, 32, 9, attn_flash=True).eval()
    assert set(pt.state_dict()) == set(TDNNPt(12, 16, 32, 9).state_dict())
    convert.load_flax_variables(pt, variables)
    with torch.no_grad():
        got = pt(torch.from_numpy(x)).numpy()
    assert port_flash["k4"] == 3
    assert got.shape == ref.shape
    assert _rel_l2(got, ref) < K4_REL_L2


MEL = 23
MODEL = dict(input_dim=3 * MEL, vocab_size=20, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="rnn", dec_layers=2, embd_dim=8, tdnn_nhid=32, tdnn_layers=5,
             tdnn_transformer_dropout=0.0, attn_flash=True)
FBANK = dict(sample_frequency=16000, window_type="hamming", dither=0.0, num_mel_bins=MEL)
MAX_SAMPLES = 8000
OPTIM = dict(initial_lr=0.003, final_lr=0.0001, total_batches=100000, momentum=0.9, grad_clip=3.0)


def test_flash_train_step_matches_jax(jax_flash, port_flash):
    """One train step with ``attn_flash`` and dropout 0 (where the JAX
    package takes its flash kernel forward and backward) from identical
    weights, RNG off: the loss to 1e-3 relative, parameter changes to 1e-1
    relative L2 in the encoder and 1e-2 elsewhere, BatchNorm statistics to
    1e-2 (the bf16 tolerances of tests/test_torch_train.py).  CMVN comes
    from the batch's own frames, as there.  The key bias's change is 0 but
    for noise (softmax ignores a shift of a query's scores); with ds rounded
    to bf16 before dk = ds^T q, as both kernels do, that noise reaches a few
    1e-7 on both sides, so quantities under 1e-5 are held to 1e-5
    absolute."""
    rng = np.random.default_rng(12)
    wav_lens = np.array([8000, 6000, 4000], np.int32)
    wavs = np.zeros((3, MAX_SAMPLES), np.float32)
    for i, n in enumerate(wav_lens):
        wavs[i, :n] = np.round(rng.standard_normal(n) * 3000)
    batch = dict(wavs=wavs, wav_lens=wav_lens,
                 labels=rng.integers(1, 20, (3, 4)).astype(np.int32),
                 label_lens=np.array([4, 2, 1], np.int32))
    feat_cfg = dict(max_samples=MAX_SAMPLES, lctx=1, rctx=1)
    plain = make_featurizer(FeaturizerConfig(fbank=FbankConfig(**FBANK), **feat_cfg),
                            device="cpu")
    feats, lens = plain(torch.from_numpy(wavs), torch.from_numpy(wav_lens))
    valid = torch.cat([f[:n] for f, n in zip(feats, lens.tolist())]).numpy()
    offset, scale = -valid.mean(0), 1.0 / valid.std(0)

    model_jax, variables = _init_jax_jit(jax.random.PRNGKey(4), ConfigJax(**MODEL))
    variables = jax.tree.map(np.asarray, variables)
    jax_flash["flash"] = 0  # count the step only
    tx = lr_jax.make_optimizer("sgd", **OPTIM)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       opt_state=tx.init(variables["params"]),
                       batch_stats=variables["batch_stats"])
    step_jax = train_step_jax(
        model_jax, tx, featurizer_jax(FeatJax(fbank=FbankJax(**FBANK), **feat_cfg),
                                      jnp.asarray(offset), jnp.asarray(scale)),
        loss_chunk=8, loss_backend="xla", donate=False)
    state, metrics = step_jax(state, {k: jnp.asarray(x) for k, x in batch.items()},
                              jax.random.PRNGKey(0))
    assert jax_flash["flash"] == 1
    ref_sd = convert.state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))

    model = init_transducer(TransducerConfig(**MODEL), torch.Generator().manual_seed(0),
                            device="cpu")
    convert.load_flax_variables(model, variables)
    init_sd = {n: x.clone() for n, x in model.state_dict().items()}
    featurizer = make_featurizer(FeaturizerConfig(fbank=FbankConfig(**FBANK), **feat_cfg),
                                 torch.from_numpy(offset), torch.from_numpy(scale), device="cpu")
    step = make_train_step(model, make_optimizer(model.parameters(), "sgd", **OPTIM),
                           featurizer, loss_chunk=8)
    out = step({k: torch.from_numpy(x) for k, x in batch.items()}, torch.Generator().manual_seed(0))
    assert port_flash["k4"] == 1  # the one transformer layer of 5 TDNN layers
    np.testing.assert_allclose(out["loss"].item(), float(metrics["loss"]), rtol=1e-3)
    checked = 0
    for name, x in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = x.numpy(), ref_sd[name].numpy()
        assert np.isfinite(got).all(), name
        if name.endswith(("running_mean", "running_var")):
            tol = 1e-2
        else:
            got, ref = got - init_sd[name].numpy(), ref - init_sd[name].numpy()
            tol = 1e-1 if name.startswith("encoder.") else 1e-2
        if np.abs(ref).max() < 1e-5:  # 0 but for rounding noise on both sides
            assert np.abs(got - ref).max() < 1e-5, name
            continue
        assert _rel_l2(got, ref) < tol, (name, _rel_l2(got, ref), tol)
        checked += 1
    assert checked > 50


# ---------------------------------------------------------------------------
# dispatch: where each package takes its flash path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["eval", "train_rate_0", "mask", "train_dropout", "tq_ne_tk"])
def test_flash_dispatch_matches_jax(jax_flash, port_flash, rng, case):
    """Both packages take the flash core in eval mode and in train mode at
    dropout rate 0; with a mask, with dropout on the probabilities, or with
    queries and keys of other lengths, both take the exact path, and the
    flash layer's output then equals the exact layer's."""
    t, tk = 21, (13 if case == "tq_ne_tk" else 21)
    rate = 0.0 if case == "train_rate_0" else 0.3
    x = rng.standard_normal((2, t, 128)).astype(np.float32)
    kv = rng.standard_normal((2, tk, 128)).astype(np.float32)
    mask = (rng.uniform(size=(2, t, tk)) < 0.3) if case == "mask" else None
    train = case in ("train_rate_0", "train_dropout")
    flash = case in ("eval", "train_rate_0")

    outs = []
    for use_flash in (True, False):
        layer = transformer_jax.MultiHeadedAttention(2, 128, rate, use_flash=use_flash)
        variables = layer.init(jax.random.PRNGKey(1), kv, kv, x)
        jax_flash["flash"] -= int(use_flash and tk == t)  # count the apply only
        outs.append(np.asarray(layer.apply(variables, kv, kv, x, mask=mask,
                                           deterministic=not train,
                                           rngs={"dropout": jax.random.PRNGKey(2)})))
    assert jax_flash["flash"] == int(flash)
    if not flash:
        np.testing.assert_array_equal(outs[0], outs[1])

    pt_outs = []
    for use_flash in (True, False):
        pt = convert.load_flax_variables(
            transformer_pt.MultiHeadedAttention(2, 128, rate, use_flash=use_flash),
            jax.tree.map(np.asarray, variables))
        pt.train(train)
        kvt, xt = torch.from_numpy(kv), torch.from_numpy(x)
        with torch.no_grad():
            pt_outs.append(pt(kvt, kvt, xt, None if mask is None else torch.from_numpy(mask),
                              generator=torch.Generator().manual_seed(3)).numpy())
    assert port_flash["k4"] == int(flash)
    if flash:
        assert _rel_l2(pt_outs[0], outs[0]) < K4_REL_L2
    else:
        np.testing.assert_array_equal(pt_outs[0], pt_outs[1])
        if case != "train_dropout":  # the dropout masks differ between the packages
            assert _rel_l2(pt_outs[0], outs[0]) < 1e-3


# ---------------------------------------------------------------------------
# the entry points' default device
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card(monkeypatch):
    """With no device named the entry points take the CUDA card; without a
    card they raise and never move to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransducerConfig(**MODEL)
    feat_cfg = FeaturizerConfig(fbank=FbankConfig(**FBANK), max_samples=MAX_SAMPLES)
    for build in (lambda: init_transducer(cfg, torch.Generator().manual_seed(0)),
                  lambda: make_featurizer(feat_cfg),
                  lambda: make_fbank_fn(feat_cfg.fbank, MAX_SAMPLES)):
        with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
            build()
    model = init_transducer(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    feats, _ = make_featurizer(feat_cfg, device="cpu")(torch.zeros(1, MAX_SAMPLES),
                                                       torch.tensor([MAX_SAMPLES]))
    assert feats.device.type == "cpu"
