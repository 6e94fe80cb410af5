"""The port's pruned RNN-T loss (``pika_tpu_torch/ops/rnnt_pruned.py``)
against the JAX package's (``pika_tpu/ops/rnnt_pruned.py``, jitted) on the
same numpy inputs, on the CPU:

* ``simple_channels``; ``rnnt_loss_simple``'s value and its gradients in am
  and lm;
* ``prune_ranges``: the JAX band starts on every utterance but those where
  two bands hold the same posterior mass to float32 rounding (counted and
  printed), and its four invariants on ragged lengths with infeasible rows;
* ``rnnt_loss_pruned``'s value and its six gradients at s_range 2, 3 and 5
  on the JAX band starts; against the port's numpy oracle; with the full
  band, ``rnnt_loss_fused`` (plain backend); 0 for infeasible utterances;
* two train steps with ``pruned_range=4``, the first a warm step
  (``pruned_scale=0.1``), against the JAX step.

Tolerances: float32 in another order: values 1e-5 relative (1e-6
absolute near 0); gradients, entries of order 1 that sum posterior
occupancies and cancel, 1e-5 relative and 1e-5 absolute (measured: up to
6.8e-6 absolute); the numpy oracle (float64 over a float32 lattice) 1e-5.
The train steps as ``tests/test_torch_train.py`` holds them with float32
attention: losses 1e-5, parameter changes 2e-3 relative L2."""

import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pika_tpu.models.transformer as transformer_jax
import pika_tpu.ops.rnnt_pruned as pruned_jax
from pika_tpu.features.fbank import FbankConfig as FbankJax
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
import pika_tpu_torch.models.transformer as transformer_pt
from pika_tpu_torch import convert
from pika_tpu_torch.features.fbank import FbankConfig
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.ops.rnnt_loss import rnnt_loss_fused, rnnt_occupancy
from pika_tpu_torch.ops.rnnt_pruned import (
    prune_ranges,
    rnnt_loss_pruned,
    rnnt_loss_pruned_numpy,
    rnnt_loss_simple,
    simple_channels,
)
from pika_tpu_torch.train.lr import make_optimizer
from pika_tpu_torch.train.step import FeaturizerConfig, make_featurizer, make_train_step

torch.set_num_threads(1)

B, T, U, V, H = 5, 12, 6, 9, 8
# ragged: full, shorter in both, one frame, empty labels, and a row with no
# banded path at s_range 2 (T * (s - 1) = 4 < U = 6)
T_LEN = np.array([12, 9, 1, 7, 4], np.int32)
U_LEN = np.array([6, 4, 0, 0, 6], np.int32)


def _close(got, ref, what, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=atol,
                               err_msg=what)


def _close_grad(got, ref, what):
    _close(got, ref, what, atol=1e-5)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)

    def randn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(am=randn(B, T, V, scale=2.0), lm=randn(B, U + 1, V, scale=2.0),
                ax=randn(B, T, H), gx=randn(B, T, H), ay=randn(B, U + 1, H),
                gy=randn(B, U + 1, H), w2=randn(H, V), b2=randn(V),
                labels=rng.integers(1, V, (B, U)).astype(np.int32), t_len=T_LEN, u_len=U_LEN)


def _t(case, *names):
    return [torch.from_numpy(case[n]) for n in names]


def _j(case, *names):
    return [jnp.asarray(case[n]) for n in names]


@pytest.fixture(scope="module")
def jax_ref(case):
    """The JAX functions' results on ``case``, computed once per s_range."""
    cache = {}

    def simple():
        if "simple" not in cache:
            def loss(am, lm):
                losses, ch = pruned_jax.rnnt_loss_simple(am, lm, *_j(case, "labels", "t_len",
                                                                     "u_len"))
                return losses.sum(), (losses, ch)

            (_, (losses, ch)), grads = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(*_j(case, "am", "lm"))
            cache["simple"] = jax.tree.map(np.asarray, (losses, ch, grads))
        return cache["simple"]

    def pruned(s_range):
        if s_range not in cache:
            _, (blp, elp), _ = simple()
            sb = np.asarray(jax.jit(pruned_jax.prune_ranges, static_argnums=5)(
                jnp.asarray(blp), jnp.asarray(elp), *_j(case, "labels", "t_len", "u_len"),
                s_range))

            def loss(*f):
                losses = pruned_jax.rnnt_loss_pruned(*f, *_j(case, "labels", "t_len", "u_len"),
                                                     jnp.asarray(sb), s_range, chunk=5)
                return losses.sum(), losses

            (_, losses), grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(6)),
                                                            has_aux=True))(
                *_j(case, "ax", "gx", "ay", "gy", "w2", "b2"))
            cache[s_range] = sb, np.asarray(losses), [np.asarray(g) for g in grads]
        return cache[s_range]

    return dict(simple=simple, pruned=pruned)


def test_simple_loss_and_channels_match_jax(case, jax_ref):
    losses_ref, (blp_ref, elp_ref), grads_ref = jax_ref["simple"]()
    am, lm = (x.requires_grad_() for x in _t(case, "am", "lm"))
    blp, elp = simple_channels(am, lm, torch.from_numpy(case["labels"]))
    _close(blp.detach(), blp_ref, "blank_lp")
    _close(elp.detach(), elp_ref, "emit_lp")
    losses, _ = rnnt_loss_simple(am, lm, *_t(case, "labels", "t_len", "u_len"))
    losses.sum().backward()
    _close(losses.detach(), losses_ref, "simple loss")
    _close_grad(am.grad, grads_ref[0], "d am")
    _close_grad(lm.grad, grads_ref[1], "d lm")


def _check_invariants(sb, t_len, u_len, s_range):
    """The guarantees of ``prune_ranges``' docstring: a band start of 0 at
    the first frame, monotone, at most ``max(0, u_len + 1 - s_range)``; on
    feasible utterances steps of at most ``s_range - 1`` and the last valid
    frame's band covering ``u_len``.  (On an infeasible one the end
    envelope outruns the step bound, in the JAX package too; its pruned
    loss is 0.)  Returns the number of infeasible utterances."""
    sb = np.asarray(sb)
    assert (sb[:, 0] == 0).all()
    d = np.diff(sb, axis=1)
    assert (d >= 0).all()
    assert (sb <= np.maximum(u_len + 1 - s_range, 0)[:, None]).all()
    infeasible = 0
    for i in range(len(sb)):
        if (max(t_len[i], 1) - 1) * (s_range - 1) < u_len[i] + 1 - s_range:
            infeasible += 1
            continue
        assert (d[i] <= s_range - 1).all(), (i, sb[i])
        last = sb[i, max(t_len[i], 1) - 1]
        assert last <= u_len[i] < last + s_range, (i, sb[i])
    return infeasible


@pytest.mark.parametrize("s_range", [2, 3, 5])
def test_prune_ranges_match_jax(case, jax_ref, s_range):
    """The port's band starts from the JAX channels equal the JAX ones on
    every utterance but those whose two bands hold the same posterior mass
    to float32 rounding (an argmax between windows whose sums tie to the
    last bit; counted and printed); both meet the invariants."""
    _, (blp, elp), _ = jax_ref["simple"]()
    sb_ref = jax_ref["pruned"](s_range)[0]
    sb = prune_ranges(torch.from_numpy(blp), torch.from_numpy(elp),
                      *_t(case, "t_len", "u_len"), s_range).numpy()
    _check_invariants(sb, T_LEN, U_LEN, s_range)
    _check_invariants(sb_ref, T_LEN, U_LEN, s_range)
    g_blank, g_emit = rnnt_occupancy(torch.from_numpy(blp), torch.from_numpy(elp),
                                     *_t(case, "t_len", "u_len"))
    gamma = -(g_blank + g_emit).double().numpy()
    u = np.arange(U + 1)

    def in_band(s):
        return (u >= s[..., None]) & (u < s[..., None] + s_range)

    ties = 0
    for i in range(B):
        if (sb[i] == sb_ref[i]).all():
            continue
        mass, mass_ref = ((gamma[i] * in_band(x[i])).sum() for x in (sb, sb_ref))
        assert abs(mass - mass_ref) <= 1e-5 * max(1.0, abs(mass_ref)), (i, sb[i], sb_ref[i])
        ties += 1
    print(f"prune_ranges s_range {s_range}: {ties} of {B} utterances differ by a float32 tie")
    assert ties < B


def test_prune_ranges_invariants_on_ragged_rows():
    """Random channels over many ragged rows, infeasible ones included."""
    rng = np.random.default_rng(8)
    b, t, u = 24, 10, 9
    t_len = rng.integers(1, t + 1, b).astype(np.int32)
    u_len = rng.integers(0, u + 1, b).astype(np.int32)
    blp = -rng.uniform(0.1, 4.0, (b, t, u + 1)).astype(np.float32)
    elp = -rng.uniform(0.1, 4.0, (b, t, u + 1)).astype(np.float32)
    for s_range in (2, 3, 4, 6):
        sb = prune_ranges(torch.from_numpy(blp), torch.from_numpy(elp), torch.from_numpy(t_len),
                          torch.from_numpy(u_len), s_range)
        assert sb.shape == (b, t) and sb.dtype == torch.long
        infeasible = _check_invariants(sb.numpy(), t_len, u_len, s_range)
        assert infeasible > 0 or s_range > 2


@pytest.mark.parametrize("s_range", [2, 3, 5])
def test_pruned_loss_matches_jax(case, jax_ref, s_range):
    """Value and the six gradients on the JAX band starts, T-chunks of 5
    (a short last chunk)."""
    sb, losses_ref, grads_ref = jax_ref["pruned"](s_range)
    factors = [x.requires_grad_() for x in _t(case, "ax", "gx", "ay", "gy", "w2", "b2")]
    losses = rnnt_loss_pruned(*factors, *_t(case, "labels", "t_len", "u_len"),
                              torch.from_numpy(sb), s_range, chunk=5)
    losses.sum().backward()
    _close(losses.detach(), losses_ref, "loss")
    for name, x, g in zip(("ax", "gx", "ay", "gy", "w2", "b2"), factors, grads_ref):
        _close_grad(x.grad, g, f"d {name}")
    if s_range == 2:  # the infeasible row gives 0 and no gradient
        assert losses[4].item() == 0.0 and (factors[0].grad[4] == 0).all()
    assert (losses[[0, 1, 3]] > 0).all()


def _lattice(case):
    """(B, T, U+1, V) log-probs of the gated joint, float32."""
    ax, gx, ay, gy, w2, b2 = _t(case, "ax", "gx", "ay", "gy", "w2", "b2")
    h = torch.tanh(ax[:, :, None] + ay[:, None]) * torch.sigmoid(gx[:, :, None] + gy[:, None])
    return torch.log_softmax(h @ w2 + b2, dim=-1).numpy()


@pytest.mark.parametrize("s_range", [2, 3, 5])
def test_pruned_loss_matches_numpy_oracle(case, jax_ref, s_range):
    sb = jax_ref["pruned"](s_range)[0]
    with torch.no_grad():
        got = rnnt_loss_pruned(*_t(case, "ax", "gx", "ay", "gy", "w2", "b2", "labels", "t_len",
                                   "u_len"), torch.from_numpy(sb), s_range)
    want = rnnt_loss_pruned_numpy(_lattice(case), case["labels"], T_LEN, U_LEN, sb, s_range)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_full_band_equals_fused_loss(case):
    """s_range U+1 from s_begin 0 covers the lattice: the pruned loss and
    its six gradients equal ``rnnt_loss_fused`` (plain backend) to float32
    order."""
    f1 = [x.requires_grad_() for x in _t(case, "ax", "gx", "ay", "gy", "w2", "b2")]
    f2 = [x.requires_grad_() for x in _t(case, "ax", "gx", "ay", "gy", "w2", "b2")]
    rest = _t(case, "labels", "t_len", "u_len")
    got = rnnt_loss_pruned(*f1, *rest, torch.zeros(B, T, dtype=torch.long), U + 1, chunk=4)
    ref = rnnt_loss_fused(*f2, *rest, chunk=4, backend="plain")
    got.sum().backward()
    ref.sum().backward()
    _close(got.detach(), ref.detach(), "loss")
    for a, b in zip(f1, f2):
        _close_grad(a.grad, b.grad, "gradient")


def test_infeasible_utterances_give_zero():
    """A band moves at most s_range - 1 labels a frame, so T frames hold at
    most T * (s_range - 1) labels: 6 labels in 3 frames at s_range 2, or in
    2 frames at s_range 3, give a pruned loss of exactly 0 and zero
    gradients; 3 frames at s_range 3 give a loss.  The band starts come
    from ``prune_ranges`` on random channels."""
    rng = np.random.default_rng(2)
    f = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_()
         for s in ((1, 3, H), (1, 3, H), (1, 7, H), (1, 7, H), (H, V), (V,))]
    labels = torch.from_numpy(rng.integers(1, V, (1, 6)).astype(np.int32))
    lps = [torch.from_numpy(-rng.uniform(0.1, 3.0, (1, 3, 7)).astype(np.float32))
           for _ in range(2)]
    u_len = torch.tensor([6])
    for frames, s_range, zero in ((3, 2, True), (2, 3, True), (3, 3, False)):
        t_len = torch.tensor([frames])
        sb = prune_ranges(*lps, t_len, u_len, s_range)
        loss = rnnt_loss_pruned(*f, labels, t_len, u_len, sb, s_range)
        assert (loss.item() == 0.0) == zero, (frames, s_range)
        if zero:
            grads = torch.autograd.grad(loss.sum(), f, allow_unused=True)
            assert all(g is None or (g == 0).all() for g in grads)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

MEL = 4
MODEL = dict(input_dim=3 * MEL, vocab_size=V, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="rnn", dec_layers=2, embd_dim=8, tdnn_nhid=32, tdnn_layers=5,
             tdnn_transformer_dropout=0.0, simple_joint=True)
FBANK = dict(sample_frequency=16000, window_type="hamming", dither=0.0, num_mel_bins=MEL)
MAX_SAMPLES = 16000
OPTIM = dict(initial_lr=0.003, final_lr=0.0001, total_batches=100000, momentum=0.9, grad_clip=3.0)
PRUNED = dict(pruned_range=4, simple_scale=0.5)


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


@pytest.fixture(scope="module")
def step_inputs():
    rng = np.random.default_rng(11)
    wav_lens = np.array([16000, 12000, 9000, 4000], np.int32)
    wavs = np.zeros((4, MAX_SAMPLES), np.float32)
    for i, n in enumerate(wav_lens):
        wavs[i, :n] = np.round(rng.standard_normal(n) * 3000)
    batches = [dict(wavs=wavs, wav_lens=wav_lens,
                    labels=rng.integers(1, V, (4, 5)).astype(np.int32),
                    label_lens=np.array([5, 3, 0, 2], np.int32)) for _ in range(2)]
    plain = make_featurizer(FeaturizerConfig(fbank=FbankConfig(**FBANK), max_samples=MAX_SAMPLES,
                                             lctx=1, rctx=1), device="cpu")
    feats, lens = plain(torch.from_numpy(wavs), torch.from_numpy(wav_lens))
    valid = torch.cat([f[:n] for f, n in zip(feats, lens.tolist())]).numpy()
    cfg = ConfigJax(**MODEL)
    variables = jax.jit(lambda k: init_jax(k, cfg, max_t=64)[1])(jax.random.PRNGKey(6))
    return dict(batches=batches, offset=-valid.mean(0).astype(np.float32),
                scale=(1.0 / valid.std(0)).astype(np.float32), model=TransducerJax(cfg),
                variables=jax.tree.map(np.asarray, variables))


def test_pruned_train_steps_match_jax(step_inputs, f32_attention):
    """A warm step (``pruned_scale`` 0.1) then a full one, from the same
    weights, against the JAX steps (``loss_backend="xla"``): losses to 1e-5
    relative; every parameter's change (the simple heads' included) and
    BatchNorm statistic to 2e-3 relative L2, quantities that are 0 but for
    float noise to 1e-6 absolute."""
    s = step_inputs
    v = s["variables"]
    assert "simple_am" in v["params"]
    featurizer = featurizer_jax(
        FeatJax(fbank=FbankJax(**FBANK), max_samples=MAX_SAMPLES, lctx=1, rctx=1),
        jnp.asarray(s["offset"]), jnp.asarray(s["scale"]))
    tx = lr_jax.make_optimizer("sgd", **OPTIM)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       opt_state=tx.init(v["params"]), batch_stats=v["batch_stats"])
    ref_losses = []
    for i, scale in enumerate((0.1, 1.0)):
        step = train_step_jax(s["model"], tx, featurizer, loss_chunk=8, loss_backend="xla",
                              donate=False, pruned_scale=scale, **PRUNED)
        state, metrics = step(state, {k: jnp.asarray(x) for k, x in s["batches"][i].items()},
                              jax.random.PRNGKey(i))
        ref_losses.append(float(metrics["loss"]))
    ref_sd = convert.state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))

    pt = init_transducer(TransducerConfig(**MODEL), torch.Generator().manual_seed(0),
                         device="cpu")
    convert.load_flax_variables(pt, v)
    port_featurizer = make_featurizer(
        FeaturizerConfig(fbank=FbankConfig(**FBANK), max_samples=MAX_SAMPLES, lctx=1, rctx=1),
        torch.from_numpy(s["offset"]), torch.from_numpy(s["scale"]), device="cpu")
    optimizer = make_optimizer(pt.parameters(), "sgd", **OPTIM)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for i, scale in enumerate((0.1, 1.0)):
        step = make_train_step(pt, optimizer, port_featurizer, loss_chunk=8, pruned_scale=scale,
                               **PRUNED)
        losses.append(step({k: torch.from_numpy(x) for k, x in s["batches"][i].items()},
                           gen)["loss"].item())
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    init = convert.state_dict_from_flax(v)
    checked = 0
    for name, x in pt.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = x.numpy(), ref_sd[name].numpy()
        stats = name.endswith(("running_mean", "running_var"))
        got_d, ref_d = (got, ref) if stats else (got - init[name].numpy(),
                                                 ref - init[name].numpy())
        if np.abs(ref_d).max() < 1e-6:
            assert np.abs(got_d - ref_d).max() < 1e-6, name
            continue
        rel = np.linalg.norm(got_d - ref_d) / np.linalg.norm(ref_d)
        assert rel < 2e-3, (name, rel)
        checked += name.startswith("simple_")
    assert checked == 4  # both heads' weights and biases trained
