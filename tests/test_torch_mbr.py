"""The port's MBR fine-tuning pieces against the JAX package on the CPU, on
the same numpy inputs and weights: the batched edit distance (exact), the
beam search without duplicate pruning (the MBR decode: tokens, lengths and
alignments bit for bit, scores to 1e-5), ``mbr_losses`` on one shared
N-best (objective and metrics to 1e-5 relative, gradients to 1e-4 relative
L2, attention in float32 on both sides) and two ``make_mbr_step`` steps of
a BatchNorm encoder (weights to 1e-3 relative, running statistics to 1e-4),
with the random draws off (no dither, no SpecAugment, dropout 0)."""

import functools
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pika_tpu.models.transformer as transformer_jax
from pika_tpu.decode.beam import BeamConfig as BeamConfigJax, beam_search as beam_search_jax
from pika_tpu.models.transducer import (
    Transducer as TransducerJax,
    TransducerConfig as ConfigJax,
    init_transducer as init_jax,
)
from pika_tpu.ops.edit_distance import edit_distance_batch_jax
from pika_tpu.train import lr as lr_jax
from pika_tpu.train.mbr import make_mbr_step as make_mbr_step_jax, mbr_losses as mbr_losses_jax
from pika_tpu.train.step import TrainState
import pika_tpu_torch.models.transformer as transformer_pt
from pika_tpu_torch.convert import load_flax_variables, state_dict_from_flax
from pika_tpu_torch.decode.beam import NEG, BeamConfig, beam_search
from pika_tpu_torch.decode.wer import edit_distance
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.ops.edit_distance import edit_distance_batch
from pika_tpu_torch.train.lr import make_optimizer
from pika_tpu_torch.train.mbr import make_mbr_step, mbr_losses

torch.set_num_threads(1)

VOCAB = 8
FEAT = 12
MODEL = dict(input_dim=FEAT, vocab_size=VOCAB, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="rnn", enc_layers=5, dec_layers=1, embd_dim=8, tdnn_nhid=32,
             tdnn_layers=5, dropout=0.0, tdnn_transformer_dropout=0.0)
OPTIM = dict(initial_lr=0.01, final_lr=0.001, total_batches=100, momentum=0.9, grad_clip=3.0)


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


@functools.lru_cache(maxsize=1)
def _jax_variables():
    cfg = ConfigJax(**MODEL)
    variables = jax.jit(lambda key: init_jax(key, cfg, max_t=64)[1])(jax.random.PRNGKey(5))
    return jax.tree.map(np.asarray, variables)


def _models():
    v = jax.tree.map(np.array, _jax_variables())
    pt = init_transducer(TransducerConfig(**MODEL), torch.Generator().manual_seed(0), device="cpu")
    load_flax_variables(pt, v)
    return TransducerJax(ConfigJax(**MODEL)), v, pt


def _batch(seed, b=3, t=40, u=3):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, FEAT)).astype(np.float32)
    feat_lens = np.array([t, t - 6, t - 13][:b], np.int32)
    labels = rng.integers(1, VOCAB - 1, (b, u)).astype(np.int32)
    label_lens = np.array([u, u - 1, 1][:b], np.int32)
    return dict(wavs=feats, wav_lens=feat_lens, labels=labels, label_lens=label_lens)


# ---------------------------------------------------------------------------
# edit distance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_edit_distance_matches_jax(seed):
    """Random pairs with empty refs and hyps and -1 padding past the
    lengths: the port's distances equal the JAX function's and the numpy DP
    of ``decode/wer.py``."""
    rng = np.random.default_rng(seed)
    n, u, v = 64, 9, 11
    refs = rng.integers(0, 5, (n, u)).astype(np.int32)
    hyps = rng.integers(0, 5, (n, v)).astype(np.int32)
    ref_lens = rng.integers(0, u + 1, n).astype(np.int32)
    hyp_lens = rng.integers(0, v + 1, n).astype(np.int32)
    ref_lens[:4], hyp_lens[2:6] = 0, 0
    refs[np.arange(u)[None] >= ref_lens[:, None]] = -1
    hyps[np.arange(v)[None] >= hyp_lens[:, None]] = -1
    ref = np.asarray(edit_distance_batch_jax(*map(jnp.asarray, (refs, ref_lens, hyps, hyp_lens))))
    got = edit_distance_batch(*map(torch.from_numpy, (refs, ref_lens, hyps, hyp_lens)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    dp = [edit_distance(r[:a].tolist(), h[:c].tolist())
          for r, a, h, c in zip(refs, ref_lens, hyps, hyp_lens)]
    np.testing.assert_array_equal(got.numpy(), dp)


# ---------------------------------------------------------------------------
# the MBR decode: beam search without duplicate pruning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blank", [0, 3])
@pytest.mark.parametrize("beam", [2, 4])
def test_beam_without_pruning_matches_jax(beam, blank):
    """``prune_dups=False`` and ``n_best = beam``, as the MBR step decodes:
    duplicates stay in the N-best, dead beams at NEG fill it, and the top-k
    tie rule holds; tokens, lengths, alignments bit for bit, live scores to
    1e-5."""
    model, v, pt = _models()
    enc = (np.random.default_rng(blank + beam).standard_normal((3, 9, 16)) * 2).astype(np.float32)
    lens = np.array([9, 5, 1], np.int32)
    cfg = dict(beam_size=beam, n_best=beam, max_symbols=6, prune_dups=False, blank=blank)
    ref = beam_search_jax(model, v, jnp.asarray(enc), jnp.asarray(lens), BeamConfigJax(**cfg))
    got = beam_search(pt, torch.from_numpy(enc), torch.from_numpy(lens), BeamConfig(**cfg))
    ref = {k: np.asarray(x) for k, x in ref.items()}
    for name in ("tokens", "lens", "aligns", "align_lens"):
        np.testing.assert_array_equal(got[name].numpy(), ref[name], err_msg=name)
    live = ref["scores"] > NEG / 2
    np.testing.assert_allclose(got["scores"].numpy()[live], ref["scores"][live], rtol=1e-5)
    assert (got["scores"].numpy()[~live] <= NEG / 2).all()


# ---------------------------------------------------------------------------
# the objective and its gradients on one N-best
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blank", [0, 5])
def test_mbr_losses_match_jax(f32_attention, blank):
    """One N-best decoded by the JAX beam fed to both ``mbr_losses`` in
    train mode (batch statistics; dropout 0), with ``rnnt_scale`` 0.3 and
    ``sm_scale`` 1.2: the objective and the metrics to 1e-5 relative, every
    parameter's gradient to 1e-4 relative L2 (each tensor to 1e-3), the
    BatchNorm running statistics to 1e-4."""
    model, v, pt = _models()
    bt = _batch(1)
    x = {k: jnp.asarray(a) for k, a in bt.items()}
    variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    enc = jax.jit(lambda v, f, n: model.apply(v, f, n, method=TransducerJax.encode))(
        variables, x["wavs"], x["wav_lens"])
    enc_lens = model.apply(variables, x["wav_lens"], method=TransducerJax.encoder_out_len)
    nbest = beam_search_jax(model, variables, enc, enc_lens,
                            BeamConfigJax(beam_size=4, n_best=4, max_symbols=6,
                                          prune_dups=False, blank=blank))
    aligns = np.asarray(nbest["aligns"])
    assert (aligns == blank).any() and (aligns == -1).any()  # blank steps and padding seen

    def objective(params):
        return mbr_losses_jax(model, params, x["wavs"], x["wav_lens"], x["labels"],
                              x["label_lens"], nbest, 0.3, 1.2, dropout_key=jax.random.PRNGKey(0),
                              loss_chunk=8, loss_backend="xla",
                              batch_stats=v["batch_stats"], blank=blank)

    (ref_total, (ref_metrics, ref_stats)), ref_grads = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(v["params"])
    pt.train()
    t = {k: torch.from_numpy(a) for k, a in bt.items()}
    total, metrics = mbr_losses(pt, t["wavs"], t["wav_lens"], t["labels"], t["label_lens"],
                                {k: torch.from_numpy(np.array(a)) for k, a in nbest.items()},
                                0.3, 1.2, loss_chunk=8, loss_backend="auto", blank=blank)
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-5)
    for name in ("mbr_loss", "rnnt_loss", "num_labels"):
        np.testing.assert_allclose(float(metrics[name]), float(ref_metrics[name]), rtol=1e-5,
                                   err_msg=name)
    ref_sd = state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": ref_grads, "batch_stats": ref_stats}))
    # the whole gradient to 1e-4 relative L2; each tensor to 1e-3 (the
    # encoder's first layers sit behind four BatchNorms over 3 utterances of
    # a dozen frames, which amplify float32 rounding: measured up to 1.0e-4
    # on encoder.bn_0.weight, 2e-6 after the encoder)
    names = [n for n, _ in pt.named_parameters()]
    got = np.concatenate([p.grad.numpy().ravel() for _, p in pt.named_parameters()])
    ref = np.concatenate([ref_sd[n].numpy().ravel() for n in names])
    assert _rel_l2(got, ref) <= 1e-4, _rel_l2(got, ref)
    checked = 0
    for name, p in pt.named_parameters():
        g, r = p.grad.numpy(), ref_sd[name].numpy()
        if np.abs(r).max() < 1e-4 * np.abs(ref).max():
            # 0 but for float noise (a BatchNorm's affine feeding another)
            assert np.abs(g - r).max() < 1e-6, name
            continue
        assert _rel_l2(g, r) <= 1e-3, (name, _rel_l2(g, r))
        checked += 1
    assert checked > 40
    for name, buf in pt.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), ref_sd[name].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

def test_mbr_steps_match_jax(f32_attention):
    """Two MBR steps of both packages from the same weights on a BatchNorm
    encoder: each decodes its own N-best (eval mode), then the loss in train
    mode and one SGD-Nesterov update with inf-norm clipping.  The metrics to
    1e-5 relative; each parameter's change to 1e-3 relative L2 and the
    running statistics to 1e-4; the model is left in the mode it had."""
    model, v, pt = _models()
    beam = dict(beam_size=3, n_best=3, max_symbols=6, prune_dups=False)
    tx = lr_jax.make_optimizer("sgd", **OPTIM)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       opt_state=tx.init(v["params"]), batch_stats=v["batch_stats"])
    step_jax = make_mbr_step_jax(model, tx, lambda key, x, lens, train: (x, lens),
                                 BeamConfigJax(**beam), rnnt_scale=0.1, sm_scale=1.2,
                                 loss_chunk=8, loss_backend="xla", donate=False)
    step = make_mbr_step(pt, make_optimizer(pt.parameters(), "sgd", **OPTIM),
                         lambda x, lens, generator=None: (x, lens), BeamConfig(**beam),
                         rnnt_scale=0.1, sm_scale=1.2, loss_chunk=8)
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        bt = _batch(10 + i)
        state, ref = step_jax(state, {k: jnp.asarray(a) for k, a in bt.items()},
                              jax.random.PRNGKey(i))
        got = step({k: torch.from_numpy(a) for k, a in bt.items()}, gen)
        for name in ("mbr_loss", "rnnt_loss", "num_labels"):
            np.testing.assert_allclose(float(got[name]), float(ref[name]), rtol=1e-5,
                                       err_msg=f"step {i} {name}")
    assert not pt.training
    ref_sd = state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    init_sd = state_dict_from_flax(v)
    checked = 0
    for name, x in pt.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = x.numpy(), ref_sd[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6, err_msg=name)
            continue
        got_d, ref_d = got - init_sd[name].numpy(), ref - init_sd[name].numpy()
        if np.abs(ref_d).max() < 1e-6:
            assert np.abs(got_d - ref_d).max() < 1e-6, name
            continue
        assert _rel_l2(got_d, ref_d) < 1e-3, (name, _rel_l2(got_d, ref_d))
        checked += 1
    assert checked > 40
