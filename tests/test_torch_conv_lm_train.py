"""Training with the transformer prediction net against the JAX package on
the CPU, at a tiny width (d_model 8, 2 heads, d_ff 16), from the same
weights and the same numpy inputs, with the random draws off (dither 0, no
augmentation, dropout 0):

* two train steps of ``make_train_step`` against the JAX step
  (``loss_backend="xla"``), with float32 and with bf16 attention;

and the CLIs with ``--decoder_type transformer`` against the JAX CLIs,
in-process on one 12-utterance corpus, from one JAX bundle and its
``bundle_from_flax`` conversion, with float32 attention on both sides:

* the training CLI for one epoch: the epoch's summed loss to 1e-4
  relative, the parameters' update to 1e-3 relative L2 (as
  ``tests/test_torch_train_cli.py`` holds the LSTM decoder); then the
  decode CLIs on the JAX-trained bundle (the port's on its conversion):
  the same N-best file, byte for byte, and the same WER; the port's own
  bundle decodes; and the port's CLI from fresh weights with
  ``--decoder_type transformer``;
* one MBR CLI epoch: the summed MBR and RNN-T losses to 1e-4 relative and
  the update of the parameters to 1e-3 relative L2 (as
  ``tests/test_torch_mbr_las_cli.py`` holds the LSTM decoder)."""

import inspect
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pika_tpu.data as data_jax
import pika_tpu.models.transformer as transformer_jax
import pika_tpu.utils.logger as logger_jax
from pika_tpu.features.fbank import FbankConfig as FbankJax
from pika_tpu.models.transducer import (
    Transducer as TransducerJax,
    TransducerConfig as ConfigJax,
    init_transducer as init_jax,
)
from pika_tpu.train import lr as lr_jax
from pika_tpu.train.bundle import load_bundle as load_bundle_jax, save_bundle as save_bundle_jax
from pika_tpu.train.eval_transducer import main as eval_main_jax
from pika_tpu.train.step import (
    FeaturizerConfig as FeatJax,
    TrainState,
    make_featurizer as featurizer_jax,
    make_train_step as train_step_jax,
)
from pika_tpu.train.train_mbr import main as mbr_main_jax
from pika_tpu.train.train_transducer import main as train_main_jax
import pika_tpu_torch.models.transformer as transformer_pt
import pika_tpu_torch.utils.logger as logger_pt
from pika_tpu_torch import convert
from pika_tpu_torch.convert import state_dict_from_flax
from pika_tpu_torch.data.prep import main as prep_main
from pika_tpu_torch.features.fbank import FbankConfig
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.train.bundle import bundle_from_flax, load_bundle
from pika_tpu_torch.train.eval_transducer import main as eval_main
from pika_tpu_torch.train.lr import make_optimizer
from pika_tpu_torch.train.step import FeaturizerConfig, make_featurizer, make_train_step
from pika_tpu_torch.train.train_mbr import main as mbr_main
from pika_tpu_torch.train.train_transducer import main as train_main

torch.set_num_threads(1)

SR = 16000
VOCAB = 10
MEL = 20
N_UTTS = 12
MODEL = dict(input_dim=3 * MEL, vocab_size=VOCAB, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="transformer", enc_layers=5, dec_layers=2, embd_dim=8, tdnn_nhid=32,
             tdnn_layers=5, dropout=0.0, tdnn_transformer_dropout=0.0, dec_d_model=8,
             dec_heads=2, dec_d_ff=16)
MODEL_FLAGS = ["--encoder_type", "transformer", "--enc_layers", "5", "--tdnn_layers", "5",
               "--tdnn_nhid", "32", "--decoder_type", "transformer", "--dec_layers", "2",
               "--rnn_size", "16", "--embd_dim", "8", "--output_dim", str(VOCAB)]
COMMON = ["--feats_dim", str(MEL), "--lctx", "1", "--rctx", "1", "--batch_size", "4",
          "--num_workers", "1", "--max_wav_seconds", "1.0", "--grad_clip", "3.0",
          "--num_batches_per_epoch", "3", "--dp_mode", "sync", "--num_devices", "1",
          "--no_augment", "--num_epochs", "1"]
TRAIN_FLAGS = [*COMMON, "--initial_lr", "0.003", "--final_lr", "0.0001",
               "--steps_per_dispatch", "1"]
MBR_FLAGS = [*COMMON, "--initial_lr", "0.003", "--final_lr", "0.001", "--momentum", "0.9",
             "--beam_size", "3", "--sm_scale", "1.2", "--rnnt_scale", "0.1",
             "--decode_max_symbols", "6", "--loss_chunk", "8"]
# 24 symbols: the trained tiny model emits to the cap, and at 8 or 12 the
# JAX beam's N-best holds NaN-scored hypotheses (a dead beam past a full
# token buffer: ROADMAP Queue 3), which the port does not copy
DECODE_FLAGS = ["--feats_dim", str(MEL), "--max_wav_seconds", "1.0", "--batch_size", "4",
                "--beam_size", "3", "--n_best", "3", "--max_symbols", "24"]


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


@pytest.fixture
def epoch_sums(monkeypatch):
    """Each Logger's (summed losses, labels) at its epoch summary, per package."""
    sums = {"jax": [], "pt": []}
    for key, module in (("jax", logger_jax), ("pt", logger_pt)):
        original = module.Logger.summarize_and_log

        def record(self, _original=original, _key=key):
            sums[_key].append((list(self.total_loss), self.total_frames))
            return _original(self)

        monkeypatch.setattr(module.Logger, "summarize_and_log", record)
    return sums


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

# MODEL on 4 mel bins; its decoder's d_head is 4: both packages scale q by
# sqrt(d_head) rounded to q's dtype (bf16 in the port), which float32
# attention keeps apart unless it is exact
STEP_MEL = 4
STEP_MODEL = dict(MODEL, input_dim=3 * STEP_MEL)
FBANK = dict(sample_frequency=16000, window_type="hamming", dither=0.0, num_mel_bins=STEP_MEL)
MAX_SAMPLES = 16000
OPTIM = dict(initial_lr=0.003, final_lr=0.0001, total_batches=100000, momentum=0.9, grad_clip=3.0)


@pytest.fixture(scope="module")
def step_inputs():
    rng = np.random.default_rng(11)
    wav_lens = np.array([16000, 12000, 9000, 4000], np.int32)
    wavs = np.zeros((4, MAX_SAMPLES), np.float32)
    for i, n in enumerate(wav_lens):
        wavs[i, :n] = np.round(rng.standard_normal(n) * 3000)
    batches = [dict(wavs=wavs, wav_lens=wav_lens,
                    labels=rng.integers(1, VOCAB, (4, 5)).astype(np.int32),
                    label_lens=np.array([5, 3, 0, 2], np.int32)) for _ in range(2)]
    plain = make_featurizer(FeaturizerConfig(fbank=FbankConfig(**FBANK), max_samples=MAX_SAMPLES,
                                             lctx=1, rctx=1), device="cpu")
    feats, lens = plain(torch.from_numpy(wavs), torch.from_numpy(wav_lens))
    valid = torch.cat([f[:n] for f, n in zip(feats, lens.tolist())]).numpy()
    return dict(batches=batches, offset=-valid.mean(0).astype(np.float32),
                scale=(1.0 / valid.std(0)).astype(np.float32))


def _jax_steps(jax_model, s, n):
    model, v = jax_model
    featurizer = featurizer_jax(
        FeatJax(fbank=FbankJax(**FBANK), max_samples=MAX_SAMPLES, lctx=1, rctx=1),
        jnp.asarray(s["offset"]), jnp.asarray(s["scale"]))
    tx = lr_jax.make_optimizer("sgd", **OPTIM)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       opt_state=tx.init(v["params"]), batch_stats=v["batch_stats"])
    step = train_step_jax(model, tx, featurizer, loss_chunk=8, loss_backend="xla", donate=False)
    losses = []
    for i in range(n):
        state, metrics = step(state, {k: jnp.asarray(x) for k, x in s["batches"][i].items()},
                              jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
    return losses, convert.state_dict_from_flax(
        _np({"params": state.params, "batch_stats": state.batch_stats}))


def _port_steps(jax_model, s, n):
    pt = init_transducer(TransducerConfig(**STEP_MODEL),
                         torch.Generator().manual_seed(0), device="cpu")
    convert.load_flax_variables(pt, jax_model[1])
    featurizer = make_featurizer(
        FeaturizerConfig(fbank=FbankConfig(**FBANK), max_samples=MAX_SAMPLES, lctx=1, rctx=1),
        torch.from_numpy(s["offset"]), torch.from_numpy(s["scale"]), device="cpu")
    step = make_train_step(pt, make_optimizer(pt.parameters(), "sgd", **OPTIM), featurizer,
                           loss_chunk=8)
    gen = torch.Generator().manual_seed(0)
    losses = [step({k: torch.from_numpy(x) for k, x in s["batches"][i].items()}, gen)["loss"].item()
              for i in range(n)]
    return losses, pt


@pytest.fixture(scope="module")
def step_model():
    """A JAX model at the featurizer's input width (3 x STEP_MEL)."""
    cfg = ConfigJax(**STEP_MODEL)
    variables = jax.jit(lambda k: init_jax(k, cfg, max_t=64)[1])(jax.random.PRNGKey(5))
    return TransducerJax(cfg), _np(variables)


@pytest.mark.parametrize("f32", [True, False])
def test_train_steps_match_jax(step_model, step_inputs, monkeypatch, f32):
    """Two steps of the port's train step (K1-K3's plain versions here)
    against two JAX steps (``loss_backend="xla"``) from the same weights:
    losses to 1e-5 relative with float32 attention and 1e-3 with bf16; every
    parameter's change to 2e-3 relative L2 (float32 attention) or to 1e-1 in
    the encoder and 1e-2 elsewhere (bf16), the BatchNorm statistics to 2e-3
    and 1e-2; quantities that are 0 but for float noise (the key biases'
    gradients, 0 by the softmax's shift invariance) to 1e-6 absolute, 1e-5
    with bf16 probabilities (measured: 1.0e-6)."""
    if f32:
        _f32_attention(monkeypatch)
    ref_losses, ref_sd = _jax_steps(step_model, step_inputs, 2)
    losses, pt = _port_steps(step_model, step_inputs, 2)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5 if f32 else 1e-3)
    init = convert.state_dict_from_flax(step_model[1])
    checked = 0
    for name, x in pt.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = x.numpy(), ref_sd[name].numpy()
        assert np.isfinite(got).all(), name
        stats = name.endswith(("running_mean", "running_var"))
        got_d, ref_d = (got, ref) if stats else (got - init[name].numpy(),
                                                 ref - init[name].numpy())
        if np.abs(ref_d).max() < 1e-6:
            assert np.abs(got_d - ref_d).max() < (1e-6 if f32 else 1e-5), name
            continue
        tol = 2e-3 if f32 else (1e-2 if stats or not name.startswith("encoder.") else 1e-1)
        assert _rel_l2(got_d, ref_d) < tol, (name, _rel_l2(got_d, ref_d), tol)
        checked += name.startswith("decoder.")
    assert checked > 20  # the decoder's parameters trained


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 utterances of 0.8-1.0 s of noise with 2-4 labels as mrk/seq
    archives, their CMVN statistics, an fbank configuration without dither,
    and a JAX bundle of the tiny model with its port conversion."""
    d = tmp_path_factory.mktemp("conv_lm_cli")
    rng = np.random.default_rng(5)
    labels = []
    with open(d / "wav.scp", "w") as scp:
        for i in range(N_UTTS):
            n = int(rng.integers(int(0.8 * SR), SR))
            data_jax.write_wav(d / f"u{i}.wav", (rng.standard_normal(n) * 3000).astype(np.int16),
                               SR)
            scp.write(f"utt{i} {d}/u{i}.wav\n")
            labels.append((f"utt{i}", rng.integers(1, VOCAB, int(rng.integers(2, 5))).tolist()))
    data_jax.write_int_vectors(str(d / "label.txt"), labels)
    prep_main(["wav_to_seq", str(d / "wav.scp"), str(d / "train.mrk"), str(d / "train.seq"),
               "--device", "cpu"])
    (d / "data.lst").write_text(f"{d}/train.mrk.0 {d}/train.seq.0 ark:{d}/label.txt\n")
    (d / "fbank.conf").write_text(
        f"--window-type=hamming\n--sample-frequency=16000\n--dither=0\n--low-freq=40\n"
        f"--high-freq=-200\n--num-mel-bins={MEL}\n")
    prep_main(["compute_global_cmvn", str(d / "data.lst"), str(d / "cmvn.stats"),
               "--feat_config", str(d / "fbank.conf"), "--no_normalize", "--device", "cpu"])
    cfg = ConfigJax(**MODEL)
    variables = jax.jit(lambda key: init_jax(key, cfg, max_t=64)[1])(jax.random.PRNGKey(7))
    variables = jax.tree.map(np.asarray, variables)
    save_bundle_jax(str(d / "jax_init"), "transducer", cfg, variables)
    bundle_from_flax(str(d / "pt_init"), json.loads((d / "jax_init" / "model.json").read_text()),
                     variables)
    return d


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _check_update(d, jax_bundle, pt_bundle):
    """The port's trained bundle against the JAX one: every tensor within
    1e-2 relative L2, a zero-initialised one (which holds only its update,
    so its error is the update's) within 5e-2 (measured after the MBR
    epoch: 1.2e-2 on ``encoder.bn_in.bias``), 1e-6 absolute where 0 but for
    float noise; the whole update (final - initial) within 1e-3."""
    _, variables, _ = load_bundle_jax(str(jax_bundle))
    ref_sd = state_dict_from_flax(jax.tree.map(np.asarray, variables))
    model, _ = load_bundle(str(pt_bundle), device="cpu")
    assert model.config.decoder_type == "transformer"
    init, _ = load_bundle(str(d / "pt_init"), device="cpu")
    got_d, ref_d, changed = [], [], 0
    for name, x in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        g, r, i = x.numpy(), ref_sd[name].numpy(), init.state_dict()[name].numpy()
        if np.abs(r).max() < 1e-6:
            assert np.abs(g - r).max() < 1e-6, name
        else:
            tol = 5e-2 if not i.any() else 1e-2
            assert _rel_l2(g, r) < tol, (name, _rel_l2(g, r))
        got_d.append((g - i).ravel())
        ref_d.append((r - i).ravel())
        changed += name.startswith("decoder.") and not np.array_equal(g, i)
    assert _rel_l2(np.concatenate(got_d), np.concatenate(ref_d)) < 1e-3
    assert changed > 10  # the transformer decoder trained


def test_train_and_decode_clis_match_jax(corpus, f32_attention, epoch_sums, capsys):
    d = corpus
    data = str(d / "data.lst")
    flags = [*TRAIN_FLAGS, "--feat_config", str(d / "fbank.conf"),
             "--cmvn_stats", str(d / "cmvn.stats"), "--decoder_type", "transformer"]
    train_main_jax([data, str(d / "jax.log"), str(d / "jax"), *flags,
                    "--init_model", str(d / "jax_init")])
    train_main([data, str(d / "pt.log"), str(d / "pt"), *flags,
                "--init_model", str(d / "pt_init"), "--device", "cpu"])
    (gl, gn), (rl, rn) = epoch_sums["pt"][0], epoch_sums["jax"][0]
    assert gn == rn > 0 and abs(gl[0] - rl[0]) <= 1e-4 * abs(rl[0]), (gl, rl)
    _check_update(d, d / "jax" / "model.epoch.0", d / "pt" / "model.epoch.0")

    # the decode CLIs on the JAX-trained bundle and its conversion: the same
    # N-best file, byte for byte, and the same WER; the port's own bundle
    # decodes too
    _, variables, _ = load_bundle_jax(str(d / "jax" / "model.epoch.0"))
    bundle_from_flax(str(d / "jax_trained"),
                     json.loads((d / "jax" / "model.epoch.0" / "model.json").read_text()),
                     jax.tree.map(np.asarray, variables))
    decode = [*DECODE_FLAGS, "--cmvn_stats", str(d / "cmvn.stats"),
              "--ref_labels", f"ark:{d}/label.txt"]
    wer_ref = eval_main_jax([str(d / "jax" / "model.epoch.0"), str(d / "wav.scp"),
                             str(d / "ref.txt"), *decode])
    err_ref = capsys.readouterr().err
    wer = eval_main([str(d / "jax_trained"), str(d / "wav.scp"), str(d / "got.txt"),
                     "--device", "cpu", *decode])
    err = capsys.readouterr().err
    assert (d / "got.txt").read_bytes() == (d / "ref.txt").read_bytes()
    lines = (d / "got.txt").read_text().splitlines()
    assert len(lines) == N_UTTS * 3 and any(lines)
    assert wer == wer_ref
    assert [x for x in err.splitlines() if x.startswith("%WER")] == [
        x for x in err_ref.splitlines() if x.startswith("%WER")]
    eval_main([str(d / "pt" / "model.epoch.0"), str(d / "wav.scp"), str(d / "own.txt"),
               "--device", "cpu", *decode])
    assert len((d / "own.txt").read_text().splitlines()) == N_UTTS * 3
    # at a cap of 8 every N-best score of the port is finite (or the dead
    # mark -1e20), where the JAX beam's holds NaNs on this bundle
    eval_main([str(d / "jax_trained"), str(d / "wav.scp"), str(d / "cap8.txt"), "--device",
               "cpu", *DECODE_FLAGS[:-2], "--max_symbols", "8", "--cmvn_stats",
               str(d / "cmvn.stats"), "--output_scores"])
    scores = [float(x.rsplit(" ", 1)[1]) for x in (d / "cap8.txt").read_text().splitlines()]
    assert len(scores) == N_UTTS * 3 and np.isfinite(scores).all()


def test_train_cli_fresh_transformer_decoder(corpus, tmp_path):
    """Without ``--init_model`` the flags build the transformer decoder
    (the JAX defaults d_model 512, 8 heads, d_ff 2048 are too wide here, so
    a saved bundle's widths are checked instead of a JAX run)."""
    d = corpus
    train_main([str(d / "data.lst"), str(tmp_path / "log"), str(tmp_path / "out"),
                *MODEL_FLAGS, *TRAIN_FLAGS, "--feat_config", str(d / "fbank.conf"),
                "--cmvn_stats", str(d / "cmvn.stats"), "--device", "cpu"])
    model, _ = load_bundle(str(tmp_path / "out" / "model.epoch.0"), device="cpu")
    assert model.config.decoder_type == "transformer"
    assert model.decoder.conv_0.weight.shape == (512, 8, 5)
    assert model.decoder.transformer_1.feed_forward.w_1.weight.shape == (2048, 512)
    assert "Training Finished" in (tmp_path / "log").read_text()


def test_mbr_cli_matches_jax(corpus, f32_attention, epoch_sums):
    d = corpus
    flags = [*MBR_FLAGS, "--feat_config", str(d / "fbank.conf"),
             "--cmvn_stats", str(d / "cmvn.stats")]
    mbr_main_jax([str(d / "data.lst"), str(d / "mbr_jax.log"), str(d / "mbr_jax"), *flags,
                  "--init_model", str(d / "jax_init")])
    mbr_main([str(d / "data.lst"), str(d / "mbr_pt.log"), str(d / "mbr_pt"), *flags,
              "--init_model", str(d / "pt_init"), "--device", "cpu"])
    (g_losses, gn), (r_losses, rn) = epoch_sums["pt"][0], epoch_sums["jax"][0]
    assert gn == rn > 0
    for g, r in zip(g_losses, r_losses):
        assert abs(g - r) <= 1e-4 * abs(r), (g_losses, r_losses)
    _check_update(d, d / "mbr_jax" / "model.epoch.0", d / "mbr_pt" / "model.epoch.0")
