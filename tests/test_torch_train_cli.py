"""The port's training CLI (``pika_tpu_torch/train/train_transducer.py``)
against the JAX CLI on the CPU, in-process on one 12-utterance corpus:

* both CLIs from the same weights (a JAX bundle, and the port bundle that
  ``bundle_from_flax`` makes of it), with the random draws off (dither 0,
  no speed/gain, no SpecAugment, dropout 0), one loader worker and float32
  attention on both sides: each epoch's summed loss (the "Overall Avg
  Loss" line's numerator) to 1e-4 relative, the final parameters to 1e-3
  relative L2; and the same with ``--loader utt`` over a feature archive;
* a resume at an epoch boundary equal to the uninterrupted run bit for bit,
  with dither, speed/gain, SpecAugment and dropout on;
* the flags that raised until their paths were ported (the pruned loss,
  the transformer prediction net) training an epoch, and the entry points
  raising without a device named on a machine without a card;
* the port's decode CLI reading the trained ``model.epoch.N``."""

import inspect
import json
import re
import shutil

import numpy as np
import jax
import pytest
import torch

import pika_tpu.data as data_jax
import pika_tpu.models.transformer as transformer_jax
import pika_tpu.utils.logger as logger_jax
from pika_tpu.data.kaldi_ark import write_matrix_ark
from pika_tpu.models.transducer import (
    Transducer as TransducerJax,
    TransducerConfig as ConfigJax,
    init_transducer as init_jax,
)
from pika_tpu.train.bundle import load_bundle as load_bundle_jax, save_bundle as save_bundle_jax
from pika_tpu.train.train_transducer import main as train_main_jax
import pika_tpu_torch.models.transformer as transformer_pt
import pika_tpu_torch.utils.logger as logger_pt
from pika_tpu_torch.convert import state_dict_from_flax
from pika_tpu_torch.data.prep import main as prep_main
from pika_tpu_torch.train.bundle import bundle_from_flax, load_bundle
from pika_tpu_torch.train.checkpoint import restore_checkpoint
from pika_tpu_torch.train.eval_transducer import main as eval_main
from pika_tpu_torch.train.train_transducer import main as train_main

torch.set_num_threads(1)

SR = 16000
VOCAB = 10
MEL = 20
N_UTTS = 12
MODEL = dict(input_dim=3 * MEL, vocab_size=VOCAB, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="rnn", enc_layers=5, dec_layers=2, embd_dim=8, tdnn_nhid=32,
             tdnn_layers=5, dropout=0.0, tdnn_transformer_dropout=0.0)
# the recipe's model flags at a tiny width (the port reads them when it
# does not start from a bundle)
MODEL_FLAGS = ["--encoder_type", "transformer", "--enc_layers", "5", "--tdnn_layers", "5",
               "--tdnn_nhid", "32", "--decoder_type", "rnn", "--dec_layers", "2",
               "--rnn_size", "16", "--embd_dim", "8", "--output_dim", str(VOCAB)]
TRAIN_FLAGS = ["--feats_dim", str(MEL), "--lctx", "1", "--rctx", "1", "--batch_size", "4",
               "--num_workers", "1", "--max_wav_seconds", "1.0", "--initial_lr", "0.003",
               "--final_lr", "0.0001", "--grad_clip", "3.0", "--num_batches_per_epoch", "3",
               "--dp_mode", "sync", "--num_devices", "1", "--steps_per_dispatch", "1"]


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


@pytest.fixture
def epoch_sums(monkeypatch):
    """Each Logger's (summed loss, labels) at its epoch summary, per package."""
    sums = {"jax": [], "pt": []}
    for key, module in (("jax", logger_jax), ("pt", logger_pt)):
        original = module.Logger.summarize_and_log

        def record(self, _original=original, _key=key):
            sums[_key].append((self.total_loss[0], self.total_frames))
            return _original(self)

        monkeypatch.setattr(module.Logger, "summarize_and_log", record)
    return sums


def _write_conf(path, dither):
    path.write_text(f"--window-type=hamming\n--sample-frequency=16000\n--dither={dither}\n"
                    f"--low-freq=40\n--high-freq=-200\n--num-mel-bins={MEL}\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 utterances of 0.8-1.0 s of noise (one waveform bucket at
    --max_wav_seconds 1) with 2-4 labels, as mrk/seq archives through the port's prep, CMVN
    statistics, a feature archive of the same audio, fbank configurations
    with and without dither, and a JAX bundle of a tiny model with its port
    conversion."""
    d = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(5)
    labels = []
    with open(d / "wav.scp", "w") as scp:
        for i in range(N_UTTS):
            n = int(rng.integers(int(0.8 * SR), SR))
            pcm = (rng.standard_normal(n) * 3000).astype(np.int16)
            data_jax.write_wav(d / f"u{i}.wav", pcm, SR)
            scp.write(f"utt{i} {d}/u{i}.wav\n")
            labels.append((f"utt{i}", rng.integers(1, VOCAB, int(rng.integers(2, 5))).tolist()))
    data_jax.write_int_vectors(str(d / "label.txt"), labels)
    prep_main(["wav_to_seq", str(d / "wav.scp"), str(d / "train.mrk"), str(d / "train.seq"),
               "--device", "cpu"])
    (d / "data.lst").write_text(f"{d}/train.mrk.0 {d}/train.seq.0 ark:{d}/label.txt\n")
    _write_conf(d / "fbank0.conf", 0)
    _write_conf(d / "fbank1.conf", 1)
    # statistics of the audio as the CLIs see it without augmentation (a
    # mismatched CMVN leaves ReLU units at the edge of dying, where the
    # gradients of both packages jump with the last bit of their inputs)
    prep_main(["compute_global_cmvn", str(d / "data.lst"), str(d / "cmvn.stats"),
               "--feat_config", str(d / "fbank0.conf"), "--no_normalize", "--device", "cpu"])
    feats = []
    for i in range(N_UTTS):
        x = rng.standard_normal((int(rng.integers(80, 100)), MEL)).astype(np.float32)
        feats.append((f"utt{i}", x + np.linspace(0, 1, MEL, dtype=np.float32)))
    write_matrix_ark(str(d / "feats.ark"), feats)

    model, variables = _init_jax(7, ConfigJax(**MODEL))
    save_bundle_jax(str(d / "jax_init"), "transducer", ConfigJax(**MODEL),
                    jax.tree.map(np.asarray, variables))
    with open(d / "jax_init" / "model.json") as f:
        spec = json.load(f)
    bundle_from_flax(str(d / "pt_init"), spec, jax.tree.map(np.asarray, variables))
    return d


def _init_jax(seed, cfg):
    """``init_transducer`` under jit (eager init takes seconds here)."""
    variables = jax.jit(lambda key: init_jax(key, cfg, max_t=64)[1])(jax.random.PRNGKey(seed))
    return TransducerJax(cfg), variables


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _check_against_jax(d, tag, data, data_flags, epoch_sums):
    common = [*TRAIN_FLAGS, "--no_augment", "--num_epochs", "2", *data_flags]
    train_main_jax([data, str(d / f"{tag}_jax.log"), str(d / f"{tag}_jax"), *common,
                    "--init_model", str(d / "jax_init")])
    train_main([data, str(d / f"{tag}_pt.log"), str(d / f"{tag}_pt"), *common,
                "--init_model", str(d / "pt_init"), "--device", "cpu"])
    ref, got = epoch_sums["jax"], epoch_sums["pt"]
    assert len(ref) == len(got) == 2
    for (gl, gn), (rl, rn) in zip(got, ref):
        assert gn == rn > 0
        assert abs(gl - rl) <= 1e-4 * abs(rl), (gl, rl)
    logs = [(d / f"{tag}_{k}.log").read_text() for k in ("jax", "pt")]
    for log in logs:
        assert log.count("Overall Avg Loss") == 2 and "Training Finished" in log
    _, variables, _ = load_bundle_jax(str(d / f"{tag}_jax" / "model.epoch.1"))
    ref_sd = state_dict_from_flax(jax.tree.map(np.asarray, variables))
    model, meta = load_bundle(str(d / f"{tag}_pt" / "model.epoch.1"), device="cpu")
    assert meta == {"epoch": 1}
    init, _ = load_bundle(str(d / "pt_init"), device="cpu")
    changed = 0
    for name, x in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = x.numpy(), ref_sd[name].numpy()
        if np.abs(ref).max() < 1e-6:  # 0 but for float noise (a key bias, a mean after BN)
            assert np.abs(got - ref).max() < 1e-6, name
        else:
            assert _rel_l2(got, ref) < 1e-3, (name, _rel_l2(got, ref))
        changed += not torch.equal(x, init.state_dict()[name])
    assert changed > 20  # the runs trained
    return logs


def test_cli_matches_jax(corpus, f32_attention, epoch_sums):
    d = corpus
    logs = _check_against_jax(d, "otf", str(d / "data.lst"),
                              ["--feat_config", str(d / "fbank0.conf"),
                               "--cmvn_stats", str(d / "cmvn.stats"),
                               "--valid_data_lst", str(d / "data.lst")], epoch_sums)
    for log in logs:
        assert log.count("valid loss/label") == 2
    valid = [re.findall(r"valid loss/label: ([0-9.]+)", log) for log in logs]
    np.testing.assert_allclose(np.array(valid[1], float), np.array(valid[0], float), rtol=1e-3)


def test_cli_loader_utt_matches_jax(corpus, f32_attention, epoch_sums):
    d = corpus
    _check_against_jax(d, "utt", str(d / "feats.ark"),
                       ["--loader", "utt", "--ali_rspec", f"ark:{d}/label.txt",
                        "--buffer_size", "4"], epoch_sums)


RANDOM_FLAGS = ["--feat_config", None, "--spec_augment", "--max_freq_span", "5",
                "--max_time_span", "8", "--dropout", "0.3", "--tdnn_transformer_dropout", "0.2",
                "--attn_cheap_dropout", "on", "--speed_rate", "0.9,1.0,1.1"]


def test_resume_equals_uninterrupted_run(corpus, tmp_path):
    """Three epochs in one run (saving on a thread); then the run cut back
    to its epoch-1 checkpoint and resumed to the third epoch: with dither,
    speed/gain, SpecAugment, LSTM and transformer dropout (the head-shared
    mask) on, the same epoch sums, the same weights, the same momentum and
    schedule step, bit for bit."""
    d = corpus
    flags = [*MODEL_FLAGS, *TRAIN_FLAGS, *RANDOM_FLAGS, "--cmvn_stats", str(d / "cmvn.stats"),
             "--device", "cpu", "--num_epochs", "3"]
    flags[flags.index(None)] = str(d / "fbank1.conf")
    data = str(d / "data.lst")
    train_main([data, str(tmp_path / "full.log"), str(tmp_path / "full"), *flags,
                "--async_save"])
    shutil.copytree(tmp_path / "full", tmp_path / "part")
    shutil.rmtree(tmp_path / "part" / "ckpt" / "2")
    shutil.rmtree(tmp_path / "part" / "model.epoch.2")
    train_main([data, str(tmp_path / "resumed.log"), str(tmp_path / "part"), *flags,
                "--resume"])
    full = (tmp_path / "full.log").read_text()
    resumed = (tmp_path / "resumed.log").read_text()
    assert "resumed from epoch 1 (optimizer state included)" in resumed

    def losses(text):
        return re.findall(r"Overall Avg Loss: ([0-9.]+)", text)

    assert len(losses(full)) == 3 and losses(resumed) == losses(full)[2:]
    a = restore_checkpoint(str(tmp_path / "full" / "ckpt"))
    b = restore_checkpoint(str(tmp_path / "part" / "ckpt"))
    assert a["metadata"] == b["metadata"] == {"epoch": 2}
    assert a["optimizer"]["count"] == b["optimizer"]["count"] >= 6  # 3 epochs of 2-3 steps
    for k, x in a["model"].items():
        assert torch.equal(x, b["model"][k]), k
    moms = [s["momentum_buffer"] for s in a["optimizer"]["optimizer"]["state"].values()]
    moms_b = [s["momentum_buffer"] for s in b["optimizer"]["optimizer"]["state"].values()]
    assert len(moms) == len(moms_b) > 20
    assert all(torch.equal(x, y) for x, y in zip(moms, moms_b))
    bundle_a, _ = load_bundle(str(tmp_path / "full" / "model.epoch.2"), device="cpu")
    bundle_b, _ = load_bundle(str(tmp_path / "part" / "model.epoch.2"), device="cpu")
    for (k, x), y in zip(bundle_a.state_dict().items(), bundle_b.state_dict().values()):
        assert torch.equal(x, y), k
    # the trained bundle decodes in the port's decode CLI
    wer = eval_main([str(tmp_path / "part" / "model.epoch.2"), str(d / "wav.scp"),
                     str(tmp_path / "nbest.txt"), "--device", "cpu", "--feats_dim", str(MEL),
                     "--max_wav_seconds", "1.0", "--batch_size", "4", "--beam_size", "2",
                     "--n_best", "2", "--max_symbols", "6", "--cmvn_stats", str(d / "cmvn.stats"),
                     "--ref_labels", f"ark:{d}/label.txt"])
    assert wer is not None
    assert len((tmp_path / "nbest.txt").read_text().splitlines()) == N_UTTS * 2


@pytest.mark.parametrize("flags,field", [
    (["--pruned_loss_range", "4"], "simple_joint"), (["--decoder_type", "transformer"],
                                                     "decoder_type")])
def test_unported_flags_raise(corpus, tmp_path, flags, field):
    """The flags that raised until their paths were ported (the pruned loss,
    the transformer prediction net) now train an epoch and save a bundle of
    their configuration (tests/test_torch_pruned_cli.py and
    tests/test_torch_conv_lm_cli.py hold them to the JAX CLI)."""
    d = corpus
    train_main([str(d / "data.lst"), str(tmp_path / "log"), str(tmp_path / "out"),
                *MODEL_FLAGS, *TRAIN_FLAGS, *flags, "--feat_config", str(d / "fbank0.conf"),
                "--cmvn_stats", str(d / "cmvn.stats"), "--num_epochs", "1", "--device", "cpu"])
    model, _ = load_bundle(str(tmp_path / "out" / "model.epoch.0"), device="cpu")
    assert getattr(model.config, field) in (True, "transformer")
    assert "Training Finished" in (tmp_path / "log").read_text()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_entry_points_need_a_named_device_without_a_card(corpus, tmp_path):
    d = corpus
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main([str(d / "data.lst"), str(tmp_path / "log"), str(tmp_path / "out"),
                    *MODEL_FLAGS])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prep_main(["wav_to_bytes", str(d / "wav.scp"), str(tmp_path / "bytes.txt")])
