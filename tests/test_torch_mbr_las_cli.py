"""The port's second-stage training CLIs against the JAX CLIs on the CPU,
in-process on one 12-utterance corpus (the training CLI's test corpus),
from the same bundles (JAX bundles and their ``bundle_from_flax``
conversions), with the random draws off (dither 0, no speed/gain, no
SpecAugment, dropout 0, scheduled sampling at 0), one loader worker and
float32 attention on both sides:

* MBR fine-tuning (``train/train_mbr.py``): each epoch's summed MBR and
  RNN-T losses to 1e-4 relative, the update of the parameters to 1e-3
  relative L2, ``model.tmp`` written at ``--tmp_save_batches``; a command
  line without ``--init_model`` exits;
* the LAS rescorer (``train/train_las.py``) on the frozen transducer
  encoder, forward and with ``--reverse_labels``: each epoch's summed loss
  to 1e-4 relative, the final weights to 1e-3 relative L2 (zero-initialised
  biases to 1e-2), the bundles' metadata;
* a multi-card launch that cannot be laid out raising, and the entry
  points raising without a device named on a machine without a card."""

import inspect
import json

import numpy as np
import jax
import pytest
import torch

import pika_tpu.data as data_jax
import pika_tpu.models.transformer as transformer_jax
import pika_tpu.utils.logger as logger_jax
from pika_tpu.models.las import LASConfig as LASConfigJax, init_las as init_las_jax
from pika_tpu.models.transducer import TransducerConfig as ConfigJax, init_transducer as init_jax
from pika_tpu.train.bundle import load_bundle as load_bundle_jax, save_bundle as save_bundle_jax
from pika_tpu.train.train_las import main as las_main_jax
from pika_tpu.train.train_mbr import main as mbr_main_jax
import pika_tpu_torch.models.transformer as transformer_pt
import pika_tpu_torch.utils.logger as logger_pt
from pika_tpu_torch.convert import state_dict_from_flax
from pika_tpu_torch.data.prep import main as prep_main
from pika_tpu_torch.train.bundle import bundle_from_flax, load_bundle
from pika_tpu_torch.train.train_las import main as las_main
from pika_tpu_torch.train.train_mbr import main as mbr_main

torch.set_num_threads(1)

SR = 16000
VOCAB = 10
MEL = 20
N_UTTS = 12
EPOCHS = 2
MODEL = dict(input_dim=3 * MEL, vocab_size=VOCAB, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="rnn", enc_layers=5, dec_layers=2, embd_dim=8, tdnn_nhid=32,
             tdnn_layers=5, dropout=0.0, tdnn_transformer_dropout=0.0)
FLAGS = ["--feats_dim", str(MEL), "--lctx", "1", "--rctx", "1", "--batch_size", "4",
         "--num_workers", "1", "--max_wav_seconds", "1.0", "--initial_lr", "0.003",
         "--final_lr", "0.001", "--grad_clip", "3.0", "--momentum", "0.9",
         "--num_batches_per_epoch", "3", "--dp_mode", "sync", "--num_devices", "1",
         "--beam_size", "3", "--sm_scale", "1.2", "--rnnt_scale", "0.1",
         "--decode_max_symbols", "6", "--loss_chunk", "8", "--no_augment", "--num_epochs", str(EPOCHS),
         "--tmp_save_batches", "2"]
# the LAS rescorer: labels 1..9, EOS 10, pad 11, on the encoder's output
LAS_CFG = dict(input_dim=16, output_dim=VOCAB + 1, pad_idx=VOCAB + 1, rnn_size=12, enc_layers=2,
               dec_layers=2, embd_dim=6)
LAS_FLAGS = ["--feats_dim", str(MEL), "--lctx", "1", "--rctx", "1", "--batch_size", "4",
             "--num_workers", "1", "--max_wav_seconds", "1.0", "--optim", "adam",
             "--initial_lr", "0.001", "--final_lr", "0.0001", "--num_batches_per_epoch", "3",
             "--dp_mode", "sync", "--num_devices", "1", "--no_augment", "--num_epochs", "2",
             "--SOS", "0", "--EOS", str(VOCAB), "--padding_tgt", str(VOCAB + 1),
             "--padding_idx", str(VOCAB + 1), "--output_dim", str(VOCAB + 1)]


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
    """Each Logger's (summed losses, labels) at its epoch summary, per
    package."""
    sums = {"jax": [], "pt": []}
    for key, module in (("jax", logger_jax), ("pt", logger_pt)):
        original = module.Logger.summarize_and_log

        def record(self, _original=original, _key=key):
            sums[_key].append((list(self.total_loss), self.total_frames))
            return _original(self)

        monkeypatch.setattr(module.Logger, "summarize_and_log", record)
    return sums


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 utterances of 0.8-1.0 s of noise with 2-4 labels as mrk/seq
    archives through the port's prep, their CMVN statistics, an fbank
    configuration without dither, and a JAX bundle of a tiny model with its
    port conversion."""
    d = tmp_path_factory.mktemp("mbr_cli")
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
    spec = json.loads((d / "jax_init" / "model.json").read_text())
    bundle_from_flax(str(d / "pt_init"), spec, variables)
    las_cfg = LASConfigJax(**LAS_CFG)
    las_v = jax.jit(lambda key: init_las_jax(key, las_cfg)[1])(jax.random.PRNGKey(8))
    las_v = jax.tree.map(np.asarray, las_v)
    save_bundle_jax(str(d / "jax_las"), "las", las_cfg, las_v)
    spec = json.loads((d / "jax_las" / "model.json").read_text())
    bundle_from_flax(str(d / "pt_las"), spec, las_v)
    return d


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def test_mbr_cli_matches_jax(corpus, f32_attention, epoch_sums):
    d = corpus
    data = [str(d / "data.lst")]
    flags = [*FLAGS, "--feat_config", str(d / "fbank.conf"), "--cmvn_stats", str(d / "cmvn.stats")]
    mbr_main_jax([*data, str(d / "jax.log"), str(d / "jax"), *flags,
                  "--init_model", str(d / "jax_init")])
    mbr_main([*data, str(d / "pt.log"), str(d / "pt"), *flags, "--init_model", str(d / "pt_init"),
              "--device", "cpu"])
    ref, got = epoch_sums["jax"], epoch_sums["pt"]
    assert len(ref) == len(got) == EPOCHS
    for (g_losses, g_n), (r_losses, r_n) in zip(got, ref):
        assert g_n == r_n > 0
        for g, r in zip(g_losses, r_losses):
            assert abs(g - r) <= 1e-4 * abs(r), (g_losses, r_losses)
    logs = [(d / f"{k}.log").read_text() for k in ("jax", "pt")]
    for log in logs:
        assert log.startswith("MBR fine-tuning: devices 1 (sync), processes 1, beam 3\n")
        assert log.count("Overall Avg MBR Loss") == EPOCHS and log.endswith("Training Finished\n")
    assert (d / "pt" / "model.tmp" / "model.pt").exists()
    _, variables, _ = load_bundle_jax(str(d / "jax" / f"model.epoch.{EPOCHS - 1}"))
    ref_sd = state_dict_from_flax(jax.tree.map(np.asarray, variables))
    model, meta = load_bundle(str(d / "pt" / f"model.epoch.{EPOCHS - 1}"), device="cpu")
    init, _ = load_bundle(str(d / "pt_init"), device="cpu")
    assert meta == {"epoch": EPOCHS - 1}
    # the whole update (final - initial, every tensor) to 1e-3 relative L2
    # (measured: 4e-5); each tensor to 1e-2 (the encoder's zero-initialised
    # biases behind its BatchNorms drift apart fastest, twofold per epoch:
    # 3.6e-3 after 2 epochs, 2e-6 after the encoder)
    changed = 0
    got_d, ref_d = [], []
    for name, x in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        g, r, i = x.numpy(), ref_sd[name].numpy(), init.state_dict()[name].numpy()
        if np.abs(r).max() < 1e-6:
            assert np.abs(g - r).max() < 1e-6, name
        else:
            assert _rel_l2(g, r) < 1e-2, (name, _rel_l2(g, r))
        got_d.append((g - i).ravel())
        ref_d.append((r - i).ravel())
        changed += not torch.equal(x, init.state_dict()[name])
    assert _rel_l2(np.concatenate(got_d), np.concatenate(ref_d)) < 1e-3
    assert changed > 20  # the runs trained


@pytest.mark.parametrize("reverse", [False, True])
def test_las_cli_matches_jax(corpus, f32_attention, epoch_sums, reverse):
    d = corpus
    tag = "las_bw" if reverse else "las_fw"
    flags = [*LAS_FLAGS, "--feat_config", str(d / "fbank.conf"), "--cmvn_stats",
             str(d / "cmvn.stats"), *(["--reverse_labels"] if reverse else [])]
    las_main_jax([str(d / "data.lst"), str(d / f"{tag}_jax.log"), str(d / f"{tag}_jax"), *flags,
                  "--shared_encoder_model", str(d / "jax_init"), "--init_model",
                  str(d / "jax_las")])
    las_main([str(d / "data.lst"), str(d / f"{tag}_pt.log"), str(d / f"{tag}_pt"), *flags,
              "--shared_encoder_model", str(d / "pt_init"), "--init_model", str(d / "pt_las"),
              "--device", "cpu"])
    ref, got = epoch_sums["jax"], epoch_sums["pt"]
    assert len(ref) == len(got) == 2
    for (g_losses, g_n), (r_losses, r_n) in zip(got, ref):
        assert g_n == r_n > 0
        assert abs(g_losses[0] - r_losses[0]) <= 1e-4 * abs(r_losses[0]), (g_losses, r_losses)
    logs = [(d / f"{tag}_{k}.log").read_text() for k in ("jax", "pt")]
    for log in logs:
        assert log.startswith("LAS training: devices 1 (sync), processes 1\n")
        assert "===> Epoch 1 (sampling_prob 0.0) <===" in log
        assert log.count("Overall Avg Loss") == 2 and log.endswith("Training Finished\n")
    _, variables, ref_meta = load_bundle_jax(str(d / f"{tag}_jax" / "model.epoch.1"))
    ref_sd = state_dict_from_flax(jax.tree.map(np.asarray, variables))
    model, meta = load_bundle(str(d / f"{tag}_pt" / "model.epoch.1"), device="cpu")
    assert meta == ref_meta == {"epoch": 1, "reverse_labels": reverse, "las_input": "enc"}
    init, _ = load_bundle(str(d / "pt_las"), device="cpu")
    # biases initialised at 0 hold only their Adam updates, whose float32
    # error grows where successive gradients cancel (measured: 1.8e-3 after
    # 6 steps on attn_linear_query_b): those to 1e-2
    changed = 0
    for name, x in model.state_dict().items():
        tol = 1e-2 if not init.state_dict()[name].any() else 1e-3
        assert _rel_l2(x.numpy(), ref_sd[name].numpy()) < tol, name
        changed += not torch.equal(x, init.state_dict()[name])
    assert changed > 20  # the runs trained


def test_mbr_cli_requires_init_model(tmp_path):
    with pytest.raises(SystemExit, match="requires --init_model"):
        mbr_main(["data.lst", str(tmp_path / "log"), str(tmp_path / "out"), "--device", "cpu"])


@pytest.mark.parametrize("main", [mbr_main, las_main], ids=["mbr", "las"])
@pytest.mark.parametrize("flags,what", [
    (["--num_processes", "2"], "needs --coordinator_address"),
    (["--num_devices", "3", "--num_processes", "2", "--coordinator_address", "127.0.0.1:1"],
     "does not split"),
    (["--num_processes", "2", "--process_id", "2", "--coordinator_address", "127.0.0.1:1"],
     "outside")])
def test_multi_card_modes_raise(main, flags, what, tmp_path):
    """The multi-card modes run (``tests/test_torch_dist_mbr_las.py``); a
    launch that cannot be laid out raises before any work."""
    with pytest.raises(ValueError, match=what):
        main(["data.lst", str(tmp_path / "log"), str(tmp_path / "out"), "--device", "cpu",
              "--init_model", "bundle", *flags])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_entry_points_need_a_named_device_without_a_card(corpus, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mbr_main([str(corpus / "data.lst"), str(tmp_path / "log"), str(tmp_path / "out"),
                  "--init_model", str(corpus / "pt_init")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        las_main([str(corpus / "data.lst"), str(tmp_path / "log"), str(tmp_path / "out"),
                  "--shared_encoder_model", str(corpus / "pt_init")])
