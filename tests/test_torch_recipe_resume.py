"""The quality recipes' two-phase curriculum (``egs/mini_synthetic.sh``
stages 3a and 3b) in the port's training CLI against the JAX CLI, on the
CPU: Adam with the warm-up's schedule (1e-3 -> 8e-4 over its epochs), then
``--resume`` into a longer run with a new schedule (1e-3 -> 5e-5 over all
epochs) and noise augmentation from the corpus' noise archive
(``--noise_lst --snr_range 10,30``), on top of the recipe's speed and gain
perturbation.  The existing CLI tests resume SGD at an unchanged schedule
only.

Both CLIs start from one JAX bundle and its ``bundle_from_flax`` conversion
at a tiny width, dropout and dither off, float32 attention, one loader
worker (the loaders' numpy draws are the same in both packages): each
epoch's summed loss to 1e-4 relative (``tests/test_torch_train_cli.py``'s
tolerance) and every update's learning rate to 1e-6 relative, the first
resumed one included (the schedule's step restored from the checkpoint,
the new schedule applied to it).  The final parameters are not compared:
Adam turns the float noise of a gradient that is zero in exact arithmetic
(a bias before a BatchNorm) into steps of the full learning rate."""

import inspect
import json

import jax
import numpy as np
import pytest
import torch

import pika_tpu.models.transformer as transformer_jax
import pika_tpu.train.lr as lr_jax
import pika_tpu.utils.logger as logger_jax
from pika_tpu.models.transducer import (
    TransducerConfig as ConfigJax,
    init_transducer as init_jax,
)
from pika_tpu.train.bundle import save_bundle as save_bundle_jax
from pika_tpu.train.train_transducer import main as train_main_jax
import pika_tpu_torch.models.transformer as transformer_pt
import pika_tpu_torch.train.lr as lr_pt
import pika_tpu_torch.utils.logger as logger_pt
from pika_tpu_torch.data import MrkSeqWriter, write_int_vectors, write_wav
from pika_tpu_torch.recipes.mini_synthetic import train_commands
from pika_tpu_torch.recipes.stages import Recipe, global_cmvn, set_flags, wav_to_seq
from pika_tpu_torch.train.bundle import bundle_from_flax
from pika_tpu_torch.train.train_transducer import main as train_main

torch.set_num_threads(1)

SR, MEL, VOCAB, N_UTTS = 16000, 20, 31, 12
WARMUP_EPOCHS, EPOCHS, BATCHES = 2, 3, 3
MODEL = dict(input_dim=3 * MEL, vocab_size=VOCAB, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="rnn", enc_layers=5, dec_layers=1, embd_dim=8, tdnn_nhid=32,
             tdnn_layers=5, dropout=0.0, tdnn_transformer_dropout=0.0)
# the recipe's flags at the tiny width and budget of MODEL
TINY = {"--enc_layers": "5", "--tdnn_nhid": "32", "--tdnn_layers": "5", "--rnn_size": "16",
        "--embd_dim": "8", "--dropout": "0", "--tdnn_transformer_dropout": "0",
        "--feats_dim": str(MEL), "--num_batches_per_epoch": str(BATCHES), "--batch_size": "4",
        "--max_wav_seconds": "1.0"}


@pytest.fixture
def f32_attention(monkeypatch):
    """Attention in float32 in both packages (as ``test_torch_train_cli.py``)."""
    init = transformer_jax.MultiHeadedAttention.__init__.__wrapped__
    names = [n for n in inspect.signature(init).parameters if n != "self"]
    defaults = list(init.__defaults__)
    defaults[names.index("mm_dtype") - (len(names) - len(defaults))] = None
    monkeypatch.setattr(init, "__defaults__", tuple(defaults))
    monkeypatch.setattr(transformer_pt, "_bf16", lambda x: x)


@pytest.fixture
def records(monkeypatch):
    """Each epoch's (summed loss, labels) and each update's (schedule step,
    learning rate), per package."""
    rec = {"jax": [], "pt": [], "lr_jax": [], "lr_pt": []}
    for key, module in (("jax", logger_jax), ("pt", logger_pt)):
        original = module.Logger.summarize_and_log

        def summarize(self, _original=original, _key=key):
            rec[_key].append((self.total_loss[0], self.total_frames))
            return _original(self)

        monkeypatch.setattr(module.Logger, "summarize_and_log", summarize)

    schedule_jax = lr_jax.exp_interp_schedule

    def traced_schedule(*args):
        schedule = schedule_jax(*args)

        def lr(count):
            value = schedule(count)
            jax.debug.callback(lambda c, v: rec["lr_jax"].append((int(c), float(v))), count,
                               value)
            return value

        return lr

    monkeypatch.setattr(lr_jax, "exp_interp_schedule", traced_schedule)
    step_pt = lr_pt.Optimizer.step

    def step(self):
        rec["lr_pt"].append((self.count, self.schedule(self.count)))
        step_pt(self)

    monkeypatch.setattr(lr_pt.Optimizer, "step", step)
    return rec


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 utterances of 0.8-1.0 s of noise with 2-4 labels and a noise
    archive of 3 clips (``noise.lst``, as the recipe's corpus writes it),
    their prep and CMVN through the port's stages, an fbank configuration
    without dither, and a JAX bundle of MODEL with its port conversion.
    (The recipe's formant corpus has runs of exact zeros, whose features sit
    at the log floor: at this width a BatchNorm unit alive on a frame or two
    makes both packages' gradients jump with the last bit of their inputs.)"""
    d = tmp_path_factory.mktemp("curriculum")
    train = d / "data" / "train"
    train.mkdir(parents=True)
    rng = np.random.default_rng(5)
    labels = []
    with open(train / "wav.scp", "w") as scp:
        for i in range(N_UTTS):
            pcm = (rng.standard_normal(int(rng.integers(int(0.8 * SR), SR))) * 3000)
            write_wav(str(train / f"u{i}.wav"), pcm.astype(np.int16), SR)
            scp.write(f"utt{i} {train}/u{i}.wav\n")
            labels.append((f"utt{i}", rng.integers(1, VOCAB, int(rng.integers(2, 5))).tolist()))
    write_int_vectors(str(train / "label.txt"), labels)
    with MrkSeqWriter(str(d / "data" / "noise.mrk"), str(d / "data" / "noise.seq")) as w:
        for i in range(3):
            w.write(f"noise{i}", (rng.standard_normal(2 * SR) * 2000).astype(np.int16))
        shards = list(w.shards)
    (d / "data" / "noise.lst").write_text("".join(f"{m} {s} -\n" for m, s in shards))
    conf = d / "fbank.conf"
    conf.write_text("--window-type=hamming\n--sample-frequency=16000\n--dither=0\n"
                    f"--low-freq=40\n--high-freq=-200\n--num-mel-bins={MEL}\n")
    recipe = Recipe(str(d), device="cpu")
    wav_to_seq(recipe, str(train), "train", str(conf))
    global_cmvn(recipe, str(train), "train", str(conf))
    cfg = ConfigJax(**MODEL)
    variables = jax.jit(lambda key: init_jax(key, cfg, max_t=64)[1])(jax.random.PRNGKey(3))
    variables = jax.tree.map(np.asarray, variables)
    save_bundle_jax(str(d / "jax_init"), "transducer", cfg, variables)
    with open(d / "jax_init" / "model.json") as f:
        bundle_from_flax(str(d / "pt_init"), json.load(f), variables)
    return d


def _phase_argv(d, out, phase):
    argv = train_commands(str(d / "data"), str(d / out), str(d / "fbank.conf"), WARMUP_EPOCHS,
                          EPOCHS)[phase]
    return set_flags(argv, TINY)


def test_two_phase_curriculum_matches_jax(corpus, f32_attention, records):
    d = corpus
    for out in ("jax", "pt"):
        (d / out).mkdir()
    warmup_steps = None
    for phase in ("train_warmup", "train"):
        train_main_jax([*_phase_argv(d, "jax", phase), "--init_model", str(d / "jax_init"),
                        "--steps_per_dispatch", "1"])
        train_main([*_phase_argv(d, "pt", phase), "--init_model", str(d / "pt_init"),
                    "--device", "cpu"])
        warmup_steps = warmup_steps or len(records["lr_pt"])
    ref, got = records["jax"], records["pt"]
    assert len(ref) == len(got) == EPOCHS
    for (gl, gn), (rl, rn) in zip(got, ref):
        assert gn == rn > 0
        assert abs(gl - rl) <= 1e-4 * abs(rl), (gl, rl)
    for log in ("jax/train.log", "pt/train.log"):
        assert "resumed from epoch 1 (optimizer state included)" in (d / log).read_text()

    # every update's schedule step and learning rate; at the first resumed
    # update the step restored and the new schedule applied to it
    lr_ref, lr_got = records["lr_jax"], records["lr_pt"]
    assert [c for c, _ in lr_got] == [c for c, _ in lr_ref] == list(range(len(lr_got)))
    assert len(lr_got) > warmup_steps >= WARMUP_EPOCHS
    for (_, lr), (_, want) in zip(lr_got, lr_ref):
        assert abs(lr - want) <= 1e-6 * want
    total = EPOCHS * BATCHES
    assert lr_got[warmup_steps][1] == pytest.approx(
        1e-3 * (5e-5 / 1e-3) ** (warmup_steps / total), rel=1e-12)
    assert lr_got[warmup_steps - 1][1] == pytest.approx(
        1e-3 * 0.8 ** ((warmup_steps - 1) / (WARMUP_EPOCHS * BATCHES)), rel=1e-12)
