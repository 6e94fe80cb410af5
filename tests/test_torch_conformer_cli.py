"""The Conformer encoder through the port's normal entry points on the CPU:
the training CLI builds it from ``--encoder_type conformer`` and the
``--conformer_*`` flags and trains an epoch, its bundle carries the new
fields through ``dataclasses.asdict`` and back, the decode CLI reads that
bundle; ``beam_search_features`` and the eval step run on a tiny
conformer; ``rnn`` and ``transformer`` still build what they built.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_conformer_cli.py -q
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from pika_tpu_torch.data.kaldi_ark import write_matrix_ark
from pika_tpu_torch.data.scp import write_int_vectors
from pika_tpu_torch.decode.beam import BeamConfig, beam_search_features
from pika_tpu_torch.models.conformer import ConformerEncoder
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.train.bundle import load_bundle, save_bundle
from pika_tpu_torch.train.eval_transducer import main as eval_main
from pika_tpu_torch.train.step import make_eval_step, make_feats_featurizer
from pika_tpu_torch.train.train_transducer import build_parser, main as train_main, make_model

VOCAB, FEAT_DIM, N_UTTS = 6, 8, 8
CONFORMER = {"conformer_layers": 2, "conformer_d_model": 16, "conformer_heads": 4,
             "conformer_d_ff": 32, "conformer_kernel": 6, "conformer_dropout": 0.1}
FLAGS = ["--loader", "utt", "--feats_dim", str(FEAT_DIM), "--lctx", "0", "--rctx", "0",
         "--stride", "1", "--batch_size", "2", "--num_devices", "1", "--num_workers", "1",
         "--output_dim", str(VOCAB), "--dec_layers", "1", "--rnn_size", "16",
         "--embd_dim", "8", "--optim", "sgd", "--initial_lr", "0.003",
         "--final_lr", "0.001", "--grad_clip", "3.0", "--num_epochs", "1",
         "--num_batches_per_epoch", "4", "--seed", "3", "--log_per_n_frames", "1",
         "--device", "cpu", "--encoder_type", "conformer",
         *[x for k, v in CONFORMER.items() for x in (f"--{k}", str(v))]]
DECODE = ["--loader", "utt", "--feats_dim", str(FEAT_DIM), "--lctx", "0", "--rctx", "0",
          "--batch_size", "4", "--beam_size", "3", "--n_best", "3", "--max_symbols", "6",
          "--device", "cpu"]
TINY = TransducerConfig(input_dim=FEAT_DIM, vocab_size=VOCAB, hid_dim=16,
                        encoder_type="conformer", dec_layers=1, embd_dim=8, **CONFORMER)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Precomputed features of 20-40 frames and 3 labels an utterance."""
    d = tmp_path_factory.mktemp("conformer_cli")
    rng = np.random.default_rng(7)
    items, labels = [], []
    for i in range(N_UTTS):
        t = int(rng.integers(20, 40))
        items.append((f"utt{i}", rng.standard_normal((t, FEAT_DIM)).astype(np.float32)))
        labels.append((f"utt{i}", rng.integers(1, VOCAB, 3).tolist()))
    write_matrix_ark(str(d / "feats.ark"), items)
    write_int_vectors(str(d / "label.txt"), labels)
    return d


def test_training_cli_trains_and_decodes_a_conformer(corpus, capsys):
    d = corpus
    train_main([str(d / "feats.ark"), str(d / "train.log"), str(d / "out"),
                "--ali_rspec", f"ark:{d}/label.txt", *FLAGS])
    bundle = d / "out" / "model.epoch.0"
    spec = json.loads((bundle / "model.json").read_text())
    assert spec["config"]["encoder_type"] == "conformer"
    assert {k: spec["config"][k] for k in CONFORMER} == CONFORMER
    model, _ = load_bundle(str(bundle), device="cpu")
    assert isinstance(model.encoder, ConformerEncoder) and len(model.encoder.blocks) == 2
    assert dataclasses.asdict(model.config) == spec["config"]
    losses = [float(x.split()[1]) for x in (d / "train.log").read_text().splitlines()
              if x.startswith("Loss: ")]
    assert losses and all(math.isfinite(x) for x in losses)
    wer = eval_main([str(bundle), str(d / "feats.ark"), str(d / "nbest.txt"), *DECODE,
                     "--ref_labels", f"ark:{d}/label.txt"])
    capsys.readouterr()
    assert wer is not None
    assert len((d / "nbest.txt").read_text().splitlines()) == N_UTTS * 3


def test_bundle_round_trips_the_conformer_fields(tmp_path):
    model = init_transducer(TINY, torch.Generator().manual_seed(1), device="cpu")
    save_bundle(str(tmp_path / "b"), model)
    back, _ = load_bundle(str(tmp_path / "b"), device="cpu")
    assert back.config == TINY
    for (n, a), (m, b) in zip(model.state_dict().items(), back.state_dict().items()):
        assert n == m and torch.equal(a, b), n


def test_beam_search_and_eval_step():
    model = init_transducer(TINY, torch.Generator().manual_seed(2), device="cpu")
    assert all(torch.isfinite(p).all() for p in model.parameters())
    gen = torch.Generator().manual_seed(3)
    feats = torch.randn(3, 40, FEAT_DIM, generator=gen)
    feat_lens = torch.tensor([40, 31, 22])
    out = beam_search_features(model, feats, feat_lens,
                               BeamConfig(beam_size=3, n_best=3, max_symbols=6))
    assert torch.equal(out["enc_lens"], model.encoder_out_len(feat_lens))
    assert out["tokens"].shape[:2] == (3, 3)
    assert bool(torch.isfinite(out["scores"][:, 0]).all())
    step = make_eval_step(model, make_feats_featurizer())
    batch = {"feats": feats, "feat_lens": feat_lens,
             "labels": torch.randint(1, VOCAB, (3, 3), generator=gen),
             "label_lens": torch.tensor([3, 2, 3])}
    assert math.isfinite(float(step(batch)["loss"]))


@pytest.mark.parametrize("flag, built", [("rnn", "rnn"), ("transformer", "tdnn_transformer"),
                                         ("conformer", "conformer")])
def test_encoder_type_flag(flag, built):
    args = build_parser().parse_args(["d", "log", "out", "--encoder_type", flag,
                                      "--tdnn_layers", "5", "--tdnn_nhid", "16",
                                      "--rnn_size", "16", "--output_dim", str(VOCAB),
                                      "--embd_dim", "8",
                                      *[x for k, v in CONFORMER.items()
                                        for x in (f"--{k}", str(v))]])
    model, cfg = make_model(args, FEAT_DIM, torch.device("cpu"))
    assert cfg.encoder_type == built
    assert {k: getattr(cfg, k) for k in CONFORMER} == CONFORMER
