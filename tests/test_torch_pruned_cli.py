"""The training CLI with the pruned objective (``--pruned_loss_range 4
--pruned_warmup_epochs 1``, 2 epochs: a warm epoch with the banded term at
0.1, then a full one) against the JAX CLI on the CPU, in-process, on 16
utterances of precomputed features (``--loader utt``), from one JAX bundle
of a tiny rnn-encoder transducer with the simple joint's heads and its
``bundle_from_flax`` conversion, with no random draws (dropout 0, no
augmentation):

* ``--dp_mode sync`` on one rank: each logged loss within 2e-3 of the JAX
  CLI's (3 decimals printed), the update of the parameters (final -
  initial, the simple heads' included) to 1e-3 relative L2 and each tensor
  to 1e-2, validation lines alike;
* ``--dp_mode bmuf`` over 2 ranks (``--num_devices 2 --device cpu``: two
  gloo workers) against the JAX CLI on a 2-device mesh, the same
  tolerances (as ``tests/test_torch_dist_cli.py`` holds BMUF);
* the decode CLIs on the JAX-trained bundle, whose simple heads they leave
  unused (the port's on its conversion): the same N-best file."""

import json
import re

import numpy as np
import jax
import pytest
import torch

from pika_tpu.models.transducer import TransducerConfig as ConfigJax, init_transducer as init_jax
from pika_tpu.train.bundle import load_bundle as load_bundle_jax, save_bundle as save_bundle_jax
from pika_tpu.train.eval_transducer import main as eval_main_jax
from pika_tpu.train.train_transducer import main as train_main_jax
from pika_tpu_torch.convert import state_dict_from_flax
from pika_tpu_torch.data.kaldi_ark import write_matrix_ark
from pika_tpu_torch.data.scp import write_int_vectors
from pika_tpu_torch.train.bundle import bundle_from_flax, load_bundle
from pika_tpu_torch.train.eval_transducer import main as eval_main
from pika_tpu_torch.train.train_transducer import main as train_main

torch.set_num_threads(1)

VOCAB, FEAT_DIM, N_UTTS = 6, 8, 16
MODEL = dict(input_dim=FEAT_DIM, vocab_size=VOCAB, hid_dim=16, encoder_type="rnn",
             decoder_type="rnn", enc_layers=1, dec_layers=1, embd_dim=8, simple_joint=True)
FLAGS = ["--loader", "utt", "--feats_dim", str(FEAT_DIM), "--lctx", "0", "--rctx", "0",
         "--stride", "1", "--num_workers", "1", "--output_dim", str(VOCAB), "--enc_layers", "1",
         "--dec_layers", "1", "--rnn_size", "16", "--embd_dim", "8", "--dropout", "0.0",
         "--optim", "sgd", "--initial_lr", "0.05", "--final_lr", "0.05", "--grad_clip", "3.0",
         "--num_epochs", "2", "--num_batches_per_epoch", "4", "--seed", "3",
         "--steps_per_dispatch", "1", "--log_per_n_frames", "1",
         "--pruned_loss_range", "4", "--pruned_warmup_epochs", "1", "--simple_loss_scale", "0.5"]
RUNS = {"sync": ["--dp_mode", "sync", "--num_devices", "1", "--batch_size", "2"],
        "bmuf": ["--dp_mode", "bmuf", "--num_devices", "2", "--batch_size", "1",
                 "--sync_period", "2", "--block_momentum", "0.5"]}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Features of 8-12 frames with 3 labels each (every rank reads the same
    arks), a JAX bundle with the simple heads and its port conversion."""
    d = tmp_path_factory.mktemp("pruned_cli")
    rng = np.random.default_rng(5)
    items, labels = [], []
    for i in range(N_UTTS):
        items.append((f"utt{i}", rng.standard_normal((int(rng.integers(8, 12)), FEAT_DIM))
                      .astype(np.float32)))
        labels.append((f"utt{i}", rng.integers(1, VOCAB, 3).tolist()))
    write_matrix_ark(str(d / "feats.ark"), items)
    write_int_vectors(str(d / "label.txt"), labels)
    cfg = ConfigJax(**MODEL)
    variables = jax.jit(lambda key: init_jax(key, cfg, max_t=64)[1])(jax.random.PRNGKey(3))
    variables = jax.tree.map(np.asarray, variables)
    save_bundle_jax(str(d / "jax_init"), "transducer", cfg, variables)
    bundle_from_flax(str(d / "pt_init"), json.loads((d / "jax_init" / "model.json").read_text()),
                     variables)
    return d


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _losses(log: str) -> list:
    return [float(x) for x in re.findall(r"^Loss: (\S+)", log, re.M)]


@pytest.mark.parametrize("mode", ["sync", "bmuf"])
def test_pruned_cli_matches_jax(corpus, mode):
    d = corpus

    def argv(tag, init, *extra):
        return [str(d / "feats.ark"), str(d / f"{tag}.WORKER-ID.log"), str(d / tag),
                "--ali_rspec", f"ark:{d}/label.txt", *FLAGS, *RUNS[mode],
                "--init_model", str(d / init), *extra]

    train_main_jax(argv(f"{mode}_jax", "jax_init"))
    train_main(argv(f"{mode}_pt", "pt_init", "--device", "cpu"))
    ref_log = (d / f"{mode}_jax.0.log").read_text()
    log = (d / f"{mode}_pt.0.log").read_text()
    assert log.endswith("Training Finished\n") and log.count("Overall Avg Loss") == 2
    got, ref = _losses(log), _losses(ref_log)
    assert len(got) == len(ref) > 0
    np.testing.assert_allclose(got, ref, atol=2e-3)
    _, variables, _ = load_bundle_jax(str(d / f"{mode}_jax" / "model.epoch.1"))
    ref_sd = state_dict_from_flax(jax.tree.map(np.asarray, variables))
    model, _ = load_bundle(str(d / f"{mode}_pt" / "model.epoch.1"), device="cpu")
    init, _ = load_bundle(str(d / "pt_init"), device="cpu")
    assert model.config.simple_joint
    got_d, ref_d = [], []
    for name, x in model.state_dict().items():
        g, r, i = x.numpy(), ref_sd[name].numpy(), init.state_dict()[name].numpy()
        if np.abs(r).max() < 1e-6:
            assert np.abs(g - r).max() < 1e-6, name
        else:
            assert _rel_l2(g, r) < 1e-2, (name, _rel_l2(g, r))
        got_d.append((g - i).ravel())
        ref_d.append((r - i).ravel())
    assert not np.array_equal(model.simple_am.weight.detach().numpy(),
                              init.simple_am.weight.detach().numpy())
    assert _rel_l2(np.concatenate(got_d), np.concatenate(ref_d)) < 1e-3
    if mode == "sync":
        bundle_from_flax(str(d / "jax_trained"),
                         json.loads((d / "sync_jax" / "model.epoch.1" / "model.json").read_text()),
                         jax.tree.map(np.asarray, variables))
        flags = ["--loader", "utt", "--feats_dim", str(FEAT_DIM), "--lctx", "0", "--rctx", "0",
                 "--batch_size", "4",
                 "--beam_size", "3", "--n_best", "3", "--max_symbols", "24",
                 "--ref_labels", f"ark:{d}/label.txt"]
        wer_ref = eval_main_jax([str(d / "sync_jax" / "model.epoch.1"), str(d / "feats.ark"),
                                 str(d / "ref.txt"), *flags])
        wer = eval_main([str(d / "jax_trained"), str(d / "feats.ark"), str(d / "got.txt"),
                         "--device", "cpu", *flags])
        assert wer == wer_ref
        assert (d / "got.txt").read_bytes() == (d / "ref.txt").read_bytes()
        assert len((d / "got.txt").read_text().splitlines()) == N_UTTS * 3
