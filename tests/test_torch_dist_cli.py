"""The port's training CLI across ranks (``--num_devices 2 --device cpu``:
two gloo workers spawned by the CLI) against the JAX CLI on a 2-device mesh
(``--num_devices 2`` of the conftest's virtual CPU devices), in-process, on
the ``--loader utt`` corpus and flags of ``tests/test_multihost.py`` (16
utterances of precomputed features, batch 1 per rank, no random draws:
dropout 0, no augmentation), from one JAX bundle and its
``bundle_from_flax`` conversion, one epoch:

* ``--dp_mode sync`` with a tiny TDNN-Transformer encoder and float32
  attention on both sides: the summed gradient and the BatchNorm's global
  moments (an averaged gradient or per-rank moments give another update);
  at the training CLI test's learning rate (0.003 -> 0.0001): at 0.05 this
  tiny BatchNorm model is chaotic, and the JAX CLI's own 1- and 2-device
  runs part after 4 steps;
* ``--dp_mode bmuf`` with the rnn encoder and prediction net
  (``--sync_period 2 --block_momentum 0.5``), as the JAX package's own
  multi-process test runs it.

Each logged loss within 2e-3 of the JAX CLI's (3 decimals printed), the
parameters' update (final - initial, all tensors) to 1e-3 relative L2 and
each tensor to 1e-2 (a zero-initialised bias holds only its updates); the
log headers alike.  ``tests/test_torch_dist_forms.py`` holds the launch
forms, the resume and the NaN stop on this corpus; the MBR and LAS CLIs
are in ``tests/test_torch_dist_mbr_las.py``.  Spawned runs have their own
timeouts (the CLI's process-group timeout).  The spawned workers import
this module, which imports JAX only inside the functions that run it.
"""

import inspect
import json
import re

import numpy as np
import pytest
import torch

import pika_tpu_torch.models.transformer as transformer_pt
from pika_tpu_torch.convert import state_dict_from_flax
from pika_tpu_torch.data.kaldi_ark import write_matrix_ark
from pika_tpu_torch.data.scp import write_int_vectors
from pika_tpu_torch.parallel.mesh import local_rendezvous
from pika_tpu_torch.train import common
from pika_tpu_torch.train.bundle import bundle_from_flax, load_bundle
from pika_tpu_torch.train.train_transducer import build_parser, main as train_main, run

torch.set_num_threads(1)

VOCAB, FEAT_DIM, N_UTTS = 6, 8, 16
FLAGS = ["--loader", "utt", "--feats_dim", str(FEAT_DIM), "--lctx", "0", "--rctx", "0",
         "--stride", "1", "--batch_size", "1", "--num_devices", "2", "--num_workers", "1",
         "--output_dim", str(VOCAB), "--enc_layers", "1", "--dec_layers", "1", "--rnn_size", "16",
         "--embd_dim", "8", "--dropout", "0.0", "--optim", "sgd", "--initial_lr", "0.05",
         "--final_lr", "0.05", "--grad_clip", "3.0", "--num_epochs", "1",
         "--num_batches_per_epoch", "2", "--seed", "3", "--steps_per_dispatch", "1",
         "--log_per_n_frames", "1"]
BMUF = ["--dp_mode", "bmuf", "--sync_period", "2", "--block_momentum", "0.5"]
RNN = dict(input_dim=FEAT_DIM, vocab_size=VOCAB, hid_dim=16, encoder_type="rnn",
           decoder_type="rnn", enc_layers=1, dec_layers=1, embd_dim=8)
TDNN = dict(RNN, encoder_type="tdnn_transformer", enc_layers=5, tdnn_layers=5, tdnn_nhid=32,
            tdnn_transformer_dropout=0.0)
# frames per utterance: the rnn corpus's, and enough for the TDNN's 18 frames of context
FRAMES = {"rnn": (8, 12), "tdnn": (40, 60)}


@pytest.fixture
def f32_attention(monkeypatch):
    """The JAX layer's attention in float32 (its ``mm_dtype`` default set
    to None); the port's ranks make theirs float32 in ``_f32_rank``."""
    import pika_tpu.models.transformer as transformer_jax

    init = transformer_jax.MultiHeadedAttention.__init__.__wrapped__
    names = [n for n in inspect.signature(init).parameters if n != "self"]
    defaults = list(init.__defaults__)
    defaults[names.index("mm_dtype") - (len(names) - len(defaults))] = None
    monkeypatch.setattr(init, "__defaults__", tuple(defaults))


def _identity(x):
    return x


def _f32_rank(local_rank: int, argv: list, init: str) -> None:
    """One of the port CLI's two ranks, as ``common.launch`` starts it,
    with the attention's bf16 rounding made the identity."""
    transformer_pt._bf16 = _identity
    common._run_rank(local_rank, build_parser().parse_args(argv), run, "cpu", 2, 0, init, 1)


def _corpus(d, kind: str, model: dict, nan: bool = False) -> None:
    """Features and labels from a seed (every rank reads the same arks),
    a JAX bundle of ``model`` and its port conversion."""
    rng = np.random.default_rng(5)
    items, labels = [], []
    for i in range(N_UTTS):
        t = int(rng.integers(*FRAMES[kind]))
        x = rng.standard_normal((t, FEAT_DIM)).astype(np.float32)
        items.append((f"utt{i}", np.full_like(x, np.nan) if nan else x))
        labels.append((f"utt{i}", rng.integers(1, VOCAB, 3).tolist()))
    write_matrix_ark(str(d / "feats.ark"), items)
    write_int_vectors(str(d / "label.txt"), labels)
    import jax
    from pika_tpu.models.transducer import TransducerConfig as ConfigJax, init_transducer
    from pika_tpu.train.bundle import save_bundle

    cfg = ConfigJax(**model)
    variables = jax.jit(lambda key: init_transducer(key, cfg, max_t=64)[1])(
        jax.random.PRNGKey(3))
    variables = jax.tree.map(np.asarray, variables)
    save_bundle(str(d / "jax_init"), "transducer", cfg, variables)
    bundle_from_flax(str(d / "pt_init"), json.loads((d / "jax_init" / "model.json").read_text()),
                     variables)


@pytest.fixture(scope="module")
def rnn_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_rnn")
    _corpus(d, "rnn", RNN)
    return d


def _argv(d, out: str, *extra, init: str = "pt_init") -> list:
    return [str(d / "feats.ark"), str(d / f"{out}.WORKER-ID.log"), str(d / out),
            "--ali_rspec", f"ark:{d}/label.txt", *FLAGS, "--init_model", str(d / init), *extra]


def _losses(log: str) -> list:
    return [float(x) for x in re.findall(r"^Loss: (\S+)", log, re.M)]


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _check_against_jax(d, tag: str, *extra, f32: bool = False) -> None:
    import jax
    from pika_tpu.train.bundle import load_bundle as load_bundle_jax
    from pika_tpu.train.train_transducer import main as train_main_jax

    train_main_jax(_argv(d, f"{tag}_jax", *extra, init="jax_init"))
    argv = _argv(d, f"{tag}_pt", *extra, "--device", "cpu")
    if f32:
        with local_rendezvous() as init:
            torch.multiprocessing.start_processes(
                _f32_rank, args=(argv, init), nprocs=2, join=True, start_method="spawn")
    else:
        train_main(argv)
    ref_log = (d / f"{tag}_jax.0.log").read_text()
    log = (d / f"{tag}_pt.0.log").read_text()
    head = lambda text: text[text.index("devices"):text.index("model size")]
    assert head(log) == head(ref_log)
    assert log.endswith("Training Finished\n")
    got, ref = _losses(log), _losses(ref_log)
    assert len(got) == len(ref) > 0
    np.testing.assert_allclose(got, ref, atol=2e-3)
    _, variables, _ = load_bundle_jax(str(d / f"{tag}_jax" / "model.epoch.0"))
    ref_sd = state_dict_from_flax(jax.tree.map(np.asarray, variables))
    model, _ = load_bundle(str(d / f"{tag}_pt" / "model.epoch.0"), device="cpu")
    init, _ = load_bundle(str(d / "pt_init"), device="cpu")
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
    update = np.concatenate(ref_d)
    assert np.linalg.norm(update) > 0
    assert _rel_l2(np.concatenate(got_d), update) < 1e-3


def test_sync_with_batch_norm_matches_jax(tmp_path, f32_attention):
    _corpus(tmp_path, "tdnn", TDNN)
    _check_against_jax(tmp_path, "sync", "--initial_lr", "0.003", "--final_lr", "0.0001",
                       f32=True)


def test_bmuf_rnn_matches_jax(rnn_corpus):
    _check_against_jax(rnn_corpus, "bmuf", *BMUF)
