"""The ``rnn`` encoder (``encoder_type="rnn"``, the JAX package's default) of
the port's ``Transducer`` against the JAX one, and the CLIs on it:

* on converted weights, uni- and bidirectional, ragged frame lengths: the
  encoder output (0 past each length), ``encoder_out_len`` (the identity),
  the full log-prob lattice and greedy decoding, at float32 rounding
  (rtol 1e-5, atol 1e-5; hypotheses equal);
* the independent golden of ``tests/golden/rnnt_tiny_torch.npz`` (made with
  torch's own ``nn.LSTM``): its lattice (rtol 1e-4, atol 1e-5, the
  tolerance ``tests/test_golden_torch.py`` holds the JAX model to) and its
  greedy hypotheses;
* the training CLI with ``--encoder_type rnn --brnn`` (two layers) against
  the JAX CLI for one epoch on the ``--loader utt`` corpus of
  ``tests/test_torch_dist_cli.py`` from one JAX bundle and its conversion:
  each logged loss within 2e-3 (3 decimals printed), the update to 1e-3
  relative L2;
* the decode CLI on the trained bundle (N-best lines and a WER), and both
  decode CLIs on the converted bundle: byte-identical N-best files.
"""

import json
import os

import numpy as np
import pytest
import torch

from pika_tpu_torch.convert import load_flax_variables
from pika_tpu_torch.decode.greedy import greedy_decode
from pika_tpu_torch.models.transducer import Transducer, TransducerConfig
from pika_tpu_torch.train.bundle import load_bundle
from pika_tpu_torch.train.eval_transducer import main as eval_main
from test_torch_dist_cli import FEAT_DIM, N_UTTS, RNN, _check_against_jax, _corpus

torch.set_num_threads(1)

GOLD = np.load(os.path.join(os.path.dirname(__file__), "golden", "rnnt_tiny_torch.npz"))
TINY = dict(input_dim=6, vocab_size=7, hid_dim=8, encoder_type="rnn", decoder_type="rnn",
            enc_layers=2, dec_layers=1, embd_dim=5)
RTOL = ATOL = 1e-5


def _models(brnn: bool):
    """The JAX model and variables (init under jit) and the port model
    holding the same weights."""
    import jax
    from pika_tpu.models.transducer import (
        Transducer as TransducerJax, TransducerConfig as ConfigJax, init_transducer)

    kw = dict(TINY, brnn=brnn)
    cfg = ConfigJax(**kw)
    variables = jax.jit(lambda k: init_transducer(k, cfg, max_t=16)[1])(jax.random.PRNGKey(1))
    pt = Transducer(TransducerConfig(**kw), device="cpu").eval()
    load_flax_variables(pt, jax.tree.map(np.asarray, variables))
    return TransducerJax(cfg), variables, pt


def _batch():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 11, TINY["input_dim"])).astype(np.float32)
    x_len = np.array([11, 6, 8], np.int32)
    y = rng.integers(1, TINY["vocab_size"], (3, 4)).astype(np.int32)
    y_len = np.array([4, 2, 3], np.int32)
    return x, x_len, y, y_len


@pytest.mark.parametrize("brnn", [False, True], ids=["uni", "bi"])
def test_encoder_lattice_and_greedy_match_jax(brnn):
    import jax
    import jax.numpy as jnp
    from pika_tpu.decode.greedy import greedy_decode as greedy_jax
    from pika_tpu.models.transducer import Transducer as TransducerJax

    model, variables, pt = _models(brnn)
    apply = jax.jit(model.apply, static_argnames=("method", "softmax"))
    x, x_len, y, y_len = _batch()
    enc_ref = np.asarray(apply(variables, jnp.asarray(x), jnp.asarray(x_len),
                               method=TransducerJax.encode))
    xt, xl = torch.from_numpy(x), torch.from_numpy(x_len)
    with torch.no_grad():
        enc = pt.encode(xt, xl)
        assert torch.equal(pt.encoder_out_len(xl), xl)
        np.testing.assert_allclose(enc.numpy(), enc_ref, rtol=RTOL, atol=ATOL)
        for b, n in enumerate(x_len):
            assert not enc[b, n:].any()  # packed-sequence semantics: 0 past the length
        lat = pt(xt, torch.from_numpy(y).long(), xl, torch.from_numpy(y_len)).numpy()
        hyps, lens = greedy_decode(pt, enc, xl, max_symbols=8)
    lat_ref = np.asarray(apply(variables, jnp.asarray(x), jnp.asarray(y), jnp.asarray(x_len),
                               jnp.asarray(y_len), softmax=True))
    for b in range(len(x)):
        tl, ul = int(x_len[b]), int(y_len[b])
        np.testing.assert_allclose(lat[b, :tl, :ul + 1], lat_ref[b, :tl, :ul + 1], rtol=RTOL,
                                   atol=ATOL)
    hyps_ref, lens_ref = greedy_jax(model, variables, jnp.asarray(enc_ref), jnp.asarray(x_len),
                                    max_symbols=8)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(lens_ref))
    for b, n in enumerate(np.asarray(lens_ref)):
        np.testing.assert_array_equal(hyps[b, :n].numpy(), np.asarray(hyps_ref)[b, :n])


def _golden_model() -> Transducer:
    """The golden's torch weights in the port's modules (torch layout on
    both sides; the concatenated joint split into its x and y halves)."""
    h = 16
    cfg = TransducerConfig(input_dim=10, vocab_size=8, hid_dim=h, enc_layers=2, dec_layers=2,
                           embd_dim=6)
    model = Transducer(cfg, device="cpu").eval()
    sd = {"embed.weight": GOLD["embed_weight"], "fc2.weight": GOLD["fc2_weight"],
          "fc2.bias": GOLD["fc2_bias"]}
    for name, key in (("fc1", "fc1"), ("gate", "fc_gate")):
        sd[f"{name}_x.weight"] = GOLD[f"{key}_weight"][:, :h]
        sd[f"{name}_y.weight"] = GOLD[f"{key}_weight"][:, h:]
        sd[f"{name}_y.bias"] = GOLD[f"{key}_bias"]
    for net, key in (("encoder", "enc"), ("decoder", "dec")):
        for k in range(2):
            sd[f"{net}.weight_ih_l{k}"] = GOLD[f"{key}_wih_l{k}"]
            sd[f"{net}.weight_hh_l{k}"] = GOLD[f"{key}_whh_l{k}"]
            sd[f"{net}.bias_l{k}"] = GOLD[f"{key}_b_l{k}"]
    model.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()})
    return model


def test_golden_lattice_and_greedy():
    model = _golden_model()
    x, x_len = torch.from_numpy(GOLD["x"]), torch.from_numpy(GOLD["x_len"])
    with torch.no_grad():
        lat = model(x, torch.from_numpy(GOLD["y"]).long(), x_len,
                    torch.from_numpy(GOLD["y_len"])).numpy()
        hyps, lens = greedy_decode(model, model.encode(x, x_len), x_len,
                                   max_symbols=2 * GOLD["y"].shape[1])
    for b in range(len(x_len)):
        tl, ul = int(GOLD["x_len"][b]), int(GOLD["y_len"][b])
        np.testing.assert_allclose(lat[b, :tl, :ul + 1], GOLD["logprobs"][b, :tl, :ul + 1],
                                   rtol=1e-4, atol=1e-5, err_msg=f"utt {b}")
    np.testing.assert_array_equal(lens.numpy(), GOLD["greedy_lens"])
    for b, n in enumerate(GOLD["greedy_lens"]):
        np.testing.assert_array_equal(hyps[b, :n].numpy(), GOLD["greedy_hyps"][b, :n])


DECODE = ["--loader", "utt", "--feats_dim", str(FEAT_DIM), "--lctx", "0", "--rctx", "0",
          "--batch_size", "4", "--beam_size", "3", "--n_best", "3", "--max_symbols", "6"]


def test_cli_brnn_matches_jax_and_decodes(tmp_path, capsys):
    d = tmp_path
    _corpus(d, "rnn", dict(RNN, enc_layers=2, brnn=True))
    _check_against_jax(d, "brnn", "--encoder_type", "rnn", "--brnn", "--enc_layers", "2",
                       "--num_devices", "1", "--batch_size", "2")
    spec = json.loads((d / "brnn_pt" / "model.epoch.0" / "model.json").read_text())
    assert spec["config"]["encoder_type"] == "rnn" and spec["config"]["brnn"]
    model, _ = load_bundle(str(d / "brnn_pt" / "model.epoch.0"), device="cpu")
    assert model.encoder.dirs == 2 and model.encoder.num_layers == 2
    refs = ["--ref_labels", f"ark:{d}/label.txt"]
    wer = eval_main([str(d / "brnn_pt" / "model.epoch.0"), str(d / "feats.ark"),
                     str(d / "trained.txt"), "--device", "cpu", *DECODE, *refs])
    assert wer is not None
    assert len((d / "trained.txt").read_text().splitlines()) == N_UTTS * 3

    from pika_tpu.train.eval_transducer import main as eval_main_jax

    wer_ref = eval_main_jax([str(d / "jax_init"), str(d / "feats.ark"), str(d / "ref.txt"),
                             *DECODE, *refs])
    wer = eval_main([str(d / "pt_init"), str(d / "feats.ark"), str(d / "got.txt"),
                     "--device", "cpu", *DECODE, *refs])
    capsys.readouterr()
    assert wer == wer_ref
    assert (d / "got.txt").read_bytes() == (d / "ref.txt").read_bytes()
