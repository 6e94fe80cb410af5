"""The port's inference slice end to end against the JAX package: the same
waveforms and weights through ``make_eval_step`` and
``greedy_decode_waveforms`` in both.  The losses agree to 1e-3 relative (bf16
rounding in attention); the greedy hypotheses and lengths are identical, at
any interval between the host's reads of the loop's device flag.  Also: the
package imports with JAX, Orbax and the JAX package blocked, and
``chip_smoke.py`` refuses to run without a CUDA card."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pika_tpu_torch
from pika_tpu.decode.greedy import greedy_decode_waveforms as greedy_jax
from pika_tpu.features.fbank import FbankConfig as FbankJax
from pika_tpu.models.transducer import (
    Transducer as TransducerJax,
    TransducerConfig as ConfigJax,
    init_transducer as init_jax,
)
from pika_tpu.train.step import (
    FeaturizerConfig as FeatJax,
    TrainState,
    make_eval_step as eval_step_jax,
    make_featurizer as featurizer_jax,
)
from pika_tpu_torch.convert import load_flax_variables
from pika_tpu_torch.decode.greedy import greedy_decode, greedy_decode_waveforms
from pika_tpu_torch.features.fbank import FbankConfig
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.train.step import FeaturizerConfig, make_eval_step, make_featurizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEL = 23
MODEL = dict(input_dim=3 * MEL, vocab_size=20, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="rnn", dec_layers=2, embd_dim=8, tdnn_nhid=32, tdnn_layers=5)
FBANK = dict(sample_frequency=16000, window_type="hamming", dither=0.0, num_mel_bins=MEL)
MAX_SAMPLES = 16000


def _init_jax_jit(key, cfg):
    """``init_transducer`` under jit (eager init takes seconds here)."""
    return TransducerJax(cfg), jax.jit(lambda k: init_jax(k, cfg, max_t=64)[1])(key)


@pytest.fixture(scope="module")
def slice_inputs():
    rng = np.random.default_rng(5)
    wav_lens = np.array([16000, 12000, 9000], np.int32)
    wavs = np.zeros((3, MAX_SAMPLES), np.float32)
    for i, n in enumerate(wav_lens):
        wavs[i, :n] = np.round(rng.standard_normal(n) * 3000)
    labels = rng.integers(1, 20, (3, 5)).astype(np.int32)
    label_lens = np.array([5, 3, 0], np.int32)
    cmvn_offset = (rng.standard_normal(3 * MEL) * 0.1 - 10.0).astype(np.float32)
    cmvn_scale = rng.uniform(0.2, 0.4, 3 * MEL).astype(np.float32)

    model, variables = _init_jax_jit(jax.random.PRNGKey(4), ConfigJax(**MODEL))
    v = jax.tree.map(np.asarray, variables)
    v["batch_stats"] = jax.tree.map(
        lambda x: x + rng.uniform(0.0, 0.2, x.shape).astype(np.float32), v["batch_stats"])
    return dict(wavs=wavs, wav_lens=wav_lens, labels=labels, label_lens=label_lens,
                offset=cmvn_offset, scale=cmvn_scale, model=model, variables=v)


def _port(s):
    model = init_transducer(TransducerConfig(**MODEL), torch.Generator().manual_seed(0),
                            device="cpu")
    load_flax_variables(model, s["variables"])
    featurizer = make_featurizer(
        FeaturizerConfig(fbank=FbankConfig(**FBANK), max_samples=MAX_SAMPLES, lctx=1, rctx=1),
        torch.from_numpy(s["offset"]), torch.from_numpy(s["scale"]), device="cpu")
    return model, featurizer


def _jax(s):
    return featurizer_jax(
        FeatJax(fbank=FbankJax(**FBANK), max_samples=MAX_SAMPLES, lctx=1, rctx=1),
        jnp.asarray(s["offset"]), jnp.asarray(s["scale"]))


def test_eval_loss_matches_jax(slice_inputs):
    s = slice_inputs
    v = s["variables"]
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"], opt_state=None,
                       batch_stats=v["batch_stats"])
    batch = {k: s[k] for k in ("wavs", "wav_lens", "labels", "label_lens")}
    ref = eval_step_jax(s["model"], _jax(s), loss_chunk=8, loss_backend="xla")(
        state, {k: jnp.asarray(x) for k, x in batch.items()})
    model, featurizer = _port(s)
    for backend in ("auto", "plain"):
        got = make_eval_step(model, featurizer, loss_chunk=8, loss_backend=backend)(
            {k: torch.from_numpy(x) for k, x in batch.items()})
        assert np.isfinite(got["loss"].item())
        np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]), rtol=1e-3)
        assert int(got["num_labels"]) == int(ref["num_labels"])


@pytest.fixture(scope="module")
def greedy_ref(slice_inputs):
    """The JAX package's greedy hypotheses of the slice's batch (shared by
    the tests below)."""
    s = slice_inputs
    hyps, lens = greedy_jax(s["model"], s["variables"], _jax(s), jnp.asarray(s["wavs"]),
                            jnp.asarray(s["wav_lens"]), max_symbols=12)
    return np.asarray(hyps), np.asarray(lens)


def test_greedy_decode_matches_jax(slice_inputs, greedy_ref):
    s = slice_inputs
    ref_hyps, ref_lens = greedy_ref
    model, featurizer = _port(s)
    hyps, lens = greedy_decode_waveforms(model, featurizer, torch.from_numpy(s["wavs"]),
                                         torch.from_numpy(s["wav_lens"]), max_symbols=12)
    assert hyps.dtype == torch.int32 and tuple(hyps.shape) == (3, 12)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_array_equal(hyps.numpy(), np.asarray(ref_hyps))
    assert int(lens.sum()) > 0  # the comparison exercised emissions


@pytest.mark.parametrize("steps_per_check", [1, 7])
def test_greedy_decode_check_intervals(slice_inputs, greedy_ref, steps_per_check):
    """The masked greedy loop gives test_greedy_decode_matches_jax's
    hypotheses whether the host reads the device flag every step or every
    7 steps."""
    s = slice_inputs
    ref_hyps, ref_lens = greedy_ref
    model, featurizer = _port(s)
    feats, feat_lens = featurizer(torch.from_numpy(s["wavs"]), torch.from_numpy(s["wav_lens"]))
    with torch.no_grad():
        enc = model.encode(feats, feat_lens)
    hyps, lens = greedy_decode(model, enc, model.encoder_out_len(feat_lens), max_symbols=12,
                               steps_per_check=steps_per_check)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_array_equal(hyps.numpy(), np.asarray(ref_hyps))


BLOCKED = ("jax", "flax", "optax", "orbax", "pika_tpu")


def test_imports_without_jax():
    """Every module of the port imports with jax, flax, optax, orbax and the
    JAX package blocked."""
    names = [m.name for m in pkgutil.walk_packages(pika_tpu_torch.__path__, "pika_tpu_torch.")]
    for name in ("pika_tpu_torch.ops.rnnt_kernels", "pika_tpu_torch.data.wavio",
                 "pika_tpu_torch.utils.dtypes", "pika_tpu_torch.train.bundle",
                 "pika_tpu_torch.train.eval_transducer", "pika_tpu_torch.decode.beam"):
        assert name in names
    code = ("import sys\n"
            f"for m in {BLOCKED!r}: sys.modules[m] = None\n"
            f"import importlib\nfor n in {names!r}: importlib.import_module(n)\n"
            f"assert not any(k.split('.')[0] in {BLOCKED!r} and v is not None "
            "for k, v in sys.modules.items())\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
    pattern = re.compile(r"^\s*(import|from)\s+(" + "|".join(BLOCKED) + r")\b", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "pika_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            assert not pattern.search(fh.read()), path


def _smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, script], cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA device, and alone in a directory, chip_smoke.py exits
    non-zero and prints no result line."""
    out = _smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    out = _smoke(tmp_path, str(alone))
    assert out.returncode != 0 and '"ok"' not in out.stdout
