"""The port's features (pika_tpu_torch.features) against the JAX package:
fbank against ``make_fbank_fn`` and the float64 oracle ``fbank_numpy``, the
numpy helpers against their originals, splice with ragged ``frame_lens``,
stride and CMVN."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pika_tpu.features import fbank as fbank_jax
from pika_tpu.features import pipeline as pipeline_jax
from pika_tpu_torch.features import fbank as fbank_pt
from pika_tpu_torch.features import pipeline as pipeline_pt

torch.set_num_threads(1)

CONF = dict(sample_frequency=16000, window_type="hamming", dither=0.0,
            low_freq=40.0, high_freq=-200.0, num_mel_bins=80)


def _rel(got, ref):
    return np.abs(got - ref) / (np.abs(ref) + 1e-3)


@pytest.mark.parametrize("window", ["hamming", "povey", "hanning", "blackman", "rectangular"])
def test_numpy_helpers_equal_originals(window):
    kw = dict(CONF, window_type=window)
    cfg_pt, cfg_jax = fbank_pt.FbankConfig(**kw), fbank_jax.FbankConfig(**kw)
    assert dataclasses.asdict(cfg_pt) == dataclasses.asdict(cfg_jax)
    assert (cfg_pt.frame_length, cfg_pt.frame_shift, cfg_pt.padded_window_size) == \
        (cfg_jax.frame_length, cfg_jax.frame_shift, cfg_jax.padded_window_size)
    np.testing.assert_array_equal(fbank_pt.feature_window(cfg_pt), fbank_jax.feature_window(cfg_jax))
    np.testing.assert_array_equal(fbank_pt.mel_banks_matrix(cfg_pt),
                                  fbank_jax.mel_banks_matrix(cfg_jax))


def test_conf_parse_equal(tmp_path):
    conf = tmp_path / "fbank.conf"
    conf.write_text("--window-type=hamming\n--sample-frequency=16000\n--dither=1\n"
                    "--low-freq=40 # low\n--high-freq=-200\n--num-mel-bins=80\n"
                    "--remove-dc-offset=false\n")
    assert fbank_pt.FbankConfig.from_conf(str(conf)) == \
        fbank_pt.FbankConfig(**dataclasses.asdict(fbank_jax.FbankConfig.from_conf(str(conf))))


@pytest.mark.parametrize("n_samples", [400, 1600, 16001, 16159])
def test_fbank_matches_oracle_and_jax(rng, n_samples):
    """rFFT fbank within 1e-4 relative of the float64 oracle, and of the JAX
    matmul-DFT fbank."""
    pcm = (rng.standard_normal(n_samples) * 8000.0).astype(np.float32)
    max_samples = 16160
    wav = np.zeros((1, max_samples), np.float32)
    wav[0, :n_samples] = pcm
    oracle = fbank_jax.fbank_numpy(pcm, fbank_jax.FbankConfig(**CONF))
    n = oracle.shape[0]
    feats, lens = fbank_pt.make_fbank_fn(fbank_pt.FbankConfig(**CONF), max_samples, device="cpu")(
        torch.from_numpy(wav), torch.tensor([n_samples]))
    assert int(lens[0]) == n
    got = feats[0, :n].numpy()
    assert _rel(got, oracle).max() < 1e-4
    ref_feats, ref_lens = fbank_jax.make_fbank_fn(fbank_jax.FbankConfig(**CONF), max_samples)(
        jnp.asarray(wav), jnp.asarray([n_samples]))
    assert int(ref_lens[0]) == n
    assert _rel(got, np.asarray(ref_feats[0, :n])).max() < 1e-4


def test_fbank_dither_uses_generator(rng):
    cfg = fbank_pt.FbankConfig(**dict(CONF, dither=1.0))
    wav = torch.from_numpy((rng.standard_normal((2, 4000)) * 100).astype(np.float32))
    fb = fbank_pt.make_fbank_fn(cfg, 4000, device="cpu")
    lens = torch.tensor([4000, 3000])
    a, _ = fb(wav, lens, generator=torch.Generator().manual_seed(1))
    b, _ = fb(wav, lens, generator=torch.Generator().manual_seed(1))
    c, _ = fb(wav, lens, generator=torch.Generator().manual_seed(2))
    d, _ = fb(wav, lens)  # no generator: no dither
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and not torch.equal(a, d)


@pytest.mark.parametrize("lctx,rctx", [(0, 0), (1, 1), (3, 2)])
def test_splice_ragged_frame_lens(rng, lctx, rctx):
    feats = rng.standard_normal((3, 11, 4)).astype(np.float32)
    frame_lens = np.array([11, 6, 1], np.int32)
    ref = pipeline_jax.splice(jnp.asarray(feats), lctx, rctx, frame_lens=jnp.asarray(frame_lens))
    got = pipeline_pt.splice(torch.from_numpy(feats), lctx, rctx,
                             frame_lens=torch.from_numpy(frame_lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref2 = pipeline_jax.splice(jnp.asarray(feats[0]), lctx, rctx)
    np.testing.assert_array_equal(pipeline_pt.splice(torch.from_numpy(feats[0]), lctx, rctx).numpy(),
                                  np.asarray(ref2))


def test_stride_and_cmvn(rng):
    feats = rng.standard_normal((2, 10, 4)).astype(np.float32)
    offset = rng.standard_normal(4).astype(np.float32)
    scale = rng.standard_normal(4).astype(np.float32)
    for stride in (1, 3):
        np.testing.assert_array_equal(
            pipeline_pt.stride_subsample(torch.from_numpy(feats), stride).numpy(),
            np.asarray(pipeline_jax.stride_subsample(jnp.asarray(feats), stride)))
    lens = np.array([10, 9, 1])
    np.testing.assert_array_equal(pipeline_pt.strided_len(torch.from_numpy(lens), 3).numpy(),
                                  np.asarray(pipeline_jax.strided_len(jnp.asarray(lens), 3)))
    for cmn in (False, True):
        got = pipeline_pt.apply_cmvn(torch.from_numpy(feats), torch.from_numpy(offset),
                                     torch.from_numpy(scale), cmn=cmn)
        ref = pipeline_jax.apply_cmvn(jnp.asarray(feats), jnp.asarray(offset),
                                      jnp.asarray(scale), cmn=cmn)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
