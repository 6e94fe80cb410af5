"""The port's training data layer against the JAX package on the CPU, on the
same seeded numpy inputs: mrk/seq archives both ways (byte-identical
files), the data-list and int-vector parsers, the length-grouped lists,
every augmentation of ``data/segment.py``, the otf ``dataloader`` at one
worker (speed, gain, noise at an SNR range, RIR), the Kaldi ark reader and
``compress_matrix``, ``feats_dataloader`` with its shuffle buffer over two
epochs, CMVN accumulation, the logger's lines and ``compute_global_cmvn``
(to 1e-5 relative).  Everything but the last is bit for bit."""

import random
import re

import numpy as np
import pytest
import torch

import pika_tpu.data as data_jax
import pika_tpu.data.kaldi_ark as ark_jax
import pika_tpu.data.segment as seg_jax
import pika_tpu.utils.logger as logger_jax
from pika_tpu.data.feats_loader import FeatsLoaderConfig as FeatsCfgJax, feats_dataloader as feats_jax
from pika_tpu.data.loader import OtfLoaderConfig as OtfCfgJax, dataloader as dataloader_jax
from pika_tpu.data.prep import main as prep_jax
import pika_tpu_torch.data as data_pt
import pika_tpu_torch.data.kaldi_ark as ark_pt
import pika_tpu_torch.data.segment as seg_pt
import pika_tpu_torch.utils.logger as logger_pt
from pika_tpu_torch.data.feats_loader import FeatsLoaderConfig, feats_dataloader
from pika_tpu_torch.data.loader import OtfLoaderConfig, dataloader, prefetch_iter
from pika_tpu_torch.data.prep import main as prep_pt

torch.set_num_threads(1)

SR = 16000


def _same_files(a, b):
    assert open(a, "rb").read() == open(b, "rb").read(), (a, b)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Ten wavs of 0.2-1.1 s (int16 noise, one 24-bit-scale int32 source),
    wav.scp, label.txt, two noise segments and one RIR."""
    d = tmp_path_factory.mktemp("data_train")
    rng = np.random.default_rng(21)
    with open(d / "wav.scp", "w") as scp, open(d / "label.txt", "w") as lab:
        for i in range(10):
            n = int(rng.integers(SR // 5, int(1.1 * SR)))
            pcm = (rng.standard_normal(n) * (800 + 300 * i)).astype(np.int16)
            data_jax.write_wav(d / f"u{i}.wav", pcm, SR)
            scp.write(f"utt{i} {d}/u{i}.wav\n")
            lab.write(f"utt{i} " + " ".join(map(str, rng.integers(1, 9, 2 + i % 5))) + "\n")
    data_jax.wav_scp_to_mrk_seq(str(d / "wav.scp"), str(d / "a.mrk"), str(d / "a.seq"), 4)
    with open(d / "data.lst", "w") as f:
        for k in range(3):
            f.write(f"{d}/a.mrk.{k} {d}/a.seq.{k} ark:{d}/label.txt\n")
    noise = [(rng.standard_normal(int(1.5 * SR)) * 0.1).astype(np.float32) for _ in range(2)]
    rir = [np.exp(-np.arange(400) / 60.0).astype(np.float32) * rng.standard_normal(400)
           .astype(np.float32)]
    return d, noise, rir


# ---------------------------------------------------------------------------
# archives, parsers, lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["int16", "int32", "float32"])
def test_archive_writers_byte_identical(tmp_path, kind):
    """Both writers on the same samples (int16, full-scale int32, float):
    the same shards, byte for byte; each package reads the other's."""
    rng = np.random.default_rng(1)
    utts = []
    for i in range(5):
        x = rng.standard_normal(int(rng.integers(10, 300)))
        x = {"int16": (x * 3000).astype(np.int16), "int32": (x * 2 ** 28).astype(np.int32),
             "float32": (x * 0.3).astype(np.float32)}[kind]
        utts.append((f"u{i}", x))
    paths = {}
    for name, pkg in (("jax", data_jax), ("pt", data_pt)):
        with pkg.MrkSeqWriter(str(tmp_path / f"{name}.mrk"), str(tmp_path / f"{name}.seq"),
                              2) as w:
            for u, x in utts:
                w.write(u, x)
        paths[name] = w.shards
    assert len(paths["jax"]) == len(paths["pt"]) == 3
    for (mj, sj), (mp, sp) in zip(paths["jax"], paths["pt"]):
        _same_files(mj, mp)
        _same_files(sj, sp)
        with data_jax.MrkSeqReader(mp, sp) as rj, data_pt.MrkSeqReader(mj, sj) as rp:
            assert len(rj) == len(rp)
            for (uj, xj), (up, xp) in zip(rj, rp):
                assert uj == up and np.array_equal(xj, xp)


def test_wav_scp_conversions_byte_identical(corpus, tmp_path):
    d, _, _ = corpus
    ref = data_jax.wav_scp_to_mrk_seq(str(d / "wav.scp"), str(tmp_path / "j.mrk"),
                                      str(tmp_path / "j.seq"), 3)
    got = data_pt.wav_scp_to_mrk_seq(str(d / "wav.scp"), str(tmp_path / "p.mrk"),
                                     str(tmp_path / "p.seq"), 3)
    assert len(ref) == len(got) == 4
    for a, b in zip(ref, got):
        _same_files(a[0], b[0])
        _same_files(a[1], b[1])
    data_jax.wav_scp_to_bytes(str(d / "wav.scp"), str(tmp_path / "j.bytes"))
    data_pt.wav_scp_to_bytes(str(d / "wav.scp"), str(tmp_path / "p.bytes"))
    _same_files(tmp_path / "j.bytes", tmp_path / "p.bytes")


def test_parsers_match_jax(corpus, tmp_path):
    d, _, _ = corpus
    assert data_pt.read_data_lst(str(d / "data.lst")) == data_jax.read_data_lst(str(d / "data.lst"))
    ref = list(data_jax.iter_int_vectors(f"ark:{d}/label.txt"))
    got = list(data_pt.iter_int_vectors(f"ark,t:{d}/label.txt"))
    assert [u for u, _ in got] == [u for u, _ in ref]
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for (_, a), (_, b) in zip(got, ref))
    data_jax.write_int_vectors(str(tmp_path / "j.txt"), ref)
    data_pt.write_int_vectors(str(tmp_path / "p.txt"), got)
    _same_files(tmp_path / "j.txt", tmp_path / "p.txt")


@pytest.mark.parametrize("full_batch,shuffle,seed", [(False, False, None), (True, True, 3),
                                                     (False, True, 4)])
def test_lists_match_jax(tmp_path, full_batch, shuffle, seed):
    rng = np.random.default_rng(2)
    lens = tmp_path / "lens.txt"
    lens.write_text("".join(f"u{i} {int(rng.integers(1, 400))}\n" for i in range(57)) + "bad\n")
    out = {}
    for name, pkg in (("jax", data_jax), ("pt", data_pt)):
        src = tmp_path / f"{name}.txt"
        src.write_text(lens.read_text())
        out[name] = pkg.split_by_length(str(src), 4, 3, 10, 350, full_batch, shuffle, seed)
        pkg.shuffle_by_length(str(src), str(tmp_path / f"{name}.shuf"), 5, 300, full_batch,
                              shuffle, seed)
    for a, b in zip(out["jax"], out["pt"]):
        _same_files(a, b)
    _same_files(tmp_path / "jax.shuf", tmp_path / "pt.shuf")


# ---------------------------------------------------------------------------
# augmentations
# ---------------------------------------------------------------------------

def _signal(seed=3, n=4000):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


AUGMENTATIONS = {
    "to_float32_int16": lambda m: m.to_float32((_signal() * 30000).astype(np.int16)),
    "to_float32_stereo": lambda m: m.to_float32(np.stack([_signal(1), _signal(2)], 1)),
    "from_float32": lambda m: m.from_float32(_signal() * 20, "int16"),
    "rms_db": lambda m: np.float64(m.rms_db(_signal())),
    "gain_db": lambda m: m.gain_db(_signal(), -7.5),
    "normalize": lambda m: m.normalize(_signal(), -23.0),
    "change_speed_0.9": lambda m: m.change_speed(_signal(), 0.9),
    "change_speed_1.1": lambda m: m.change_speed(_signal(), 1.1),
    "online_bayesian": lambda m: m.normalize_online_bayesian(_signal(), SR, -20.0, -25.0, 500.0,
                                                             0.05),
    "resample": lambda m: m.resample(_signal(), 16000, 8000),
    "pad_silence": lambda m: m.pad_silence(_signal(), SR, 0.01, "both"),
    "shift": lambda m: m.shift(_signal(), SR, -12.5),
    "subsegment": lambda m: m.subsegment(_signal(), SR, 0.02, -0.05),
    "random_subsegment": lambda m: m.random_subsegment(_signal(), SR, 0.1, random.Random(5)),
    "convolve": lambda m: m.convolve(_signal(), _signal(4, 200)),
    "convolve_and_normalize": lambda m: m.convolve_and_normalize(_signal(), _signal(4, 200)),
    "add_noise": lambda m: m.add_noise(_signal(), SR, _signal(6, 9000), 12.0,
                                       rng=random.Random(7)),
}


@pytest.mark.parametrize("name", sorted(AUGMENTATIONS))
def test_segment_matches_jax(name):
    ref, got = AUGMENTATIONS[name](seg_jax), AUGMENTATIONS[name](seg_pt)
    assert got.dtype == ref.dtype and np.array_equal(got, ref), name


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

LOADER = dict(batch_size=3, num_workers=1, seed=11, max_len=95, tu_limit=60,
              wav_buckets=(4000, 8000, 12000, 17600), label_buckets=(2, 4, 8), sos=0)


def _batches_equal(ref, got):
    assert len(ref) == len(got) > 0
    for a, b in zip(ref, got):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
            if k != "uttids":
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("aug", [dict(augment=False), dict(),
                                 dict(snr_range=(5.0, 15.0), noise_prob=0.6),
                                 dict(snr_range=(0.0, 10.0), rir=True)])
def test_dataloader_matches_jax(corpus, aug):
    """One worker (the batch order is the stream order): the same batches,
    with the filters (frames, T*U/3, buckets) and the accepted-count flush;
    speed and gain, noise at an SNR range, and an RIR."""
    d, noise, rir = corpus
    kw = dict(LOADER, **{k: v for k, v in aug.items() if k != "rir"})
    rirs = rir if aug.get("rir") else None
    ref = list(dataloader_jax(str(d / "data.lst"), OtfCfgJax(**kw), noise=noise, rir=rirs))
    got = list(dataloader(str(d / "data.lst"), OtfLoaderConfig(**kw), noise=noise, rir=rirs))
    _batches_equal(ref, got)
    n = sum(len(b["uttids"]) for b in got)
    assert 0 < n < 10  # the filters dropped some utterances


def test_loader_errors_propagate(corpus, tmp_path):
    """A worker's failure (a label missing) and a prefetch producer's raise
    in the consumer."""
    d, _, _ = corpus
    (tmp_path / "bad.lst").write_text(f"{d}/a.mrk.0 {d}/a.seq.0 ark:{tmp_path}/none.txt\n")
    (tmp_path / "none.txt").write_text("other 1 2\n")
    with pytest.raises(RuntimeError, match="loader worker 0 failed"):
        list(dataloader(str(tmp_path / "bad.lst"), OtfLoaderConfig(**LOADER)))

    def boom():
        yield 1
        raise ValueError("producer")

    with pytest.raises(RuntimeError, match="prefetch producer failed"):
        list(prefetch_iter(boom()))
    assert list(prefetch_iter(iter(range(5)), transform=lambda x: x * 2)) == [0, 2, 4, 6, 8]


def test_kaldi_ark_matches_jax(tmp_path):
    """An ark written by the JAX writer read by both readers (binary float,
    text and the three compressed formats, also through the scp), and
    ``compress_matrix`` byte for byte."""
    rng = np.random.default_rng(8)
    mats = [(f"u{i}", rng.standard_normal((int(rng.integers(3, 30)), 7)).astype(np.float32) * 3)
            for i in range(4)]
    scp = ark_jax.write_matrix_ark(str(tmp_path / "f.ark"), mats)
    for fmt in (1, 2, 3):
        assert ark_pt.compress_matrix(mats[0][1], fmt) == ark_jax.compress_matrix(mats[0][1], fmt)
    with open(tmp_path / "mixed.ark", "wb") as f:
        for fmt, (u, m) in zip((1, 2, 3), mats):
            f.write(u.encode() + b" \0B" + ark_jax.compress_matrix(m, fmt))
        f.write(b"txt  [\n  1 2.5 3\n  4 5 -6 ]\n")
    for path in (str(tmp_path / "f.ark"), str(tmp_path / "mixed.ark")):
        ref, got = list(ark_jax.iter_matrix_ark(path)), list(ark_pt.iter_matrix_ark(path))
        assert [u for u, _ in got] == [u for u, _ in ref]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, ref))
    ref, got = list(ark_jax.iter_matrices_scp(scp)), list(ark_pt.iter_matrices_scp(scp))
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, ref)) and len(got) == 4
    ark_pt.write_matrix_ark(str(tmp_path / "p.ark"), mats)
    _same_files(tmp_path / "f.ark", tmp_path / "p.ark")


@pytest.mark.parametrize("spec", ["ark", "scp"])
def test_feats_dataloader_matches_jax(tmp_path, spec):
    """Splice, stride, the last-frame padding, the label edits and the
    shuffle buffer seeded per epoch as the CLI seeds it: two epochs."""
    rng = np.random.default_rng(9)
    mats = [(f"u{i}", rng.standard_normal((int(rng.integers(5, 60)), 6)).astype(np.float32))
            for i in range(11)]
    scp = ark_jax.write_matrix_ark(str(tmp_path / "f.ark"), mats)
    data_jax.write_int_vectors(str(tmp_path / "l.txt"),
                               [(u, rng.integers(1, 9, 3)) for u, _ in mats])
    src = str(tmp_path / "f.ark") if spec == "ark" else f"scp:{scp}"
    for epoch in range(2):
        kw = dict(batch_size=4, lctx=2, rctx=1, stride=2, max_len=25, reverse_labels=True,
                  eos=9, shuffle_buffer=5, seed=3 + 1000 * epoch, frame_buckets=(8, 16, 32))
        ref = list(feats_jax(src, f"ark:{tmp_path}/l.txt", FeatsCfgJax(**kw)))
        got = list(feats_dataloader(src, f"ark:{tmp_path}/l.txt", FeatsLoaderConfig(**kw)))
        _batches_equal(ref, got)


# ---------------------------------------------------------------------------
# CMVN, logger, compute_global_cmvn
# ---------------------------------------------------------------------------

def test_cmvn_accumulate_and_write_match_jax(tmp_path):
    rng = np.random.default_rng(10)
    sj, sp = data_jax.CmvnStats(5), data_pt.CmvnStats(5)
    for _ in range(3):
        x = rng.standard_normal((int(rng.integers(1, 40)), 5)) * 4 + 2
        sj.accumulate(x)
        sp.accumulate(x)
    assert sp.dim == 5 and np.array_equal(sp.stats, sj.stats)
    sj.write(str(tmp_path / "j.stats"))
    sp.write(str(tmp_path / "p.stats"))
    _same_files(tmp_path / "j.stats", tmp_path / "p.stats")
    assert np.array_equal(data_pt.CmvnStats.read(str(tmp_path / "j.stats")).stats, sj.stats)


def test_logger_lines_match_jax():
    """The same updates give the same lines, the rates aside (wall-clock)."""
    import io

    texts = []
    for module in (logger_jax, logger_pt):
        out = io.StringIO()
        log = module.Logger(out, 100, ["Loss", "Aux"])
        for n, loss in ((60, 30.5), (50, 12.25), (120, 40.0), (7, 1.0)):
            log.update_and_log(n, [loss, loss / 2])
        assert log.summarize_and_log() == (83.75, 237)
        texts.append(re.sub(r"fps: [0-9.]+", "fps: X", out.getvalue()))
    assert texts[0] == texts[1] and texts[0].count("Loss") == 3


@pytest.mark.parametrize("dither", [0, 1])
def test_compute_global_cmvn_matches_jax(corpus, tmp_path, dither):
    """The JAX tool's statistics (numpy float64 fbank) and the port's (the
    port's float32 fbank on the CPU), with the same speed and gain draws:
    to 1e-5 relative; with dither on, each side draws its own dither."""
    d, _, _ = corpus
    conf = tmp_path / "fbank.conf"
    conf.write_text(f"--window-type=hamming\n--sample-frequency=16000\n--dither={dither}\n"
                    "--low-freq=40\n--high-freq=-200\n--num-mel-bins=23\n")
    args = [str(d / "data.lst"), "--feat_config", str(conf), "--seed", "4"]
    prep_jax(["compute_global_cmvn", args[0], str(tmp_path / "j.stats"), *args[1:]])
    prep_pt(["compute_global_cmvn", args[0], str(tmp_path / "p.stats"), *args[1:],
             "--device", "cpu"])
    ref = data_jax.CmvnStats.read(str(tmp_path / "j.stats")).stats
    got = data_pt.CmvnStats.read(str(tmp_path / "p.stats")).stats
    assert got[0, -1] == ref[0, -1] > 0  # the same frames
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_prep_list_tools_match_jax(corpus, tmp_path):
    d, _, _ = corpus
    lens = "".join(f"u{i} {10 * i + 3}\n" for i in range(23))
    for name, main in (("j", prep_jax), ("p", prep_pt)):
        (tmp_path / f"{name}.lens").write_text(lens)
        extra = ["--device", "cpu"] if name == "p" else []
        main(["split_by_length", str(tmp_path / f"{name}.lens"), "--batch_size", "2",
              "--world_size", "3", "--random", "--seed", "1", *extra])
        main(["shuffle_by_length", str(tmp_path / f"{name}.lens"),
              str(tmp_path / f"{name}.shuf"), "--batch_size", "4", *extra])
    for k in range(3):
        _same_files(tmp_path / f"j.lens.{k}", tmp_path / f"p.lens.{k}")
    _same_files(tmp_path / "j.shuf", tmp_path / "p.shuf")
