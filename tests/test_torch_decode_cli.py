"""The port's decode CLI and the host data it reads, against the JAX package
on the CPU: the data copies (WAV reading, Kaldi text parsers, sample
conversion, CMVN, WER, reranking) on the same files and arrays; the bundle
conversion from an Orbax bundle (transducer and LAS); and both
``eval_transducer.main`` in-process on the same synthetic wavs -- the same
N-best file and the same WER, also with LAS rescoring and its scale
sweep."""

import inspect
import json
import struct

import numpy as np
import jax
import pytest
import torch

import pika_tpu.data as data_jax
import pika_tpu.models.transformer as transformer_jax
from pika_tpu.data import segment as segment_jax
from pika_tpu.data.kaldi_ark import write_matrix_ark
from pika_tpu.decode.rescore import rerank_nbest as rerank_jax
from pika_tpu.decode.wer import edit_distance as edit_distance_jax, score_wer as score_wer_jax
from pika_tpu.models.las import LASConfig as LASConfigJax, init_las as init_las_jax
from pika_tpu.models.transducer import (
    Transducer as TransducerJax,
    TransducerConfig as ConfigJax,
    init_transducer as init_jax,
)
from pika_tpu.train.bundle import load_bundle as load_bundle_jax, save_bundle as save_bundle_jax
from pika_tpu.train.eval_transducer import (
    main as eval_main_jax,
    select_las_input as select_las_input_jax,
)
import pika_tpu_torch.data as data_pt
import pika_tpu_torch.models.transformer as transformer_pt
from pika_tpu_torch.convert import state_dict_from_flax
from pika_tpu_torch.decode.rescore import rerank_nbest
from pika_tpu_torch.decode.wer import edit_distance, score_wer
from pika_tpu_torch.models.las import LAS, LASConfig, init_las
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.train.bundle import bundle_from_flax, load_bundle, save_bundle
from pika_tpu_torch.train.eval_transducer import main as eval_main, select_las_input

torch.set_num_threads(1)

SR = 16000
VOCAB = 12
MEL = 20
MODEL = dict(input_dim=3 * MEL, vocab_size=VOCAB, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="rnn", dec_layers=2, embd_dim=8, tdnn_nhid=32, tdnn_layers=5)
N_UTTS = 5  # two batches of 4: the second is filled with rows of silence
# LAS rescorers: the labels and EOS (= VOCAB), pad VOCAB + 1; on the
# transducer encoder's output (hid_dim 16) or on the features
LAS_CFG = dict(output_dim=VOCAB + 1, pad_idx=VOCAB + 1, rnn_size=16, enc_layers=2, dec_layers=2,
           embd_dim=6)
LAS_BUNDLES = {"fw": (16, "enc", False), "bw": (16, "enc", True), "feats": (3 * MEL, "feats", False)}


def _init_jax_jit(key, cfg):
    """``init_transducer`` under jit (eager init takes seconds here)."""
    return TransducerJax(cfg), jax.jit(lambda k: init_jax(k, cfg, max_t=64)[1])(key)


def _write_pcm24(path, samples):
    """A 24-bit PCM mono WAV from int32 samples in 24-bit range."""
    raw = np.asarray(samples, "<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, SR, SR * 3, 3, 24)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", 16) + fmt + b"data" + struct.pack("<I", len(raw)) + raw)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Synthetic wavs (ragged, one short enough for --min_len), wav.scp,
    label.txt, a symbol table, CMVN stats, and the same tiny model as an
    Orbax bundle and a port bundle."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(6)
    with open(d / "wav.scp", "w") as scp, open(d / "label.txt", "w") as lab:
        for i in range(N_UTTS):
            n = int(rng.integers(SR // 4, SR)) if i else 300
            pcm = (rng.standard_normal(n) * 3000).astype(np.int16)
            data_jax.write_wav(d / f"u{i}.wav", pcm, SR)
            scp.write(f"utt{i} {d}/u{i}.wav\n")
            lab.write(f"utt{i} " + " ".join(map(str, rng.integers(1, VOCAB, 4))) + "\n")
        lab.write("extra 1 2\n")  # a reference with no decoded utterance
    with open(d / "units.txt", "w") as f:
        f.write("<blk> 0\n" + "".join(f"{chr(97 + k)} {k}\n" for k in range(1, VOCAB)))
    stats = data_jax.CmvnStats(MEL)
    stats.accumulate(rng.standard_normal((500, MEL)) * 2 + 10)
    stats.write(str(d / "cmvn.stats"))

    model, variables = _init_jax_jit(jax.random.PRNGKey(3), ConfigJax(**MODEL))
    v = jax.tree.map(np.array, variables)
    v["params"]["fc2"]["bias"][0] += 2.0  # a model that also stops by the search's stop rule
    save_bundle_jax(str(d / "jax_bundle"), "transducer", ConfigJax(**MODEL), v)
    inits = {}  # one compiled init per input width
    for i, (name, (input_dim, las_input, reverse)) in enumerate(LAS_BUNDLES.items()):
        cfg = LASConfigJax(input_dim=input_dim, **LAS_CFG)
        if input_dim not in inits:
            inits[input_dim] = jax.jit(lambda key, cfg=cfg: init_las_jax(key, cfg)[1])
        las_v = inits[input_dim](jax.random.PRNGKey(20 + i))
        save_bundle_jax(str(d / f"jax_las_{name}"), "las", cfg, jax.tree.map(np.asarray, las_v),
                        metadata={"epoch": 0, "reverse_labels": reverse, "las_input": las_input})
    return d, v


def _port_bundle(d, name="bundle"):
    """The Orbax bundle ``jax_<name>`` converted as the README says."""
    _, variables, _ = load_bundle_jax(str(d / f"jax_{name}"))
    with open(d / f"jax_{name}" / "model.json") as f:
        spec = json.load(f)
    return bundle_from_flax(str(d / f"torch_{name}"), spec, jax.tree.map(np.asarray, variables))


def test_bundle_round_trip(corpus, tmp_path):
    """Orbax save_bundle -> bundle_from_flax -> load_bundle(device="cpu")
    gives the flax tree's state dict, for a transducer and a LAS bundle
    (with its metadata); the port's own save_bundle round-trips both kinds;
    an unknown kind raises."""
    d, v = corpus
    model, meta = load_bundle(_port_bundle(d), device="cpu")
    assert meta == {} and not model.training and model.config == TransducerConfig(**MODEL)
    expected = state_dict_from_flax(v)
    got = model.state_dict()
    assert set(got) == set(expected)
    for k, x in expected.items():
        assert torch.equal(got[k], x), k
    pt = init_transducer(TransducerConfig(**MODEL), torch.Generator().manual_seed(1), device="cpu")
    again, meta = load_bundle(save_bundle(str(tmp_path / "b"), pt, {"epoch": 3}), device="cpu")
    assert meta == {"epoch": 3}
    for (k, x), y in zip(pt.state_dict().items(), again.state_dict().values()):
        assert torch.equal(x, y), k
    las, meta = load_bundle(_port_bundle(d, "las_bw"), device="cpu")
    assert isinstance(las, LAS) and not las.training
    assert las.config == LASConfig(input_dim=16, **LAS_CFG)
    assert meta == {"epoch": 0, "reverse_labels": True, "las_input": "enc"}
    _, las_v, _ = load_bundle_jax(str(d / "jax_las_bw"))
    expected = state_dict_from_flax(jax.tree.map(np.asarray, las_v))
    assert set(las.state_dict()) == set(expected)
    for k, x in las.state_dict().items():
        assert torch.equal(x, expected[k]), k
    pt_las = init_las(LASConfig(input_dim=8, **LAS_CFG), torch.Generator().manual_seed(2), device="cpu")
    again, meta = load_bundle(save_bundle(str(tmp_path / "las"), pt_las, {"las_input": "feats"}),
                              device="cpu")
    assert isinstance(again, LAS) and meta == {"las_input": "feats"}
    for (k, x), y in zip(pt_las.state_dict().items(), again.state_dict().values()):
        assert torch.equal(x, y), k
    spec = json.loads((tmp_path / "b" / "model.json").read_text())
    spec["kind"] = "bogus"
    (tmp_path / "b" / "model.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match="bundle kind 'bogus'"):
        load_bundle(str(tmp_path / "b"), device="cpu")


def test_load_bundle_config_override(tmp_path):
    """A bundle of a model with chunked attention loads with its chunking,
    or with the ``config`` fields given (the CLI's ``--attn_chunk 0``: full
    attention); the weights are the same either way."""
    pt = init_transducer(TransducerConfig(**MODEL), torch.Generator().manual_seed(1), device="cpu")
    path = save_bundle(str(tmp_path / "b"), pt)
    spec = json.loads((tmp_path / "b" / "model.json").read_text())
    spec["config"]["attn_chunk"] = 64
    (tmp_path / "b" / "model.json").write_text(json.dumps(spec))
    chunked, _ = load_bundle(path, device="cpu")
    assert chunked.config.attn_chunk == 64
    assert chunked.encoder.transformer_0.self_attn.q_chunk == 64
    model, _ = load_bundle(path, device="cpu", attn_chunk=0)
    assert model.config.attn_chunk == 0
    for x, y, z in zip(pt.state_dict().values(), model.state_dict().values(),
                       chunked.state_dict().values()):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_read_wav_matches_jax(corpus, tmp_path):
    """PCM 16 and 24, float32, and a pipe entry."""
    d, _ = corpus
    rng = np.random.default_rng(7)
    _write_pcm24(tmp_path / "p24.wav", rng.integers(-2 ** 23, 2 ** 23, 999))
    data_jax.write_wav(tmp_path / "f32.wav", rng.standard_normal(500).astype(np.float32) * 0.3, SR)
    for source in (str(d / "u1.wav"), str(tmp_path / "p24.wav"), str(tmp_path / "f32.wav"),
                   f"cat {d}/u2.wav |"):
        ref, ref_rate = data_jax.read_wav(source)
        got, rate = data_pt.read_wav(source)
        assert got.dtype == ref.dtype and rate == ref_rate == SR, source
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(data_pt.to_float32(got), segment_jax.to_float32(ref))
        x = segment_jax.to_float32(ref) * 1.5  # saturates
        np.testing.assert_array_equal(data_pt.from_float32(x), segment_jax.from_float32(x))
    data_pt.write_wav(tmp_path / "w.wav", got, SR)
    np.testing.assert_array_equal(data_jax.read_wav(str(tmp_path / "w.wav"))[0], got)


def test_text_parsers_and_cmvn_match_jax(corpus):
    d, _ = corpus
    assert data_pt.read_wav_scp(str(d / "wav.scp")) == data_jax.read_wav_scp(str(d / "wav.scp"))
    for rspec in (f"ark:{d}/label.txt", f"ark,t:{d}/label.txt", str(d / "label.txt")):
        ref, got = data_jax.read_int_vectors(rspec), data_pt.read_int_vectors(rspec)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    assert data_pt.read_symbol_table(str(d / "units.txt")) == \
        data_jax.read_symbol_table(str(d / "units.txt"))
    ref = data_jax.offset_scale(data_jax.CmvnStats.read(str(d / "cmvn.stats")).stats, 3)
    got = data_pt.offset_scale(data_pt.CmvnStats.read(str(d / "cmvn.stats")).stats, 3)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_wer_and_rerank_match_jax():
    rng = np.random.default_rng(8)
    refs, hyps = {}, {}
    for i in range(30):
        refs[f"u{i}"] = [str(x) for x in rng.integers(0, 5, rng.integers(0, 9))]
        if i % 7:
            hyps[f"u{i}"] = [str(x) for x in rng.integers(0, 5, rng.integers(0, 9))]
    hyps["stray"] = ["1"]
    assert score_wer(refs, hyps) == score_wer_jax(refs, hyps)
    for r, h in zip(refs.values(), hyps.values()):
        assert edit_distance(r, h) == edit_distance_jax(r, h)
    scores = rng.standard_normal((4, 6)).astype(np.float32) * 5
    lens = rng.integers(0, 4, (4, 6)).astype(np.int32)
    fw = rng.standard_normal((4, 6)).astype(np.float32)
    for args in ((scores, lens), (scores, lens, fw, None, 0.5, 0.2)):
        (ref_idx, ref_fused), (idx, fused) = rerank_jax(*args), rerank_nbest(*args)
        np.testing.assert_array_equal(idx, np.asarray(ref_idx))
        np.testing.assert_allclose(fused, np.asarray(ref_fused), rtol=1e-6)


def _flags(d):
    return ["--feats_dim", str(MEL), "--max_wav_seconds", "1.0", "--batch_size", "4",
            "--beam_size", "4", "--n_best", "4", "--max_symbols", "8", "--min_len", "5",
            "--cmvn_stats", str(d / "cmvn.stats"), "--ref_labels", f"ark:{d}/label.txt"]


@pytest.fixture
def f32_attention(monkeypatch):
    """Attention in float32 in both packages (the JAX layer's ``mm_dtype``
    default set to None, the port's bf16 rounding made the identity): the
    bf16 rounding of q, k, v and the probabilities would otherwise move the
    scores by about 1e-4 relative."""
    init = transformer_jax.MultiHeadedAttention.__init__.__wrapped__
    names = [n for n in inspect.signature(init).parameters if n != "self"]
    defaults = list(init.__defaults__)
    defaults[names.index("mm_dtype") - (len(names) - len(defaults))] = None
    monkeypatch.setattr(init, "__defaults__", tuple(defaults))
    monkeypatch.setattr(transformer_pt, "_bf16", lambda x: x)


def test_cli_matches_jax(corpus, capsys, f32_attention):
    """Both CLIs on the same wavs and weights: the N-best files byte-identical
    without scores (token ids and, with --symbols_map, symbols), the scores
    within rtol 1e-5 with --output_scores, the same WER, and no warning (the
    reference without a decoded utterance is not a hypothesis without a
    reference)."""
    d, _ = corpus
    bundle = _port_bundle(d)
    for extra in ([], ["--output_scores", "--symbols_map", str(d / "units.txt")]):
        wer_ref = eval_main_jax([str(d / "jax_bundle"), str(d / "wav.scp"), str(d / "ref.txt"),
                                 *_flags(d), *extra])
        err_ref = capsys.readouterr().err
        wer = eval_main([bundle, str(d / "wav.scp"), str(d / "got.txt"), "--device", "cpu",
                         *_flags(d), *extra])
        err = capsys.readouterr().err
        assert wer == wer_ref
        wer_line = [x for x in err.splitlines() if x.startswith("%WER")]
        assert wer_line == [x for x in err_ref.splitlines() if x.startswith("%WER")]
        assert len(wer_line) == 1 and "WARNING" not in err  # "extra" is a reference, not a hyp
        ref_lines = (d / "ref.txt").read_text().splitlines()
        got_lines = (d / "got.txt").read_text().splitlines()
        assert len(got_lines) == N_UTTS * 4
        if not extra:
            assert (d / "got.txt").read_bytes() == (d / "ref.txt").read_bytes()
            assert any(got_lines)  # the comparison exercised emissions
            continue
        for g, r in zip(got_lines, ref_lines):
            (g_text, g_score), (r_text, r_score) = g.rsplit(" ", 1), r.rsplit(" ", 1)
            assert g_text == r_text
            np.testing.assert_allclose(float(g_score), float(r_score), rtol=1e-5)


def _write_arpa(path, rng):
    """A bigram ARPA over the corpus' units (letters), with <s>, </s>,
    backoffs and a word outside the symbol table."""
    words = [chr(97 + k) for k in range(1, VOCAB)]
    unigrams = [("<s>", -99.0, -0.4), ("</s>", -1.2, None), ("zz", -2.0, -0.1)]
    unigrams += [(w, -float(rng.uniform(0.5, 2.0)), -float(rng.uniform(0.1, 0.5))) for w in words]
    bigrams = [(a, b, -float(rng.uniform(0.1, 1.5))) for a in ["<s>", "zz"] + words
               for b in words + ["</s>"] if rng.random() < 0.3]
    with open(path, "w") as f:
        f.write(f"\\data\\\nngram 1={len(unigrams)}\nngram 2={len(bigrams)}\n\n\\1-grams:\n")
        for w, p, bow in unigrams:
            f.write(f"{p:.4f} {w}" + (f" {bow:.4f}" if bow is not None else "") + "\n")
        f.write("\n\\2-grams:\n")
        for a, b, p in bigrams:
            f.write(f"{p:.4f} {a} {b}\n")
        f.write("\n\\end\\\n")


@pytest.mark.parametrize("fusion", [["--fst_fusion", "per_beam"],
                                    ["--fst_fusion", "per_token", "--fst_cache_file", "auto"],
                                    ["--fst_per_token", "--fst_cache_mb", "0",
                                     "--nonblk_reward", "0.3"]])
def test_cli_fst_matches_jax(corpus, capsys, f32_attention, fusion):
    """Both CLIs with ``--fst_lm`` on one ARPA LM, per-beam and per-token
    (exact through the advance cache, kept in ``<fst_lm>.advcache.npz``;
    and without the cache, which falls back to the top-8 walk): the N-best
    files byte-identical, the same WER and the same cache and fallback
    lines."""
    d, _ = corpus
    bundle = _port_bundle(d)
    arpa = d / f"lm{len(fusion)}.arpa"
    _write_arpa(arpa, np.random.default_rng(9))
    extra = ["--fst_lm", str(arpa), "--symbols_map", str(d / "units.txt"), "--fst_lm_scale",
             "0.8", *fusion]
    wer_ref = eval_main_jax([str(d / "jax_bundle"), str(d / "wav.scp"), str(d / "fst_ref.txt"),
                             *_flags(d), *extra])
    err_ref = capsys.readouterr().err
    wer = eval_main([bundle, str(d / "wav.scp"), str(d / "fst_got.txt"), "--device", "cpu",
                     *_flags(d), *extra])
    err = capsys.readouterr().err
    assert wer == wer_ref

    def lines(text, prefix):
        return [x for x in text.splitlines() if x.startswith(prefix)]

    for prefix in ("%WER", "FST advance cache", "per-token fusion"):
        assert lines(err, prefix) == lines(err_ref, prefix), prefix
    assert len(lines(err, "FST advance cache")) == (fusion[-1] != "0.3")
    assert len(lines(err, "per-token fusion")) == (fusion[-1] == "0.3")
    assert (d / "fst_got.txt").read_bytes() == (d / "fst_ref.txt").read_bytes()
    got_lines = (d / "fst_got.txt").read_text().splitlines()
    assert len(got_lines) == N_UTTS * 4 and any(got_lines)  # the comparison saw emissions
    if "auto" in fusion:
        assert (d / (arpa.name + ".advcache.npz")).exists()


SWEEP = ["--las_scale_sweep", "0.3:0.7,0.5:0.5,1.0:0.0"]


@pytest.mark.parametrize("rescorers,extra", [
    (["fw", "bw"], ["--output_scores", *SWEEP]),
    (["feats"], ["--output_scores", "--las_input", "feats", "--las_fw_score_scale", "0.8"]),
    (["bw"], SWEEP)])
def test_cli_las_matches_jax(corpus, capsys, f32_attention, rescorers, extra):
    """Both CLIs with LAS rescoring from the same weights (forward and
    backward rescorers on the transducer encoder's output, or a forward one
    on the features): the hypotheses of every N-best line identical, its
    RNN-T and per-token LAS scores within rtol 1e-5 (atol 1e-5 for a score
    near 0), the file byte-identical without scores; the WER line and one
    sweep line per pair identical."""
    d, _ = corpus
    bundle = _port_bundle(d)
    flags = [*_flags(d), "--SOS", "0", "--EOS", str(VOCAB), *extra]
    jax_las, pt_las = [], []
    for name in rescorers:
        flag = "--las_rescorer_bw_model" if name == "bw" else "--las_rescorer_model"
        jax_las += [flag, str(d / f"jax_las_{name}")]
        pt_las += [flag, _port_bundle(d, f"las_{name}")]
    out = "_".join(rescorers)
    wer_ref = eval_main_jax([str(d / "jax_bundle"), str(d / "wav.scp"), str(d / f"{out}_ref.txt"),
                             *flags, *jax_las])
    err_ref = capsys.readouterr().err
    wer = eval_main([bundle, str(d / "wav.scp"), str(d / f"{out}_got.txt"), "--device", "cpu",
                     *flags, *pt_las])
    err = capsys.readouterr().err
    assert wer == wer_ref

    def lines(text, prefix):
        return [x for x in text.splitlines() if x.startswith(prefix)]

    for prefix in ("%WER", "las_scales"):
        assert lines(err, prefix) == lines(err_ref, prefix), prefix
    assert len(lines(err, "las_scales")) == (3 if SWEEP[1] in extra else 0)
    got = (d / f"{out}_got.txt").read_text().splitlines()
    ref = (d / f"{out}_ref.txt").read_text().splitlines()
    assert len(got) == len(ref) == N_UTTS * 4 and any(got)
    if "--output_scores" not in extra:
        assert (d / f"{out}_got.txt").read_bytes() == (d / f"{out}_ref.txt").read_bytes()
        return
    n_dirs = len(rescorers)
    for g, r in zip(got, ref):
        g, r = g.split(), r.split()
        assert len(g) == len(r)
        # ntok ids, the RNN-T score, ntok + 1 per-token scores per direction
        ntok = (len(g) - 1 - n_dirs) // (1 + n_dirs)
        assert g[:ntok] == r[:ntok]
        np.testing.assert_allclose(np.array(g[ntok:], float), np.array(r[ntok:], float),
                                   rtol=1e-5, atol=1e-5)


def test_select_las_input_matches_jax():
    """The rescorer's input by flag, by the bundle's metadata, by width, and
    the ties and mismatches that raise, as in the JAX CLI."""
    cases = [("auto", {}, 16, 16, 60), ("auto", {}, 60, 16, 60), ("auto", {}, 16, 16, 16),
             ("auto", {"las_input": "feats"}, 60, 16, 60), ("enc", {"las_input": "feats"}, 16,
                                                             16, 60),
             ("feats", {}, 16, 16, 60), ("auto", {}, 7, 16, 60)]
    for case in cases:
        try:
            ref = select_las_input_jax(*case)
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                select_las_input(*case)
            assert str(got.value) == str(exc)
            continue
        assert select_las_input(*case) == ref, case


def test_cli_attn_chunk_matches_jax(corpus, capsys, f32_attention):
    """``--attn_chunk 8`` (query blocks over the encoder's attention) in
    both CLIs: the N-best files byte-identical and the same WER."""
    d, _ = corpus
    bundle = _port_bundle(d)
    wer_ref = eval_main_jax([str(d / "jax_bundle"), str(d / "wav.scp"), str(d / "chunk_ref.txt"),
                             *_flags(d), "--attn_chunk", "8"])
    wer = eval_main([bundle, str(d / "wav.scp"), str(d / "chunk_got.txt"), "--device", "cpu",
                     *_flags(d), "--attn_chunk", "8"])
    capsys.readouterr()
    assert wer == wer_ref
    assert (d / "chunk_got.txt").read_bytes() == (d / "chunk_ref.txt").read_bytes()
    assert any((d / "chunk_got.txt").read_text().splitlines())


@pytest.mark.parametrize("extra", [[], ["--cmn", "--min_len", "30", "--stride", "2"]])
def test_cli_loader_utt_matches_jax(corpus, capsys, f32_attention, extra):
    """``--loader utt`` in both CLIs over one Kaldi feature archive (read
    through its scp too): splice, stride, the --min_len edge pad, CMN and
    CMVN on the host, then the beam; the N-best files byte-identical, the
    same WER."""
    d, _ = corpus
    bundle = _port_bundle(d)
    rng = np.random.default_rng(11)
    feats = [(f"utt{i}", (rng.standard_normal((int(rng.integers(20, 70)), MEL)) * 2 + 10)
              .astype(np.float32)) for i in range(N_UTTS)]
    scp = write_matrix_ark(str(d / "feats.ark"), feats)
    flags = ["--loader", "utt", "--feats_dim", str(MEL), "--batch_size", "4", "--beam_size", "4",
             "--n_best", "4", "--max_symbols", "8", "--cmvn_stats", str(d / "cmvn.stats"),
             "--ref_labels", f"ark:{d}/label.txt", *extra]
    for src in (str(d / "feats.ark"), f"scp:{scp}"):
        wer_ref = eval_main_jax([str(d / "jax_bundle"), src, str(d / "utt_ref.txt"), *flags])
        wer = eval_main([bundle, src, str(d / "utt_got.txt"), "--device", "cpu", *flags])
        capsys.readouterr()
        assert wer == wer_ref
        assert (d / "utt_got.txt").read_bytes() == (d / "utt_ref.txt").read_bytes()
        lines = (d / "utt_got.txt").read_text().splitlines()
        assert len(lines) == N_UTTS * 4 and any(lines)
