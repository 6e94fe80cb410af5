"""LAS rescoring and the N-best rerank CLI of the port against the JAX
package on the CPU: ``_build_targets`` (exact), ``las_score_hyps`` forward
and reversed from the same weights on the same N-best (scores to 1e-5, the
per-token scores too), and the rerank CLI on the same N-best files (output
byte-identical, with and without LAS columns, ids and text hypotheses)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pika_tpu.decode.rerank import main as rerank_main_jax
from pika_tpu.decode.rescore import (
    _build_targets as build_targets_jax,
    las_score_hyps as las_score_hyps_jax,
)
from pika_tpu.models.las import LAS as LASJax, LASConfig as LASConfigJax, init_las as init_las_jax
from pika_tpu_torch.convert import load_flax_variables
from pika_tpu_torch.decode.rerank import main as rerank_main
from pika_tpu_torch.decode.rescore import _build_targets, las_score_hyps
from pika_tpu_torch.models.las import LASConfig, init_las

torch.set_num_threads(1)

VOCAB = 9  # labels 1..7, EOS 8 (SOS 0), pad 9
SOS, EOS = 0, 8


def _nbest(seed, b=3, n=4, um=6):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, um + 1, (b, n)).astype(np.int32)
    lens[0, 0], lens[-1, -1] = um, 0
    tokens = rng.integers(1, EOS, (b, n, um)).astype(np.int32)
    tokens[np.arange(um)[None, None] >= lens[..., None]] = -1
    return tokens, lens


@pytest.mark.parametrize("reverse", [False, True])
def test_build_targets_matches_jax(reverse):
    tokens, lens = _nbest(0)
    flat, flat_lens = tokens.reshape(-1, tokens.shape[-1]).clip(0), lens.reshape(-1)
    ref = np.asarray(build_targets_jax(jnp.asarray(flat), jnp.asarray(flat_lens), SOS, EOS, VOCAB,
                                       reverse))
    got = _build_targets(torch.from_numpy(flat), torch.from_numpy(flat_lens), SOS, EOS, VOCAB,
                         reverse)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kw", [dict(), dict(brnn=True, use_downsampler=True, downsampler_layers=2),
                                dict(rnn_type="SRU", coverage_attn=True, attn_type="general")])
def test_las_score_hyps_matches_jax(reverse, kw):
    """The totals and the per-token scores (hypothesis tokens and EOS, 0
    past them) to 1e-5; the port encodes each utterance once and steps the
    decoder only as far as the longest hypothesis."""
    cfg = dict(input_dim=5, output_dim=VOCAB, pad_idx=VOCAB, rnn_size=12, enc_layers=2,
               dec_layers=2, embd_dim=6, **kw)
    variables = jax.jit(lambda key: init_las_jax(key, LASConfigJax(**cfg))[1])(
        jax.random.PRNGKey(3))
    model = LASJax(LASConfigJax(**cfg))
    pt = load_flax_variables(init_las(LASConfig(**cfg), torch.Generator().manual_seed(0),
                                      device="cpu"), jax.tree.map(np.asarray, variables))
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((3, 10, 5)).astype(np.float32)
    enc_lens = np.array([10, 7, 3], np.int32)
    tokens, lens = _nbest(2)
    ref_total, ref_tok = jax.jit(lambda v, *a: las_score_hyps_jax(
        model, v, *a, sos=SOS, eos=EOS, reverse=reverse))(
        variables, *map(jnp.asarray, (enc, enc_lens, tokens, lens)))
    total, tok = las_score_hyps(pt, *map(torch.from_numpy, (enc, enc_lens, tokens, lens)),
                                sos=SOS, eos=EOS, reverse=reverse)
    np.testing.assert_allclose(total.numpy(), np.asarray(ref_total), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tok.numpy(), np.asarray(ref_tok), rtol=1e-5, atol=1e-5)
    assert tok.shape == (3, 4, 7) and not tok[-1, -1, 1:].any()


def _write_nbest(path, rng, n_utts, nbest, dirs, ids):
    with open(path, "w") as f:
        for _ in range(n_utts * nbest):
            ntok = int(rng.integers(0, 5))
            toks = rng.integers(1, 30, ntok)
            text = " ".join(map(str, toks)) if ids else "".join(chr(96 + t % 26 + 1) for t in toks)
            fields = [text] if text else []
            fields.append(str(float(rng.standard_normal() * 5)))
            for _ in range(dirs):
                fields += [str(float(x)) for x in rng.standard_normal(ntok + 1)]
            f.write(" ".join(fields) + "\n")


@pytest.mark.parametrize("ids", [False, True])
@pytest.mark.parametrize("dirs,flags", [
    (0, []), (2, ["--las_rescore"]), (1, ["--las_rescore", "--las_dirs", "fw"]),
    (1, ["--las_rescore", "--las_dirs", "bw", "--las_bw_score_scale", "0.9"]),
    (2, ["--las_rescore", "--rnnt_score_scale", "0.5", "--las_fw_score_scale", "0.2"])])
def test_rerank_cli_matches_jax(tmp_path, capsys, ids, dirs, flags):
    """Both rerank CLIs on one N-best file (6 utterances of 4 lines, empty
    hypotheses included, and a trailing short group): the best hypotheses
    byte-identical, the same warning."""
    rng = np.random.default_rng(dirs * 2 + ids)
    _write_nbest(tmp_path / "nbest.txt", rng, 6, 4, dirs, ids)
    with open(tmp_path / "nbest.txt", "a") as f:
        f.write(" ".join(["1" if ids else "a", "0.5"] + ["-0.1"] * (2 * dirs)) + "\n")
    common = ["--nbest", "4", *(["--ids"] if ids else []), *flags]
    rerank_main_jax([str(tmp_path / "nbest.txt"), str(tmp_path / "ref.txt"), *common])
    err_ref = capsys.readouterr().err
    rerank_main([str(tmp_path / "nbest.txt"), str(tmp_path / "got.txt"), *common])
    err = capsys.readouterr().err
    assert (tmp_path / "got.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()
    assert len((tmp_path / "got.txt").read_text().splitlines()) == 7
    assert err == err_ref and "trailing group" in err
