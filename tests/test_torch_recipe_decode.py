"""A bundle the port trained, decoded by the JAX decode CLI: the port's
bundle converted to flax variables (``port_to_flax``: the port's flax ->
torch conversion traced with unique ids, as it only moves and transposes
values), then both decode CLIs on one grammar dev set, without an LM and
with per-beam FST fusion on the recipe's bigram ARPA: the same WER line
and the same hypotheses (scores to 1e-4 relative).

Run as a script, it makes the same comparison on a recipe's own work
directory (``mini_grammar``'s bundle, dev set, CMVN and LM)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_recipe_decode.py BUNDLE WORK SCALE [OUT]

printing the JAX CLI's and the port's ``%WER`` lines (``SCALE`` ``none``:
no LM)."""

import dataclasses
import inspect
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import pika_tpu.models.transformer as transformer_jax
from pika_tpu.models.transducer import TransducerConfig as ConfigJax, init_transducer as init_jax
from pika_tpu.train.bundle import save_bundle as save_bundle_jax
from pika_tpu.train.eval_transducer import main as eval_main_jax
import pika_tpu_torch.models.transformer as transformer_pt
from pika_tpu_torch.convert import state_dict_from_flax
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.recipes import hard_corpus, train_ngram
from pika_tpu_torch.recipes.mini_synthetic import decode_flags
from pika_tpu_torch.recipes.stages import Recipe, global_cmvn, wav_to_seq, write_fbank_conf
from pika_tpu_torch.train.bundle import save_bundle
from pika_tpu_torch.train.eval_transducer import main as eval_main

torch.set_num_threads(1)

TINY = dict(input_dim=120, vocab_size=31, hid_dim=16, encoder_type="tdnn_transformer",
            decoder_type="rnn", enc_layers=5, dec_layers=1, embd_dim=8, tdnn_nhid=32,
            tdnn_layers=5, dropout=0.0, tdnn_transformer_dropout=0.0)


def port_to_flax(bundle: str, out: str) -> None:
    """Write a JAX bundle of the port bundle ``bundle`` into ``out``."""
    with open(os.path.join(bundle, "model.json")) as f:
        spec = json.load(f)
    # the port's own fields (the conformer's) have no JAX counterpart
    known = {f.name for f in dataclasses.fields(ConfigJax)}
    cfg = ConfigJax(**{k: v for k, v in spec["config"].items() if k in known})
    variables = jax.jit(lambda key: init_jax(key, cfg, max_t=64)[1])(jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(jax.tree.map(np.asarray, variables))
    sizes = np.cumsum([0] + [x.size for x in leaves])
    ids = [np.arange(a, b, dtype=np.float64).reshape(x.shape)
           for a, b, x in zip(sizes[:-1], sizes[1:], leaves)]
    traced = state_dict_from_flax(jax.tree_util.tree_unflatten(treedef, ids))
    state = torch.load(os.path.join(bundle, "model.pt"), map_location="cpu")
    flat = np.full(sizes[-1], np.nan)
    for name, where in traced.items():
        if not name.endswith("num_batches_tracked"):
            flat[where.numpy().astype(np.int64).ravel()] = state[name].double().numpy().ravel()
    if np.isnan(flat).any():
        raise ValueError(f"{bundle}: {int(np.isnan(flat).sum())} flax values unmapped")
    new = [flat[a:b].reshape(x.shape).astype(x.dtype)
           for a, b, x in zip(sizes[:-1], sizes[1:], leaves)]
    save_bundle_jax(out, "transducer", cfg, jax.tree_util.tree_unflatten(treedef, new))


def decode_both(pt_bundle: str, jax_bundle: str, work: str, scale: str, out: str) -> tuple:
    """Both decode CLIs on ``work``'s dev set with the recipe's decode flags
    (per-beam fusion at ``scale`` unless it is "none"): each CLI's %WER line
    and its N-best lines."""
    os.makedirs(out, exist_ok=True)
    data, dev = f"{work}/data", f"{work}/dev/test"
    flags = ["--ref_labels", f"ark:{dev}/label.txt",
             *decode_flags(f"{work}/fbank.conf", f"{data}/train/global_cmvn.stats")]
    if scale != "none":
        flags += ["--fst_lm", f"{data}/lm.arpa", "--fst_lm_scale", scale,
                  "--fst_fusion", "per_beam", "--symbols_map", f"{data}/char.txt"]
    results = []
    for name, main, bundle, extra in (("jax", eval_main_jax, jax_bundle, []),
                                      ("pt", eval_main, pt_bundle, ["--device", "cpu"])):
        nbest = os.path.join(out, f"{name}_nbest.txt")
        wer = main([bundle, f"{dev}/wav.scp", nbest, *flags, *extra])
        with open(nbest) as f:
            results.append((wer, f.read().splitlines()))
    return tuple(results)


def _split(line):
    """(the hypothesis' text, its score) of an N-best line."""
    text, score = line.rsplit(" ", 1)
    return text, float(score)


@pytest.fixture
def f32_attention(monkeypatch):
    """Attention in float32 in both packages (as ``test_torch_decode_cli.py``:
    a random model's search runs to its symbol cap, where a bf16 rounding in
    either package's attention parts the hypotheses)."""
    init = transformer_jax.MultiHeadedAttention.__init__.__wrapped__
    names = [n for n in inspect.signature(init).parameters if n != "self"]
    defaults = list(init.__defaults__)
    defaults[names.index("mm_dtype") - (len(names) - len(defaults))] = None
    monkeypatch.setattr(init, "__defaults__", tuple(defaults))
    monkeypatch.setattr(transformer_pt, "_bf16", lambda x: x)


@pytest.fixture(scope="module")
def recipe_dir(tmp_path_factory):
    """A grammar dev set, CMVN and bigram LM as mini_grammar makes them, and
    a port bundle of a tiny random model with its flax conversion."""
    work = str(tmp_path_factory.mktemp("decode"))
    data = f"{work}/data"
    hard_corpus.main([data, "--train", "6", "--test", "1", "--grammar_branching", "6",
                      "--grammar_split", "test", "--grammar_text", "80"])
    hard_corpus.main([f"{work}/dev", "--train", "1", "--test", "6", "--seed", "4047",
                      "--grammar_branching", "6", "--grammar_split", "test"])
    write_fbank_conf(f"{work}/fbank.conf")
    recipe = Recipe(work, device="cpu")
    wav_to_seq(recipe, f"{data}/train", "train", f"{work}/fbank.conf")
    global_cmvn(recipe, f"{data}/train", "train", f"{work}/fbank.conf")
    train_ngram.main([f"ark:{data}/grammar_text.txt", f"{data}/char.txt", f"{data}/lm.arpa"])
    model = init_transducer(TransducerConfig(**TINY), torch.Generator().manual_seed(3), "cpu")
    save_bundle(f"{work}/pt_bundle", model)
    port_to_flax(f"{work}/pt_bundle", f"{work}/jax_bundle")
    return work


@pytest.mark.parametrize("scale", ["none", "0.8"])
def test_jax_cli_decodes_a_port_bundle_as_the_port(recipe_dir, tmp_path, f32_attention, scale):
    work = recipe_dir
    (wer_ref, ref), (wer, got) = decode_both(f"{work}/pt_bundle", f"{work}/jax_bundle", work,
                                             scale, str(tmp_path))
    assert wer == pytest.approx(wer_ref, abs=1e-12) and wer is not None
    assert len(got) == len(ref) == 6 * 4
    for line, want in zip(got, ref):
        (text, score), (want_text, want_score) = _split(line), _split(want)
        assert text == want_text
        assert score == pytest.approx(want_score, rel=1e-4)


if __name__ == "__main__":
    bundle, work, scale = sys.argv[1:4]
    out = sys.argv[4] if len(sys.argv) > 4 else os.path.join(work, "decode_both")
    port_to_flax(bundle, os.path.join(out, "jax_bundle"))
    for name, (wer, _) in zip(("JAX CLI", "port CLI"),
                              decode_both(bundle, os.path.join(out, "jax_bundle"), work, scale,
                                          out)):
        print(f"{name}: %WER {wer * 100:.2f}")
