"""The independent-LAS experiment and the seed retune end to end on the
CPU at a tiny size, after a tiny ``mini_grammar`` seed 1: the RESULTS files
hold the JAX files' line forms in their order
(``egs/results/RESULTS.las_ind.seed1``, ``RESULTS.seed2.retune``), a second
invocation redoes no stage and no decode, and the oracle of the recipe's
own N-best files (token ids, and symbol strings through ``char.txt``) is
the JAX tool's line byte for byte."""

import contextlib
import io
import os
import re

import pytest
import torch

from pika_tpu_torch.recipes import las_diversity, mini_grammar, nbest_oracle, retune_grammar_seed
from test_torch_grammar_tools import _jax_tool
from test_torch_recipe import REPO, TINY_BUDGET, TINY_FLAGS, TINY_SWEEPS, _bundles, _line_kinds

torch.set_num_threads(1)

BUDGET = dict(dev=3, text=60, **TINY_BUDGET)


@pytest.fixture(scope="module")
def grammar(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("grammar") / "w")
    assert mini_grammar.run(work, 1, "cpu", TINY_FLAGS, **TINY_SWEEPS, **BUDGET)["ok"]
    return work


def test_las_diversity_end_to_end_and_resume(grammar):
    work = grammar
    run = dict(seed=1, device="cpu", flags=TINY_FLAGS, las_ind_epochs=2, **BUDGET)
    out = las_diversity.run(work, **run)
    assert out["ok"] and all(w is not None for w in out["wer"].values())
    assert set(out["times"]) == {
        "stage 1: independent LAS fw (own BLSTM encoder, 2 epochs)",
        "stage 1: independent LAS bw (own BLSTM encoder, 2 epochs)",
        "decode decode_dev_las_ind.out", "decode decode_mbr_fst_pt_las_ind.out",
        "decode decode_mbr_las_ind.out"}
    exp = f"{work}/exp_seed1"
    assert os.path.isdir(f"{exp}/las_ind_fw/model.epoch.1")
    assert os.path.isdir(f"{exp}/las_ind_bw/model.epoch.1")
    results = f"{work}/RESULTS.las_ind.seed1"
    lines = open(results).read().splitlines()
    reference = open(f"{REPO}/egs/results/RESULTS.las_ind.seed1").read().splitlines()
    assert _line_kinds(lines) == _line_kinds(reference)
    assert all(any(rx.match(line) for rx in las_diversity.RESULT_FORMS.values())
               for line in lines), lines
    assert sum(line.startswith("dev las_scales") for line in lines) == 9
    note = open(f"{exp}/las_ind_sweep.note").read().splitlines()
    assert note[0] == "chosen las_ind_scales " + ":".join(out["las_pair"])

    bundles = _bundles(work)
    again = las_diversity.run(work, **run)
    assert again["times"] == {} and _bundles(work) == bundles
    assert open(results).read().splitlines() == lines


def test_retune_end_to_end_and_resume(grammar):
    work = grammar
    run = dict(seed=1, device="cpu", flags=TINY_FLAGS, fst_scales="0.2,0.8",
               pt_scales="0.4,1.2", las_sweep="0.0:0.0,0.3:0.7", **BUDGET)
    out = retune_grammar_seed.run(work, **run)
    assert all(w is not None for w in out["wer"].values()) and len(out["wer"]) == 5
    # the seed's own dev decodes of mini_grammar are reused: only the LAS
    # sweep and the five test rows decode
    assert set(out["times"]) == {"decode decode_dev_las_rt.out",
                                 *[f"decode decode_{t}.out" for t in out["wer"]]}
    lines = open(f"{work}/RESULTS.seed1.retune").read().splitlines()
    reference = open(f"{REPO}/egs/results/RESULTS.seed2.retune").read().splitlines()
    assert _line_kinds(lines) == _line_kinds(reference)
    again = retune_grammar_seed.run(work, **run)
    assert again["times"] == {}
    assert open(f"{work}/RESULTS.seed1.retune").read().splitlines() == lines


@pytest.mark.parametrize("nbest,symbols", [("nbest_base.txt", False),
                                           ("nbest_fst_pt.txt", True)])
def test_oracle_of_the_recipes_nbest_is_the_jax_tools(grammar, nbest, symbols):
    work = grammar
    argv = [f"{work}/exp_seed1/{nbest}", f"ark:{work}/data/test/label.txt",
            f"{work}/data/test/wav.scp", "4", *([f"{work}/data/char.txt"] if symbols else [])]
    want = _jax_tool("nbest_oracle.py", *argv, cwd=work)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        nbest_oracle.main(argv)
    assert buf.getvalue() == want
    assert re.match(r"1-best WER [0-9.]+% \[\d+/\d+\]  oracle-4 WER [0-9.]+% \[\d+/\d+\]\n$", want)
