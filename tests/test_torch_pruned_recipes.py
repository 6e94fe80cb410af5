"""The pruned objective's grammar recipes (``pika_tpu_torch/recipes/``
``pruned_grammar``, ``pruned_retune``, ``pruned_finetune``,
``exact_fusion_redecodes``) on the CPU:

* each recipe's command lines equal its script's (``tools/r5_*.sh``), read
  from the script's text with its variables expanded, in the script's
  order: the flags, the epochs, the scale lists, the paths and the tags of
  its ``wer_of`` lines; the fine-tune's directory rule is the script's own
  ``if`` run by bash;
* the RESULTS lines parse to the recipes' forms, in the scripts' order;
* ``pruned_grammar`` end to end at a tiny size after a tiny ``mini_grammar``,
  cut after stage 3a and resumed by a rerun (stage 3b from the warm-up's
  checkpoint), then the retune, the fine-tune with its oracle and its
  ``--sm_scale`` probe, and the exact re-decodes, whose line for an absent
  seed has no WER; a second invocation of each redoes nothing."""

import os
import re
import shlex
import subprocess

import pytest
import torch

import test_torch_recipe
from pika_tpu_torch.recipes import (
    exact_fusion_redecodes,
    mini_grammar,
    pruned_finetune,
    pruned_grammar,
    pruned_retune,
)
from test_torch_recipe import REPO, TINY_BUDGET, TINY_FLAGS, TINY_SWEEPS, W, _bundles, expand

torch.set_num_threads(1)

BUDGET = dict(dev=3, text=60, **TINY_BUDGET)
TOOLS = f"{REPO}/tools"


def _script(name):
    return open(f"{TOOLS}/{name}").read()


def _commands(name, env, monkeypatch):
    """``test_torch_recipe.script_commands`` of a tools script (which also
    runs ``tools/nbest_oracle.py``, whose redirections are cut)."""
    monkeypatch.setitem(test_torch_recipe.KINDS, "tools/nbest_oracle.py", "oracle")
    out = []
    for kind, argv in test_torch_recipe.script_commands(f"{TOOLS}/{name}", env):
        if "2>/dev/null" in argv:
            argv = argv[:argv.index("2>/dev/null")]
        out.append((kind, argv))
    return out


def _tags(name):
    """The tags of the script's ``wer_of`` calls, in order."""
    return re.findall(r"^wer_of (\w+) python", _script(name), re.M)


def _pruned_grammar_case(monkeypatch):
    exp = f"{W}/exp_seed1_pruned"
    env = {"work": W, "data": f"{W}/data", "conf": f"{W}/fbank.conf", "exp": exp, "SEED": "1",
           "model": f"{exp}/model.epoch.159"}
    c = pruned_grammar.Commands(W, 1)
    train, rows = c.training(), c.rows()
    want = [("train", train["train_warmup"]), ("train", train["train"]),
            *[("eval", rows[t]) for t in _tags("r5_pruned_grammar.sh")]]
    assert list(rows) == _tags("r5_pruned_grammar.sh") == ["base", "base_fst", "base_fst_pt"]
    assert c.results == f"{exp}/RESULTS" and c.model == env["model"]
    return _commands("r5_pruned_grammar.sh", env, monkeypatch), want


def _pruned_retune_case(monkeypatch):
    exp = f"{W}/exp_seed1_pruned"
    env = {"work": W, "data": f"{W}/data", "dev": f"{W}/dev", "conf": f"{W}/fbank.conf",
           "exp": exp, "SEED": "1", "model": f"{exp}/model.epoch.159", "best_scale": "S",
           "pt_scale": "P"}
    fst, pt = re.findall(r"for s in (.*); do", _script("r5_pruned_retune.sh"))
    assert fst.split() == pruned_retune.FST_SCALES.split(",")
    assert pt.split() == pruned_retune.PT_SCALES.split(",")
    c = pruned_grammar.Commands(W, 1)
    own = pruned_retune.own_rows(c, "S", "P")
    assert ["base_fst", *own] == _tags("r5_pruned_retune.sh")
    want = [("eval", c.rows()["base_fst"]), *[("eval", c.dev_fst(s)) for s in fst.split()],
            *[("eval", c.dev_pt(s)) for s in pt.split()], *[("eval", a) for a in own.values()]]
    return _commands("r5_pruned_retune.sh", env, monkeypatch), want


def _pruned_finetune_case(monkeypatch):
    exp = f"{W}/exp_seed1_prunedft"
    env = {"work": W, "data": f"{W}/data", "dev": f"{W}/dev", "conf": f"{W}/fbank.conf",
           "exp": exp, "pruned_exp": f"{W}/exp_seed1_pruned", "SEED": "1", "FT_EPOCHS": "10",
           "FT_LR": "0.0002", "last": "9", "model": f"{exp}/model.epoch.9"}
    c = pruned_finetune.Commands(W, 1)
    assert (c.exp, c.model, c.results) == (exp, env["model"], f"{exp}/RESULTS")
    rows, probe = c.rows(), c.sm_probe()
    assert [*rows, *probe] == _tags("r5_pruned_finetune.sh")
    want = [("train", c.finetune()), *[("eval", a) for a in rows.values()],
            ("oracle", c.oracle()), *[("eval", a) for a in probe.values()]]
    return _commands("r5_pruned_finetune.sh", env, monkeypatch), want


def _exact_case(monkeypatch):
    """The script's decode, expanded for each seed of its ``for SEED`` loop
    and each pair of its ``for pair`` loop (``tag=${pair%%:*}``,
    ``mdl=${pair#*:}``)."""
    text = _script("r5_exact_fusion_redecodes.sh")
    seeds = re.search(r"for SEED in (.*); do", text)[1].split()
    assert ",".join(seeds) == exact_fusion_redecodes.SEEDS
    pairs = shlex.split(re.search(r"for pair in (.*); do", text)[1])
    flags = " ".join(re.search(r'^\s*decode_flags="(.*?)"', text, re.S | re.M)[1].split())
    cmd = re.search(r"python -m pika_tpu\.train\.eval_transducer (.*?) > \$o",
                    re.sub(r"\\\n\s*", " ", text))[1]
    pt_scale = re.search(r"^pt_scale=(\S+)", text, re.M)[1]
    got, want = [], []
    for seed in seeds:
        exp = f"{W}/exp_seed{seed}"
        env = {"work": W, "data": f"{W}/data", "conf": f"{W}/fbank.conf", "exp": exp,
               "SEED": seed, "model": f"{exp}/model.epoch.159",
               "mbr_model": f"{exp}/mbr/model.epoch.1", "pt_scale": pt_scale,
               "decode_flags": flags}
        for pair in pairs:
            pair = expand(pair, env)
            tag, mdl = pair.split(":", 1)
            got.append(("eval", shlex.split(expand(cmd, {**env, "tag": tag, "mdl": mdl}))))
        rows = exact_fusion_redecodes.exact_rows(mini_grammar.Commands(W, int(seed)))
        want += [("eval", argv) for argv in rows.values()]
        assert list(rows) == [p.split(":")[0] for p in pairs]
    return got, want


@pytest.mark.parametrize("case", [_pruned_grammar_case, _pruned_retune_case,
                                  _pruned_finetune_case, _exact_case],
                         ids=["pruned_grammar", "pruned_retune", "pruned_finetune",
                              "exact_fusion_redecodes"])
def test_recipe_commands_are_the_scripts(case, monkeypatch):
    got, want = case(monkeypatch)
    assert got == want


@pytest.mark.parametrize("epochs,lr", [(10, "0.0002"), (40, "0.0005"), (10, "2e-4"),
                                       (20, "0.0002")])
def test_finetune_directory_is_the_scripts_rule(epochs, lr):
    """The script's own ``FT_LR`` default and ``if`` block, run by bash."""
    text = _script("r5_pruned_finetune.sh")
    block = re.search(r"^FT_LR=.*?^fi$", text, re.S | re.M)[0]
    env = dict(os.environ, work=W, SEED="1", FT_EPOCHS=str(epochs), FT_LR=lr)
    got = subprocess.run(["bash", "-c", block + '\necho "$exp"'], env=env, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert pruned_finetune.Commands(W, 1, epochs, lr).exp == got


def test_result_forms():
    """The forms parse the scripts' lines and nothing else."""
    good = {
        "wer": "base_fst_own %WER 12.53 [ 301 / 2402, 12 ins, 99 del, 190 sub ]",
        "sweep": "dev pt fst_lm_scale 1.6 -> WER 4.47",
        "chosen": "chosen fst_lm_scale 0.8 (dev WER 11.70)",
        "heading": "### 4-best oracle after fine-tune",
        "oracle": "1-best WER 14.64% [352/2404]  oracle-4 WER 13.01% [313/2404]",
        "exact": "seed2 mbr_fst_pt_exact %WER 5.46",
    }
    for form, line in good.items():
        assert [k for k, _ in pruned_grammar.parse_results([line])] == [form]
    assert [k for k, _ in pruned_grammar.parse_results(["seed3 base_fst_pt_exact "])] == ["exact"]
    assert [k for k, _ in pruned_grammar.parse_results(["chosen fst_lm_scale  (dev WER 1e9)"])
            ] == ["chosen"]
    for bad in ("base decode failed; skipping", "seed3 base_fst_pt_exact", "### other"):
        with pytest.raises(ValueError):
            pruned_grammar.parse_results([bad])


def test_pruned_grammar_needs_the_corpus(tmp_path, capsys):
    out = pruned_grammar.run(str(tmp_path / "empty"), device="cpu", **BUDGET)
    assert not out["ok"] and "run mini_grammar" in capsys.readouterr().out
    assert not pruned_finetune.run(str(tmp_path / "empty"), device="cpu", **BUDGET)["ok"]


@pytest.fixture(scope="module")
def envelope(tmp_path_factory):
    """A tiny ``mini_grammar`` seed 1, then ``pruned_grammar`` cut in stage
    3b (its training raises there) and run again, then the retune, the
    fine-tune (1 epoch) and the exact re-decodes of seeds 1 and 2 (seed 2
    absent)."""
    from pika_tpu_torch.train import train_transducer

    work = str(tmp_path_factory.mktemp("pruned") / "w")
    assert mini_grammar.run(work, 1, "cpu", TINY_FLAGS, **TINY_SWEEPS, **BUDGET)["ok"]
    run = dict(seed=1, device="cpu", flags=TINY_FLAGS, **BUDGET)
    real = train_transducer.main

    class Cut(Exception):
        pass

    def killed_in_3b(argv):
        if "--resume" in argv:
            raise Cut
        return real(argv)

    train_transducer.main = killed_in_3b
    try:
        with pytest.raises(Cut):
            pruned_grammar.run(work, **run)
    finally:
        train_transducer.main = real
    exp = f"{work}/exp_seed1_pruned"
    cut = sorted(os.listdir(exp))
    out = {"work": work, "run": run, "cut": cut,
           "grammar": pruned_grammar.run(work, **run),
           "retune": pruned_retune.run(work, **run),
           "finetune": pruned_finetune.run(work, ft_epochs=1, **run),
           "exact": exact_fusion_redecodes.run(work, "1,2", **{k: v for k, v in run.items()
                                                               if k != "seed"})}
    return out


def _kinds(path):
    return [k for k, _ in pruned_grammar.parse_results(open(path).read().splitlines())]


def test_pruned_grammar_cut_resumes(envelope):
    e = envelope
    exp = f"{e['work']}/exp_seed1_pruned"
    assert "model.epoch.0" in e["cut"] and "model.epoch.1" not in e["cut"]
    out = e["grammar"]
    assert out["ok"] and all(w is not None for w in out["wer"].values())
    assert "stage 3b (pruned): noise training to epoch 2" in out["times"]
    assert not any(t.startswith("stage 3a") for t in out["times"])
    # the warm-up's epoch and the resumed noisy epoch, each logged once
    assert len(out["losses"]["warmup"]) == 1 and len(out["losses"]["train"]) == 1
    assert "--pruned_loss_range 5 --simple_loss_scale 0.5 --pruned_warmup_epochs 5" in " ".join(
        pruned_grammar.Commands(e["work"], 1, **BUDGET).training()["train"])
    assert os.path.isdir(f"{exp}/model.epoch.1")


def test_pruned_results_in_the_scripts_order(envelope):
    e = envelope
    exp = f"{e['work']}/exp_seed1_pruned"
    sweeps = len(pruned_retune.FST_SCALES.split(",")), len(pruned_retune.PT_SCALES.split(","))
    assert _kinds(f"{exp}/RESULTS") == (
        ["wer"] * 3 + ["wer"] + ["sweep"] * sweeps[0] + ["chosen"] + ["sweep"] * sweeps[1]
        + ["chosen", "wer", "wer"])
    lines = open(f"{exp}/RESULTS").read().splitlines()
    assert [line.split()[0] for line in lines if "%WER" in line] == [
        "base", "base_fst", "base_fst_pt", "base_fst", "base_fst_own", "base_fst_pt_own"]
    assert e["retune"]["fst_scale"] in pruned_retune.FST_SCALES.split(",")
    ft = f"{e['work']}/exp_seed1_prunedft1_0.0002"
    assert _kinds(f"{ft}/RESULTS") == ["wer"] * 3 + ["heading", "oracle"] + ["wer"] * 2
    assert open(f"{ft}/RESULTS").read().splitlines()[4] == e["finetune"]["oracle"]
    assert list(e["finetune"]["wer"]) == ["base", "base_fst", "base_fst_pt", "dev_sm05_fst",
                                          "dev_sm05_pt"]
    assert len(e["finetune"]["losses"]) == 1


def test_exact_redecodes_leave_an_absent_seed_without_wer(envelope):
    e = envelope
    lines = open(f"{e['work']}/RESULTS.exact_fusion").read().splitlines()
    assert lines[2:] == ["seed2 base_fst_pt_exact ", "seed2 mbr_fst_pt_exact "]
    assert all(re.match(r"seed1 (base|mbr)_fst_pt_exact %WER [0-9.]+$", line)
               for line in lines[:2]), lines
    assert set(_kinds(f"{e['work']}/RESULTS.exact_fusion")) == {"exact"}


def test_recipes_rerun_nothing(envelope):
    """Every stage guarded and every decode reused: a second invocation of
    each recipe trains and decodes nothing and rewrites no bundle, and the
    RESULTS files come out the same (the retune appends its lines again, as
    the script does)."""
    e = envelope
    work, run = e["work"], e["run"]
    exp, ft = f"{work}/exp_seed1_pruned", f"{work}/exp_seed1_prunedft1_0.0002"
    bundles = _bundles(work)
    before = {p: open(p).read() for p in (f"{exp}/RESULTS", f"{ft}/RESULTS",
                                          f"{work}/RESULTS.exact_fusion")}
    assert pruned_grammar.run(work, **run)["times"] == {}
    first = before[f"{exp}/RESULTS"].splitlines()
    assert open(f"{exp}/RESULTS").read().splitlines() == first[:3]
    assert pruned_retune.run(work, **run)["times"] == {}
    assert open(f"{exp}/RESULTS").read() == before[f"{exp}/RESULTS"]
    assert pruned_finetune.run(work, ft_epochs=1, **run)["times"] == {}
    assert exact_fusion_redecodes.run(work, "1,2", **{k: v for k, v in run.items()
                                                      if k != "seed"})["times"] == {}
    assert _bundles(work) == bundles
    assert all(open(p).read() == text for p, text in before.items())
