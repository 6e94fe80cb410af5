"""The grammar-matrix tools of the port against the JAX package's tools and
scripts, on the CPU:

* ``recipes/nbest_oracle.py`` prints ``tools/nbest_oracle.py``'s line byte
  for byte (N-best files of token ids with scores, and of symbol strings
  re-tokenised through a symbols map), and ``recipes/summarize_grammar.py``
  ``tools/summarize_grammar.py``'s table on the committed
  ``egs/results/RESULTS.seed*`` (the JAX tools run as subprocesses);
* ``recipes/grammar_seeds.py`` reads seed 1's scales as
  ``tools/run_grammar_seeds.sh``'s ``awk`` does (the script's own lines run
  by bash), hands them to seeds 2 and 3, and retries an incomplete seed;
* the command lines of ``recipes/retune_grammar_seed.py`` and
  ``recipes/las_diversity.py`` are the scripts' text expanded
  (``tools/retune_grammar_seed.sh``, ``egs/las_diversity.sh``);
* ``las_diversity`` picks the pair as the script does on the JAX seed-1
  sweep (0.2:0.2 over a tied 0.3:0.3), and exits 1 with the script's
  message without the MBR bundle;
* the command lines of ``grammar_seeds`` and ``las_diversity`` hand their
  flags on to ``run`` (``las_diversity`` takes no sweep lists)."""

import contextlib
import io
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pika_tpu_torch.recipes import (
    grammar_seeds,
    las_diversity,
    mini_grammar,
    nbest_oracle,
    retune_grammar_seed,
    summarize_grammar,
)
from pika_tpu_torch.recipes.stages import run_main
from test_torch_recipe import W, script_commands

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_UTTS, N_BEST = 5, 4


def _jax_tool(script, *argv, cwd) -> str:
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", script), *argv], env=env,
                       cwd=cwd, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


def _port_stdout(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def nbest_files(tmp_path_factory):
    """wav.scp, labels, a symbols map (``w1`` .. ``w30``: longest match
    matters) and two N-best files of the same hypotheses: token ids with
    float scores, and symbol strings."""
    d = tmp_path_factory.mktemp("nbest")
    rng = np.random.default_rng(0)
    (d / "char.txt").write_text("<blk> 0\n" + "".join(f"w{i} {i}\n" for i in range(1, 31)))
    scp, labels, ids, syms = [], [], [], []
    for u in range(N_UTTS):
        utt = f"utt{u:02d}"
        ref = rng.integers(1, 31, rng.integers(2, 7))
        scp.append(f"{utt} /nowhere/{utt}.wav\n")
        labels.append(utt + " " + " ".join(map(str, ref)) + "\n")
        for j in range(N_BEST):
            hyp = ref.copy() if j == N_BEST - 1 - u % N_BEST else rng.integers(1, 31, len(ref))
            hyp = hyp[:len(hyp) - (j % 2)] if u != 2 or j else hyp[:0]  # an empty hypothesis
            scores = " ".join(f"{s:.6f}" for s in rng.standard_normal(3) - 10)
            ids.append(" ".join([*map(str, hyp), scores]) + "\n")
            syms.append("".join(f"w{t}" for t in hyp) + f" {scores.split()[0]}\n")
    (d / "wav.scp").write_text("".join(scp))
    (d / "label.txt").write_text("".join(labels))
    (d / "nbest_ids.txt").write_text("".join(ids))
    (d / "nbest_syms.txt").write_text("".join(syms))
    return d


@pytest.mark.parametrize("kind", ["ids", "syms"])
def test_nbest_oracle_prints_the_jax_tools_line(nbest_files, kind):
    d = nbest_files
    argv = [str(d / f"nbest_{kind}.txt"), f"ark:{d}/label.txt", str(d / "wav.scp"), str(N_BEST)]
    if kind == "syms":
        argv.append(str(d / "char.txt"))
    want = _jax_tool("nbest_oracle.py", *argv, cwd=str(d))
    got = _port_stdout(nbest_oracle.main, argv)
    assert got == want
    first, best = re.findall(r"WER ([0-9.]+)%", got)
    assert float(best) < float(first)  # one utterance in four has its reference in the list


def test_nbest_oracle_rejects_a_short_file(nbest_files):
    d = nbest_files
    short = d / "short.txt"
    short.write_text("".join((d / "nbest_ids.txt").read_text().splitlines(True)[:-1]))
    with pytest.raises(SystemExit, match=f"{N_BEST * N_UTTS - 1} lines != {N_BEST} x {N_UTTS}"):
        nbest_oracle.main([str(short), f"ark:{d}/label.txt", str(d / "wav.scp"), str(N_BEST)])


def test_summarize_grammar_prints_the_jax_tools_table(tmp_path):
    for name in os.listdir(f"{REPO}/egs/results"):
        if name.startswith("RESULTS.seed"):
            shutil.copy(f"{REPO}/egs/results/{name}", tmp_path / name)
    want = _jax_tool("summarize_grammar.py", str(tmp_path), cwd=str(tmp_path))
    assert _port_stdout(summarize_grammar.main, [str(tmp_path)]) == want
    assert "| base | 17.19 | 27.72 | 23.86 | 22.92 | 10.53 |" in want.splitlines()


SEED1_FORMS = {
    "every scale": ["chosen fst_lm_scale 0.4 (dev WER 9.1)", "base_fst %WER 6.85 [ 1 / 2 ]",
                    "chosen fst_lm_scale 0.8 (dev WER 6.74)",
                    "chosen pt fst_lm_scale 1.6 (dev WER 3.83)",
                    "chosen las_scales fw 0.05 bw 0.3"],
    "a scale missing, one empty": ["chosen fst_lm_scale 0.8 (dev WER 6.74)",
                                   "chosen pt fst_lm_scale"],
}


@pytest.mark.parametrize("case", list(SEED1_FORMS))
def test_reused_scales_are_the_scripts_awk(tmp_path, case):
    (tmp_path / "RESULTS.seed1").write_text("\n".join(SEED1_FORMS[case]) + "\n")
    text = open(f"{REPO}/tools/run_grammar_seeds.sh").read()
    awks = dict(re.findall(r"(\w+)=\$\((awk .*?RESULTS\.seed1 \| tail -1)\)", text))
    assert set(awks) == {"fs", "pt", "lp"}
    script = f"work={tmp_path}\n" + "".join(f"{k}=$({v})\necho \"{k}=${k}\"\n"
                                             for k, v in awks.items())
    shell = subprocess.run(["bash", "-c", script], capture_output=True, text=True, check=True)
    by_awk = dict(line.split("=", 1) for line in shell.stdout.splitlines())
    names = {"fs": "fst_scale", "pt": "pt_scale", "lp": "las_pair"}
    # the script sets a scale only where its awk printed a value ([ -n "$x" ])
    want = {names[k]: v for k, v in by_awk.items() if v}
    assert grammar_seeds.reused_scales(str(tmp_path / "RESULTS.seed1")) == want
    if case == "every scale":
        assert want == {"fst_scale": "0.8", "pt_scale": "1.6", "las_pair": "0.05:0.3"}


def test_grammar_seeds_hand_on_seed_1s_scales_and_retry(tmp_path, monkeypatch):
    work = str(tmp_path)
    calls = []

    def fake_run(w, seed, **kw):
        calls.append((seed, {k: kw.get(k) for k in ("fst_scale", "pt_scale", "las_pair")}))
        attempt = sum(s == seed for s, _ in calls)
        lines = ["base %WER 20.00 [ 1 / 5, 0 ins, 0 del, 1 sub ]"]
        if seed == 1:
            lines += ["chosen fst_lm_scale 1.2 (dev WER 11.21)",
                      "chosen las_scales fw 0.1 bw 0.2",
                      "chosen pt fst_lm_scale 1.6 (dev WER 4.47)"]
        if seed == 2 and attempt == 1:
            raise RuntimeError("a lost attempt")
        if seed != 2 or attempt == 3:
            lines.append(f"mbr_fst_pt_las %WER {seed}.00 [ 1 / 5, 0 ins, 0 del, 1 sub ]")
        with open(mini_grammar.Commands(w, seed).results, "w") as f:
            f.write("\n".join(lines) + "\n")
        return {"seed": seed}

    monkeypatch.setattr(mini_grammar, "run", fake_run)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        out = grammar_seeds.run(work, device="cpu")
    reused = {"fst_scale": "1.2", "pt_scale": "1.6", "las_pair": "0.1:0.2"}
    none = dict.fromkeys(reused)
    assert calls == [(1, none), (2, reused), (2, reused), (2, reused), (3, reused)]
    log = buf.getvalue()
    assert "seed 2 reusing seed-1 scales: FST_SCALE=1.2 PT_SCALE=1.6 LAS_PAIR=0.1:0.2" in log
    assert "===== SEED 2 attempt 1 incomplete; retrying =====" in log
    assert "===== SEED 2 attempt 2 incomplete; retrying =====" in log
    assert re.search(r"===== SEED 2 complete .* =====", log)
    assert out["table"][0] == "| Stage | seed 1 | seed 2 | seed 3 | mean | spread |"
    assert "| mbr_fst_pt_las | 1.00 | 2.00 | 3.00 | 2.00 | 2.00 |" in out["table"]


def _env(seed: int, **extra) -> dict:
    exp = f"{W}/exp_seed{seed}"
    return {"work": W, "data": f"{W}/data", "dev": f"{W}/dev", "exp": exp,
            "conf": f"{W}/fbank.conf", "SEED": str(seed), "model": f"{exp}/model.epoch.159",
            "mbr_model": f"{exp}/mbr/model.epoch.1", "rev": "", **extra}


def test_retune_commands_are_the_scripts():
    script = f"{REPO}/tools/retune_grammar_seed.sh"
    got = script_commands(script, _env(2, best_scale="S", pt_scale="P", las_fw_scale="F",
                                       las_bw_scale="B"))
    fst, pt = re.findall(r"for s in (.*); do", open(script).read())
    assert fst.split() == retune_grammar_seed.FST_SCALES.split(",")
    assert pt.split() == retune_grammar_seed.PT_SCALES.split(",")
    c = retune_grammar_seed.Commands(W, seed=2)
    want = [*[("eval", c.dev_fst(s)) for s in fst.split()],
            *[("eval", c.dev_pt(s)) for s in pt.split()],
            ("eval", c.dev_las_rt("P", retune_grammar_seed.LAS_SWEEP)),
            *[("eval", argv) for argv in c.retuned("S", "P", "F", "B").values()]]
    assert got == want


def test_las_diversity_commands_are_the_scripts():
    got = script_commands(f"{REPO}/egs/las_diversity.sh",
                          _env(1, pt_scale="P", fw_scale="F", bw_scale="B"))
    c = las_diversity.Commands(W, seed=1)
    want = [("las", c.las_ind("fw")), ("las", c.las_ind("bw")),
            ("eval", c.dev_las_ind("P", las_diversity.LAS_IND_SWEEP)),
            *[("eval", argv) for argv in c.tagged_ind("P", "F", "B").values()]]
    assert got == want
    assert "--shared_encoder_model" not in c.las_ind("fw")
    assert c.las_ind_models[0] == f"{W}/exp_seed1/las_ind_fw/model.epoch.39"


def test_las_diversity_pair_tie_rule_on_the_jax_sweep(tmp_path):
    """The JAX seed-1 sweep has 0.2:0.2 and 0.3:0.3 tied at 2.77 %: the
    script's ``sort -g | head -1`` took 0.2:0.2."""
    jax_lines = open(f"{REPO}/egs/results/RESULTS.las_ind.seed1").read().splitlines()
    sweep = [line[len("dev "):] for line in jax_lines if line.startswith("dev las_scales")]
    out = tmp_path / "decode_dev_las_ind.out"
    out.write_text("decoding...\n" + "\n".join(sweep) + "\n%WER 3.90 [ 55 / 1410 ]\n")
    pair, lines = mini_grammar.best_las_pair(str(out))
    assert pair == "0.2:0.2" and lines == sweep
    chosen = [line for line in jax_lines if line.startswith("chosen")]
    assert chosen == [f"chosen las_ind_scales fw {pair.split(':')[0]} bw {pair.split(':')[1]}"]
    kinds = [next(k for k, rx in las_diversity.RESULT_FORMS.items() if rx.match(line))
             for line in jax_lines]
    assert kinds == ["sweep"] * 9 + ["pair", "wer", "wer"]


def test_las_diversity_exits_1_without_the_mbr_bundle(tmp_path, monkeypatch, capsys):
    work = str(tmp_path / "grammar")
    monkeypatch.setattr(sys, "argv", ["las_diversity", work, "--device", "cpu"])
    with pytest.raises(SystemExit) as exc:
        run_main(las_diversity.main)
    assert exc.value.code == 1
    assert "seed 1 mbr model missing; run mini_grammar.sh first" in capsys.readouterr().out
    assert open(f"{work}/RESULTS.las_ind.seed1").read() == ""


def test_grammar_seeds_cli_hands_the_budget_and_sweeps_to_every_seed(tmp_path, monkeypatch):
    """The command line runs seeds 1-3 with the budget, the device, ``--set``
    and the sweep lists, seeds 2 and 3 at seed 1's scales."""
    work = str(tmp_path)
    calls = []

    def fake_run(w, seed, **kw):
        calls.append((seed, kw))
        lines = ["mbr_fst_pt_las %WER 3.00 [ 1 / 5, 0 ins, 0 del, 1 sub ]"]
        if seed == 1:
            lines += SEED1_FORMS["every scale"]
        with open(mini_grammar.Commands(w, seed).results, "w") as f:
            f.write("\n".join(lines) + "\n")

    monkeypatch.setattr(mini_grammar, "run", fake_run)
    with contextlib.redirect_stdout(io.StringIO()):
        assert grammar_seeds.main([work, "--device", "cpu", "--epochs", "2", "--fst_scales",
                                   "0.4", "--set", "batch_size=4"])
    assert [seed for seed, _ in calls] == [1, 2, 3]
    for seed, kw in calls:
        assert (kw["device"], kw["epochs"], kw["fst_scales"]) == ("cpu", 2, "0.4")
        assert kw["flags"] == {"--batch_size": "4"} and kw["train"] == mini_grammar.TRAIN
        scales = {k: kw.get(k) for k in ("fst_scale", "pt_scale", "las_pair")}
        assert scales == (dict.fromkeys(scales) if seed == 1 else
                          {"fst_scale": "0.8", "pt_scale": "1.6", "las_pair": "0.05:0.3"})


def test_las_diversity_cli_takes_the_budget_and_no_sweep_lists(monkeypatch):
    """``las_diversity`` has no per-beam or per-token sweep, so it refuses
    their flags; the budget, ``--set`` and ``--las_ind_epochs`` reach
    ``run``."""
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        las_diversity.build_parser().parse_args(["w", "--fst_scales", "0.4"])
    got = {}
    monkeypatch.setattr(las_diversity, "run", lambda work, seed, **kw: (
        got.update(work=work, seed=seed, **kw), {"ok": True})[1])
    assert las_diversity.main(["w", "--seed", "2", "--device", "cpu", "--las_ind_epochs", "2",
                               "--epochs", "3", "--set", "batch_size=4"])
    assert (got["work"], got["seed"], got["device"]) == ("w", 2, "cpu")
    assert (got["las_ind_epochs"], got["epochs"], got["pt_scale"]) == (2, 3, las_diversity.PT_SCALE)
    assert got["flags"] == {"--batch_size": "4"} and "las_sweep" not in got
