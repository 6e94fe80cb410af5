"""The port's quality recipes (``pika_tpu_torch/recipes/``) on the CPU:

* each recipe's default command lines equal the shell scripts' own
  (``egs/mini_synthetic.sh``, ``egs/mini_grammar.sh``), read from the
  scripts' text with their variables expanded, in the scripts' order; the
  probe's equal ``tests/test_convergence_probe.py``'s;
* both recipes run end to end at a tiny size with ``--device cpu``, and
  ``RESULTS`` holds the JAX recipe's lines in its order;
* a second invocation skips every finished stage and rewrites no bundle;
* a decode that fails or runs past its time limit is recorded as failed
  ("decode failed; skipping"), never as a WER, and is retried by the next
  invocation."""

import ast
import os
import re
import shlex
import time

import torch

import pika_tpu_torch.train.eval_transducer as eval_module
from pika_tpu_torch.recipes import mini_grammar, mini_synthetic, probe
from pika_tpu_torch.recipes.stages import prep_commands

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = "/W"  # the work directory the command lines are compared at
KINDS = {"tools/make_hard_corpus.py": "corpus", "tools/train_ngram.py": "ngram",
         "pika_tpu.data.prep": "prep", "pika_tpu.train.train_transducer": "train",
         "pika_tpu.train.eval_transducer": "eval", "pika_tpu.train.train_mbr": "mbr",
         "pika_tpu.train.train_las": "las"}
# a tiny model and budget, set through the recipes' overrides
TINY_FLAGS = {"--tdnn_nhid": "32", "--tdnn_layers": "5", "--enc_layers": "5",
              "--rnn_size": "16", "--embd_dim": "8", "--num_batches_per_epoch": "2",
              "--batch_size": "4"}
TINY_BUDGET = dict(train=12, test=3, warmup_epochs=1, epochs=2, mbr_epochs=1, las_epochs=1)
TINY_SWEEPS = dict(fst_scales="0.2,0.8", pt_scales="0.4,1.2", las_sweep="0.05:0.05,0.3:0.7")


def script_commands(path: str, env: dict) -> list:
    """(kind, argv) of every ``python`` command of a shell recipe, in order,
    with its variables expanded from ``env`` and the script's own quoted
    assignments; a command inside a ``for V in ...`` loop once per value."""
    text = open(path).read()
    env = dict(env)
    for name, value in re.findall(r'^(\w+_flags)="(.*?)"', text, re.S | re.M):
        env[name] = " ".join(value.split())
    lines, loops, out = [], [], []
    for line in re.sub(r"\\\n\s*", " ", text).splitlines():
        line = line.strip()
        if line.startswith("#"):
            continue
        loop = re.match(r"for (\w+) in (.*); do", line)
        if loop:
            loops.append((loop[1], loop[2].split()))
            continue
        if line == "done":
            loops.pop()
            continue
        cmd = re.search(r"\bpython (?:-m )?(?!-c)(\S+)(.*)", line)
        if not cmd:
            continue
        rest = re.split(r" > | 2>&1| \|\| ", cmd[2])[0]
        values = [{}] if not loops else [{loops[-1][0]: v} for v in loops[-1][1]]
        for bound in values:
            local = {**env, **bound}
            if local.get("d") == "bw":
                local["rev"] = "--reverse_labels"
            out.append((KINDS[cmd[1]], shlex.split(expand(rest, local))))
    return out


def expand(text: str, env: dict) -> str:
    while True:
        new = re.sub(r"\$\{?(\w+)\}?", lambda m: env.get(m[1], m[0]), text)
        if new == text:
            return text
        text = new


def test_mini_synthetic_commands_are_the_scripts():
    env = {"work": W, "data": f"{W}/data", "exp": f"{W}/exp", "conf": f"{W}/fbank.conf",
           "model": f"{W}/exp/model.epoch.159", "mbr_model": f"{W}/mbr/model.epoch.1",
           "rev": ""}
    got = script_commands(f"{REPO}/egs/mini_synthetic.sh", env)
    c = mini_synthetic.commands(W)
    prep = prep_commands(f"{W}/data/train", "train", f"{W}/fbank.conf")
    want = [("corpus", c["corpus"]), ("prep", prep[0]), ("prep", prep[1]),
            ("train", c["train_warmup"]), ("train", c["train"]), ("eval", c["decode_noisy"]),
            ("eval", c["decode_clean"]), ("mbr", c["mbr"]), ("las", c["las_fw"]),
            ("las", c["las_bw"]), ("eval", c["decode_rescored"])]
    assert got == want
    # the one decode the port adds: the rescored decode without its rescorers
    i = c["decode_rescored"].index("--las_rescorer_model")
    assert c["decode_mbr"] == [*c["decode_rescored"][:2], f"{W}/nbest_noisy_mbr.txt",
                               *c["decode_rescored"][3:i], *c["decode_rescored"][i + 8:]]


def test_mini_grammar_commands_are_the_scripts():
    exp = f"{W}/exp_seed1"
    env = {"work": W, "data": f"{W}/data", "dev": f"{W}/dev", "exp": exp,
           "conf": f"{W}/fbank.conf", "SEED": "1", "model": f"{exp}/model.epoch.159",
           "mbr_model": f"{exp}/mbr/model.epoch.1", "best_scale": "S", "pt_scale": "P",
           "las_fw_scale": "F", "las_bw_scale": "B", "rev": ""}
    script = f"{REPO}/egs/mini_grammar.sh"
    got = script_commands(script, env)
    text = open(script).read()
    fst, pt = re.findall(r"for s in (.*); do", text)
    assert fst.split() == mini_grammar.FST_SCALES.split(",")
    assert pt.split() == mini_grammar.PT_SCALES.split(",")
    c = mini_grammar.Commands(W, seed=1)
    train, tagged = c.training(), c.tagged("S", "P", "F", "B")
    prep = prep_commands(f"{W}/data/train", "train", f"{W}/fbank.conf")
    evals = lambda *tags: [("eval", tagged[t]) for t in tags]  # noqa: E731
    want = [("corpus", c.corpus()), ("corpus", c.dev_corpus()), ("prep", prep[0]),
            ("prep", prep[1]), ("ngram", c.ngram()), ("train", train["train_warmup"]),
            ("train", train["train"]), *evals("base", "dev_base"),
            *[("eval", c.dev_fst(s)) for s in fst.split()], *evals("base_fst"),
            ("mbr", c.mbr()), *evals("mbr", "mbr_fst"), ("las", c.las("fw")),
            ("las", c.las("bw")), ("eval", c.dev_las("S", mini_grammar.LAS_SWEEP)),
            *evals("mbr_las", "mbr_las_fst"), *[("eval", c.dev_pt(s)) for s in pt.split()],
            *evals("base_fst_pt", "mbr_fst_pt", "mbr_fst_pt_las")]
    assert got == want


def test_probe_commands_are_the_jax_probes():
    """The JAX probe's corpus and training argv (``run([...])`` in its test),
    its work directory ``d`` substituted; and its gates."""
    source = open(f"{REPO}/tests/test_convergence_probe.py").read()
    lists = [node for node in ast.walk(ast.parse(source)) if isinstance(node, ast.List)
             and node.elts and isinstance(node.elts[0], (ast.Constant, ast.JoinedStr))]
    found = [eval(ast.unparse(node), {"d": W, "repo": "/R"}) for node in lists]  # noqa: S307
    corpus = next(x for x in found if x[0] == "/R/tools/make_hard_corpus.py")
    train = next(x for x in found if x[:2] == ["-m", "pika_tpu.train.train_transducer"])
    c = probe.commands(W)
    assert c["corpus"] == corpus[1:]
    assert c["train"] == train[2:]
    assert probe.missed_gates([14.9, 9, 9, 4.4, 9, 9, 9, 9, 9, 9, 9, 1.9]) == []
    assert len(probe.missed_gates([15.0, 9, 9, 4.5] + [9] * 7 + [2.0])) == 3
    assert len(probe.missed_gates([1.0] * 11)) == 1


def _bundles(work):
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, names in os.walk(work) for f in names if f == "model.pt"}


def _line_kinds(lines):
    """Each RESULTS line with its numbers blanked; a run of equal kinds once
    (the sweeps' lines, whose count follows the sweep lists)."""
    kinds = [re.sub(r"[0-9]+(\.[0-9]+)?", "N", line) for line in lines]
    return [k for i, k in enumerate(kinds) if i == 0 or k != kinds[i - 1]]


def test_mini_synthetic_end_to_end_and_resume(tmp_path):
    work = str(tmp_path / "mini")
    out = mini_synthetic.run(work, "cpu", full_pipeline=True, flags=TINY_FLAGS, **TINY_BUDGET)
    lines = open(f"{work}/RESULTS").read().splitlines()
    assert [line.split()[0] for line in lines] == ["noisy", "clean", "mbr", "mbr_las"]
    assert all(re.match(r"\w+ %WER [0-9.]+ \[ \d+ / \d+, \d+ ins, \d+ del, \d+ sub \]$", line)
               for line in lines), lines
    assert all(w is not None for w in out["wer"].values())
    assert len(out["losses"]["warmup"]) == 1 and len(out["losses"]["train"]) == 1
    bundles = _bundles(work)
    assert len(bundles) == 5  # two RNN-T epochs, MBR, LAS fw and bw
    again = mini_synthetic.run(work, "cpu", full_pipeline=True, flags=TINY_FLAGS,
                               **TINY_BUDGET)
    assert again["times"] == {}  # no stage ran, no decode ran
    assert _bundles(work) == bundles
    assert open(f"{work}/RESULTS").read().splitlines() == lines


def test_mini_grammar_end_to_end_resume_and_failed_decodes(tmp_path, monkeypatch):
    work = str(tmp_path / "grammar")
    run = dict(seed=1, device="cpu", flags=TINY_FLAGS, dev=3, text=60, **TINY_SWEEPS,
               **TINY_BUDGET)
    out = mini_grammar.run(work, **run)
    assert out["ok"]
    results = f"{work}/RESULTS.seed1"
    lines = open(results).read().splitlines()
    reference = open(f"{REPO}/egs/results/RESULTS.seed1").read().splitlines()
    assert _line_kinds(lines) == _line_kinds(reference)
    assert sum(line.startswith("dev fst_lm_scale") for line in lines) == 2
    assert all(w is not None for w in out["wer"].values()) and len(out["wer"]) == 10
    assert os.path.exists(f"{work}/data/lm.arpa")
    bundles = _bundles(work)
    assert len(bundles) == 5

    again = mini_grammar.run(work, **run)
    assert again["times"] == {} and _bundles(work) == bundles
    assert open(results).read().splitlines() == lines

    # a decode that raises and one past its time limit: recorded as failed
    # and retried by the next invocation
    real_main = eval_module.main

    def failing_main(argv):
        if f"{work}/exp_seed1/nbest_dev_fst0.8.txt" in argv:
            raise RuntimeError("decode broke")
        if f"{work}/exp_seed1/nbest_mbr.txt" in argv:
            time.sleep(60)
        return real_main(argv)

    for name in ("decode_devfst0.8.out", "decode_mbr.out"):
        os.remove(f"{work}/exp_seed1/{name}")
    monkeypatch.setattr(eval_module, "main", failing_main)
    t0 = time.perf_counter()
    failed = mini_grammar.run(work, decode_timeout=2.0, **run)
    assert time.perf_counter() - t0 < 30
    failed_lines = open(results).read().splitlines()
    assert "dev fst_lm_scale 0.8 -> decode failed; skipping" in failed_lines
    assert "mbr decode failed; skipping" in failed_lines
    assert failed["wer"]["mbr"] is None
    assert not any(re.match(r"(mbr|dev fst_lm_scale 0\.8) .*WER", line) for line in failed_lines)
    assert not os.path.exists(f"{work}/exp_seed1/decode_mbr.out")
    assert "DecodeTimeout" in open(f"{work}/exp_seed1/decode_mbr.out.failed").read()

    monkeypatch.setattr(eval_module, "main", real_main)
    retried = mini_grammar.run(work, **run)
    assert set(retried["times"]) == {"decode decode_devfst0.8.out", "decode decode_mbr.out"}
    assert open(results).read().splitlines() == lines
