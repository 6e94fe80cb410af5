"""The grammar-corpus quality recipe on the port (``egs/mini_grammar.sh``
stages 0-10): the synthetic acoustics of ``mini_synthetic`` with test and
dev transcripts drawn from a sparse bigram grammar (training transcripts
stay uniform), a bigram ARPA LM estimated from grammar text, the two-phase
RNN-T training, FST shallow fusion with its scale tuned on the dev corpus
(per beam and per token), MBR fine-tuning, the LAS forward and backward
rescorers with their scale pair tuned on dev, and the full stack.

    python -m pika_tpu_torch.recipes.mini_grammar WORK [--seed 1] [--device cpu]
        [--fst_scale S] [--pt_scale S] [--las_pair FW:BW]

``--seed``, ``--fst_scale``, ``--pt_scale`` and ``--las_pair`` stand in for
the script's ``SEED``, ``FST_SCALE``, ``PT_SCALE`` and ``LAS_PAIR``.  Its
defaults are the script's flags; only the overrides shrink it (corpus
sizes, epochs, sweep lists and ``--set NAME=VALUE`` for any CLI flag).
Every WER line goes to ``WORK/RESULTS.seed$SEED`` in the script's format
and order.  The corpus block (stages 0-2) is guarded by its last artifact,
``lm.arpa``; each training stage by its last bundle; a finished decode is
reused and a failed one retried on the next invocation.
"""

from __future__ import annotations

import argparse
import os
import re

from pika_tpu_torch.recipes import hard_corpus, train_ngram
from pika_tpu_torch.recipes.mini_synthetic import (
    decode_flags,
    las_command,
    mbr_command,
    train_commands,
)
from pika_tpu_torch.recipes.stages import (
    Recipe,
    epoch_losses,
    global_cmvn,
    parse_sets,
    run_main,
    summary,
    sweep_list,
    wav_to_seq,
    write_fbank_conf,
)

TRAIN, TEST, DEV, TEXT = 1500, 400, 200, 6000
WARMUP_EPOCHS, EPOCHS, MBR_EPOCHS, LAS_EPOCHS = 20, 160, 2, 8
FST_SCALES = "0.2,0.4,0.8,1.2"
PT_SCALES = "0.4,0.8,1.2,1.6"
LAS_SWEEP = "0.05:0.05,0.1:0.1,0.2:0.2,0.3:0.3,0.5:0.5,0.3:0.7,0.7:0.3,0.15:0.35"
DEFAULT_LAS_PAIR = "0.3:0.7"


# the lines of RESULTS.seed$SEED: a decode's WER by tag, a dev sweep's
# scale, a chosen scale; and the lines of a decode or a tuning that failed
RESULT_FORMS = {
    "wer": re.compile(r"(\w+) %WER ([0-9.]+) \[ \d+ / \d+, \d+ ins, \d+ del, \d+ sub \]$"),
    "sweep": re.compile(r"dev (?:pt )?fst_lm_scale [0-9.]+ -> WER [0-9.]+$"),
    "chosen": re.compile(r"chosen (?:pt )?fst_lm_scale [0-9.]+ "
                         r"\((?:dev WER [0-9.e]+|reused, tuned by seed 1)\)$"),
    "pair": re.compile(r"chosen las_scales fw [0-9.]+ bw [0-9.]+$"),
    "failed": re.compile(r"(?:\w+|dev (?:pt )?fst_lm_scale [0-9.]+ ->) decode failed; skipping$"
                         r"|no dev decode succeeded; cannot tune fst_lm_scale$"),
}


def parse_results(lines, forms=None) -> list:
    """Each RESULTS line's form (a key of ``forms``, by default
    ``RESULT_FORMS``) and match; raises ``ValueError`` on a line of no form."""
    forms = RESULT_FORMS if forms is None else forms
    out = []
    for line in lines:
        form = next((k for k, rx in forms.items() if rx.match(line)), None)
        if form is None:
            raise ValueError(f"RESULTS line of no known form: {line!r}")
        out.append((form, forms[form].match(line)))
    return out


class Commands:
    """Each CLI's argv of the recipe (without ``--device``)."""

    def __init__(self, work: str, seed: int = 1, train: int = TRAIN, test: int = TEST,
                 dev: int = DEV, text: int = TEXT, warmup_epochs: int = WARMUP_EPOCHS,
                 epochs: int = EPOCHS, mbr_epochs: int = MBR_EPOCHS, las_epochs: int = LAS_EPOCHS):
        self.work, self.seed = work, seed
        self.sizes = (train, test, dev, text)
        self.epochs = (warmup_epochs, epochs, mbr_epochs, las_epochs)
        self.data, self.dev = f"{work}/data", f"{work}/dev"
        self.exp = f"{work}/exp_seed{seed}"
        self.conf = f"{work}/fbank.conf"
        self.lm, self.char = f"{self.data}/lm.arpa", f"{self.data}/char.txt"
        self.model = f"{self.exp}/model.epoch.{epochs - 1}"
        self.mbr_model = f"{self.exp}/mbr/model.epoch.{mbr_epochs - 1}"
        self.las_models = tuple(f"{self.exp}/las_{d}/model.epoch.{las_epochs - 1}"
                                for d in ("fw", "bw"))
        self.results = f"{work}/RESULTS.seed{seed}"

    def corpus(self) -> list:
        train, test, _, text = self.sizes
        return [self.data, "--train", str(train), "--test", str(test),
                "--grammar_branching", "6", "--grammar_split", "test",
                "--grammar_text", str(text), "--test_snr", "5,15"]

    def dev_corpus(self) -> list:
        return [self.dev, "--train", "1", "--test", str(self.sizes[2]), "--seed", "4047",
                "--grammar_branching", "6", "--grammar_split", "test", "--test_snr", "5,15"]

    def ngram(self) -> list:
        return [f"ark:{self.data}/grammar_text.txt", self.char, self.lm]

    def training(self) -> dict:
        warmup_epochs, epochs, _, _ = self.epochs
        return train_commands(self.data, self.exp, self.conf, warmup_epochs, epochs, self.seed)

    def mbr(self) -> list:
        return mbr_command(self.data, f"{self.exp}/mbr", self.conf, self.model, self.epochs[2],
                           self.seed)

    def las(self, d: str) -> list:
        return las_command(self.data, f"{self.exp}/las_{d}", self.conf, self.model,
                           self.epochs[3], d == "bw", self.seed)

    def decode(self, model: str, split: str, nbest: str, *extra) -> list:
        """The decode CLI on ``split`` ("test" or "dev") writing ``nbest``."""
        root = self.data if split == "test" else self.dev
        return [model, f"{root}/test/wav.scp", f"{self.exp}/{nbest}",
                "--ref_labels", f"ark:{root}/test/label.txt", *extra,
                *decode_flags(self.conf, f"{self.data}/train/global_cmvn.stats")]

    def fst(self, scale, per_token: bool = False) -> list:
        mode = ["--fst_per_token"] if per_token else ["--fst_fusion", "per_beam"]
        return ["--fst_lm", self.lm, "--fst_lm_scale", str(scale), *mode,
                "--symbols_map", self.char]

    def las_flags(self, fw=None, bw=None) -> list:
        flags = ["--las_rescorer_model", self.las_models[0],
                 "--las_rescorer_bw_model", self.las_models[1], "--SOS", "0", "--EOS", "31"]
        if fw is not None:
            flags += ["--las_fw_score_scale", str(fw), "--las_bw_score_scale", str(bw)]
        return flags

    def dev_fst(self, s) -> list:
        return self.decode(self.model, "dev", f"nbest_dev_fst{s}.txt", *self.fst(s))

    def dev_pt(self, s) -> list:
        return self.decode(self.model, "dev", f"nbest_dev_pt{s}.txt", *self.fst(s, True))

    def dev_las(self, scale, sweep: str) -> list:
        return self.decode(self.mbr_model, "dev", "nbest_dev_las.txt", *self.las_flags(),
                           *self.fst(scale), "--las_scale_sweep", sweep)

    def tagged(self, scale, pt_scale, fw, bw) -> dict:
        """The ``wer_of`` decodes by tag, in the script's order, at the
        chosen scales."""
        m, mbr = self.model, self.mbr_model
        las = self.las_flags(fw, bw)
        return {
            "base": self.decode(m, "test", "nbest_base.txt"),
            "dev_base": self.decode(m, "dev", "nbest_dev_base.txt"),
            "base_fst": self.decode(m, "test", "nbest_fst.txt", *self.fst(scale)),
            "mbr": self.decode(mbr, "test", "nbest_mbr.txt"),
            "mbr_fst": self.decode(mbr, "test", "nbest_mbr_fst.txt", *self.fst(scale)),
            "mbr_las": self.decode(mbr, "test", "nbest_mbr_las.txt", *las),
            "mbr_las_fst": self.decode(mbr, "test", "nbest_full.txt", *las, *self.fst(scale)),
            "base_fst_pt": self.decode(m, "test", "nbest_fst_pt.txt", *self.fst(pt_scale, True)),
            "mbr_fst_pt": self.decode(mbr, "test", "nbest_mbr_fst_pt.txt",
                                      *self.fst(pt_scale, True)),
            "mbr_fst_pt_las": self.decode(mbr, "test", "nbest_mbr_fst_pt_las.txt", *las,
                                          *self.fst(pt_scale, True)),
        }


def best_las_pair(out: str):
    """The dev sweep's pair of least WER from the decode output's
    ``las_scales FW:BW %WER W ...`` lines (ties to the lesser ``W FW:BW``
    text, as the script's ``sort -g | head -1``), and those lines."""
    lines = [line.rstrip("\n") for line in open(out)] if os.path.exists(out) else []
    lines = [line for line in lines if line.startswith("las_scales")]
    ranked = sorted((float(f[3]), f"{f[3]} {f[1]}", f[1]) for f in map(str.split, lines))
    return (ranked[0][2] if ranked else None), lines


def run(work: str, seed: int = 1, device=None, flags=None, fst_scale=None, pt_scale=None,
        las_pair=None, fst_scales: str = FST_SCALES, pt_scales: str = PT_SCALES,
        las_sweep: str = LAS_SWEEP, decode_timeout: float = 1500.0, **budget) -> dict:
    """The recipe in ``work``; returns the WERs by tag (None where a decode
    failed), the chosen scales, the stage times and both training phases'
    epoch losses; ``ok`` is False where no dev decode could tune the FST
    scale (the script's ``exit 1``)."""
    from pika_tpu_torch.train.train_las import main as las_main
    from pika_tpu_torch.train.train_mbr import main as mbr_main
    from pika_tpu_torch.train.train_transducer import main as train_main

    c = Commands(work, seed, **budget)
    r = Recipe(work, device, flags, results=c.results, decode_timeout=decode_timeout)
    exp, data = c.exp, c.data
    warmup_epochs, epochs, mbr_epochs, las_epochs = c.epochs
    os.makedirs(exp, exist_ok=True)
    write_fbank_conf(c.conf)
    out = {"wer": {}, "times": r.times, "ok": True}

    def corpus_block():
        train, test, dev, _ = c.sizes
        r.stage(f"stage 0: synthesize grammar corpus ({train} train / {test} test; dev {dev})",
                None, lambda: (r.cli(hard_corpus.main, c.corpus(), device=False),
                               r.cli(hard_corpus.main, c.dev_corpus(), device=False)))
        r.stage("stage 1: wav.scp -> mrk/seq archives + data.lst", None,
                lambda: wav_to_seq(r, f"{data}/train", "train", c.conf))
        r.stage("stage 2: global CMVN + bigram ARPA LM from grammar text", None,
                lambda: (global_cmvn(r, f"{data}/train", "train", c.conf),
                         r.cli(train_ngram.main, c.ngram(), device=False)))

    # the block's guard is its LAST artifact: a run killed mid-block redoes it
    r.stage("stages 0-2", c.lm, corpus_block)
    train = c.training()
    r.stage(f"stage 3a: RNN-T warm-up, clean augmentation ({warmup_epochs} epochs, seed {seed})",
            f"{exp}/model.epoch.{warmup_epochs - 1}", lambda: r.cli(train_main, train["train_warmup"]))
    r.stage(f"stage 3b: RNN-T training with noise SNR 10-30 dB (resume, to epoch {epochs})",
            c.model, lambda: r.cli(train_main, train["train"]))

    def wer_of(tag, scale=None, pt=None, fw=None, bw=None):
        out["wer"][tag] = r.wer_of(tag, c.tagged(scale, pt, fw, bw)[tag],
                                   f"{exp}/decode_{tag}.out")

    r.say("=== stage 4: TEST decode -- baseline beam ===")
    wer_of("base")
    r.say("=== stage 4b: tune fst_lm_scale on DEV, decode TEST with FST fusion ===")
    if fst_scale is not None:
        best = str(fst_scale)
        r.result(f"chosen fst_lm_scale {best} (reused, tuned by seed 1)")
    else:
        wer_of("dev_base")
        best, best_wer = r.sweep("fst_lm_scale", sweep_list(fst_scales), lambda s: r.decoded_wer(
            c.dev_fst(s), f"{exp}/decode_devfst{s}.out"))
        if best is None:
            r.result("no dev decode succeeded; cannot tune fst_lm_scale")
            out["ok"] = False
            return out
        r.result(f"chosen fst_lm_scale {best} (dev WER {best_wer})")
    out["fst_scale"] = best
    wer_of("base_fst", best)

    os.makedirs(f"{exp}/mbr", exist_ok=True)
    r.stage(f"stage 5: MBR fine-tuning (seed {seed})", c.mbr_model,
            lambda: r.cli(mbr_main, c.mbr()))
    r.say("=== stage 5b: TEST decode -- MBR model (plain and +FST) ===")
    wer_of("mbr")
    wer_of("mbr_fst", best)
    for d, las_model in zip(("fw", "bw"), c.las_models):
        os.makedirs(f"{exp}/las_{d}", exist_ok=True)
        r.stage(f"stage 6: LAS {d} rescorer training (seed {seed})", las_model,
                lambda d=d: r.cli(las_main, c.las(d)))

    r.say("=== stage 7a: tune LAS rescoring scales on DEV (one decode, sweep) ===")
    note = f"{exp}/las_sweep.note"

    def noted_pair():
        if not os.path.exists(note):
            return None
        for line in open(note):
            if "chosen las_scales" in line:
                return line.split()[2]
        return None

    if las_pair is not None and noted_pair() is None:
        with open(note, "w") as f:
            f.write(f"chosen las_scales {las_pair} (reused, tuned by seed 1)\n")
    if noted_pair() is None:
        sweep_out = f"{exp}/decode_dev_las.out"
        r.decode(c.dev_las(best, las_sweep), sweep_out)
        pair, lines = best_las_pair(sweep_out)
        with open(note, "w") as f:
            f.write(f"chosen las_scales {pair or DEFAULT_LAS_PAIR}\n")
            f.writelines(line + "\n" for line in lines)
    fw, _, bw = noted_pair().partition(":")
    r.result(f"chosen las_scales fw {fw} bw {bw}")
    out["las_pair"] = (fw, bw)

    r.say("=== stage 7: TEST decode -- MBR + LAS fw/bw rescoring ===")
    wer_of("mbr_las", fw=fw, bw=bw)
    r.say("=== stage 8: TEST decode -- full stack (MBR + LAS + FST fusion) ===")
    wer_of("mbr_las_fst", best, fw=fw, bw=bw)

    r.say("=== stage 9a: tune fst_lm_scale for PER-TOKEN fusion on DEV ===")
    if pt_scale is not None:
        pt = str(pt_scale)
        r.result(f"chosen pt fst_lm_scale {pt} (reused, tuned by seed 1)")
    else:
        pt, pt_best = r.sweep("pt fst_lm_scale", sweep_list(pt_scales), lambda s: r.decoded_wer(
            c.dev_pt(s), f"{exp}/decode_devpt{s}.out"))
        pt = pt if pt is not None else best
        r.result(f"chosen pt fst_lm_scale {pt} (dev WER {pt_best})")
    out["pt_scale"] = pt
    r.say("=== stage 9: per-token fusion (--fst_per_token) decodes ===")
    wer_of("base_fst_pt", pt=pt)
    wer_of("mbr_fst_pt", pt=pt)
    r.say("=== stage 10: FULL stack -- MBR + per-token fusion + LAS rescoring ===")
    wer_of("mbr_fst_pt_las", pt=pt, fw=fw, bw=bw)
    r.say(f"=== RESULTS (seed {seed}) ===")
    r.say(open(c.results).read().rstrip("\n"))
    out["losses"] = {"warmup": epoch_losses(f"{exp}/train_warmup.log"),
                     "train": epoch_losses(f"{exp}/train.log")}
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="egs/mini_grammar.sh on the port")
    ap.add_argument("work", nargs="?", default="recipe_work/mini_grammar")
    ap.add_argument("--seed", type=int, default=1, help="the training seed (SEED)")
    ap.add_argument("--fst_scale", type=str, default=None,
                    help="reuse a dev-tuned per-beam fst_lm_scale (FST_SCALE)")
    ap.add_argument("--pt_scale", type=str, default=None,
                    help="reuse a dev-tuned per-token fst_lm_scale (PT_SCALE)")
    ap.add_argument("--las_pair", type=str, default=None,
                    help="reuse a dev-tuned FW:BW LAS scale pair (LAS_PAIR)")
    add_budget_args(ap)
    add_sweep_args(ap)
    return ap


BUDGET = ("train", "test", "dev", "text", "warmup_epochs", "epochs", "mbr_epochs", "las_epochs")
SWEEPS = ("fst_scales", "pt_scales", "las_sweep")


def add_budget_args(ap: argparse.ArgumentParser) -> None:
    """The device, the overrides that shrink the recipe and ``--set``
    (shared by the recipes built on it)."""
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of every stage (default: the CUDA card)")
    ap.add_argument("--train", type=int, default=TRAIN)
    ap.add_argument("--test", type=int, default=TEST)
    ap.add_argument("--dev", type=int, default=DEV)
    ap.add_argument("--text", type=int, default=TEXT, help="grammar text lines for the LM")
    ap.add_argument("--warmup_epochs", type=int, default=WARMUP_EPOCHS)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--mbr_epochs", type=int, default=MBR_EPOCHS)
    ap.add_argument("--las_epochs", type=int, default=LAS_EPOCHS)
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE",
                    help="replace --NAME's value in every CLI that takes it")


def add_sweep_args(ap: argparse.ArgumentParser, fst_scales: str = FST_SCALES,
                   pt_scales: str = PT_SCALES, las_sweep: str = LAS_SWEEP) -> None:
    """The dev sweeps' scale lists."""
    ap.add_argument("--fst_scales", type=str, default=fst_scales)
    ap.add_argument("--pt_scales", type=str, default=pt_scales)
    ap.add_argument("--las_sweep", type=str, default=las_sweep)


def run_kwargs(args) -> dict:
    """``run``'s keyword arguments from the flags of ``add_budget_args`` and,
    where the parser has them, ``add_sweep_args``."""
    given = vars(args)
    return dict(device=args.device, flags=parse_sets(args.set),
                **{k: given[k] for k in (*BUDGET, *SWEEPS) if k in given})


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = run(args.work, args.seed, fst_scale=args.fst_scale, pt_scale=args.pt_scale,
              las_pair=args.las_pair, **run_kwargs(args))
    print(summary(out), flush=True)
    return out["ok"]


if __name__ == "__main__":
    run_main(main)
