"""The pruned RNN-T objective at grammar scale on the port
(``tools/r5_pruned_grammar.sh``), run after ``mini_grammar`` has written the
corpus and the LM in WORK:

    python -m pika_tpu_torch.recipes.pruned_grammar [WORK] [--seed 1] [--device cpu]
        [overrides]

It trains the seed's grammar acoustic model with ``--pruned_loss_range 5
--simple_loss_scale 0.5 --pruned_warmup_epochs 5`` added to the recipe's
training lines (the same corpus, the clean warm-up and the resumed noisy
phase, each guarded by its last bundle), then decodes the test set plain
(``base``), with per-beam fusion at the tune-once scale 0.8 (``base_fst``)
and per-token fusion at 1.2 (``base_fst_pt``), into
``WORK/exp_seed$SEED_pruned/RESULTS`` in the script's form.  A finished
``decode_*.out`` is reused; a failed decode adds no line and is retried by
the next invocation.  Stages 0-2 are not run again: without ``mini_grammar``'s
corpus and LM it exits 1 with a message.  The script's ``timeout`` on the
two training phases is not carried: a phase runs to its end, and a run cut
short resumes from its guard (the noisy phase from its newest checkpoint).
The overrides are ``mini_grammar``'s budget and ``--set``.
"""

from __future__ import annotations

import argparse
import os
import re

from pika_tpu_torch.recipes import mini_grammar
from pika_tpu_torch.recipes.stages import Recipe, epoch_losses, run_main, summary

PRUNED_FLAGS = ["--pruned_loss_range", "5", "--simple_loss_scale", "0.5",
                "--pruned_warmup_epochs", "5"]
FST_SCALE, PT_SCALE = "0.8", "1.2"  # the matrix's tune-once scales (seed 1's dev)

# the lines of the pruned recipes' RESULTS files: a decode's WER by tag, a
# dev sweep's scale, a chosen scale, the fine-tune's oracle heading and
# line, and the exact-fusion re-decodes (no WER where the decode failed)
RESULT_FORMS = {
    "wer": mini_grammar.RESULT_FORMS["wer"],
    "sweep": mini_grammar.RESULT_FORMS["sweep"],
    "chosen": re.compile(r"chosen (?:pt )?fst_lm_scale [0-9.]* \(dev WER [0-9.e]+\)$"),
    "heading": re.compile(r"### 4-best oracle after fine-tune$"),
    "oracle": re.compile(r"1-best WER [0-9.]+% \[\d+/\d+\]  "
                         r"oracle-\d+ WER [0-9.]+% \[\d+/\d+\]$"),
    "exact": re.compile(r"seed\d+ (?:base|mbr)_fst_pt_exact (?:%WER [0-9.]+)?$"),
}


def parse_results(lines) -> list:
    """Each line's form (a key of ``RESULT_FORMS``) and match."""
    return mini_grammar.parse_results(lines, RESULT_FORMS)


class Commands(mini_grammar.Commands):
    """The pruned model's training and decodes, in ``exp_seed$SEED_pruned``
    (``mini_grammar``'s corpus, LM and flags)."""

    def __init__(self, work: str, seed: int = 1, **budget):
        super().__init__(work, seed, **budget)
        self.exp = f"{work}/exp_seed{seed}_pruned"
        self.model = f"{self.exp}/model.epoch.{self.epochs[1] - 1}"
        self.results = f"{self.exp}/RESULTS"

    def training(self) -> dict:
        return {k: [*argv, *PRUNED_FLAGS] for k, argv in super().training().items()}

    def rows(self, scale=FST_SCALE, pt_scale=PT_SCALE) -> dict:
        """The test decodes by tag, in the scripts' order: plain, per beam
        at ``scale``, per token at ``pt_scale``."""
        m = self.model
        return {"base": self.decode(m, "test", "nbest.txt", "--symbols_map", self.char),
                "base_fst": self.decode(m, "test", "nbest_fst.txt", *self.fst(scale)),
                "base_fst_pt": self.decode(m, "test", "nbest_fst_pt.txt",
                                           *self.fst(pt_scale, True))}

    def missing_corpus(self) -> list:
        """The files of ``mini_grammar``'s stages 0-2 that the pruned
        recipes read and WORK lacks."""
        need = (f"{self.data}/train/data.lst", f"{self.data}/train/global_cmvn.stats",
                f"{self.data}/noise.lst", self.lm, self.char, f"{self.data}/test/wav.scp",
                f"{self.dev}/test/wav.scp", self.conf)
        return [p for p in need if not os.path.exists(p)]


def decode_rows(r: Recipe, c: Commands, rows: dict, out: dict) -> None:
    """``wer_of`` over ``rows`` (tag -> argv): a failed decode adds no line."""
    for tag, argv in rows.items():
        out["wer"][tag] = r.wer_of(tag, argv, f"{c.exp}/decode_{tag}.out", record_failure=False)


def run(work: str, seed: int = 1, device=None, flags=None, decode_timeout: float = 1500.0,
        **budget) -> dict:
    """Returns the WERs by tag, the stage times and both phases' epoch
    losses; ``ok`` is False without the corpus and LM."""
    from pika_tpu_torch.train.train_transducer import main as train_main

    c = Commands(work, seed, **budget)
    out = {"wer": {}, "ok": True}
    missing = c.missing_corpus()
    if missing:
        print(f"missing {', '.join(missing)}: run mini_grammar in {work} first "
              "(its stages 0-2 write the corpus and the LM)", flush=True)
        out["ok"] = False
        return out
    os.makedirs(c.exp, exist_ok=True)
    r = Recipe(work, device, flags, results=c.results, decode_timeout=decode_timeout)
    out["times"] = r.times
    warmup_epochs, epochs = c.epochs[:2]
    train = c.training()
    r.stage(f"stage 3a (pruned): clean warm-up to epoch {warmup_epochs}",
            f"{c.exp}/model.epoch.{warmup_epochs - 1}",
            lambda: r.cli(train_main, train["train_warmup"]))
    r.stage(f"stage 3b (pruned): noise training to epoch {epochs}", c.model,
            lambda: r.cli(train_main, train["train"]))
    r.say("=== decodes ===")
    decode_rows(r, c, c.rows(), out)
    r.say("### PRUNED GRAMMAR DONE")
    r.say(open(c.results).read().rstrip("\n"))
    out["losses"] = {"warmup": epoch_losses(f"{c.exp}/train_warmup.log"),
                     "train": epoch_losses(f"{c.exp}/train.log")}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="tools/r5_pruned_grammar.sh on the port")
    ap.add_argument("work", nargs="?", default="recipe_work/mini_grammar")
    ap.add_argument("--seed", type=int, default=1, help="the training seed (SEED)")
    mini_grammar.add_budget_args(ap)
    args = ap.parse_args(argv)
    out = run(args.work, args.seed, **mini_grammar.run_kwargs(args))
    print(summary(out), flush=True)
    return out["ok"] and all(w is not None for w in out["wer"].values())


if __name__ == "__main__":
    run_main(main)
