"""A short full-loss polish of the pruned-objective grammar model
(``tools/r5_pruned_finetune.sh``), after ``pruned_grammar`` has run in WORK:

    python -m pika_tpu_torch.recipes.pruned_finetune [WORK] [--seed 1] [--ft_epochs 10]
        [--ft_lr 0.0002] [--skip_sm_probe] [--device cpu] [overrides]

Trained only on banded cells, the pruned model's off-band scores are
uncalibrated and its N-best can collapse, which floors LM fusion.  This
trains ``--ft_epochs`` epochs of the full loss (Adam, ``--ft_lr`` down to
5e-5, noise at 10-30 dB) from the pruned model's last bundle through
``--init_model``, decodes the test rows at the tune-once scales (plain, per
beam 0.8, per token 1.2), appends ``### 4-best oracle after fine-tune`` and
``recipes/nbest_oracle.py``'s line for the plain N-best, and, unless
``--skip_sm_probe``, decodes dev with the pure pruned model at ``--sm_scale
0.5`` (per beam and per token), the no-training mitigation.
``--ft_epochs``, ``--ft_lr`` and ``--skip_sm_probe`` stand in for the
script's ``FT_EPOCHS``, ``FT_LR`` and ``SKIP_SM_PROBE``; the work
directory is ``exp_seed$SEED_prunedft`` at (10, 0.0002) and
``exp_seed$SEED_prunedft${FT_EPOCHS}_$FT_LR`` otherwise (``--ft_lr`` is
compared as the script compares it, as text).  The lines go to its
``RESULTS``; the training is guarded by its last bundle and every finished
``decode_*.out`` is reused.  Without the pruned bundle it exits 1.
"""

from __future__ import annotations

import argparse
import os

from pika_tpu_torch.recipes import mini_grammar, nbest_oracle, pruned_grammar
from pika_tpu_torch.recipes.mini_synthetic import model_flags
from pika_tpu_torch.recipes.pruned_grammar import FST_SCALE, PT_SCALE, decode_rows
from pika_tpu_torch.recipes.stages import Recipe, epoch_losses, run_main, summary

FT_EPOCHS, FT_LR = 10, "0.0002"
SM_SCALE = "0.5"


class Commands(pruned_grammar.Commands):
    """The fine-tune's training and decodes; ``pruned_model`` is the
    pruned model's last bundle."""

    def __init__(self, work: str, seed: int = 1, ft_epochs: int = FT_EPOCHS, ft_lr: str = FT_LR,
                 **budget):
        super().__init__(work, seed, **budget)
        self.pruned_model = self.model
        self.ft_epochs, self.ft_lr = ft_epochs, ft_lr
        default = (str(ft_epochs), ft_lr) == (str(FT_EPOCHS), FT_LR)
        suffix = "" if default else f"{ft_epochs}_{ft_lr}"
        self.exp = f"{work}/exp_seed{seed}_prunedft{suffix}"
        self.model = f"{self.exp}/model.epoch.{ft_epochs - 1}"
        self.results = f"{self.exp}/RESULTS"

    def finetune(self) -> list:
        return [f"{self.data}/train/data.lst", f"{self.exp}/train.log", self.exp,
                "--feat_config", self.conf, "--cmvn_stats", f"{self.data}/train/global_cmvn.stats",
                "--optim", "adam", "--initial_lr", self.ft_lr, "--final_lr", "0.00005",
                "--num_epochs", str(self.ft_epochs),
                "--noise_lst", f"{self.data}/noise.lst", "--snr_range", "10,30",
                "--init_model", self.pruned_model, *model_flags(self.seed)]

    def oracle(self) -> list:
        """``tools/nbest_oracle.py``'s arguments for the plain N-best."""
        return [f"{self.exp}/nbest.txt", f"ark:{self.data}/test/label.txt",
                f"{self.data}/test/wav.scp", "4", self.char]

    def sm_probe(self) -> dict:
        """The pure pruned model's dev decodes at ``--sm_scale 0.5``."""
        return {f"dev_sm05_{kind}": self.decode(self.pruned_model, "dev",
                                                f"nbest_dev_sm05_{kind}.txt", "--sm_scale",
                                                SM_SCALE, *self.fst(scale, kind == "pt"))
                for kind, scale in (("fst", FST_SCALE), ("pt", PT_SCALE))}


def run(work: str, seed: int = 1, device=None, flags=None, ft_epochs: int = FT_EPOCHS,
        ft_lr: str = FT_LR, skip_sm_probe: bool = False, decode_timeout: float = 1500.0,
        **budget) -> dict:
    """Returns the WERs by tag, the oracle line, the stage times and the
    epoch losses; ``ok`` is False without the pruned bundle."""
    from pika_tpu_torch.train.train_transducer import main as train_main

    c = Commands(work, seed, ft_epochs, ft_lr, **budget)
    out = {"wer": {}, "ok": True}
    if not os.path.isdir(c.pruned_model):
        print(f"{c.pruned_model} missing: run pruned_grammar in {work} first", flush=True)
        out["ok"] = False
        return out
    os.makedirs(c.exp, exist_ok=True)
    r = Recipe(work, device, flags, results=c.results, decode_timeout=decode_timeout)
    out["times"] = r.times
    r.stage(f"full-loss fine-tune, {ft_epochs} epochs from the pruned model's last epoch",
            c.model, lambda: r.cli(train_main, c.finetune()))

    r.say("=== decodes (tune-once scales, directly comparable to the matrix) ===")
    decode_rows(r, c, c.rows(), out)
    r.result("### 4-best oracle after fine-tune")
    try:
        nbest, labels, scp, n, symbols = c.oracle()
        out["oracle"] = nbest_oracle.oracle_line(int(n), *nbest_oracle.oracle(
            nbest, labels, scp, int(n), symbols))
        r.result(out["oracle"])
    except (OSError, SystemExit, KeyError, ValueError) as e:  # the script's line is then empty
        r.say(f"oracle failed: {e!r}")
    if not skip_sm_probe:
        r.say("=== sm_scale 0.5 probe on the PURE pruned model (dev, no training) ===")
        decode_rows(r, c, c.sm_probe(), out)
    r.say("### PRUNED FINETUNE DONE")
    r.say(open(c.results).read().rstrip("\n"))
    out["losses"] = epoch_losses(f"{c.exp}/train.log")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="tools/r5_pruned_finetune.sh on the port")
    ap.add_argument("work", nargs="?", default="recipe_work/mini_grammar")
    ap.add_argument("--seed", type=int, default=1, help="the pruned model's seed (SEED)")
    ap.add_argument("--ft_epochs", type=int, default=FT_EPOCHS, help="FT_EPOCHS")
    ap.add_argument("--ft_lr", type=str, default=FT_LR, help="FT_LR, as text")
    ap.add_argument("--skip_sm_probe", action="store_true", help="SKIP_SM_PROBE")
    mini_grammar.add_budget_args(ap)
    args = ap.parse_args(argv)
    out = run(args.work, args.seed, ft_epochs=args.ft_epochs, ft_lr=args.ft_lr,
              skip_sm_probe=args.skip_sm_probe, **mini_grammar.run_kwargs(args))
    print(summary(out), flush=True)
    return out["ok"] and all(w is not None for w in out["wer"].values())


if __name__ == "__main__":
    run_main(main)
