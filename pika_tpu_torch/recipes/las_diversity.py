"""The LAS-rescoring diversity experiment on the port (``egs/las_diversity.sh``),
run after ``mini_grammar`` has finished a seed in WORK:

    python -m pika_tpu_torch.recipes.las_diversity [WORK] [--seed 1] [--pt_scale 1.2]
        [--device cpu] [overrides]

The grammar recipe's LAS rescorers reuse the frozen transducer encoder
(``--shared_encoder_model``) and earn almost nothing there.  This trains an
independent LAS pair, forward and backward, each with its own 3-layer
bidirectional LSTM encoder over the fbank features (stage 1, 40 epochs,
guarded by the last bundle), tunes its scale pair on dev in one decode of
the MBR model's per-token-fused stack at ``PT_SCALE`` (stage 2; the pair
of least WER, ties to the line that sorts first, kept in
``las_ind_sweep.note`` and reused on restart), and decodes the test set
with it on that stack and on the plain MBR model (stages 3-4).  The lines
go to ``WORK/RESULTS.las_ind.seed$SEED`` in the script's forms.  Without
the seed's MBR bundle it exits 1 with the script's message.  The overrides
are ``mini_grammar``'s budget and ``--set`` (the budget locates the seed's
bundles) and ``--las_ind_epochs``.
"""

from __future__ import annotations

import argparse
import os
import re

from pika_tpu_torch.recipes import mini_grammar
from pika_tpu_torch.recipes.stages import Recipe, run_main

LAS_IND_EPOCHS = 40
PT_SCALE = "1.2"  # fixed by seed 1's mini_grammar dev tuning
LAS_IND_SWEEP = "0.0:0.0,0.05:0.05,0.1:0.1,0.2:0.2,0.3:0.3,0.5:0.5,0.3:0.7,0.7:0.3,1.0:1.0"

# the lines of RESULTS.las_ind.seed$SEED
RESULT_FORMS = {
    "sweep": re.compile(r"dev las_scales [0-9.]+:[0-9.]+ %WER [0-9.]+ \[ \d+ / \d+ \]$"),
    "pair": re.compile(r"chosen las_ind_scales fw [0-9.]+ bw [0-9.]+$"),
    "wer": re.compile(r"(mbr_fst_pt_las_ind|mbr_las_ind) %WER ([0-9.]+) "
                      r"\[ \d+ / \d+, \d+ ins, \d+ del, \d+ sub \]$"),
}


def aug_flags(data: str) -> list:
    """The script's ``aug_flags`` (without the grammar recipe's
    ``--rng_impl``)."""
    return ["--feats_dim", "40", "--lctx", "1", "--rctx", "1", "--stride", "1",
            "--speed_rate", "0.96,1.0,1.04", "--gain_range", "55,10",
            "--noise_lst", f"{data}/noise.lst", "--snr_range", "10,30", "--max_wav_seconds", "4.0"]


class Commands(mini_grammar.Commands):
    """The experiment's CLI argv (without ``--device``)."""

    def __init__(self, work: str, seed: int = 1, las_ind_epochs: int = LAS_IND_EPOCHS, **budget):
        super().__init__(work, seed, **budget)
        self.las_ind_epochs = las_ind_epochs
        self.las_ind_models = tuple(f"{self.exp}/las_ind_{d}/model.epoch.{las_ind_epochs - 1}"
                                    for d in ("fw", "bw"))
        self.results = f"{work}/RESULTS.las_ind.seed{seed}"

    def las_ind(self, d: str) -> list:
        out = f"{self.exp}/las_ind_{d}"
        return [f"{self.data}/train/data.lst", f"{out}/train.log", out,
                "--feat_config", self.conf, "--cmvn_stats", f"{self.data}/train/global_cmvn.stats",
                "--SOS", "0", "--EOS", "31", "--padding_tgt", "32", "--padding_idx", "32",
                "--output_dim", "32",
                "--enc_layers", "3", "--brnn", "--dec_layers", "1", "--rnn_size", "256",
                "--embd_dim", "64", "--global_attention", "mlp", "--dropout", "0.1",
                "--optim", "adam", "--initial_lr", "3e-4", "--final_lr", "3e-5",
                "--num_epochs", str(self.las_ind_epochs), "--num_batches_per_epoch", "94",
                "--batch_size", "16",
                "--sampling_decoder", "--sampling_prob", "0.1", "--increase_sampling_prob_epoch",
                "20", "--seed", str(self.seed), *(["--reverse_labels"] if d == "bw" else []),
                *aug_flags(self.data)]

    def las_ind_flags(self, fw=None, bw=None) -> list:
        flags = ["--las_rescorer_model", self.las_ind_models[0],
                 "--las_rescorer_bw_model", self.las_ind_models[1], "--SOS", "0", "--EOS", "31"]
        if fw is not None:
            flags += ["--las_fw_score_scale", str(fw), "--las_bw_score_scale", str(bw)]
        return flags

    def dev_las_ind(self, pt_scale, sweep: str) -> list:
        return self.decode(self.mbr_model, "dev", "nbest_dev_las_ind.txt", *self.las_ind_flags(),
                           *self.fst(pt_scale, True), "--las_scale_sweep", sweep)

    def tagged_ind(self, pt_scale, fw, bw) -> dict:
        """Stages 3 and 4: the test decodes by tag."""
        las = self.las_ind_flags(fw, bw)
        return {
            "mbr_fst_pt_las_ind": self.decode(self.mbr_model, "test",
                                              "nbest_mbr_fst_pt_las_ind.txt", *las,
                                              *self.fst(pt_scale, True)),
            "mbr_las_ind": self.decode(self.mbr_model, "test", "nbest_mbr_las_ind.txt", *las),
        }


def run(work: str, seed: int = 1, device=None, flags=None, pt_scale: str = PT_SCALE,
        las_sweep: str = LAS_IND_SWEEP, decode_timeout: float = 1500.0, **budget) -> dict:
    """Returns the chosen pair, the test WERs by tag and the stage times;
    ``ok`` is False (the script's ``exit 1``) without the MBR bundle or when
    the dev sweep gave no pair."""
    from pika_tpu_torch.train.train_las import main as las_main

    c = Commands(work, seed, **budget)
    r = Recipe(work, device, flags, results=c.results, decode_timeout=decode_timeout)
    exp = c.exp
    out = {"wer": {}, "times": r.times, "ok": True}
    if not os.path.isdir(c.mbr_model):
        r.say(f"seed {seed} mbr model missing; run mini_grammar.sh first")
        out["ok"] = False
        return out

    for d, model in zip(("fw", "bw"), c.las_ind_models):
        os.makedirs(f"{exp}/las_ind_{d}", exist_ok=True)
        r.stage(f"stage 1: independent LAS {d} (own BLSTM encoder, {c.las_ind_epochs} epochs)",
                model, lambda d=d: r.cli(las_main, c.las_ind(d)))

    r.say("=== stage 2: tune ind-LAS scales on DEV (pt-fused stack, one decode) ===")
    note = f"{exp}/las_ind_sweep.note"
    if not (os.path.exists(note) and "chosen las_ind_scales" in open(note).read()):
        sweep_out = f"{exp}/decode_dev_las_ind.out"
        r.decode(c.dev_las_ind(pt_scale, las_sweep), sweep_out)
        pair, lines = mini_grammar.best_las_pair(sweep_out)
        if pair is None:
            r.say("dev sweep failed")
            out["ok"] = False
            return out
        with open(note, "w") as f:
            f.write(f"chosen las_ind_scales {pair}\n")
            f.writelines(line + "\n" for line in lines)
    noted = open(note).read().splitlines()
    pair = next(line.split()[2] for line in noted if "chosen las_ind_scales" in line)
    fw, _, bw = pair.partition(":")
    for line in noted:
        if line.startswith("las_scales"):
            r.result(f"dev {line}")
    r.result(f"chosen las_ind_scales fw {fw} bw {bw}")
    out["las_pair"] = (fw, bw)

    titles = {"mbr_fst_pt_las_ind": "stage 3: TEST -- MBR + per-token fusion + independent LAS",
              "mbr_las_ind": "stage 4: TEST -- plain MBR + independent LAS (no FST)"}
    for tag, argv in c.tagged_ind(pt_scale, fw, bw).items():
        r.say(f"=== {titles[tag]} ===")
        out["wer"][tag] = r.wer_of(tag, argv, f"{exp}/decode_{tag}.out", record_failure=False)
    r.say(f"=== RESULTS (las diversity, seed {seed}) ===")
    r.say(open(c.results).read().rstrip("\n"))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="egs/las_diversity.sh on the port")
    ap.add_argument("work", nargs="?", default="recipe_work/mini_grammar")
    ap.add_argument("--seed", type=int, default=1, help="the mini_grammar seed (SEED)")
    ap.add_argument("--pt_scale", type=str, default=PT_SCALE,
                    help="the per-token fst_lm_scale of the fused stack (PT_SCALE)")
    ap.add_argument("--las_ind_epochs", type=int, default=LAS_IND_EPOCHS)
    mini_grammar.add_budget_args(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = run(args.work, args.seed, pt_scale=args.pt_scale, las_ind_epochs=args.las_ind_epochs,
              **mini_grammar.run_kwargs(args))
    return out["ok"]


if __name__ == "__main__":
    run_main(main)
