"""Re-tune one grammar seed's fusion and rescoring scales on its own dev
decodes (the port's ``tools/retune_grammar_seed.sh``), after ``mini_grammar``
has run that seed in WORK:

    python -m pika_tpu_torch.recipes.retune_grammar_seed [WORK] [--seed 2] [--device cpu]

The seed matrix reuses seed 1's dev-tuned scales for seeds 2 and 3 (tune
once, deploy); this measures what the seed's own tuning would change.  It
sweeps the per-beam and the per-token ``fst_lm_scale`` on dev, then the
shared-encoder LAS pair on the per-token-fused stack (one decode), and
decodes the test rows at the seed's own scales.  The lines go to
``WORK/RESULTS.seed$SEED.retune`` in the script's forms; every finished
``decode_*.out`` is reused, so it needs decodes only.  A decode that fails
adds no line and is retried by the next invocation.  The overrides are
``mini_grammar``'s (the budget locates the seed's bundles).
"""

from __future__ import annotations

import argparse
import os

from pika_tpu_torch.recipes import mini_grammar
from pika_tpu_torch.recipes.stages import Recipe, run_main, sweep_list

FST_SCALES = "0.2,0.4,0.8,1.2"
PT_SCALES = "0.4,0.8,1.2,1.6"
LAS_SWEEP = "0.0:0.0,0.05:0.05,0.1:0.1,0.2:0.2,0.3:0.3,0.5:0.5,0.3:0.7,0.7:0.3"
DEFAULT_LAS_PAIR = "0.05:0.05"


class Commands(mini_grammar.Commands):
    """The retune's decodes (``mini_grammar``'s paths and flags)."""

    def dev_las_rt(self, pt_scale, sweep: str) -> list:
        return self.decode(self.mbr_model, "dev", "nbest_dev_las_rt.txt", *self.las_flags(),
                           *self.fst(pt_scale, True), "--las_scale_sweep", sweep)

    def retuned(self, scale, pt_scale, fw, bw) -> dict:
        """The test decodes by tag, in the script's order."""
        m, mbr = self.model, self.mbr_model
        return {
            "rt_base_fst": self.decode(m, "test", "nbest_rt_fst.txt", *self.fst(scale)),
            "rt_mbr_fst": self.decode(mbr, "test", "nbest_rt_mbr_fst.txt", *self.fst(scale)),
            "rt_base_fst_pt": self.decode(m, "test", "nbest_rt_fst_pt.txt",
                                          *self.fst(pt_scale, True)),
            "rt_mbr_fst_pt": self.decode(mbr, "test", "nbest_rt_mbr_fst_pt.txt",
                                         *self.fst(pt_scale, True)),
            "rt_mbr_fst_pt_las": self.decode(mbr, "test", "nbest_rt_full.txt",
                                             *self.las_flags(fw, bw), *self.fst(pt_scale, True)),
        }


def dev_sweep(r: Recipe, label: str, scales, decode_at):
    """A dev sweep of the script: ``dev LABEL S -> WER W`` per scale that
    decoded (a failed one adds no line); strictly lower wins."""
    best, best_wer = "", "1e9"
    for s in scales:
        w = decode_at(s)
        if w is None:
            continue
        r.result(f"dev {label} {s} -> WER {w}")
        if float(w) < float(best_wer):
            best, best_wer = s, w
    return best, best_wer


def run(work: str, seed: int = 2, device=None, flags=None, fst_scales: str = FST_SCALES,
        pt_scales: str = PT_SCALES, las_sweep: str = LAS_SWEEP, decode_timeout: float = 1500.0,
        **budget) -> dict:
    """Returns the chosen scales and the test WERs by tag."""
    c = Commands(work, seed, **budget)
    r = Recipe(work, device, flags, results=f"{c.results}.retune",
               decode_timeout=decode_timeout)
    exp = c.exp
    out = {"wer": {}, "times": r.times}

    r.say(f"=== dev sweep: per-beam fst_lm_scale (seed {seed}'s own) ===")
    scale, scale_wer = dev_sweep(r, "fst_lm_scale", sweep_list(fst_scales), lambda s: (
        r.decoded_wer(c.dev_fst(s), f"{exp}/decode_devfst{s}.out")))
    r.result(f"chosen fst_lm_scale {scale} (dev WER {scale_wer})")
    r.say("=== dev sweep: per-token fst_lm_scale ===")
    pt, pt_wer = dev_sweep(r, "pt fst_lm_scale", sweep_list(pt_scales), lambda s: (
        r.decoded_wer(c.dev_pt(s), f"{exp}/decode_devpt{s}.out")))
    r.result(f"chosen pt fst_lm_scale {pt} (dev WER {pt_wer})")

    r.say("=== dev sweep: shared-encoder LAS scales on the pt-fused stack ===")
    note = f"{exp}/las_retune.note"
    if not (os.path.exists(note) and "chosen las_scales" in open(note).read()):
        sweep_out = f"{exp}/decode_dev_las_rt.out"
        r.decode(c.dev_las_rt(pt, las_sweep), sweep_out)
        pair, lines = mini_grammar.best_las_pair(sweep_out)
        with open(note, "w") as f:
            f.write(f"chosen las_scales {pair or DEFAULT_LAS_PAIR}\n")
            f.writelines(line + "\n" for line in lines)
    noted = open(note).read().splitlines()
    pair = next(line.split()[2] for line in noted if "chosen las_scales" in line)
    fw, _, bw = pair.partition(":")
    for line in noted:
        if line.startswith("las_scales"):
            r.result(f"dev {line}")
    r.result(f"chosen las_scales fw {fw} bw {bw}")
    out.update(fst_scale=scale, pt_scale=pt, las_pair=(fw, bw))

    r.say(f"=== TEST decodes with seed {seed}'s OWN scales ===")
    for tag, argv in c.retuned(scale, pt, fw, bw).items():
        out["wer"][tag] = r.wer_of(tag, argv, f"{exp}/decode_{tag}.out", record_failure=False)
    r.say(f"=== RETUNE RESULTS (seed {seed}) ===")
    r.say(open(r.results).read().rstrip("\n"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="tools/retune_grammar_seed.sh on the port")
    ap.add_argument("work", nargs="?", default="recipe_work/mini_grammar")
    ap.add_argument("--seed", type=int, default=2, help="the seed to re-tune (SEED)")
    mini_grammar.add_budget_args(ap)
    mini_grammar.add_sweep_args(ap, FST_SCALES, PT_SCALES, LAS_SWEEP)
    args = ap.parse_args(argv)
    out = run(args.work, args.seed, **mini_grammar.run_kwargs(args))
    return all(w is not None for w in out["wer"].values())


if __name__ == "__main__":
    run_main(main)
