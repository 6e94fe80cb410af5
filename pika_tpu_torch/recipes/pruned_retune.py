"""Dev-retune the fusion scales of the pruned-objective grammar model
(``tools/r5_pruned_retune.sh``), after ``pruned_grammar`` has run in WORK:

    python -m pika_tpu_torch.recipes.pruned_retune [WORK] [--seed 1] [--device cpu]
        [overrides]

The tune-once protocol reuses seed 1's scales, tuned on the full-loss model;
the pruned objective trains the joint only on banded cells, so its optimal
LM scale can differ.  This retries the tune-once per-beam test row, sweeps
the pruned model's own per-beam scale over {0.2, 0.4, 0.8, 1.2} and its
per-token scale over {0.2, 0.4, 0.8, 1.2, 1.6} on dev (strictly lower
wins; a failed decode adds no line), and decodes the test set at the chosen
scales (``base_fst_own``, ``base_fst_pt_own``).  The lines are appended to
``WORK/exp_seed$SEED_pruned/RESULTS`` in the script's forms; every finished
``decode_*.out`` is reused.  The overrides are ``mini_grammar``'s (the
budget locates the pruned bundle) and the two scale lists.
"""

from __future__ import annotations

import argparse

from pika_tpu_torch.recipes import mini_grammar, pruned_grammar
from pika_tpu_torch.recipes.pruned_grammar import decode_rows
from pika_tpu_torch.recipes.retune_grammar_seed import dev_sweep
from pika_tpu_torch.recipes.stages import Recipe, run_main, summary, sweep_list

FST_SCALES = "0.2,0.4,0.8,1.2"
PT_SCALES = "0.2,0.4,0.8,1.2,1.6"


def own_rows(c: pruned_grammar.Commands, scale, pt_scale) -> dict:
    """The test decodes at the pruned model's own scales, by tag."""
    return {"base_fst_own": c.decode(c.model, "test", "nbest_fst_own.txt", *c.fst(scale)),
            "base_fst_pt_own": c.decode(c.model, "test", "nbest_fst_pt_own.txt",
                                        *c.fst(pt_scale, True))}


def run(work: str, seed: int = 1, device=None, flags=None, fst_scales: str = FST_SCALES,
        pt_scales: str = PT_SCALES, decode_timeout: float = 1500.0, **budget) -> dict:
    """Returns the chosen scales and the test WERs by tag."""
    c = pruned_grammar.Commands(work, seed, **budget)
    r = Recipe(work, device, flags, results=c.results, decode_timeout=decode_timeout,
               append=True)
    exp = c.exp
    out = {"wer": {}, "times": r.times}

    r.say("=== retry the tune-once per-beam test row ===")
    decode_rows(r, c, {"base_fst": c.rows()["base_fst"]}, out)
    r.say("=== dev sweep: per-beam fst_lm_scale (pruned model's own) ===")
    scale, scale_wer = dev_sweep(r, "fst_lm_scale", sweep_list(fst_scales), lambda s: (
        r.decoded_wer(c.dev_fst(s), f"{exp}/decode_devfst{s}.out")))
    r.result(f"chosen fst_lm_scale {scale} (dev WER {scale_wer})")
    r.say("=== dev sweep: per-token fst_lm_scale (pruned model's own) ===")
    pt, pt_wer = dev_sweep(r, "pt fst_lm_scale", sweep_list(pt_scales), lambda s: (
        r.decoded_wer(c.dev_pt(s), f"{exp}/decode_devpt{s}.out")))
    r.result(f"chosen pt fst_lm_scale {pt} (dev WER {pt_wer})")
    out.update(fst_scale=scale, pt_scale=pt)

    r.say("=== test decodes with the pruned model's OWN dev-tuned scales ===")
    decode_rows(r, c, own_rows(c, scale, pt), out)
    r.say("### PRUNED RETUNE DONE")
    r.say(open(c.results).read().rstrip("\n"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="tools/r5_pruned_retune.sh on the port")
    ap.add_argument("work", nargs="?", default="recipe_work/mini_grammar")
    ap.add_argument("--seed", type=int, default=1, help="the pruned model's seed (SEED)")
    mini_grammar.add_budget_args(ap)
    ap.add_argument("--fst_scales", type=str, default=FST_SCALES)
    ap.add_argument("--pt_scales", type=str, default=PT_SCALES)
    args = ap.parse_args(argv)
    out = run(args.work, args.seed, **mini_grammar.run_kwargs(args))
    print(summary(out), flush=True)
    return all(w is not None for w in out["wer"].values())


if __name__ == "__main__":
    run_main(main)
