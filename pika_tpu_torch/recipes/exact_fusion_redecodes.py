"""Re-decode the grammar matrix's per-token test rows with exact full-vocabulary
selection (``tools/r5_exact_fusion_redecodes.sh``), after ``mini_grammar``
has run the seeds in WORK:

    python -m pika_tpu_torch.recipes.exact_fusion_redecodes [WORK] [--seeds 1,2,3]
        [--device cpu] [overrides]

For each seed and for its base and MBR bundles, the per-token test decode at
the tune-once scale 1.2 with ``--fst_topm 0``; the lines
``seed$SEED ${tag}_fst_pt_exact %WER W`` go to ``WORK/RESULTS.exact_fusion``
(emptied first).  Where a decode fails (a seed's bundle absent) the line has
no WER, as the script's empty ``grep`` leaves it.  A finished
``decode_${tag}_fst_pt_exact.out`` is reused.  The overrides are
``mini_grammar``'s (the budget locates the seeds' bundles).
"""

from __future__ import annotations

import argparse
import os

from pika_tpu_torch.recipes import mini_grammar
from pika_tpu_torch.recipes.pruned_grammar import PT_SCALE
from pika_tpu_torch.recipes.stages import Recipe, run_main, summary

SEEDS = "1,2,3"


def exact_rows(c: mini_grammar.Commands) -> dict:
    """The seed's two re-decodes by tag (``base``, ``mbr``)."""
    fst = c.fst(PT_SCALE, True)
    i = fst.index("--symbols_map")
    return {tag: c.decode(model, "test", f"nbest_{tag}_fst_pt_exact.txt",
                          *fst[:i], "--fst_topm", "0", *fst[i:])
            for tag, model in (("base", c.model), ("mbr", c.mbr_model))}


def run(work: str, seeds: str = SEEDS, device=None, flags=None, decode_timeout: float = 1500.0,
        **budget) -> dict:
    """Returns {"seed$SEED ${tag}_fst_pt_exact": WER text or None}."""
    r = Recipe(work, device, flags, results=f"{work}/RESULTS.exact_fusion",
               decode_timeout=decode_timeout)
    out = {"wer": {}, "times": r.times}
    for seed in (int(s) for s in seeds.split(",") if s):
        c = mini_grammar.Commands(work, seed, **budget)
        for tag, argv in exact_rows(c).items():
            # no seed directory, no decode output (the script's redirect fails)
            w = (r.decoded_wer(argv, f"{c.exp}/decode_{tag}_fst_pt_exact.out")
                 if os.path.isdir(c.exp) else None)
            name = f"seed{seed} {tag}_fst_pt_exact"
            out["wer"][name] = w
            r.result(f"{name} {'' if w is None else '%WER ' + w}")
    r.say("### EXACT REDECODES DONE")
    r.say(open(r.results).read().rstrip("\n"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="tools/r5_exact_fusion_redecodes.sh on the port")
    ap.add_argument("work", nargs="?", default="recipe_work/mini_grammar")
    ap.add_argument("--seeds", type=str, default=SEEDS, help="the seeds, comma-separated")
    mini_grammar.add_budget_args(ap)
    args = ap.parse_args(argv)
    out = run(args.work, args.seeds, **mini_grammar.run_kwargs(args))
    print(summary(out), flush=True)
    return True


if __name__ == "__main__":
    run_main(main)
