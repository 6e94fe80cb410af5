"""The grammar recipe's seed matrix on the port (``tools/run_grammar_seeds.sh``):
``mini_grammar`` for seeds 1, 2 and 3 in turn, in one work directory whose
corpus and LM the seeds share, then the table of ``summarize_grammar``.

    python -m pika_tpu_torch.recipes.grammar_seeds [WORK] [--device cpu] [overrides]

Seeds 2 and 3 reuse the scales that seed 1 tuned on dev (the per-beam and
per-token ``fst_lm_scale`` and the LAS pair, read from ``RESULTS.seed1``
as the script's ``awk`` reads them), so the seeds' spread is the training
seed's alone.  Each seed gets up to three attempts (the recipe reuses what
an attempt finished) and is complete at its ``mbr_fst_pt_las`` line.  The
attempts run in this process: an attempt that raises is reported and
retried; each decode keeps the recipe's own time limit, but an attempt has
no overall one (the script's ``timeout 7200``).  The overrides are
``mini_grammar``'s.
"""

from __future__ import annotations

import argparse
import os
import time
import traceback

from pika_tpu_torch.recipes import mini_grammar, summarize_grammar
from pika_tpu_torch.recipes.stages import run_main

SEEDS = (1, 2, 3)
ATTEMPTS = 3
# the script's awk: (line prefix, field) of each reused scale
REUSED = {"fst_scale": ("chosen fst_lm_scale", 3), "pt_scale": ("chosen pt fst_lm_scale", 4),
          "las_pair": ("chosen las_scales fw", (4, 6))}


def reused_scales(results: str) -> dict:
    """Seed 1's chosen scales from its RESULTS file, each from the last line
    that starts with its prefix (``awk '/^PREFIX/{print $N}' | tail -1``);
    a scale whose field is empty or whose line is missing is left out."""
    out = {}
    if not os.path.exists(results):
        return out
    lines = open(results).read().splitlines()
    for name, (prefix, field) in REUSED.items():
        values = []
        for line in lines:
            if line.startswith(prefix):
                f = line.split()
                pick = lambda n: f[n - 1] if len(f) >= n else ""  # noqa: E731
                values.append(pick(field) if isinstance(field, int)
                              else ":".join(pick(n) for n in field))
        if values and values[-1]:
            out[name] = values[-1]
    return out


def complete(results: str) -> bool:
    return os.path.exists(results) and any(
        line.startswith("mbr_fst_pt_las ") for line in open(results))


def run(work: str, seeds=SEEDS, **recipe) -> dict:
    """Each seed through ``mini_grammar.run`` (``recipe``: its keyword
    arguments); returns {seed: the last attempt's result or None} and the
    summary table's lines under ``"table"``."""
    out = {}
    for s in seeds:
        scales = {}
        if s > 1:
            seed1 = mini_grammar.Commands(work, 1).results
            if os.path.exists(seed1):
                scales = reused_scales(seed1)
                env = {"fst_scale": "FST_SCALE", "pt_scale": "PT_SCALE", "las_pair": "LAS_PAIR"}
                text = " ".join(f"{env[k]}={v}" for k, v in scales.items())
                print(f"seed {s} reusing seed-1 scales: {text}", flush=True)
        out[s] = None
        for attempt in range(1, ATTEMPTS + 1):
            print(f"===== SEED {s} attempt {attempt} start {time.ctime()} =====", flush=True)
            try:
                out[s] = mini_grammar.run(work, s, **scales, **recipe)
            except Exception:  # an attempt that fails is retried, as the script does
                traceback.print_exc()
            if complete(mini_grammar.Commands(work, s).results):
                print(f"===== SEED {s} complete {time.ctime()} =====", flush=True)
                break
            print(f"===== SEED {s} attempt {attempt} incomplete; retrying =====", flush=True)
    print(f"ALL SEEDS DONE {time.ctime()}", flush=True)
    seeds_found = summarize_grammar.seed_wers(work)
    out["table"] = summarize_grammar.table(seeds_found) if seeds_found else []
    print("\n".join(out["table"]), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="tools/run_grammar_seeds.sh on the port")
    ap.add_argument("work", nargs="?", default="recipe_work/mini_grammar")
    mini_grammar.add_budget_args(ap)
    mini_grammar.add_sweep_args(ap)
    args = ap.parse_args(argv)
    run(args.work, **mini_grammar.run_kwargs(args))
    return all(complete(mini_grammar.Commands(args.work, s).results) for s in SEEDS)


if __name__ == "__main__":
    run_main(main)
