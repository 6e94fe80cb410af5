"""Merge ``mini_grammar``'s ``RESULTS.seed*`` files into one markdown table
(the port's copy of ``tools/summarize_grammar.py``: the same table, byte
for byte):

    python -m pika_tpu_torch.recipes.summarize_grammar WORK

Rows are the recipe's stages; columns one per seed, then the mean and the
spread, so that a stage's gain can be judged against the seeds' spread.
"""

from __future__ import annotations

import glob
import re
import sys

STAGES = ["base", "base_fst", "base_fst_pt", "mbr", "mbr_fst", "mbr_fst_pt",
          "mbr_las", "mbr_las_fst", "mbr_fst_pt_las"]


def seed_wers(work: str) -> dict:
    """{seed: {stage: WER}} of every ``RESULTS.seed*`` under ``work`` that
    holds a stage WER (files such as ``RESULTS.seed2.retune`` included, as
    the tool's glob includes them)."""
    seeds = {}
    for path in sorted(glob.glob(f"{work}/RESULTS.seed*")):
        seed = path.rsplit("seed", 1)[1]
        wers = {}
        for line in open(path):
            m = re.match(r"(\w+) %WER ([0-9.]+)", line)
            if m and m.group(1) in STAGES:
                wers[m.group(1)] = float(m.group(2))
        if wers:
            seeds[seed] = wers
    return seeds


def table(seeds: dict) -> list:
    cols = sorted(seeds)
    out = ["| Stage | " + " | ".join(f"seed {s}" for s in cols) + " | mean | spread |",
           "|---" * (len(cols) + 3) + "|"]
    for st in STAGES:
        vals = [seeds[s][st] for s in cols if st in seeds[s]]
        cells = [f"{seeds[s][st]:.2f}" if st in seeds[s] else "—" for s in cols]
        if vals:
            mean = sum(vals) / len(vals)
            spread = max(vals) - min(vals)
            out.append(f"| {st} | " + " | ".join(cells) + f" | {mean:.2f} | {spread:.2f} |")
        else:
            out.append(f"| {st} | " + " | ".join(cells) + " | — | — |")
    return out


def main(argv=None) -> list:
    work = (sys.argv[1:] if argv is None else argv)[0]
    seeds = seed_wers(work)
    if not seeds:
        raise SystemExit(f"no RESULTS.seed* with stage WERs under {work}")
    lines = table(seeds)
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
