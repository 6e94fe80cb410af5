#!/bin/bash
# Run one quality recipe and keep what its record needs:
#
#   bash pika_tpu_torch/recipes/run_logged.sh OUT RECIPE [recipe args...]
#
# from the root of a checkout, RECIPE being one of the recipes' modules (work
# directory recipe_work/RECIPE, or $WORK: the pruned recipes and the exact
# re-decodes share mini_grammar's, WORK=recipe_work/mini_grammar).  Writes
# OUT/card.txt (the card's
# name and power limit), OUT/smi.txt (nvidia-smi's SM clock, power draw and
# utilization every 30 s), OUT/stdout.txt (the recipe's output; the
# recipes' last line is their summary JSON) and copies the work directory's logs, decode
# outputs and N-best files, RESULTS, notes and LM to OUT.
set -o pipefail
out=$(realpath -m "$1"); recipe=$2; shift 2
work=${WORK:-recipe_work/$recipe}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
( while true; do
    nvidia-smi --query-gpu=clocks.sm,power.draw,utilization.gpu --format=csv,noheader >> "$out/smi.txt"
    sleep 30
  done ) &
smi=$!
python -m "pika_tpu_torch.recipes.$recipe" "$work" "$@" 2>&1 | tee "$out/stdout.txt" \
    | grep -v "dropped .* tail utterances"
rc=$?
pkill -P $smi; kill $smi  # the sampler and its sleep
cd "$work" && find . -name "*.log" -o -name "*.out" -o -name "*.out.failed" -o -name "RESULTS*" \
    -o -name "*.note" -o -name "lm.arpa" -o -name "nbest*.txt" \
    | while read -r f; do
    mkdir -p "$out/$(dirname "$f")" && cp "$f" "$out/$f"
done
exit $rc
