"""The controls and the faults at the cells' own sizes, on the card
(skipped without one; about ten minutes):

    python -m pytest --noconftest -m gpu benchmark/tests/test_benchmark_gpu.py -q

For each cell of ``BENCHMARK.json``, on three seeds: the program's
readings pass the cell's limits, and the control and each fault fail them
on every seed (each seed's readings printed, seen with ``-s``).
Training's control is the program's bf16 path, its faults the reference
with half of each batch left out and the program's optimizer step doing
nothing; decoding's control is the reference's
products in bf16 and fp8, its faults the first half's answers served for
the second half and one token altered where the search produced it."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests import tiny

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
CELLS = tiny.cells("train") + tiny.cells("decode")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_and_faults_fail_at_full_size(card, workload):
    failed = {}
    for seed in SEEDS:
        ctx = harness.make_ctx(tiny.REPO, workload, seed, card)
        harness.program.set_precision(ctx.config)
        limits = ctx.limits
        if ctx.traffic["kind"] == "train":
            row = calibrate.train_seed(ctx, control=True, fault=True)
            kinds = ("control", "half_batch", "unchanged")
        else:
            row = calibrate.decode_seed(ctx, control=True, fault=True)
            kinds = ("control", "half_batch", "token")
        print(json.dumps({"workload": workload, "seed": seed, **{
            k: row[k] for k in ("program",) + kinds}}), flush=True)   # seen with -s
        assert all(row["program"][k] <= limits[k] for k in limits), row
        for kind in kinds:
            failed.setdefault(kind, []).append(any(row[kind][k] > limits[k] for k in row[kind]))
    assert failed and all(all(v) for v in failed.values()), failed
