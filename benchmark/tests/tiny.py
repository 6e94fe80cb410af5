"""A benchmark tree at a CPU test's size: ``BENCHMARK.json`` with tiny
configurations and mixes under a temporary root and the metrics copied
in, so that the harness runs there as it runs at the real size.

The limits are the tiny tree's own (``TINY_LIMITS``), set from its CPU
readings as the cells' are from theirs: at this size a sound run's gaps
are those of the attention's bf16 rounding at head widths of 2 to 8, and
a score sums a few dozen steps, not some hundreds.  Sound runs read under
them and the faults and controls over them on the tests' seeds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

TINY_MODEL = {"input_dim": 24, "vocab_size": 400, "hid_dim": 32, "tdnn_nhid": 32, "embd_dim": 8,
              "dec_d_model": 16, "dec_heads": 4, "dec_d_ff": 32}
TINY_FEAT = {"num_mel_bins": 8}
TINY_TRAIN = {"batch": 4, "seconds": 1.0, "labels_per_utt": 4, "pool": 4, "loss_read_every": 2,
              "reference_block": 2, "trace_units": 2}
TINY_DECODE = {"batch": 2, "seconds": 2.0, "level_db": [-30.0, 10.0], "pool": 3, "beam": 4,
               "n_best": 4, "max_symbols": 12, "warm_units": 1, "check_batches": 2,
               "trace_units": 1}
CELLS = {"flagship.train_b32_10s": TINY_TRAIN, "flagship.decode_b8_beam8": TINY_DECODE,
         "convtf.decode_b8_beam8": TINY_DECODE}
TINY_LIMITS = {"train": {"loss_gap": 6e-3, "grad_gap": 0.3, "delta_gap": 0.3, "grad_diff": 0.14},
               "decode": {"score_gap": 0.35, "rank_gap": 0.1, "malformed": 0}}


def make_tree(root: Path) -> Path:
    """The repo's benchmark, shrunk, under ``root``: every configuration and
    mix the repo has, with TINY_* overrides; the repo's limits and metric
    readers as they are."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    out = Path(root)
    (out / "benchmark").mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", out / "benchmark" / "metrics", dirs_exist_ok=True)
    (out / "benchmark" / "limits").mkdir(exist_ok=True)
    for entry in bench["configs"]:
        config = json.loads((REPO / entry["file"]).read_text())
        config["model"].update(TINY_MODEL)
        config["features"].update(TINY_FEAT)
        path = out / entry["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(config))
    for cell in bench["workloads"]:
        src = BENCH / "traffic" / f"{cell['traffic']}.json"
        mix = json.loads(src.read_text())
        mix.update(CELLS[cell["name"]])
        dst = out / "benchmark" / "traffic" / src.name
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(json.dumps(mix))
        limits = out / "benchmark" / "limits" / f"{cell['name']}.json"
        limits.write_text(json.dumps(TINY_LIMITS[mix["kind"]]))
    (out / "BENCHMARK.json").write_text(json.dumps(bench))
    return out
