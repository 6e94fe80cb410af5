"""A benchmark tree at a CPU test's size: ``BENCHMARK.json`` with tiny
configurations and mixes under a temporary root and the metrics copied
in, so that the harness runs there as it runs at the real size.

A configuration's tiny sizes are ``TINY_SHARED`` and each of its model
parts' ``TINY`` (``reference/encoders/``, ``reference/decoders/``); a
mix's are its kind's (``TINY_MIX``).  So a new configuration or cell
needs nothing here.  ``TINY_MODEL`` (every part's sizes) and ``CELLS``
(each cell's mix sizes) serve tests outside the benchmark that build
these pieces themselves.

The limits are the tiny tree's own (``TINY_LIMITS``), set from its CPU
readings as the cells' are from theirs: at this size a sound run's gaps
are those of the attention's bf16 rounding at head widths of 2 to 8, and
a score sums a few dozen steps, not some hundreds.  Sound runs read under
them and the faults and controls over them on the tests' seeds (training's
bf16 path at this size: ``grad_diff_encoder`` sound 0.056-0.140, bf16
0.195-0.310, on eight seeds of each training cell)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.reference import model as M

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

TINY_SHARED = {"input_dim": 24, "vocab_size": 400, "hid_dim": 32, "embd_dim": 8}
TINY_FEAT = {"num_mel_bins": 8}
TINY_TRAIN = {"batch": 4, "seconds": 1.0, "labels_per_utt": 4, "pool": 4, "loss_read_every": 2,
              "reference_block": 2, "trace_units": 2}
TINY_DECODE = {"batch": 2, "seconds": 2.0, "level_db": [-30.0, 10.0], "pool": 3, "beam": 4,
               "n_best": 4, "max_symbols": 12, "warm_units": 1, "check_batches": 2,
               "trace_units": 1}
TINY_MIX = {"train": TINY_TRAIN, "decode": TINY_DECODE}
TINY_LIMITS = {"train": {"loss_gap": 6e-3, "grad_gap": 0.3, "delta_gap": 0.3, "grad_diff": 0.14,
                         "grad_diff_encoder": 0.165},
               "decode": {"score_gap": 0.35, "rank_gap": 0.1, "malformed": 0}}


def bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def kind_of(cell: dict) -> str:
    return json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())["kind"]


def cells(kind: str) -> list:
    """The names of the repo's cells whose mix is of ``kind``."""
    return [c["name"] for c in bench()["workloads"] if kind_of(c) == kind]


def tiny_model(model: dict) -> dict:
    """``model`` at the CPU size: the shared sizes and its parts'."""
    out = dict(model, **TINY_SHARED)
    for part in M.parts(model):
        out.update(part.TINY)
    return out


def _every_part_tiny() -> dict:
    out = dict(TINY_SHARED)
    for entry in bench()["configs"]:
        for part in M.parts(json.loads((REPO / entry["file"]).read_text())["model"]):
            out.update(part.TINY)
    return out


TINY_MODEL = _every_part_tiny()
CELLS = {c["name"]: TINY_MIX[kind_of(c)] for c in bench()["workloads"]}


def make_tree(root: Path) -> Path:
    """The repo's benchmark, shrunk, under ``root``: every configuration and
    mix the repo has at its tiny sizes; the repo's metric readers as they
    are, and the tiny limits."""
    data = bench()
    out = Path(root)
    (out / "benchmark").mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", out / "benchmark" / "metrics", dirs_exist_ok=True)
    (out / "benchmark" / "limits").mkdir(exist_ok=True)
    for entry in data["configs"]:
        config = json.loads((REPO / entry["file"]).read_text())
        config["model"] = tiny_model(config["model"])
        config["features"].update(TINY_FEAT)
        path = out / entry["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(config))
    for cell in data["workloads"]:
        src = BENCH / "traffic" / f"{cell['traffic']}.json"
        mix = json.loads(src.read_text())
        mix.update(TINY_MIX[mix["kind"]])
        dst = out / "benchmark" / "traffic" / src.name
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(json.dumps(mix))
        limits = out / "benchmark" / "limits" / f"{cell['name']}.json"
        limits.write_text(json.dumps(TINY_LIMITS[mix["kind"]]))
    (out / "BENCHMARK.json").write_text(json.dumps(data))
    return out
