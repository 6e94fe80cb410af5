"""The harness on the CPU at a test's size: what it finds by name, what the
traffic draws, what ``BENCHMARK.json`` holds, and that no module of the
benchmark imports JAX or the JAX package.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import json
import re
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness, traffic
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "pika_tpu"}


def test_finds_new_files_by_name(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    as new files and entries run with no edit of the harness."""
    root = tiny.make_tree(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((root / "benchmark/configs/pika_flagship.json").read_text())
    config["model"]["embd_dim"] = 6
    (root / "benchmark/configs/added.json").write_text(json.dumps(config))
    mix = json.loads((root / "benchmark/traffic/decode_b8_beam8.json").read_text())
    mix.update(beam=2, n_best=2)
    (root / "benchmark/traffic/added_mix.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/batches_done.py").write_text(
        "def read(record):\n    return float(record['units'])\n")
    (root / "benchmark/limits/added.cell.json").write_text(
        (root / "benchmark/limits/flagship.decode_b8_beam8.json").read_text())
    bench["configs"].append({"name": "added", "source": "https://example.org", "reduced": [],
                             "file": "benchmark/configs/added.json", "why": "test"})
    bench["workloads"].append({"name": "added.cell", "config": "added", "traffic": "added_mix",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "batches_done", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "decode search",
                               "moves": "decode_audio_s_per_s", "workloads": ["added.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    ctx = harness.make_ctx(root, "added.cell", 5, "cpu")
    assert ctx.config["model"]["embd_dim"] == 6 and ctx.traffic["beam"] == 2
    result = harness.run(ctx, 0.2, True, time.perf_counter())
    assert result["metrics"]["batches_done"]["value"] == result["attempted"] >= 1
    assert result["correct"] is True


@pytest.mark.parametrize("name", ["train_b32_10s", "decode_b8_beam8"])
def test_traffic_follows_the_seed(name):
    mix = traffic.load(tiny.BENCH / "traffic" / f"{name}.json")
    mix.update(batch=2, seconds=0.5, pool=2)
    a, b, c = (traffic.make_pool(mix, 50, seed, "cpu") for seed in (7, 7, 2 ** 31 + 9))
    for x, y, z in zip(a, b, c):
        for key in x:
            assert torch.equal(x[key], y[key])
            assert x[key].shape == z[key].shape
        assert not torch.equal(x["wavs"], z["wavs"])
    assert not torch.equal(a[0]["wavs"], a[1]["wavs"])


def test_benchmark_json_names_and_files():
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics] + [w["traffic"] for w in bench["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in bench["configs"]:
        assert (tiny.REPO / c["file"]).is_file()
        assert json.loads((tiny.REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert (tiny.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (tiny.BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in metrics:
        assert (tiny.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                yield arg.value


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``pika_tpu_torch`` is not
    ``pika_tpu``."""
    found = {}
    for path in sorted(tiny.BENCH.rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        if tops & FORBIDDEN:
            found[str(path)] = sorted(tops & FORBIDDEN)
    assert not found
    assert "pika_tpu_torch" not in FORBIDDEN


def test_reads_no_file_of_the_old_tools():
    """No string of the code (docstrings aside) names ``bench.py``, the
    port's ``tools/`` or a ``BENCH_*.json``; the tests aside."""
    for path in tiny.BENCH.rglob("*.py"):
        if "tests" in path.relative_to(tiny.BENCH).parts:
            continue
        tree = ast.parse(path.read_text())
        docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)}
        strings = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
                   and isinstance(n.value, str) and id(n) not in docs]
        assert not [s for s in strings if re.search(r"bench\.py|tools|BENCH_", s)], path
