"""One run of one cell: find the cell's files by the names in
``BENCHMARK.json``, set up the program, measure the window, trace a
stretch when asked, check the outputs against the reference and print the
result line.

Found by name, each in a file of its own:

* a configuration: the ``file`` of its entry in ``configs``;
* a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``kind``
  names the module that runs it, ``benchmark/drive_<kind>.py``;
* a metric: ``benchmark/metrics/<name>.py``, whose ``read(record)``
  returns the number or None (nothing to read);
* a cell's limits: ``benchmark/limits/<workload>.json``, the largest
  value each compared number may take;
* a model part of the reference: ``benchmark/reference/encoders/<encoder_type>.py``
  and ``benchmark/reference/decoders/<decoder_type>.py`` (``reference/model.py``),
  whose encoder part also gives the cell's encoder shapes.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from benchmark import counts, program, trace, traffic
from benchmark.reference import model as reference_model

FORBIDDEN = ("jax", "jaxlib", "flax", "pika_tpu")


@dataclasses.dataclass
class Ctx:
    root: Path
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: torch.device
    shapes: dict
    control: bool = False   # the program's lower-precision path (calibration)
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        """End of a named phase of set-up (host clock, after a sync)."""
        self.sync()
        self.marks.append((name, time.perf_counter()))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def load_bench(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def kind_module(kind: str):
    return importlib.import_module(f"benchmark.drive_{kind}")


def shapes_of(config: dict, mix: dict) -> dict:
    """The cell's shapes: the batch, its input frames, the label positions,
    the joint's width and vocabulary, and the keys the encoder part owns
    (``t_enc``, the encoder's output frames, and its own widths)."""
    frames = counts.kaldi_frames(traffic.samples(mix))
    model = config["model"]
    shapes = {"batch": mix["batch"], "frames": frames, "u1": mix.get("labels_per_utt", 0) + 1,
              "hid": model["hid_dim"], "vocab": model["vocab_size"]}
    shapes.update(reference_model.part("encoders", model["encoder_type"]).shapes(frames, model))
    return shapes


def make_ctx(root: Path, workload: str, seed: int, device, **kw) -> Ctx:
    root = Path(root)
    bench = load_bench(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {root / 'BENCHMARK.json'}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    mix = traffic.load(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
    limits = json.loads((root / "benchmark" / "limits" / f"{workload}.json").read_text())
    return Ctx(root, cell, config, mix, limits, int(seed), torch.device(device),
               shapes_of(config, mix), **kw)


def metric_entries(root: Path, workload: str, traced: bool) -> list:
    bench = load_bench(root)
    key = "per_layer" if traced else "end_to_end"
    return [m for m in bench[key] if "workloads" not in m or workload in m["workloads"]]


def read_metric(root: Path, name: str, record: dict):
    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(record)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w(device: torch.device):
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.strip())
    except ValueError:
        return None


def free_device(ctx: Ctx) -> None:
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx: Ctx, seconds: float, traced: bool, t_start: float) -> dict:
    """Set-up, window, optional traced stretch, check; returns the result
    line's object."""
    drive = kind_module(ctx.traffic["kind"])
    program.set_precision(ctx.config)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    ctx.marks.append(("start", t_start))
    ctx.mark("import")
    state = drive.setup(ctx)
    setup_s = time.perf_counter() - t_start
    record = {"setup_s": setup_s, "shapes": ctx.shapes, "traffic": ctx.traffic,
              "config": ctx.config, "trace": None}
    record.update(drive.window(ctx, state, seconds))
    ctx.sync()
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    if traced:
        record["trace"] = trace.profile_stretch(lambda: drive.stretch(ctx, state), ctx.device)
    drive.release(ctx, state)
    free_device(ctx)
    checks = drive.check(ctx, state)
    entries = metric_entries(ctx.root, ctx.cell["name"], traced)
    metrics = {}
    for m in entries:
        value = read_metric(ctx.root, m["name"], record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": ctx.cell["chips"], "memory_peak_bytes": int(peak),
              "power_limit_w": power_limit_w(dev)}
    result = {"correct": None, "attempted": record["units"], "failed": record["failed"],
              "metrics": metrics, "device": device}
    tr = record["trace"]
    if tr is not None:
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    compared = {k: {"value": checks[k], "limit": ctx.limits[k]} for k in ctx.limits}
    result["correct"] = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                            for c in compared.values()) and set(checks) <= set(ctx.limits)
    result["checks"] = compared
    result["setup_phases"] = {b[0]: b[1] - a[1] for a, b in zip(ctx.marks, ctx.marks[1:])}
    result["notes"] = notes(record)
    return result


def notes(record: dict) -> list:
    """Lines for standard error: the pace of the window and of the traced
    stretches, and the spread of the batches' latencies."""
    out = [f"window: {record['units']} units in {record['window_s']:.3f} s, "
           f"{record['window_s'] / record['units']:.4f} s a unit"]
    tr = record["trace"]
    if tr is not None:
        paces = [tr] + ([tr.host_trace] if tr.host_trace is not None else [])
        out.append("traced stretches (device alone, with the host): " + ", ".join(
            f"{t.seconds / t.units:.4f} s a unit, busy {t.busy_s:.4f} of {t.window_s:.4f} s"
            for t in paces))
    lat = sorted(record.get("latencies", ()))
    if lat:
        q = {p: 1000.0 * lat[math.ceil(p / 100 * len(lat)) - 1] for p in (50, 90, 95, 99)}
        slow = sum(x > 1.05 * lat[len(lat) // 2] for x in lat) / len(lat)
        out.append("batch latency ms: " + ", ".join(f"p{p} {v:.2f}" for p, v in q.items())
                   + f", max {1000.0 * lat[-1]:.2f}; over 1.05 x median: {100.0 * slow:.1f} %")
        by_batch = {}
        for i, x in zip(record.get("pool_index", ()), record["latencies"]):
            by_batch.setdefault(i, []).append(x)
        if by_batch:
            out.append("median latency ms by pool batch: " + ", ".join(
                f"{i}: {1000.0 * statistics.median(v):.2f}" for i, v in sorted(by_batch.items())))
    return out
