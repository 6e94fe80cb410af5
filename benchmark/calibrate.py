"""The readings that the limits of ``benchmark/limits/<workload>.json`` are
set from, one JSON line per seed, in one process:

    python benchmark/calibrate.py --workload <name> --seeds 101-112 \
        [--control 101-103] [--fault 101-103]

For each seed the program's readings against the reference (the lower
reading: sound runs), and on the seeds listed:

* ``--control``: the control against the reference.  Training: the
  program's own bf16 path (``compute_dtype=torch.bfloat16``), and the
  reference with the prediction net's products alone in bf16 in the
  program's place (``predict_bf16``).  Decoding:
  the reference with the encoder's products in bf16 and the prediction
  net's and joint's in fp8 (e4m3), rescoring the same served alignments.
* ``--fault``: training, the reference with half of each batch left out
  and the mean taken over the rest, in the program's place
  (``half_batch``), and the program with its optimizer's step doing
  nothing (``unchanged``); decoding, the
  served N-best altered after the search: the first half's answers served
  for the second half (``half_batch``), and one label of each batch's
  first hypothesis that holds one changed, in its tokens and alignment
  (``token``).

A decode seed runs the cell's set-up and as many batches as a run
compares, at the cell's own load.  Needs the cell's card; nothing here
is run by ``run.py``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import drive_decode, drive_train, harness, program, traffic, weights  # noqa: E402
from benchmark.reference import model as M  # noqa: E402
from pika_tpu_torch.train import lr  # noqa: E402

CONTROL = M.Precision(enc="bfloat16", dec="fp8")
PREDICT_BF16 = M.Precision(dec="bfloat16", joint="float32")


def seeds(spec: str) -> list:
    out = []
    for part in filter(None, spec.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def train_seed(ctx, control: bool, fault: bool) -> dict:
    d = drive_train
    layout = {}

    def program_readings(lower_precision: bool) -> dict:
        ctx.control = lower_precision
        run = d.setup(ctx)
        d.release(ctx, run)
        harness.free_device(ctx)
        layout.update(run["layout"])
        return run["readings"]

    got = program_readings(False)
    low = program_readings(True) if control else None
    if fault:
        with mock.patch.object(lr.Optimizer, "step", lambda self: None):
            unchanged = program_readings(False)
    ctx.control = False
    state = weights.make_state(layout["shapes"], ctx.seed, ctx.device)
    pool = traffic.make_pool(ctx.traffic, ctx.config["model"]["vocab_size"], ctx.seed, ctx.device)

    def ref(fault_kind=None, prec=M.FLOAT32) -> dict:
        gen = torch.Generator(ctx.device).manual_seed(weights.sub_seed(ctx.seed, 2))
        return d.reference_readings(ctx, state, layout["names"], pool, gen, fault_kind, prec)

    t = time.perf_counter()
    reference = ref()
    row = {"reference_s": time.perf_counter() - t, "detail": {}}
    readings = {"program": got}
    if control:
        readings.update(control=low, predict_bf16=ref(prec=PREDICT_BF16))
    if fault:
        readings.update(half_batch=ref("half_batch"), unchanged=unchanged)
    for kind, r in readings.items():
        row[kind] = d.compare(r, reference, state)
        row["detail"][kind] = detail(r, reference, state)
    del state, pool, reference, readings
    harness.free_device(ctx)
    return row


def detail(got: dict, ref: dict, start: dict) -> dict:
    """Each step's signed relative loss gap; of each leaf number the
    median, the quartiles' spread, the median by part (encoder, prediction
    net, joint), the three worst leaves and the prediction net's leaves."""
    leaves = drive_train.leaf_numbers(got, ref, start)
    out = {"loss": [(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]}
    for key, g in leaves.items():
        vals = list(g.values())
        out[key + "_median"] = float(np.median(vals))
        out[key + "_q"] = [float(np.quantile(vals, 0.25)), float(np.quantile(vals, 0.75))]
        for part in ("encoder", "decoder"):
            sub = [v for k, v in g.items() if k.startswith(part)]
            out[f"{key}_{part}"] = float(np.median(sub)) if sub else None
        sub = [v for k, v in g.items() if not k.startswith(("encoder", "decoder"))]
        out[key + "_joint"] = float(np.median(sub)) if sub else None
        out[key + "_worst"] = sorted(g.items(), key=lambda kv: -kv[1])[:3]
        out[key + "_predict"] = {k: float(f"{v:.5g}") for k, v in g.items()
                                 if k.startswith(("decoder.", "embed."))}
    return out


def faulty(picked: list, kind: str, vocab: int) -> list:
    """The picked N-best with a fault planted in what the search served."""
    out = []
    for i, host in picked:
        host = {k: v.copy() for k, v in host.items()}
        if kind == "half_batch":
            h = host["scores"].shape[0] // 2
            for v in host.values():
                v[h:2 * h] = v[:h]
        else:
            held = np.argwhere(host["lens"] > 0)
            if len(held):
                b, n = held[0]
                first = int(np.nonzero(host["aligns"][b, n] > 0)[0][0])
                new = int(host["aligns"][b, n, first]) % (vocab - 1) + 1
                host["aligns"][b, n, first] = new
                host["tokens"][b, n, 0] = new
        out.append((i, host))
    return out


def decode_seed(ctx, control: bool, fault: bool = False) -> dict:
    d = drive_decode
    run = d.setup(ctx)
    rec = d.window(ctx, run, 0.0, min_units=ctx.traffic["check_batches"])
    d.release(ctx, run)
    harness.free_device(ctx)
    t = time.perf_counter()
    state = weights.make_state(run["layout"]["shapes"], ctx.seed, ctx.device)
    ref = d.rescore(ctx, state, run["pool"], run["cmvn"], run["picked"])
    row = {"program": d.readings(ref),
           "reference_s": time.perf_counter() - t, "batch_s": float(np.median(rec["latencies"])),
           "top1_scores": [float(r[0][0]) for r in ref],
           "served": int(sum(r[3].sum() for r in ref)),
           "best_align": [int(min(h["align_lens"][:, 0].min() for _, h in run["picked"])),
                          int(max(h["align_lens"][:, 0].max() for _, h in run["picked"]))]}
    if control:
        low = d.rescore(ctx, state, run["pool"], run["cmvn"], run["picked"], CONTROL)
        gap = 0.0
        for r, c in zip(ref, low):
            g = np.minimum(np.abs(c[1] - r[1]), np.abs(c[2] - r[2]))[r[3]]
            gap = max(gap, float(g.max()) if g.size else 0.0)
        row["control"] = {"score_gap": gap}
    if fault:
        for kind in ("half_batch", "token"):
            bad = d.rescore(ctx, state, run["pool"], run["cmvn"],
                            faulty(run["picked"], kind, ctx.config["model"]["vocab_size"]))
            row[kind] = d.readings(bad)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    control, fault = set(seeds(args.control)), set(seeds(args.fault))
    for seed in seeds(args.seeds):
        t = time.perf_counter()
        ctx = harness.make_ctx(Path(args.root), args.workload, seed, args.device)
        program.set_precision(ctx.config)
        if ctx.traffic["kind"] == "train":
            row = train_seed(ctx, seed in control, seed in fault)
        else:
            row = decode_seed(ctx, seed in control, seed in fault)
        row.update(seed=seed, workload=args.workload, seconds=time.perf_counter() - t)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
