"""The ``train`` traffic kind: chained training steps of
``make_train_step`` on the mix's batches, dispatched ahead, the loss read to
the host every ``loss_read_every`` steps as the training CLI reads it.

Set-up builds one step (model, optimizer, featurizer) and drives it
through the mix's ``checked_steps`` first steps on the first batches of the
pool, keeping what the check compares: each step's loss, the first
gradient as the optimizer holds it after one step (SGD's momentum buffer)
and the parameters after the last, both copied to the host.  The window
takes that same step on from there.  After the window the reference runs
the same steps from the same weights, batches and random stream
(``reference/train.py``).
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from benchmark import program, traffic, weights
from benchmark.reference import features as RF
from benchmark.reference import model as M
from benchmark.reference import train as reference


def host_copy(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in tensors.items()}


def setup(ctx) -> dict:
    mix, config, dev = ctx.traffic, ctx.config, ctx.device
    model, layout = program.build_model(config, ctx.seed, dev)
    ctx.mark("weights")
    optimizer = program.make_optimizer(model.parameters(), "sgd", **mix["optimizer"])
    pool = traffic.make_pool(mix, config["model"]["vocab_size"], ctx.seed, dev)
    cmvn = RF.global_cmvn(pool[0]["wavs"], config["features"])
    feat = program.featurizer(config, traffic.samples(mix), dev, mix["spec_augment"],
                              mix["max_freq_span"], mix["max_time_span"], cmvn)
    step = program.make_train_step(model, optimizer, feat, loss_chunk=mix["loss_chunk"],
                                   compute_dtype=torch.bfloat16 if ctx.control else None)
    gen = torch.Generator(dev).manual_seed(weights.sub_seed(ctx.seed, 2))
    ctx.mark("pool")
    losses, first_grad = [], None
    for i in range(mix["checked_steps"]):
        losses.append(float(step(pool[i], gen)["loss"]))
        ctx.mark(f"step{i + 1}")
        if i == 0:
            params = dict(model.named_parameters())
            first_grad = host_copy({n: optimizer.opt.state.get(params[n], {}).get(
                "momentum_buffer", torch.zeros_like(params[n])) for n in layout["names"]})
    after = host_copy(dict(model.named_parameters()))
    ctx.mark("readings")
    return {"step": step, "pool": pool, "gen": gen, "next": mix["checked_steps"], "model": model,
            "layout": layout,
            "readings": {"losses": losses, "first_grad": first_grad, "after": after}}


def _steps(ctx, run: dict, n: int):
    pool = run["pool"]
    for _ in range(n):
        out = run["step"](pool[run["next"] % len(pool)], run["gen"])
        run["next"] += 1
    return out


def window(ctx, run: dict, seconds: float) -> dict:
    """Steps until the window has lasted ``seconds``, read at the loss
    reads; the rate is every step over the whole window."""
    every = ctx.traffic["loss_read_every"]
    units, nonfinite = 0, 0
    t0 = time.perf_counter()
    while True:
        loss = float(_steps(ctx, run, every)["loss"])
        units += every
        nonfinite += not math.isfinite(loss)
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    b = ctx.traffic["batch"]
    return {"window_s": elapsed, "units": units, "failed": nonfinite, "utterances": units * b,
            "audio_s": units * b * ctx.traffic["seconds"]}


def stretch(ctx, run: dict) -> int:
    n = ctx.traffic["trace_units"]
    float(_steps(ctx, run, n)["loss"])
    return n


def release(ctx, run: dict) -> None:
    """Free the program's state; the readings stay."""
    for key in ("step", "pool", "gen", "model"):
        run.pop(key)


def check(ctx, run: dict) -> dict:
    """The reference's steps from the same start; returns each compared
    number."""
    mix, config, dev = ctx.traffic, ctx.config, ctx.device
    layout = run["layout"]
    state = weights.make_state(layout["shapes"], ctx.seed, dev)
    pool = traffic.make_pool(mix, config["model"]["vocab_size"], ctx.seed, dev)
    gen = torch.Generator(dev).manual_seed(weights.sub_seed(ctx.seed, 2))
    return compare(run["readings"], reference_readings(ctx, state, layout["names"], pool, gen),
                   state)


def reference_readings(ctx, state: dict, names: list, pool: list, gen, fault=None,
                       prec=M.FLOAT32) -> dict:
    """The reference's readings of the checked steps (``fault``: one planted
    in it, as ``reference/train.py`` says; ``prec``: its products rounded,
    a control)."""
    mix, config = ctx.traffic, ctx.config
    losses, grad, after = reference.train_steps(
        state, names, pool[:mix["checked_steps"]], gen, config["model"], config["features"], mix,
        RF.global_cmvn(pool[0]["wavs"], config["features"]), prec, fault)
    return {"losses": losses, "first_grad": grad, "after": after}


def compare(got: dict, ref: dict, start: dict) -> dict:
    """loss_gap: the worst step's |loss - reference| / |reference|.
    grad_gap and delta_gap: the worst leaf's |norm - reference norm| of the
    first gradient and of the change after the last step.  grad_diff: the
    median leaf's norm of the first gradient's difference from the
    reference's; grad_diff_encoder: the same over the encoder's leaves
    alone, whose sound gap is the encoder's own and not a prediction net's
    stated bf16 attention.  Each leaf's is taken over the larger of its
    reference norm and the median leaf's (``leaf_numbers``)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    leaves = leaf_numbers(got, ref, start)
    diff = leaves["grad_diff"]
    return {"loss_gap": loss_gap, "grad_gap": max(leaves["grad_gap"].values()),
            "delta_gap": max(leaves["delta_gap"].values()),
            "grad_diff": statistics.median(diff.values()),
            "grad_diff_encoder": statistics.median(v for k, v in diff.items()
                                                   if k.startswith("encoder."))}


def leaf_numbers(got: dict, ref: dict, start: dict) -> dict:
    """Leaf -> number, on the leaves that count: those whose reference
    gradient is at least a thousandth of the median leaf's (a key's bias
    under softmax is nought to rounding).  ``grad_gap``, ``delta_gap``:
    |norm - reference norm| of the first gradient and of the parameters'
    change; ``grad_diff``, ``delta_diff``: the norm of the difference
    from the reference's.  Each over the larger of the leaf's reference
    norm and the median leaf's."""
    g_norm, d_norm, out = {}, {}, {k: {} for k in ("grad_gap", "delta_gap", "grad_diff",
                                                   "delta_diff")}
    pairs = {}
    for k, g_ref in ref["first_grad"].items():
        dev = g_ref.device
        g_got = got["first_grad"][k].to(dev)
        d_ref = ref["after"][k] - start[k]
        d_got = got["after"][k].to(dev) - start[k]
        g_norm[k], d_norm[k] = float(g_ref.norm()), float(d_ref.norm())
        pairs[k] = (float(g_got.norm()), float((g_got - g_ref).norm()),
                    float(d_got.norm()), float((d_got - d_ref).norm()))
    g_med = statistics.median(g_norm.values())
    leaves = [k for k, v in g_norm.items() if v >= 1e-3 * g_med]
    g_med = statistics.median(g_norm[k] for k in leaves)
    d_med = statistics.median(d_norm[k] for k in leaves)
    for k in leaves:
        g, dg, d, dd = pairs[k]
        gs, ds = max(g_norm[k], g_med), max(d_norm[k], d_med)
        out["grad_gap"][k] = abs(g - g_norm[k]) / gs
        out["delta_gap"][k] = abs(d - d_norm[k]) / ds
        out["grad_diff"][k] = dg / gs
        out["delta_diff"][k] = dd / ds
    return out
