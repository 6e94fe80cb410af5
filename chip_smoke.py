#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pika_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and nvcc.  It
builds the CUDA kernels from ``pika_tpu_torch/csrc``, holds each against its
plain PyTorch version at the shapes its path gives it (K1 at the eval shape,
K2 and K3 at a ragged shape and at the training shape, fed the cotangents of
a real occupancy), then drives the port at the flagship width
(``bench.py``'s model: TDNN-Transformer 9x1024, 2x1024 LSTM prediction net,
V=6268, random weights from a seed):

* the inference path: the eval step (RNN-T loss through K1) and greedy
  decoding of 8 utterances of 10 s;
* the training path: ``bench.py``'s step on 32 utterances of 10 s with 40
  labels -- dither 1.0, SpecAugment, dropout 0.2, the loss through K1
  forward and K2/K3 backward, inf-norm clipping at 3, SGD-Nesterov -- one
  warm-up step, then 3 timed steps from one seeded generator, a profiled
  step, and one step each on the kernel and the plain loss backends from
  the same weights and seed, which must agree.

Float32 throughout, with TF32 off for matmuls and cuDNN convolutions, so the
parity checks compare float32 with float32.

Output: one line per phase; then the card's name and power limit as
nvidia-smi reports them; a JSON line with each kernel's launches on the
training path, max abs error against its plain version, and both times; and
last ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line.  There is no CPU mode: without a CUDA card it exits 1.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from pika_tpu_torch.decode.greedy import greedy_decode_waveforms
from pika_tpu_torch.features.fbank import FbankConfig
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.ops import cuda_build
from pika_tpu_torch.ops.rnnt_kernels import (
    joint_channels,
    joint_channels_bwd,
    joint_channels_bwd_in,
    joint_channels_bwd_reference,
    joint_channels_bwd_w,
    joint_channels_reference,
)
from pika_tpu_torch.ops.rnnt_loss import (
    rnnt_alpha,
    rnnt_loss_forward,
    rnnt_loss_numpy,
    rnnt_occupancy,
)
from pika_tpu_torch.train.lr import make_optimizer
from pika_tpu_torch.train.step import (
    FeaturizerConfig,
    make_eval_step,
    make_featurizer,
    make_train_step,
)

VOCAB = 6268
BATCH = 8
SECONDS = 10
SR = 16000
U_MAX = 40
MAX_SYMBOLS = 200
# K1 against its plain version, both float32 with K = H summation terms in
# another order: lse (about 9 at V=6268) to 1e-4 relative, logits to 1e-3.
K1_RTOL, K1_ATOL = 1e-4, 1e-3
# eval loss through K1 against the plain backend: float32 summed over the
# batch, a few thousand nats
LOSS_RTOL = 1e-3
# K2/K3 against their plain version, float32 with the sums over H, V and the
# lattice taken in another order: per gradient, relative L2 and the max abs
# error as a share of the largest reference entry
K23_REL_L2, K23_MAX_REL = 1e-5, 1e-4
TRAIN_BATCH = 32  # bench.py's batch
TIMED_STEPS = 3
# one train step on the kernel backend against the plain one, same weights
# and seed: the summed loss (float32, ~1e4 nats) to 1e-5 relative; each
# parameter's change to relative L2 1e-2, and 1e-1 in the encoder, whose
# gradients pass through the bf16-rounded attention (a rounding flipped by a
# last-bit difference from the joint moves them at the 1e-2 level: the CPU
# tests measure 5e-2 between the port and the JAX package); BatchNorm
# statistics to 1e-4
STEP_LOSS_RTOL = 1e-5
STEP_TOL, STEP_ENCODER_TOL, STATS_TOL = 1e-2, 1e-1, 1e-4
FLAGSHIP = dict(input_dim=240, vocab_size=VOCAB, hid_dim=1024, encoder_type="tdnn_transformer",
                decoder_type="rnn", enc_layers=9, dec_layers=2, embd_dim=100, tdnn_nhid=1024,
                tdnn_layers=9)
FBANK = dict(sample_frequency=SR, window_type="hamming", low_freq=40.0, high_freq=-200.0,
             num_mel_bins=80)
OPTIM = dict(initial_lr=0.003, final_lr=0.0001, total_batches=100000, momentum=0.9,
             grad_clip=3.0)  # bench.py's optimizer


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, warmup: int, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def joint_case(device, seed: int, b: int, t: int, u1: int, h: int, v: int):
    g = torch.Generator(device).manual_seed(seed)

    def randn(*shape, scale):
        return torch.randn(*shape, generator=g, device=device) * scale

    return (randn(b, t, h, scale=0.5), randn(b, t, h, scale=0.5),
            randn(b, u1, h, scale=0.5), randn(b, u1, h, scale=0.5),
            randn(h, v, scale=2.0 / math.sqrt(h)), randn(v, scale=0.1),
            torch.randint(0, v, (b, u1), generator=g, device=device, dtype=torch.int32))


def kernel_parity(device) -> dict:
    """K1 against joint_channels_reference at a ragged shape and at the
    flagship eval shape; times both at the flagship shape."""
    worst = 0.0
    for name, shape in (("ragged", (2, 37, 11, 96, 301)),
                        ("flagship", (BATCH, 239, U_MAX + 1, 1024, VOCAB))):
        args = joint_case(device, 1, *shape)
        ref = joint_channels_reference(*args)
        got = joint_channels(*args)
        torch.cuda.synchronize()
        errs = []
        for ch, r, k in zip(("lse", "z_blank", "z_label"), ref, got):
            err = (k - r).abs()
            check(bool(torch.isfinite(k).all()), f"K1 {name} {ch} finite")
            check(bool((err <= K1_ATOL + K1_RTOL * r.abs()).all()),
                  f"K1 {name} {ch} within rtol {K1_RTOL} atol {K1_ATOL}")
            errs.append(f"{ch} {err.max().item():.3e}")
            worst = max(worst, err.max().item())
        say(f"kernel parity {name} B,T,U1,H,V={shape}: max abs err {', '.join(errs)} "
            f"(rtol {K1_RTOL}, atol {K1_ATOL}): ok")
    ms = time_ms(lambda: joint_channels(*args), warmup=2, iters=10)
    plain_ms = time_ms(lambda: joint_channels_reference(*args), warmup=1, iters=5)
    flops = 2.0 * math.prod(shape)
    say(f"K1 flagship: {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s); "
        f"plain version: {plain_ms:.3f} ms ({flops / plain_ms / 1e9:.1f} TFLOP/s)")

    # the loss through K1 against the literal numpy DP, on a small input
    ax, gx, ay, gy, w2, b2, labels_ext = joint_case(device, 2, 2, 37, 11, 96, 301)
    labels = labels_ext[:, :-1].clamp(min=1)
    t_len = torch.tensor([37, 30], device=device)
    u_len = torch.tensor([10, 6], device=device)
    h = torch.tanh(ax[:, :, None] + ay[:, None]) * torch.sigmoid(gx[:, :, None] + gy[:, None])
    log_probs = torch.log_softmax(h @ w2 + b2, dim=-1)
    oracle = rnnt_loss_numpy(log_probs.cpu().numpy(), labels.cpu().numpy(),
                             t_len.cpu().numpy(), u_len.cpu().numpy())
    loss = rnnt_loss_forward(ax, gx, ay, gy, w2, b2, labels, t_len, u_len).cpu().numpy()
    check(bool(np.allclose(loss, oracle, rtol=1e-4)), f"K1 loss {loss} vs numpy DP {oracle}")
    say(f"loss through K1 vs numpy DP: {loss.tolist()} vs {oracle.tolist()}: ok")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def occupancy_case(device, seed: int, b: int, t: int, u1: int, h: int, v: int, t_len, u_len):
    """K2/K3 inputs: random factors, K1's channels through the plain version,
    and the channel cotangents of the summed loss from the real occupancy."""
    ax, gx, ay, gy, w2, b2, labels_ext = joint_case(device, seed, b, t, u1, h, v)
    labels_ext = labels_ext.clamp(min=1)
    labels_ext[:, -1] = 0  # the column past the last label, as the loss builds it
    lse, zb, zy = joint_channels_reference(ax, gx, ay, gy, w2, b2, labels_ext)
    t_len = torch.tensor(t_len, device=device)
    u_len = torch.tensor(u_len, device=device)
    g_blank, g_emit = rnnt_occupancy(zb - lse, zy - lse, t_len, u_len)
    d_lse = -(g_blank + g_emit)
    return ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, g_blank, g_emit


def backward_parity(device) -> tuple[dict, dict]:
    """K2 and K3 against joint_channels_bwd_reference at a ragged shape and
    at the flagship training shape (bench.py's batch 32); times each kernel
    and the plain backward at the flagship shape."""
    names = ("d_ax", "d_gx", "d_ay", "d_gy", "d_w2", "d_b2")
    worst = {"K2": 0.0, "K3": 0.0}
    cases = (("ragged", (3, 37, 11, 96, 301), [37, 20, 1], [10, 4, 0]),
             ("flagship train", (TRAIN_BATCH, 239, U_MAX + 1, 1024, VOCAB),
              [239] * TRAIN_BATCH, [U_MAX] * TRAIN_BATCH))
    for name, shape, t_len, u_len in cases:
        args = occupancy_case(device, 3, *shape, t_len, u_len)
        ref = joint_channels_bwd_reference(*args)
        got = joint_channels_bwd(*args)
        torch.cuda.synchronize()
        parts = []
        for i, (g_name, g, r) in enumerate(zip(names, got, ref)):
            err = (g - r).abs().max().item()
            scale = r.abs().max().item()
            rel = ((g - r).norm() / r.norm().clamp(min=1e-30)).item()
            parts.append(f"{g_name} max abs {err:.3e} (of {scale:.3e}), rel L2 {rel:.3e}")
            check(bool(torch.isfinite(g).all()), f"{name} {g_name} finite")
            check(rel <= K23_REL_L2 and err <= K23_MAX_REL * scale,
                  f"K2/K3 {name} {g_name}: rel L2 {rel} (tol {K23_REL_L2}), max abs {err} "
                  f"(tol {K23_MAX_REL} x {scale})")
            kernel = "K2" if i < 4 else "K3"
            worst[kernel] = max(worst[kernel], err)
        say(f"K2/K3 parity {name} B,T,U1,H,V={shape}: " + "; ".join(parts)
            + f" (rel L2 tol {K23_REL_L2}, max abs tol {K23_MAX_REL} x max|ref|): ok")
        del ref, got
    k2_ms = time_ms(lambda: joint_channels_bwd_in(*args), warmup=1, iters=3)
    k3_ms = time_ms(lambda: joint_channels_bwd_w(*args), warmup=1, iters=3)
    plain_ms = time_ms(lambda: joint_channels_bwd_reference(*args), warmup=1, iters=2)
    flops = 2 * 2.0 * math.prod(shape)  # two lattice-sized products per kernel
    say(f"K2 flagship train: {k2_ms:.3f} ms ({flops / k2_ms / 1e9:.1f} TFLOP/s); "
        f"K3: {k3_ms:.3f} ms ({flops / k3_ms / 1e9:.1f} TFLOP/s); plain backward "
        f"(all six gradients, chunk 32): {plain_ms:.3f} ms")
    del args
    torch.cuda.empty_cache()
    return ({"max_abs_err": worst["K2"], "ms": k2_ms, "plain_ms": plain_ms},
            {"max_abs_err": worst["K3"], "ms": k3_ms, "plain_ms": plain_ms})


def flagship_batch(device, batch: int, seed: int = 0) -> dict:
    """bench.py's batch: ``batch`` utterances of 10 s of int16-scale noise
    and 40 random labels each."""
    rng = np.random.default_rng(seed)
    max_samples = SR * SECONDS
    wavs = (rng.standard_normal((batch, max_samples)) * 4000).astype(np.float32)
    return {
        "wavs": torch.from_numpy(wavs).to(device),
        "wav_lens": torch.full((batch,), max_samples, dtype=torch.int32, device=device),
        "labels": torch.from_numpy(rng.integers(1, VOCAB, (batch, U_MAX)).astype(np.int32)).to(device),
        "label_lens": torch.full((batch,), U_MAX, dtype=torch.int32, device=device),
    }


def inference_path(device) -> int:
    """Flagship-width eval step and greedy decode; returns K1's launches."""
    t0 = time.perf_counter()
    model = init_transducer(TransducerConfig(**FLAGSHIP), torch.Generator(device).manual_seed(0),
                            device)
    featurizer = make_featurizer(FeaturizerConfig(fbank=FbankConfig(dither=0.0, **FBANK),
                                                  max_samples=SR * SECONDS, lctx=1, rctx=1),
                                 device=device)
    batch = flagship_batch(device, BATCH)
    eval_step = make_eval_step(model, featurizer, loss_chunk=32)
    torch.cuda.synchronize()
    say(f"model init + inputs: {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    eval_step(batch)  # first call: cuBLAS/cuDNN/FFT plans
    torch.cuda.synchronize()
    say(f"eval step, first call: {time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats(device)
    joint_channels.launches = 0
    t0 = time.perf_counter()
    loss = eval_step(batch)["loss"]
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hyps, lens = greedy_decode_waveforms(model, featurizer, batch["wavs"], batch["wav_lens"],
                                         max_symbols=MAX_SYMBOLS)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = joint_channels.launches
    peak = torch.cuda.max_memory_allocated(device)
    say(f"eval step (K1): {eval_s:.3f} s, loss {loss.item():.4f}; greedy decode: "
        f"{decode_s:.3f} s; peak memory {peak / 2**30:.3f} GiB; K1 launches {launches}")

    check(launches > 0, "the eval step launched K1")
    check(bool(torch.isfinite(loss)), "eval loss finite")
    loss_plain = make_eval_step(model, featurizer, loss_chunk=32, loss_backend="plain")(batch)["loss"]
    rel = abs(loss.item() - loss_plain.item()) / abs(loss_plain.item())
    check(rel <= LOSS_RTOL, f"eval loss {loss.item()} vs plain backend {loss_plain.item()}")
    say(f"eval loss vs plain backend {loss_plain.item():.4f}: rel err {rel:.3e} "
        f"(rtol {LOSS_RTOL}): ok")

    check(tuple(hyps.shape) == (BATCH, MAX_SYMBOLS) and tuple(lens.shape) == (BATCH,),
          f"hyp shapes {tuple(hyps.shape)}, {tuple(lens.shape)}")
    check(bool(((lens >= 0) & (lens <= MAX_SYMBOLS)).all()), f"hyp lens {lens.tolist()}")
    slots = torch.arange(MAX_SYMBOLS, device=device)[None, :]
    inside = slots < lens[:, None].long()
    check(bool(((hyps >= 1) & (hyps < VOCAB))[inside].all()), "hyp tokens in [1, V)")
    check(bool((hyps[~inside] == -1).all()), "hyp padding is -1")
    say(f"greedy decode: lens {lens.tolist()}: ok")
    return launches


def train_setup(device, batch: dict, backend: str = "auto"):
    """A flagship model from seed 0 with bench.py's optimizer and the training
    featurizer (dither 1.0, SpecAugment), CMVN from the batch's own frames;
    returns ``(model, step)``."""
    model = init_transducer(TransducerConfig(**FLAGSHIP), torch.Generator(device).manual_seed(0),
                            device)
    feat_cfg = dict(max_samples=SR * SECONDS, lctx=1, rctx=1)
    with torch.no_grad():
        plain = make_featurizer(FeaturizerConfig(fbank=FbankConfig(dither=0.0, **FBANK),
                                                 **feat_cfg), device=device)
        feats, _ = plain(batch["wavs"], batch["wav_lens"])  # full-length utterances
        frames = feats.reshape(-1, feats.shape[-1])
        offset, scale = -frames.mean(0), 1.0 / frames.std(0)
    featurizer = make_featurizer(
        FeaturizerConfig(fbank=FbankConfig(dither=1.0, **FBANK), spec_augment=True, **feat_cfg),
        offset, scale, device=device)
    optimizer = make_optimizer(model.parameters(), "sgd", **OPTIM)
    return model, make_train_step(model, optimizer, featurizer, loss_chunk=16,
                                  loss_backend=backend)


def dp_seconds(fn, repeats: int = 3) -> float:
    """Median host-clock seconds of ``fn`` (a loop of small launches)."""
    times = []
    for _ in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times[1:])


def train_path(device) -> tuple[dict, float]:
    """bench.py's training step at flagship width: one warm-up step, then
    TIMED_STEPS steps from one seeded generator.  Returns the launches of
    K1, K2 and K3 over the timed steps, and the median step time."""
    t0 = time.perf_counter()
    batch = flagship_batch(device, TRAIN_BATCH)
    model, step = train_setup(device, batch)
    gen = torch.Generator(device).manual_seed(1)
    torch.cuda.synchronize()
    say(f"train: model init + inputs + CMVN: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    first = step(batch, gen)["loss"].item()
    say(f"train step, first call: {time.perf_counter() - t0:.3f} s, loss {first:.4f}")
    check(math.isfinite(first), "first train loss finite")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    torch.cuda.reset_peak_memory_stats(device)
    joint_channels.launches = joint_channels_bwd_in.launches = joint_channels_bwd_w.launches = 0
    times, losses = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(step(batch, gen)["loss"].item())  # .item() waits for the step
        times.append(time.perf_counter() - t0)
    launches = {"K1": joint_channels.launches, "K2": joint_channels_bwd_in.launches,
                "K3": joint_channels_bwd_w.launches}
    peak = torch.cuda.max_memory_allocated(device)
    step_s = statistics.median(times)
    say(f"train steps (K1 fwd, K2/K3 bwd), batch {TRAIN_BATCH} x {SECONDS} s: "
        f"{', '.join(f'{x:.4f}' for x in times)} s, median {step_s:.4f} s "
        f"({TRAIN_BATCH / step_s:.2f} utt/s); losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"peak memory {peak / 2**30:.3f} GiB; launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"train losses finite: {losses}")
    check(all(n > 0 for n in launches.values()), f"the train steps launched K1, K2, K3: {launches}")
    changed = sum(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    check(changed == len(before), f"{changed} of {len(before)} parameters changed")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "parameters finite")
    say(f"train: all {changed} parameter tensors changed and finite: ok")

    # the loss DP loops at this shape: T' host-driven steps of small ops each
    t_out = model.encoder_out_len(1 + (SR * SECONDS - 400) // 160)  # 25 ms frames, 10 ms hop
    g = torch.Generator(device).manual_seed(2)
    lp = -torch.rand((TRAIN_BATCH, t_out, U_MAX + 1), generator=g, device=device) * 5 - 0.1
    lens_t = torch.full((TRAIN_BATCH,), t_out, device=device)
    lens_u = torch.full((TRAIN_BATCH,), U_MAX, device=device)
    alpha = rnnt_alpha(lp, lp, lens_u)
    alpha_s = dp_seconds(lambda: rnnt_alpha(lp, lp, lens_u))
    occ_s = dp_seconds(lambda: rnnt_occupancy(lp, lp, lens_t, lens_u, alpha=alpha))
    say(f"loss DP at T'={t_out}, U+1={U_MAX + 1}: forward alpha loop {alpha_s * 1e3:.2f} ms "
        f"({alpha_s / step_s:.2%} of the step), backward beta loop + occupancy "
        f"{occ_s * 1e3:.2f} ms ({occ_s / step_s:.2%} of the step)")

    profile_step(step, batch, gen, device)
    del model, step, before
    torch.cuda.empty_cache()
    return launches, step_s


def profile_step(step, batch, gen, device) -> None:
    """torch.profiler over one warm train step: device-busy share of the
    wall time and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, gen)["loss"].item()
        wall = time.perf_counter() - t0
    # the device's own entries (kernels, copies, memsets): each once
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us == 0:
        say("profiled train step: the profiler saw no device time")
        return
    n_kernels = sum(e.count for e in events)
    say(f"profiled train step: wall {wall:.4f} s (profiler on), device busy "
        f"{busy_us / 1e6:.4f} s ({busy_us / 1e6 / wall:.1%}), {n_kernels} device ops")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        say(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x "
            f"{e.self_device_time_total / busy_us:6.1%}  {e.key[:90]}")


def backend_parity(device) -> None:
    """One train step on the kernel backend and one on the plain backend,
    from the same weights and the same generator seed (so the same dither,
    SpecAugment and dropout draws)."""
    batch = flagship_batch(device, TRAIN_BATCH)
    out = {}
    for backend in ("auto", "plain"):
        model, step = train_setup(device, batch, backend)
        init = {n: x.detach().clone() for n, x in model.state_dict().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(batch, torch.Generator(device).manual_seed(3))["loss"].item()
        secs = time.perf_counter() - t0
        out[backend] = (loss, {n: (x.detach() - init[n]) if not n.endswith(
            ("running_mean", "running_var", "num_batches_tracked")) else x.detach().clone()
            for n, x in model.state_dict().items()})
        say(f"train step on the {backend} loss backend: loss {loss:.4f}, {secs:.3f} s "
            f"(first step of a fresh model)")
        del model, step, init
        torch.cuda.empty_cache()
    (la, sa), (lp, sp) = out["auto"], out["plain"]
    rel = abs(la - lp) / abs(lp)
    check(rel <= STEP_LOSS_RTOL, f"train loss {la} vs plain backend {lp}")
    worst = []
    for name, a in sa.items():
        if name.endswith("num_batches_tracked"):
            continue
        p = sp[name]
        err = ((a - p).norm() / p.norm().clamp(min=1e-30)).item()
        stats = name.endswith(("running_mean", "running_var"))
        tol = STATS_TOL if stats else STEP_ENCODER_TOL if name.startswith("encoder.") else STEP_TOL
        if p.abs().max().item() < 1e-6:  # a quantity that is 0 but for float noise
            err, tol = (a - p).abs().max().item(), 1e-6
        worst.append((err / tol, err, tol, name))
    worst.sort(reverse=True)
    say(f"train step kernel vs plain backend: loss rel err {rel:.3e} (rtol {STEP_LOSS_RTOL}); "
        "largest parameter-change / statistic errors (rel L2, tol): "
        + "; ".join(f"{n} {e:.2e} ({t:g})" for _, e, t, n in worst[:6]))
    check(worst[0][0] <= 1.0, f"train step kernel vs plain backend: {worst[0][3]} "
                              f"error {worst[0][1]} > tol {worst[0][2]}")
    say("train step kernel vs plain backend: ok")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on the GPU only",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off for matmuls and cuDNN")

    t0 = time.perf_counter()
    lib = cuda_build.build()
    say(f"build: {time.perf_counter() - t0:.3f} s -> {lib.relative_to(cuda_build.PKG_DIR.parent)}")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "bytes smem" in line:
            say(f"  {line.strip()}")

    k1 = kernel_parity(device)
    k2, k3 = backward_parity(device)
    inference_launches = inference_path(device)
    launches, _ = train_path(device)
    backend_parity(device)

    say(f"K1 launches: inference path {inference_launches}, training path {launches['K1']}")
    say(card)
    print(json.dumps({"kernels": [
        {"name": "joint_channels_fwd", "route": "cuda",
         "source": "pika_tpu_torch/csrc/joint_channels_fwd.cu",
         "replaces": "pika_tpu/ops/rnnt_pallas.py:151", "launches": launches["K1"], **k1},
        {"name": "joint_channels_bwd_in", "route": "cuda",
         "source": "pika_tpu_torch/csrc/joint_channels_bwd.cu",
         "replaces": "pika_tpu/ops/rnnt_pallas.py:216", "launches": launches["K2"], **k2},
        {"name": "joint_channels_bwd_w", "route": "cuda",
         "source": "pika_tpu_torch/csrc/joint_channels_bwd.cu",
         "replaces": "pika_tpu/ops/rnnt_pallas.py:284", "launches": launches["K3"], **k3},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
