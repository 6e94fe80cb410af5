#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pika_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and nvcc.  It
builds the CUDA kernels from ``pika_tpu_torch/csrc``, holds each against its
plain PyTorch version at the shapes its path gives it (K1 at the eval shape,
K2 and K3 at a ragged shape and at the training shape, fed the cotangents of
a real occupancy; K3 at the bf16 rounding of the TPU kernel it replaces,
and also against float32), then drives the port at the flagship width
(``bench.py``'s model: TDNN-Transformer 9x1024, 2x1024 LSTM prediction net,
V=6268, random weights from a seed):

* the inference path: the eval step (RNN-T loss through K1) and greedy
  decoding of 8 utterances of 10 s;
* the training path: ``bench.py``'s step on 32 utterances of 10 s with 40
  labels -- dither 1.0, SpecAugment, dropout 0.2, the loss through K1
  forward and K2/K3 backward (K3 in bf16), inf-norm clipping at 3, SGD-Nesterov -- one
  warm-up step, then 3 timed steps from one seeded generator, a profiled
  step, and one step each on the kernel and the plain loss backends from
  the same weights and seed, which must agree;
* the flash-attention path (``attn_flash=True``), whose encoder attention
  runs through K4: K4 forward and backward against their plain versions at
  ragged shapes, at the three encoder layers' shapes (B = 8 and 32) and at
  one 60 s shape, timed at the training shape beside their bound, their
  plain version and ``scaled_dot_product_attention`` (a yardstick the port
  never calls); the eval step and greedy decode of 8 utterances of 10 s
  (3 K4 launches per encoder pass; the loss against the exact path's); the
  eval step on 4 utterances of 60 s with 240 labels on the flash and on the
  exact path (peak memory, wall time, losses); and ``bench.py``'s step with
  ``tdnn_transformer_dropout=0`` -- one warm-up and 2 timed steps through
  K1-K4, then one step each with flash and exact attention from the same
  weights and seed, which must agree.

Float32 throughout, with TF32 off for matmuls and cuDNN convolutions, so the
parity checks compare float32 with float32; attention rounds q, k, v and the
probabilities to bf16 on both paths, as the JAX package does.

Output: one line per phase; then the card's name and power limit as
nvidia-smi reports them; a JSON line with each kernel's launches on its
training path, max abs error against its plain version, its time, its
plain version's, its bound and the library call's where one exists; and
last ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line.  There is no CPU mode: without a CUDA card it exits 1.
"""

from __future__ import annotations

import json
import math
import re
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
from pika_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_di,
    flash_attention_fwd,
    flash_attention_reference,
)
from pika_tpu_torch.ops.rnnt_kernels import (
    joint_channels,
    joint_channels_bwd,
    joint_channels_bwd_in,
    joint_channels_bwd_reference,
    joint_channels_bwd_w,
    joint_channels_bwd_w_reference,
    joint_channels_reference,
    k3_chunk_rows,
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
# K3 against its bf16 plain version (both round h, W2 and dz to bf16 at the
# TPU kernel's points): float32 sums in another order, exp2 against exp, and
# the rare bf16 flip of an h or dz that this moves across a rounding
# boundary; and against the float32 plain version within the envelope the
# TPU kernels' bf16 rounding was measured at (BASELINE.md, flagship scale)
K3_REL_L2, K3_MAX_REL, K3_ENVELOPE = 1e-4, 1e-3, 6.4e-3
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
# K4 against its plain version: bf16 outputs and gradients, p rounded to bf16
# relative to the running max of the key tiles (kernel) or the row max
# (plain), so they agree to bf16 rounding: relative L2 and the max abs error
# as a share of the largest reference entry; lse is float32 (sums over T in
# another order)
K4_REL_L2, K4_MAX_REL, K4_LSE_ATOL = 1e-2, 1e-2, 1e-4
K4_NOISE = 1e-5  # a gradient whose reference stays under this is held to it absolute
# (heads, T, d_head) of the encoder's three attention layers at 10 s
FLASH_LAYERS = ((16, 992, 64), (16, 974, 64), (8, 239, 128))
LONG_SECONDS, LONG_BATCH, LONG_LABELS = 60, 4, 240
# flash against exact attention (same weights and seed), bf16 rounding in
# both, at other points: losses to 1e-3 relative (as the CPU tests hold the
# bf16 attention against JAX); one train step's parameter changes to
# STEP_TOL outside the encoder and 2e-1 inside it, BatchNorm statistics to
# 1e-2.  The flash backward rounds ds to bf16, the exact one keeps it
# float32; the transformer LayerNorm weights' small gradients amplify that
# (measured on an H100: 4.4e-2 to 8.3e-2 in the worst encoder tensor over
# three runs)
FLASH_LOSS_RTOL, FLASH_ENCODER_TOL, FLASH_STATS_TOL = 1e-3, 2e-1, 1e-2
# published H100 SXM peaks: float32 outside the tensor cores, bf16 dense,
# HBM bytes per second
PEAK_F32, PEAK_BF16, HBM_RATE = 67e12, 989e12, 3.35e12


def kernel_label(mangled: str) -> str:
    """``name<N>`` of a mangled kernel name such as
    ``_ZN.._cu_..20flash_bwd_dkv_kernelILi64EEEv..``: each name in it is
    prefixed by its length."""
    for found in re.finditer(r"\d+", mangled):
        digits = found[0]
        for k in range(len(digits)):  # a name's length may follow other digits (a file hash)
            name = mangled[found.end():found.end() + int(digits[k:])]
            if name.endswith("_kernel"):
                arg = re.match(r"ILi(\d+)E", mangled[found.end() + len(name):])
                return f"{name}<{arg[1]}>" if arg else name
    return mangled[:60]


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


def bound(flops: float, nbytes: float, peak: float) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate for their type and the bytes over the memory rate."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


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
    b, t, u1, h, v = shape
    k1_bound = bound(flops, 4 * (2 * b * t * h + 2 * b * u1 * h + h * v + v + b * u1
                                 + 3 * b * t * u1), PEAK_F32)
    say(f"K1 flagship: {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s); "
        f"plain version: {plain_ms:.3f} ms ({flops / plain_ms / 1e9:.1f} TFLOP/s); "
        f"bound {k1_bound['bound_ms']:.3f} ms ({k1_bound['bound_by']}, float32 "
        f"{PEAK_F32 / 1e12:.0f} TFLOP/s; bf16 {flops / PEAK_BF16 * 1e3:.3f} ms)")

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
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **k1_bound, "library_ms": None}


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
    """K2 against joint_channels_bwd_reference (float32) and K3 against
    joint_channels_bwd_w_reference at bf16 (and, within K3_ENVELOPE, at
    float32), at a ragged shape and at the flagship training shape
    (bench.py's batch 32); times each kernel and its plain version at the
    flagship shape."""
    names = ("d_ax", "d_gx", "d_ay", "d_gy", "d_w2", "d_b2")
    worst = {"K2": 0.0, "K3": 0.0}
    cases = (("ragged", (3, 37, 11, 96, 301), [37, 20, 1], [10, 4, 0]),
             ("flagship train", (TRAIN_BATCH, 239, U_MAX + 1, 1024, VOCAB),
              [239] * TRAIN_BATCH, [U_MAX] * TRAIN_BATCH))
    for name, shape, t_len, u_len in cases:
        args = occupancy_case(device, 3, *shape, t_len, u_len)
        ref = joint_channels_bwd_reference(*args)
        ref_bf16 = joint_channels_bwd_w_reference(*args, mm_dtype=torch.bfloat16)
        got = joint_channels_bwd(*args)
        torch.cuda.synchronize()
        parts = []
        for i, (g_name, g, r) in enumerate(zip(names, got, ref)):
            kernel = "K2" if i < 4 else "K3"
            check(bool(torch.isfinite(g).all()), f"{name} {g_name} finite")
            rel_f32 = ((g - r).norm() / r.norm().clamp(min=1e-30)).item()
            if kernel == "K3":
                r = ref_bf16[i - 4]
            err = (g - r).abs().max().item()
            scale = r.abs().max().item()
            rel = ((g - r).norm() / r.norm().clamp(min=1e-30)).item()
            rel_tol, max_tol = (K23_REL_L2, K23_MAX_REL) if kernel == "K2" else (K3_REL_L2,
                                                                                K3_MAX_REL)
            check(rel <= rel_tol and err <= max_tol * scale,
                  f"{kernel} {name} {g_name}: rel L2 {rel} (tol {rel_tol}), max abs {err} "
                  f"(tol {max_tol} x {scale})")
            if kernel == "K2":
                parts.append(f"{g_name} max abs {err:.3e} (of {scale:.3e}), rel L2 {rel:.3e}")
            else:
                check(rel_f32 <= K3_ENVELOPE,
                      f"K3 {name} {g_name} vs float32: rel L2 {rel_f32} (tol {K3_ENVELOPE})")
                parts.append(f"{g_name} vs bf16 plain max abs {err:.3e} (of {scale:.3e}), rel L2 "
                             f"{rel:.3e}; vs float32 rel L2 {rel_f32:.3e}")
            worst[kernel] = max(worst[kernel], err)
        say(f"K2/K3 parity {name} B,T,U1,H,V={shape}: " + "; ".join(parts)
            + f" (K2 vs float32: rel L2 tol {K23_REL_L2}, max abs tol {K23_MAX_REL} x max|ref|; "
            f"K3 vs bf16: {K3_REL_L2}, {K3_MAX_REL} x max|ref|, vs float32: rel L2 tol "
            f"{K3_ENVELOPE}): ok")
        del ref, ref_bf16, got
    k2_ms = time_ms(lambda: joint_channels_bwd_in(*args), warmup=1, iters=3)
    k3_ms = time_ms(lambda: joint_channels_bwd_w(*args), warmup=2, iters=10)
    plain_ms = time_ms(lambda: joint_channels_bwd_reference(*args), warmup=1, iters=2)
    k3_plain_ms = time_ms(lambda: joint_channels_bwd_w_reference(*args, mm_dtype=torch.bfloat16),
                          warmup=1, iters=2)
    flops = 2 * 2.0 * math.prod(shape)  # two lattice-sized products per kernel
    b, t, u1, h, v = shape
    rows = b * t * u1
    factor_bytes = 4 * (2 * b * t * h + 2 * b * u1 * h + v + b * u1 + 4 * rows)
    k2_bound = bound(flops, factor_bytes + 4 * h * v + 4 * (2 * b * t * h + 2 * b * u1 * h),
                     PEAK_F32)
    # K3 as the TPU kernel runs it: W2 read as bf16, the products at the bf16 peak
    k3_bound = bound(flops, factor_bytes + 2 * h * v + 4 * (h * v + v), PEAK_BF16)
    say(f"K2 flagship train: {k2_ms:.3f} ms ({flops / k2_ms / 1e9:.1f} TFLOP/s), bound "
        f"{k2_bound['bound_ms']:.3f} ms ({k2_bound['bound_by']}, float32 "
        f"{PEAK_F32 / 1e12:.0f} TFLOP/s; bf16 {flops / PEAK_BF16 * 1e3:.3f} ms); plain backward "
        f"(all six gradients, float32, chunk 32): {plain_ms:.3f} ms")
    say(f"K3 flagship train: {k3_ms:.3f} ms ({flops / k3_ms / 1e9:.1f} TFLOP/s, wrapper "
        f"included: padded bf16 W2^T, scratch, {-(-rows // k3_chunk_rows(v))} chunks of "
        f"{k3_chunk_rows(v)} rows), bound {k3_bound['bound_ms']:.3f} ms "
        f"({k3_bound['bound_by']}, bf16 {PEAK_BF16 / 1e12:.0f} TFLOP/s); bf16 plain version: "
        f"{k3_plain_ms:.3f} ms")
    del args
    torch.cuda.empty_cache()
    return ({"max_abs_err": worst["K2"], "ms": k2_ms, "plain_ms": plain_ms, **k2_bound,
             "library_ms": None},
            {"max_abs_err": worst["K3"], "ms": k3_ms, "plain_ms": k3_plain_ms, **k3_bound,
             "library_ms": None})


def flagship_batch(device, batch: int, seed: int = 0, seconds: int = SECONDS,
                   labels: int = U_MAX) -> dict:
    """bench.py's batch: ``batch`` utterances of ``seconds`` s of int16-scale
    noise and ``labels`` random labels each (10 s and 40 by default)."""
    rng = np.random.default_rng(seed)
    max_samples = SR * seconds
    wavs = (rng.standard_normal((batch, max_samples)) * 4000).astype(np.float32)
    return {
        "wavs": torch.from_numpy(wavs).to(device),
        "wav_lens": torch.full((batch,), max_samples, dtype=torch.int32, device=device),
        "labels": torch.from_numpy(rng.integers(1, VOCAB, (batch, labels)).astype(np.int32)).to(device),
        "label_lens": torch.full((batch,), labels, dtype=torch.int32, device=device),
    }


def eval_setup(device, seconds: int = SECONDS, **model_kw):
    """The flagship model from seed 0 (``model_kw`` override its config) and
    the eval featurizer for utterances of ``seconds`` s."""
    model = init_transducer(TransducerConfig(**FLAGSHIP, **model_kw),
                            torch.Generator(device).manual_seed(0), device)
    featurizer = make_featurizer(FeaturizerConfig(fbank=FbankConfig(dither=0.0, **FBANK),
                                                  max_samples=SR * seconds, lctx=1, rctx=1),
                                 device=device)
    return model, featurizer


def check_hyps(hyps, lens, device) -> None:
    check(tuple(hyps.shape) == (BATCH, MAX_SYMBOLS) and tuple(lens.shape) == (BATCH,),
          f"hyp shapes {tuple(hyps.shape)}, {tuple(lens.shape)}")
    check(bool(((lens >= 0) & (lens <= MAX_SYMBOLS)).all()), f"hyp lens {lens.tolist()}")
    slots = torch.arange(MAX_SYMBOLS, device=device)[None, :]
    inside = slots < lens[:, None].long()
    check(bool(((hyps >= 1) & (hyps < VOCAB))[inside].all()), "hyp tokens in [1, V)")
    check(bool((hyps[~inside] == -1).all()), "hyp padding is -1")


def inference_path(device) -> tuple[int, float]:
    """Flagship-width eval step and greedy decode; returns K1's launches and
    the eval loss."""
    t0 = time.perf_counter()
    model, featurizer = eval_setup(device)
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

    check_hyps(hyps, lens, device)
    say(f"greedy decode: lens {lens.tolist()}: ok")
    return launches, loss.item()


def train_setup(device, batch: dict, backend: str = "auto", **model_kw):
    """A flagship model from seed 0 (``model_kw`` override its config) with
    bench.py's optimizer and the training featurizer (dither 1.0,
    SpecAugment), CMVN from the batch's own frames; returns
    ``(model, step)``."""
    model = init_transducer(TransducerConfig(**FLAGSHIP, **model_kw),
                            torch.Generator(device).manual_seed(0), device)
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


def profile_step(step, batch, gen, device, also: str = "") -> None:
    """torch.profiler over one warm train step: device-busy share of the
    wall time, the kernels with the most device time, and the device time of
    those whose name holds ``also``."""
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
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    for e in ranked[:10] + [e for e in ranked[10:] if also and also in e.key]:
        say(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x "
            f"{e.self_device_time_total / busy_us:6.1%}  {e.key[:90]}")


def one_step(device, batch: dict, what: str, backend: str = "auto", **model_kw):
    """One train step of a fresh flagship model from seed 0 with generator
    seed 3 (so the same dither, SpecAugment and dropout draws in every
    call); returns the loss and each parameter's change (each statistic's
    value)."""
    model, step = train_setup(device, batch, backend, **model_kw)
    init = {n: x.detach().clone() for n, x in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    loss = step(batch, torch.Generator(device).manual_seed(3))["loss"].item()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    state = {n: (x.detach() - init[n]) if not n.endswith(
        ("running_mean", "running_var", "num_batches_tracked")) else x.detach().clone()
        for n, x in model.state_dict().items()}
    say(f"train step {what}: loss {loss:.4f}, {secs:.3f} s (first step of a fresh model), "
        f"peak memory {peak / 2**30:.3f} GiB")
    del model, step, init
    torch.cuda.empty_cache()
    return loss, state


def compare_steps(what: str, got, ref, loss_rtol: float, encoder_tol: float,
                  stats_tol: float) -> None:
    """Hold one step's loss, parameter changes (``encoder_tol`` relative L2 in
    the encoder, STEP_TOL elsewhere) and BatchNorm statistics to another's;
    quantities that are 0 but for float noise to 1e-6 absolute."""
    (la, sa), (lp, sp) = got, ref
    rel = abs(la - lp) / abs(lp)
    check(rel <= loss_rtol, f"train loss {what}: {la} vs {lp}")
    worst = []
    for name, a in sa.items():
        if name.endswith("num_batches_tracked"):
            continue
        p = sp[name]
        err = ((a - p).norm() / p.norm().clamp(min=1e-30)).item()
        stats = name.endswith(("running_mean", "running_var"))
        tol = stats_tol if stats else encoder_tol if name.startswith("encoder.") else STEP_TOL
        if p.abs().max().item() < 1e-6:  # a quantity that is 0 but for float noise
            err, tol = (a - p).abs().max().item(), 1e-6
        worst.append((err / tol, err, tol, name))
    worst.sort(reverse=True)
    say(f"train step {what}: loss rel err {rel:.3e} (rtol {loss_rtol}); "
        "largest parameter-change / statistic errors (rel L2, tol): "
        + "; ".join(f"{n} {e:.2e} ({t:g})" for _, e, t, n in worst[:6]))
    check(worst[0][0] <= 1.0, f"train step {what}: {worst[0][3]} "
                              f"error {worst[0][1]} > tol {worst[0][2]}")
    say(f"train step {what}: ok")


def backend_parity(device) -> None:
    """One train step on the kernel backend and one on the plain backend,
    from the same weights and the same generator seed."""
    batch = flagship_batch(device, TRAIN_BATCH)
    got = one_step(device, batch, "on the auto loss backend")
    ref = one_step(device, batch, "on the plain loss backend", "plain")
    compare_steps("kernel vs plain backend", got, ref, STEP_LOSS_RTOL, STEP_ENCODER_TOL, STATS_TOL)


def k4_case(device, seed: int, b: int, h: int, t: int, d: int):
    """bf16 q (scaled as the layer scales it: scores of a few units), k, v
    and an output cotangent."""
    g = torch.Generator(device).manual_seed(seed)

    def randn(scale):
        return (torch.randn((b, h, t, d), generator=g, device=device) * scale).to(torch.bfloat16)

    return randn(2.0 / math.sqrt(d)), randn(1.0), randn(1.0), randn(1.0)


def k4_reference(q, k, v, do):
    """K4's plain forward, then its plain backward from that forward's o and
    lse, a few utterances at a time so that one call's (b, h, T, T) float32
    scores stay near 2 GB."""
    chunk = max(1, int(2e9 // (4 * q.shape[1] * q.shape[2] ** 2)))
    parts = []
    for i in range(0, q.shape[0], chunk):
        sl = slice(i, i + chunk)
        o, lse = flash_attention_reference(q[sl], k[sl], v[sl])
        parts.append((o, lse) + flash_attention_bwd_reference(q[sl], k[sl], v[sl], o, lse, do[sl]))
    return [torch.cat(x) for x in zip(*parts)]


def k4_bytes(b, h, t, d, n_bf16: int, n_f32: int) -> float:
    return b * h * t * (2 * d * n_bf16 + 4 * n_f32)


def k4_parity(device) -> dict:
    """K4 forward, dk/dv and dq against their plain versions (the backward
    kernels fed the plain forward's o and lse) at ragged shapes, at the
    encoder layers' shapes at B = 8 and 32, and at one 60 s shape; then each
    kernel, its plain version and scaled_dot_product_attention timed over
    the three layers at the training shape (B = 32)."""
    worst = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    cases = [("ragged", (2, 3, 37, 64)), ("ragged", (2, 3, 130, 128)), ("ragged", (1, 2, 1, 64))]
    cases += [(f"layer {i} B={b}", (b, h, t, d)) for b in (BATCH, TRAIN_BATCH)
              for i, (h, t, d) in enumerate(FLASH_LAYERS)]
    cases.append((f"{LONG_SECONDS} s", (LONG_BATCH, 16, 5992, 64)))
    for name, shape in cases:
        q, k, v, do = k4_case(device, 4, *shape)
        ref_o, ref_lse, ref_dq, ref_dk, ref_dv = k4_reference(q, k, v, do)
        o, lse = flash_attention_fwd(q, k, v)
        dk, dv = flash_attention_bwd_dkv(q, k, v, ref_o, ref_lse, do)
        dq = flash_attention_bwd_dq(q, k, v, ref_o, ref_lse, do)
        torch.cuda.synchronize()
        lse_err = (lse - ref_lse).abs().max().item()
        check(bool(torch.isfinite(lse).all()) and lse_err <= K4_LSE_ATOL,
              f"K4 {name} {shape} lse: max abs err {lse_err} (atol {K4_LSE_ATOL})")
        parts = [f"lse {lse_err:.2e}"]
        for kernel, g_name, got, ref in (("fwd", "o", o, ref_o), ("dkv", "dk", dk, ref_dk),
                                         ("dkv", "dv", dv, ref_dv), ("dq", "dq", dq, ref_dq)):
            got, ref = got.float(), ref.float()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            rel = ((got - ref).norm() / ref.norm().clamp(min=1e-30)).item()
            check(bool(torch.isfinite(got).all()), f"K4 {name} {shape} {g_name} finite")
            if scale < K4_NOISE:  # 0 but for float noise (dk at T = 1: ds = p (dp - di) = 0)
                rel, scale = 0.0, K4_NOISE / K4_MAX_REL
            check(rel <= K4_REL_L2 and err <= K4_MAX_REL * scale,
                  f"K4 {name} {shape} {g_name}: rel L2 {rel} (tol {K4_REL_L2}), max abs {err} "
                  f"(tol {K4_MAX_REL} x {scale})")
            parts.append(f"{g_name} {err:.2e} of {scale:.2e}, rel L2 {rel:.2e}")
            worst[kernel] = max(worst[kernel], err)
        say(f"K4 parity {name} B,h,T,d={shape}: max abs err " + "; ".join(parts)
            + f" (rel L2 tol {K4_REL_L2}, max abs tol {K4_MAX_REL} x max|ref|): ok")
        del q, k, v, do, ref_o, ref_lse, ref_dq, ref_dk, ref_dv, o, lse, dk, dv, dq
        torch.cuda.empty_cache()

    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {key: 0.0 for key in ("fwd", "dkv", "dq", "di", "plain_fwd", "plain_bwd", "sdpa_fwd",
                                  "sdpa_bwd")}
    bounds = {"fwd": [0.0, 0.0], "dkv": [0.0, 0.0], "dq": [0.0, 0.0]}  # flops, bytes
    for h, t, d in FLASH_LAYERS:
        b = TRAIN_BATCH
        q, k, v, do = k4_case(device, 5, b, h, t, d)
        o, lse = flash_attention_fwd(q, k, v)
        # di = sum(o * do), which the autograd backward takes once for both
        # kernels: the kernels are timed without it, and it on its own
        di = flash_attention_di(o, do)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = sdpa(*leaves, scale=1.0)
        # 20 launches each (3 warm-up): a launch's host work nears the device
        # time of the smallest layer, so the first one is spread thin
        layer = {
            "fwd": time_ms(lambda: flash_attention_fwd(q, k, v), warmup=3, iters=20),
            "dkv": time_ms(lambda: flash_attention_bwd_dkv(q, k, v, o, lse, do, di=di), 3, 20),
            "dq": time_ms(lambda: flash_attention_bwd_dq(q, k, v, o, lse, do, di=di), 3, 20),
            "di": time_ms(lambda: flash_attention_di(o, do), 3, 20),
            "plain_fwd": time_ms(lambda: flash_attention_reference(q, k, v), 1, 3),
            "plain_bwd": time_ms(lambda: flash_attention_bwd_reference(q, k, v, o, lse, do), 1, 3),
            "sdpa_fwd": time_ms(lambda: sdpa(q, k, v, scale=1.0), 3, 20),
            "sdpa_bwd": time_ms(
                lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 3, 20),
        }
        flops = b * h * t * t * d
        # bytes: bf16 tensors read and written, f32 (B, h, T) rows (lse; lse and di)
        for key, mult, n_bf16, n_f32 in (("fwd", 4, 4, 1), ("dkv", 8, 6, 2), ("dq", 6, 5, 2)):
            bounds[key][0] += mult * flops
            bounds[key][1] += k4_bytes(b, h, t, d, n_bf16, n_f32)
        for key, ms in layer.items():
            times[key] += ms
        say(f"K4 layer B,h,T,d=({b}, {h}, {t}, {d}): fwd {layer['fwd']:.3f} ms "
            f"({4 * flops / layer['fwd'] / 1e9:.1f} TFLOP/s), dk/dv {layer['dkv']:.3f} ms "
            f"({8 * flops / layer['dkv'] / 1e9:.1f}), dq {layer['dq']:.3f} ms "
            f"({6 * flops / layer['dq'] / 1e9:.1f}), di {layer['di']:.3f} ms; "
            f"scaled_dot_product_attention fwd {layer['sdpa_fwd']:.3f}, "
            f"bwd {layer['sdpa_bwd']:.3f} ms")
        del q, k, v, do, o, lse, di, leaves, out
        torch.cuda.empty_cache()
    out = {}
    for key in ("fwd", "dkv", "dq"):
        plain, lib = ("plain_fwd", "sdpa_fwd") if key == "fwd" else ("plain_bwd", "sdpa_bwd")
        out[key] = {"max_abs_err": worst[key], "ms": times[key], "plain_ms": times[plain],
                    **bound(*bounds[key], PEAK_BF16), "library_ms": times[lib]}
        flops = bounds[key][0]
        say(f"K4 {key}, B={TRAIN_BATCH}, three layers: {times[key]:.3f} ms "
            f"({flops / times[key] / 1e9:.1f} TFLOP/s); plain {times[plain]:.3f} ms; "
            f"scaled_dot_product_attention {times[lib]:.3f} ms; bound "
            f"{out[key]['bound_ms']:.3f} ms ({out[key]['bound_by']}, bf16 "
            f"{PEAK_BF16 / 1e12:.0f} TFLOP/s)")
    say("  (the plain and library backward times are one call that yields dq, dk and dv)")
    pair, pair_flops = times["dkv"] + times["dq"], bounds["dkv"][0] + bounds["dq"][0]
    say(f"K4 backward, B={TRAIN_BATCH}, three layers: dk/dv {times['dkv']:.3f} + dq "
        f"{times['dq']:.3f} = {pair:.3f} ms ({pair_flops / pair / 1e9:.1f} TFLOP/s; "
        f"{pair / times['sdpa_bwd']:.2f}x scaled_dot_product_attention's backward, "
        f"{times['sdpa_bwd']:.3f} ms); + di (torch) {times['di']:.3f} = "
        f"{pair + times['di']:.3f} ms as autograd runs it "
        f"({(pair + times['di']) / times['sdpa_bwd']:.2f}x)")
    return out


def reset_launches() -> None:
    for fn in (joint_channels, joint_channels_bwd_in, joint_channels_bwd_w, flash_attention_fwd,
               flash_attention_bwd_dkv, flash_attention_bwd_dq):
        fn.launches = 0


def k4_launches() -> dict:
    return {"fwd": flash_attention_fwd.launches, "dkv": flash_attention_bwd_dkv.launches,
            "dq": flash_attention_bwd_dq.launches}


def flash_inference_path(device, exact_loss: float) -> None:
    """The eval step and greedy decode of the inference path with
    ``attn_flash=True`` (same seed, so the same weights): 3 K4 launches per
    encoder pass, the loss against the exact path's."""
    model, featurizer = eval_setup(device, attn_flash=True)
    batch = flagship_batch(device, BATCH)
    eval_step = make_eval_step(model, featurizer, loss_chunk=32)
    eval_step(batch)  # first call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    loss = eval_step(batch)["loss"].item()
    eval_s = time.perf_counter() - t0
    eval_launches = k4_launches()
    reset_launches()
    t0 = time.perf_counter()
    hyps, lens = greedy_decode_waveforms(model, featurizer, batch["wavs"], batch["wav_lens"],
                                         max_symbols=MAX_SYMBOLS)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = k4_launches()
    peak = torch.cuda.max_memory_allocated(device)
    say(f"flash eval step (K4 + K1): {eval_s:.3f} s, loss {loss:.4f}; greedy decode: "
        f"{decode_s:.3f} s; peak memory {peak / 2**30:.3f} GiB; K4 launches: eval {eval_launches}, "
        f"decode {decode_launches}")
    expect = {"fwd": 3, "dkv": 0, "dq": 0}
    check(eval_launches == expect and decode_launches == expect,
          f"3 K4 forward launches per encoder pass: eval {eval_launches}, decode "
          f"{decode_launches}")
    check(math.isfinite(loss), "flash eval loss finite")
    rel = abs(loss - exact_loss) / abs(exact_loss)
    check(rel <= FLASH_LOSS_RTOL, f"flash eval loss {loss} vs exact {exact_loss}")
    say(f"flash eval loss vs exact attention {exact_loss:.4f}: rel err {rel:.3e} "
        f"(rtol {FLASH_LOSS_RTOL}): ok")
    check_hyps(hyps, lens, device)
    say(f"flash greedy decode: lens {lens.tolist()}: ok")


def long_utterances(device) -> None:
    """The eval step on 4 utterances of 60 s with 240 labels each, with flash
    and with exact attention from the same weights: peak memory, wall time
    (second call), losses."""
    batch = flagship_batch(device, LONG_BATCH, seconds=LONG_SECONDS, labels=LONG_LABELS)
    losses = {}
    for flash in (True, False):
        model, featurizer = eval_setup(device, LONG_SECONDS, attn_flash=flash)
        eval_step = make_eval_step(model, featurizer, loss_chunk=32)
        eval_step(batch)  # first call
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        t0 = time.perf_counter()
        losses[flash] = eval_step(batch)["loss"].item()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device)
        launches = flash_attention_fwd.launches
        say(f"{LONG_BATCH} x {LONG_SECONDS} s eval step, {'flash' if flash else 'exact'} "
            f"attention: {secs:.3f} s, peak memory {peak / 2**30:.3f} GiB, loss "
            f"{losses[flash]:.4f}, K4 launches {launches}")
        check(launches == (3 if flash else 0), f"K4 launches {launches}")
        check(math.isfinite(losses[flash]), "long eval loss finite")
        del model, featurizer, eval_step
        torch.cuda.empty_cache()
    rel = abs(losses[True] - losses[False]) / abs(losses[False])
    check(rel <= FLASH_LOSS_RTOL, f"long eval loss flash {losses[True]} vs exact {losses[False]}")
    say(f"{LONG_SECONDS} s eval loss, flash vs exact: rel err {rel:.3e} (rtol {FLASH_LOSS_RTOL}): ok")


def flash_train_path(device) -> dict:
    """bench.py's step with attn_flash=True and dropout 0: one warm-up step,
    then 2 timed steps and a profiled one; returns the launches of K1-K4
    over the timed steps."""
    batch = flagship_batch(device, TRAIN_BATCH)
    model, step = train_setup(device, batch, attn_flash=True, tdnn_transformer_dropout=0.0)
    gen = torch.Generator(device).manual_seed(1)
    t0 = time.perf_counter()
    first = step(batch, gen)["loss"].item()
    say(f"flash train step, first call: {time.perf_counter() - t0:.3f} s, loss {first:.4f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    times, losses = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        losses.append(step(batch, gen)["loss"].item())
        times.append(time.perf_counter() - t0)
    launches = {"K1": joint_channels.launches, "K2": joint_channels_bwd_in.launches,
                "K3": joint_channels_bwd_w.launches, **{f"K4 {k}": n for k, n in k4_launches().items()}}
    peak = torch.cuda.max_memory_allocated(device)
    say(f"flash train steps (K4 fwd/bwd, K1 fwd, K2/K3 bwd), batch {TRAIN_BATCH} x {SECONDS} s, "
        f"dropout 0: {', '.join(f'{x:.4f}' for x in times)} s; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; peak memory {peak / 2**30:.3f} GiB; "
        f"launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"flash train losses finite: {losses}")
    check(all(n > 0 for n in launches.values()), f"the flash train steps launched K1-K4: {launches}")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "parameters finite")
    profile_step(step, batch, gen, device, also="flash_")
    del model, step
    torch.cuda.empty_cache()
    return launches


def flash_step_parity(device) -> None:
    """One train step with flash and one with exact attention (dropout 0),
    from the same weights and generator seed."""
    batch = flagship_batch(device, TRAIN_BATCH)
    got = one_step(device, batch, "with flash attention", attn_flash=True,
                   tdnn_transformer_dropout=0.0)
    ref = one_step(device, batch, "with exact attention", tdnn_transformer_dropout=0.0)
    compare_steps("flash vs exact attention", got, ref, FLASH_LOSS_RTOL, FLASH_ENCODER_TOL,
                  FLASH_STATS_TOL)


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
    kernel = ""
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_label(line.split("'")[1])
        if any(key in line for key in ("registers", "spill", "bytes smem", "warning", "C75")):
            say(f"  {kernel}: {line.strip()[:160]}")

    k1 = kernel_parity(device)
    k2, k3 = backward_parity(device)
    k4 = k4_parity(device)
    inference_launches, exact_loss = inference_path(device)
    flash_inference_path(device, exact_loss)
    long_utterances(device)
    launches, _ = train_path(device)
    backend_parity(device)
    flash_launches = flash_train_path(device)
    flash_step_parity(device)

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
         "source": "pika_tpu_torch/csrc/joint_channels_bwd_w.cu",
         "replaces": "pika_tpu/ops/rnnt_pallas.py:284", "launches": launches["K3"], **k3},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "pika_tpu_torch/csrc/flash_attention.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758 "
                     "(via pika_tpu/models/transformer.py:181)",
         "launches": flash_launches["K4 fwd"], **k4["fwd"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": "pika_tpu_torch/csrc/flash_attention.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 "
                     "(via pika_tpu/models/transformer.py:181)",
         "launches": flash_launches["K4 dkv"], **k4["dkv"]},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "pika_tpu_torch/csrc/flash_attention.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456 "
                     "(via pika_tpu/models/transformer.py:181)",
         "launches": flash_launches["K4 dq"], **k4["dq"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
