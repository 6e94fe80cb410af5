#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pika_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and nvcc.  It
builds the CUDA kernels from ``pika_tpu_torch/csrc``, holds each against its
plain PyTorch version at the shapes the inference path gives it, then drives
the inference path once at the flagship width (``bench.py``'s model:
TDNN-Transformer 9x1024, 2x1024 LSTM prediction net, V=6268, random weights
from a seed): the eval step (RNN-T loss through kernel K1) and greedy
decoding of 8 utterances of 10 s.  Float32 throughout, with TF32 off for
matmuls and cuDNN convolutions, so the parity checks compare float32 with
float32.

Output: one line per phase; then the card's name and power limit as
nvidia-smi reports them; a JSON line with each kernel's launches on the main
path, max abs error against its plain version, and both times; and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
that line.  There is no CPU mode: without a CUDA card it exits 1.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from pika_tpu_torch.decode.greedy import greedy_decode_waveforms
from pika_tpu_torch.features.fbank import FbankConfig
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.ops import cuda_build
from pika_tpu_torch.ops.rnnt_kernels import joint_channels, joint_channels_reference
from pika_tpu_torch.ops.rnnt_loss import rnnt_loss_forward, rnnt_loss_numpy
from pika_tpu_torch.train.step import FeaturizerConfig, make_eval_step, make_featurizer

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


def main_path(device) -> tuple[int, dict]:
    """Flagship-width eval step and greedy decode; returns K1's launches."""
    cfg = TransducerConfig(
        input_dim=240, vocab_size=VOCAB, hid_dim=1024, encoder_type="tdnn_transformer",
        decoder_type="rnn", enc_layers=9, dec_layers=2, embd_dim=100,
        tdnn_nhid=1024, tdnn_layers=9)
    t0 = time.perf_counter()
    model = init_transducer(cfg, torch.Generator(device).manual_seed(0), device)
    max_samples = SR * SECONDS
    fbank = FbankConfig(sample_frequency=SR, window_type="hamming", dither=0.0,
                        low_freq=40.0, high_freq=-200.0, num_mel_bins=80)
    featurizer = make_featurizer(FeaturizerConfig(fbank=fbank, max_samples=max_samples,
                                                  lctx=1, rctx=1, stride=1), device=device)
    rng = np.random.default_rng(0)
    wavs = (rng.standard_normal((BATCH, max_samples)) * 4000).astype(np.float32)
    batch = {
        "wavs": torch.from_numpy(wavs).to(device),
        "wav_lens": torch.full((BATCH,), max_samples, dtype=torch.int32, device=device),
        "labels": torch.from_numpy(rng.integers(1, VOCAB, (BATCH, U_MAX)).astype(np.int32)).to(device),
        "label_lens": torch.full((BATCH,), U_MAX, dtype=torch.int32, device=device),
    }
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
    return launches, {"eval_s": eval_s, "decode_s": decode_s, "peak_bytes": peak}


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
    launches, _ = main_path(device)

    say(card)
    print(json.dumps({"kernels": [{
        "name": "joint_channels_fwd", "route": "cuda",
        "source": "pika_tpu_torch/csrc/joint_channels_fwd.cu",
        "replaces": "pika_tpu/ops/rnnt_pallas.py:151",
        "launches": launches, **k1}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
