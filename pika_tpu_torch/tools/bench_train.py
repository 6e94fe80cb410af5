"""Benchmark: RNN-T training throughput (utterances/sec/card) of the port on
the flagship PIKA config -- TDNN-Transformer encoder (9 layers, nhid 1024),
2-layer LSTM prediction net, vocab 6268, batch 32 x 10 s utterances --
running the whole step: waveform -> fbank (dither 1.0) -> splice ->
SpecAugment -> encoder/decoder/joint -> RNN-T loss through K1 forward and
K2/K3 backward -> SGD-Nesterov update (``train/step.py:make_train_step``).
The port's counterpart of the repo's ``bench.py``:

    python -m pika_tpu_torch.tools.bench_train [--device cpu]

Knobs, read from the environment as ``bench.py`` reads them:
``BENCH_BATCH`` (32), ``BENCH_DTYPE`` (``float32``; ``bfloat16`` runs the
model on bf16 casts of float32 masters), ``BENCH_PRUNED=N`` (the pruned
objective with a band of N labels; K1-K3 do not run), ``BENCH_ATTN_CHUNK``,
``BENCH_REMAT=1`` and ``BENCH_CHEAP_DROPOUT`` (``auto``: on on the card and
off on the CPU, as the training CLI resolves ``--attn_cheap_dropout auto``;
``1`` on, ``0`` off).

Timing discipline: one warm repetition (the kernels' build or load, cuBLAS
and cuDNN plans), then two timed ones.  A repetition runs 10 steps from one
seeded generator; each step updates the parameters in place and the next
reads them, so the steps are chained; it ends with
``torch.cuda.synchronize()`` and a host read of the last loss.  The two timed
repetitions must agree within 10 % or the benchmark exits 1 and prints no
result.

Prints exactly one JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": null}
Diagnostics (per-step ms, the repetitions' spread, the analytic TFLOP/s of
``flop_model``) go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Optional

import numpy as np
import torch

from pika_tpu_torch.device import resolve_device
from pika_tpu_torch.features.fbank import FbankConfig
from pika_tpu_torch.models.transducer import Transducer, TransducerConfig, init_transducer
from pika_tpu_torch.train import common
from pika_tpu_torch.train.lr import make_optimizer
from pika_tpu_torch.train.step import FeaturizerConfig, make_featurizer, make_train_step
from pika_tpu_torch.utils.profiling import StepTimer

SECONDS = 10.0
SR = 16000
VOCAB = 6268
U_MAX = 40
N_STEPS = 10
N_REPS = 2
TOLERANCE = 0.10
LOSS_CHUNK = 16
MODEL = dict(input_dim=240, vocab_size=VOCAB, hid_dim=1024, encoder_type="tdnn_transformer",
             decoder_type="rnn", enc_layers=9, dec_layers=2, embd_dim=100, tdnn_nhid=1024,
             tdnn_layers=9)
FBANK = FbankConfig(sample_frequency=SR, window_type="hamming", dither=1.0, low_freq=40.0,
                    high_freq=-200.0, num_mel_bins=80)
OPTIM = dict(initial_lr=0.003, final_lr=0.0001, total_batches=100000, momentum=0.9,
             grad_clip=3.0)


def flop_model(t_frames: int, batch: int, u: int, pruned: int = 0) -> float:
    """Rough per-step training FLOPs for the flagship config (fwd ~= the
    matmul terms below; training ~= 3x fwd for fwd+bwd).  Dominant terms
    only -- FFT, BatchNorm, softmax, elementwise are ignored, so this is a
    mild underestimate; it exists to make implausible utt/s numbers
    self-evident, not to compute MFU precisely.  ``bench.py:flop_model``'s
    arithmetic, term for term."""
    nhid = 1024
    t4 = t_frames // 4  # final TDNN layer has stride 4
    fwd = 0.0
    # 9 TDNN layers, kernel 3 in time: first maps 240->1024, rest 1024->1024;
    # the stride-4 layer only pays for t4 output frames.
    fwd += 2 * 3 * 240 * nhid * t_frames
    fwd += 2 * 3 * nhid * nhid * (7 * t_frames + t4)
    # 3 transformer layers (2 at full T, 1 at T/4): QKVO + scores + FFN(4x)
    for t in (t_frames, t_frames, t4):
        fwd += 2 * 4 * t * nhid * nhid          # q,k,v,o projections
        fwd += 2 * 2 * t * t * nhid             # scores + context
        fwd += 2 * 2 * t * nhid * (4 * nhid)    # ffn
    # 2-layer LSTM prediction net over U+1 symbols (8 matmuls of nhid^2/gate set)
    fwd += 2 * (u + 1) * 2 * 8 * nhid * nhid
    if pruned:
        # banded joint: vocab projection on s_range cells per frame, plus
        # the simple heads (H->V over T and U) and the exp-space
        # normalizer matmul (T x V x U)
        fwd += 2 * t4 * pruned * nhid * VOCAB
        fwd += 2 * (t4 + u + 1) * nhid * VOCAB
        fwd += 2 * t4 * (u + 1) * VOCAB
    else:
        # fused joint: per (t', u) position the vocab projection dominates
        fwd += 2 * t4 * (u + 1) * nhid * VOCAB
    fwd *= batch
    return 3.0 * fwd  # fwd + bwd


def cheap_dropout(flag: str, device: torch.device) -> bool:
    """``BENCH_CHEAP_DROPOUT``: ``1`` on, another value but ``auto`` off;
    ``auto`` as the training CLI resolves ``--attn_cheap_dropout auto``."""
    if flag != "auto":
        return flag == "1"
    args = argparse.Namespace(rng_impl="auto", attn_cheap_dropout="auto")
    common.resolve_rng_impl(args, device)
    return common.resolve_cheap_dropout(args)


def config(env, device: torch.device) -> tuple[TransducerConfig, FeaturizerConfig, int]:
    """The benchmark's model and featurizer configs under the ``BENCH_*``
    knobs of ``env`` (a mapping such as ``os.environ``), and the pruned
    objective's band (0: the full loss)."""
    pruned = int(env.get("BENCH_PRUNED", "0"))
    cfg = TransducerConfig(
        **MODEL, attn_chunk=int(env.get("BENCH_ATTN_CHUNK", "0")),
        attn_cheap_dropout=cheap_dropout(env.get("BENCH_CHEAP_DROPOUT", "auto"), device),
        remat=env.get("BENCH_REMAT", "") == "1", simple_joint=pruned > 0)
    feat_cfg = FeaturizerConfig(fbank=FBANK, max_samples=int(SR * SECONDS), lctx=1, rctx=1,
                                stride=1, spec_augment=True)
    return cfg, feat_cfg, pruned


def make_batch(batch: int, max_samples: int, vocab: int, device) -> dict:
    """``bench.py``'s batch from numpy ``default_rng(0)``: ``batch``
    utterances of ``max_samples`` samples of int16-scale noise, U_MAX
    random labels each."""
    rng = np.random.default_rng(0)
    wavs = (rng.standard_normal((batch, max_samples)) * 4000).astype(np.float32)
    labels = rng.integers(1, vocab, (batch, U_MAX)).astype(np.int32)
    return {
        "wavs": torch.from_numpy(wavs).to(device),
        "wav_lens": torch.full((batch,), max_samples, dtype=torch.int32, device=device),
        "labels": torch.from_numpy(labels).to(device),
        "label_lens": torch.full((batch,), U_MAX, dtype=torch.int32, device=device),
    }


def make_step(cfg: TransducerConfig, feat_cfg: FeaturizerConfig, device,
              compute_dtype: Optional[torch.dtype] = None,
              pruned: int = 0) -> tuple[Transducer, Callable]:
    """The benchmark's model (``cfg`` from a generator seeded 0), optimizer
    (``OPTIM``) and step (``make_train_step`` with ``loss_chunk=16``); the
    featurizer from ``feat_cfg`` without CMVN, as ``bench.py`` builds it.
    Returns ``(model, step)``."""
    device = torch.device(device)
    model = init_transducer(cfg, torch.Generator(device).manual_seed(0), device)
    optimizer = make_optimizer(model.parameters(), "sgd", **OPTIM)
    step = make_train_step(model, optimizer, make_featurizer(feat_cfg, device=device),
                           loss_chunk=LOSS_CHUNK, compute_dtype=compute_dtype,
                           pruned_range=pruned)
    return model, step


def repetition(step: Callable, batch: dict, seed: int, n_steps: int) -> tuple[float, float]:
    """``n_steps`` steps drawing from one generator seeded ``seed``, each on
    the parameters the one before left, ended (inside the timed span) by a
    host read of the last loss and a synchronize of its device.  Returns
    (seconds, last loss)."""
    gen = torch.Generator(batch["wavs"].device).manual_seed(seed)
    timer = StepTimer()
    timer.start()
    for _ in range(n_steps):
        loss = step(batch, gen)["loss"]
    last = loss.item()
    timer.stop(loss)
    return timer.times[0], last


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    batch_size = int(os.environ.get("BENCH_BATCH", "32"))
    dtype_name = os.environ.get("BENCH_DTYPE", "float32")
    cfg, feat_cfg, pruned = config(os.environ, device)
    compute_dtype = torch.bfloat16 if dtype_name == "bfloat16" else None
    _, step = make_step(cfg, feat_cfg, device, compute_dtype, pruned)
    max_samples = feat_cfg.max_samples
    batch = make_batch(batch_size, max_samples, cfg.vocab_size, device)

    warm_s, _ = repetition(step, batch, 1, N_STEPS)
    rep_times = []
    for rep in range(N_REPS):
        secs, final_loss = repetition(step, batch, 2 + rep, N_STEPS)
        rep_times.append(secs)

    spread = (max(rep_times) - min(rep_times)) / min(rep_times)
    step_ms = [t / N_STEPS * 1000 for t in rep_times]
    t_frames = 1 + (max_samples - 400) // 160  # Kaldi snip-edges frame count
    tflops = flop_model(t_frames, batch_size, U_MAX, pruned) / (min(rep_times) / N_STEPS) / 1e12
    print(
        f"bench: first call + warm repetition {warm_s:.1f}s; "
        f"per-step ms per rep: {[f'{m:.1f}' for m in step_ms]}, "
        f"spread {spread * 100:.1f}%; "
        f"~{tflops:.1f} TFLOP/s (analytic matmul model, 3x-fwd training, "
        f"underestimates by ignoring FFT/norm/softmax); "
        f"final loss {final_loss:.1f}",
        file=sys.stderr,
    )
    if spread > TOLERANCE:
        print(
            f"bench: FAILED -- timed repetitions disagree by "
            f"{spread * 100:.1f}% (> {TOLERANCE * 100:.0f}%): "
            f"{[f'{t:.3f}s' for t in rep_times]}; timing not trustworthy",
            file=sys.stderr,
        )
        sys.exit(1)

    utts_per_sec = batch_size * N_STEPS / min(rep_times)
    loss_tag = f", pruned loss s={pruned}" if pruned else ""
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({
        "metric": "rnnt_train_utterances_per_sec_per_chip",
        "value": round(utts_per_sec, 3),
        "unit": f"utt/s ({SECONDS:g}s utts, batch {batch_size}, flagship TDNN-Transformer "
                f"RNN-T, wav->loss->SGD step, {dtype_name} compute{loss_tag}, {card})",
        "vs_baseline": None,
    }))


if __name__ == "__main__":
    main()
