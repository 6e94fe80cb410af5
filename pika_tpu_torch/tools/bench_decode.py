"""Decode-throughput benchmark: batched beam search on the flagship model,
the port's counterpart of the repo's ``tools/bench_decode.py``.

Measures ms a batch, utterances/sec and RTF of ``beam_search_waveforms``
(fbank, encoder, and the beam loop replayed as a CUDA graph) at the
reference's eval_transducer path (beam 8; egs/eval_transducer.sh:18-20),
with and without shallow fusion of a synthetic n-gram FST.  Run on the card:

    python -m pika_tpu_torch.tools.bench_decode [--batch 8] [--beam 8] [--fst per_token]

Timing: one warm search (the loop's graph capture, cuBLAS plans), then
``--reps`` searches ended by ``torch.cuda.synchronize()``.  Beam search runs
no hand-written kernel: K1-K4 are the training loss's and the flash
encoder's.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from pika_tpu_torch.decode.beam import BeamConfig, beam_search_waveforms
from pika_tpu_torch.decode.fst import FstTables
from pika_tpu_torch.device import resolve_device
from pika_tpu_torch.features.fbank import FbankConfig
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.train.step import FeaturizerConfig, make_featurizer
from pika_tpu_torch.utils.profiling import StepTimer

SR = 16000
VOCAB = 6268
MODEL = dict(input_dim=240, vocab_size=VOCAB, hid_dim=1024, encoder_type="tdnn_transformer",
             decoder_type="rnn", enc_layers=9, dec_layers=2, embd_dim=100, tdnn_nhid=1024,
             tdnn_layers=9)
FBANK = FbankConfig(sample_frequency=SR, window_type="hamming", dither=0.0, low_freq=40.0,
                    high_freq=-200.0, num_mel_bins=80)
SUCCESSORS = 40  # arcs of each bigram context


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--beam", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--n_best", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--max_symbols", type=int, default=64)
    ap.add_argument("--attribution", action="store_true",
                    help="also time the featurizer+encoder alone; the "
                         "difference attributes decode time between the "
                         "batch-scaling encoder forward and the "
                         "latency-bound beam loop")
    ap.add_argument("--fst", choices=("off", "per_beam", "per_token"), default="off",
                    help="decode with synthetic n-gram FST fusion to "
                         "measure the RTF cost of each fusion mode")
    ap.add_argument("--fst_states", type=int, default=5000,
                    help="synthetic LM size (bigram contexts)")
    ap.add_argument("--fst_cache_mb", type=int, default=512,
                    help="dense advance-cache budget (MB); 0 = the "
                         "backoff-walk path")
    ap.add_argument("--fst_topm", type=int, default=0,
                    help="per-token candidates per beam; 0 (the CLI "
                         "default) = exact full-vocab selection via the "
                         "dense cache")
    return ap


def beam_config(args) -> BeamConfig:
    """The search's config for the parsed flags (``mm_dtype="auto"``: bf16
    matmuls on the card)."""
    return BeamConfig(beam_size=args.beam, n_best=args.n_best, sm_scale=1.2,
                      max_symbols=args.max_symbols, mm_dtype="auto",
                      lm_scale=0.5 if args.fst != "off" else 0.0,
                      lm_per_token=(args.fst == "per_token"), lm_topm=args.fst_topm)


def synthetic_lm(vocab: int, n_states: int, seed: int = 1) -> FstTables:
    """A synthetic but realistically shaped backoff bigram LM: a unigram
    state with ``vocab`` arcs plus ``n_states`` bigram contexts with 40
    successors each, ilabel-sorted CSR (what ``compile_arpa`` produces),
    drawn from numpy ``default_rng(seed)`` as ``tools/bench_decode.py``
    draws it (``vocab`` >= 40)."""
    lm_rng = np.random.default_rng(seed)
    ns = 1 + n_states
    arc_start = np.zeros(ns + 1, np.int64)
    arc_start[1] = vocab  # unigram state: every token
    arc_start[2:] = vocab + SUCCESSORS * np.arange(1, ns, dtype=np.int64)
    ils, ws, nxt = [np.arange(1, vocab + 1, dtype=np.int32)], [], []
    ws.append(lm_rng.uniform(1.0, 12.0, vocab).astype(np.float32))
    nxt.append(lm_rng.integers(1, ns, vocab).astype(np.int32))
    for _ in range(ns - 1):
        ils.append(np.sort(lm_rng.choice(
            np.arange(1, vocab + 1, dtype=np.int32), SUCCESSORS, replace=False)))
        ws.append(lm_rng.uniform(0.2, 6.0, SUCCESSORS).astype(np.float32))
        nxt.append(lm_rng.integers(1, ns, SUCCESSORS).astype(np.int32))
    return FstTables(
        arc_start=arc_start.astype(np.int32),
        arc_ilabel=np.concatenate(ils), arc_weight=np.concatenate(ws),
        arc_next=np.concatenate(nxt),
        backoff_next=np.concatenate([[-1], np.zeros(ns - 1, np.int32)]).astype(np.int32),
        backoff_weight=np.concatenate([[0.0], lm_rng.uniform(0.5, 3.0, ns - 1)]).astype(np.float32),
        final_weight=np.full(ns, 0.5, np.float32),
        start=0,
        disambig_next=np.full((ns, 1), -1, np.int32),
        disambig_weight=np.full((ns, 1), 1e30, np.float32),
    )


def lm_tables(tables: FstTables, vocab: int, cache_mb: int, device):
    """The LM's device tables with the advance cache when it fits
    ``cache_mb``; prints the cache line.  Returns the tables."""
    t0 = time.perf_counter()
    dev = tables.device_arrays(device, n_ilabels=vocab + 1, cache_max_bytes=cache_mb << 20)
    if "adv_cost" in dev:
        print(f"  advance cache: Lm={dev['adv_cost'].shape[-1]}, "
              f"{(dev['adv_cost'].nbytes * 2) >> 20} MB, "
              f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    return dev


def exact_fallback(cfg: BeamConfig, fst_tables) -> BeamConfig:
    """Exact selection needs the cache: without it, the CLI's top-8."""
    if fst_tables is not None and cfg.lm_topm <= 0 and "adv_cost" not in fst_tables:
        return dataclasses.replace(cfg, lm_topm=8)
    return cfg


def make_wavs(batch: int, max_samples: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``batch`` utterances of ``max_samples`` samples of int16-scale noise
    from numpy ``default_rng(0)``, and their lengths."""
    rng = np.random.default_rng(0)
    wavs = (rng.standard_normal((batch, max_samples)) * 4000).astype(np.float32)
    return (torch.from_numpy(wavs).to(device),
            torch.full((batch,), max_samples, dtype=torch.int32, device=device))


def warm_then_timed(fn, reps: int):
    """``fn()`` once, then ``reps`` times, each run ended by a synchronize
    of the devices of the last result.  Returns (seconds a call of the
    timed run, the last result)."""
    timer = StepTimer()
    for n in (1, reps):
        timer.start()
        for _ in range(n):
            out = fn()
        timer.stop(out)
    return timer.times[1] / reps, out


def time_searches(model, featurizer, wavs, lens, cfg: BeamConfig, fst_tables, fst_start: int,
                  reps: int) -> tuple[float, dict]:
    """One warm search, then ``reps`` timed ones.  Returns (seconds a
    batch, the last search's result)."""
    return warm_then_timed(lambda: beam_search_waveforms(model, featurizer, wavs, lens, cfg,
                                                         fst_tables, fst_start), reps)


@torch.no_grad()
def time_encoder(model, featurizer, wavs, lens, reps: int) -> float:
    """Seconds a batch of the featurizer and the encoder alone, timed as
    ``time_searches``."""
    return warm_then_timed(lambda: model.encode(*featurizer(wavs, lens)), reps)[0]


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(None)
    max_samples = int(SR * args.seconds)
    featurizer = make_featurizer(FeaturizerConfig(fbank=FBANK, max_samples=max_samples, lctx=1,
                                                  rctx=1, stride=1), device=device)
    cfg = TransducerConfig(**MODEL)
    model = init_transducer(cfg, torch.Generator(device).manual_seed(0), device)
    bcfg = beam_config(args)
    fst_tables, fst_start = None, 0
    if args.fst != "off":
        tables = synthetic_lm(cfg.vocab_size, args.fst_states)
        fst_tables = lm_tables(tables, cfg.vocab_size, args.fst_cache_mb, device)
        fst_start = tables.start
    bcfg = exact_fallback(bcfg, fst_tables)

    wavs, lens = make_wavs(args.batch, max_samples, device)
    dt, _ = time_searches(model, featurizer, wavs, lens, bcfg, fst_tables, fst_start, args.reps)
    utts = args.batch / dt
    rtf = dt / (args.batch * args.seconds)
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"beam={args.beam} batch={args.batch} fst={args.fst}: "
          f"{dt*1000:.1f} ms/batch, {utts:.2f} utt/s, RTF {rtf:.5f} ({card})", flush=True)

    if args.attribution:
        dt_enc = time_encoder(model, featurizer, wavs, lens, args.reps)
        print(f"  attribution: featurizer+encoder {dt_enc*1000:.1f} ms "
              f"({dt_enc/dt*100:.0f}%), beam loop+joint "
              f"{(dt-dt_enc)*1000:.1f} ms ({(dt-dt_enc)/dt*100:.0f}%)", flush=True)


if __name__ == "__main__":
    main()
