"""The traffic generator: one general reader of the mixes' data files
(``benchmark/traffic/<name>.json``).

A mix states its batches: ``batch`` utterances of ``seconds`` seconds of
int16-scale noise (``noise_scale`` times a unit normal; with
``level_db`` [lo, hi] each utterance louder by a level drawn uniformly in
decibels), and for training ``labels_per_utt`` labels drawn uniformly
from 1..V-1.  ``pool`` distinct
batches are drawn on the device from the seed in one call each; the run
takes them in turn.  Every utterance has the full length, so every
batch has one shape and the seed changes the numbers, never the work.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from benchmark.counts import SAMPLE_RATE
from benchmark.weights import sub_seed


def load(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    for key in ("kind", "batch", "seconds", "pool", "noise_scale"):
        if key not in mix:
            raise ValueError(f"traffic {path} lacks {key!r}")
    return mix


def samples(mix: dict) -> int:
    return int(round(mix["seconds"] * SAMPLE_RATE))


def make_pool(mix: dict, vocab: int, seed: int, device) -> list:
    """The mix's ``pool`` batches: dicts of ``wavs`` (B, samples) float32,
    ``wav_lens`` (B,) and, with ``labels_per_utt``, ``labels`` (B, U) and
    ``label_lens``."""
    gen = torch.Generator(device).manual_seed(sub_seed(seed, 1))
    b, n, p = mix["batch"], samples(mix), mix["pool"]
    wavs = torch.randn((p, b, n), generator=gen, device=device).mul_(mix["noise_scale"])
    if "level_db" in mix:
        lo, hi = mix["level_db"]
        db = lo + (hi - lo) * torch.rand((p, b, 1), generator=gen, device=device)
        wavs.mul_(10.0 ** (db / 20.0))
    u = mix.get("labels_per_utt", 0)
    labels = torch.randint(1, vocab, (p, b, u), generator=gen, device=device,
                           dtype=torch.int32) if u else None
    pool = []
    for i in range(p):
        batch = {"wavs": wavs[i], "wav_lens": torch.full((b,), n, dtype=torch.int32,
                                                          device=device)}
        if u:
            batch["labels"] = labels[i]
            batch["label_lens"] = torch.full((b,), u, dtype=torch.int32, device=device)
        pool.append(batch)
    return pool
