"""The ``decode`` traffic kind: batches decoded back to back by
the featurizer and ``beam_search_features`` (their composition is
``beam_search_waveforms``), each batch's N-best copied to the host as the
decode CLI writes it.

The features are normalized by global CMVN from the pool's first batch,
as the recipe's decoding applies its corpus statistics; the reference
takes the same.  A batch's latency runs from the featurizer's call to its N-best on the
host; the span ``search`` from the search's call to the same end.  After
the window the check takes a sample of the finished batches, drawn from
the seed with the one whose best hypothesis has the longest alignment in
it, and scores every served hypothesis under the reference
(``reference/decode.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import program, traffic, weights
from benchmark.reference import decode as reference
from benchmark.reference import features as RF
from benchmark.reference import model as M

EMPTY = -1e19     # the search's dead slots score -1e20
NBEST = ("tokens", "lens", "scores", "aligns", "align_lens")


def beam_config(mix: dict):
    return program.BeamConfig(beam_size=mix["beam"], n_best=mix["n_best"], sm_scale=mix["sm_scale"],
                              max_symbols=mix["max_symbols"], mm_dtype=mix["mm_dtype"])


def setup(ctx) -> dict:
    mix, config, dev = ctx.traffic, ctx.config, ctx.device
    model, layout = program.build_model(config, ctx.seed, dev)
    ctx.mark("weights")
    pool = traffic.make_pool(mix, 0, ctx.seed, dev)
    cmvn = RF.global_cmvn(pool[0]["wavs"], config["features"])
    run = {"model": model, "layout": layout, "cfg": beam_config(mix),
           "feat": program.featurizer(config, traffic.samples(mix), dev, cmvn=cmvn),
           "pool": pool, "cmvn": cmvn, "next": 0, "done": []}
    ctx.mark("pool")
    for i in range(mix["warm_units"]):
        decode_one(run)
        ctx.mark(f"warm{i + 1}")
    run["done"].clear()
    return run


def decode_one(run: dict) -> tuple:
    """One batch to its N-best on the host; returns (latency s, search s)."""
    i = run["next"] % len(run["pool"])
    run["next"] += 1
    batch = run["pool"][i]
    t0 = time.perf_counter()
    feats, feat_lens = run["feat"](batch["wavs"], batch["wav_lens"])
    t1 = time.perf_counter()
    out = program.beam_search_features(run["model"], feats, feat_lens, run["cfg"])
    host = {k: out[k].cpu().numpy() for k in NBEST}
    t2 = time.perf_counter()
    run["done"].append((i, host))
    return t2 - t0, t2 - t1


def window(ctx, run: dict, seconds: float, min_units: int = 1) -> dict:
    lat, search = [], []
    t0 = time.perf_counter()
    while True:
        a, b = decode_one(run)
        lat.append(a)
        search.append(b)
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds and len(lat) >= min_units:
            break
    b = ctx.traffic["batch"]
    t_enc = ctx.shapes["t_enc"]
    failed = sum(bool(malformed(host, t_enc, ctx)[0]) for _, host in run["done"])
    return {"window_s": elapsed, "units": len(lat), "failed": failed, "utterances": len(lat) * b,
            "audio_s": len(lat) * b * ctx.traffic["seconds"], "latencies": lat,
            "pool_index": [i for i, _ in run["done"]], "spans": {"search": search}}


def stretch(ctx, run: dict) -> int:
    n = ctx.traffic["trace_units"]
    for _ in range(n):
        decode_one(run)
    return n


def malformed(host: dict, t_enc: int, ctx) -> tuple:
    """(hypotheses of a batch that say something impossible, the served
    mask (B, N)): a best hypothesis that is missing or has not reached the
    last frame; any served one whose alignment holds a token out of range,
    more blanks than frames, tokens that differ from its alignment's labels
    or more than ``max_symbols``; scores not in descending order."""
    vocab, um = ctx.config["model"]["vocab_size"], ctx.traffic["max_symbols"]
    scores, lens, al = host["scores"], host["lens"], host["align_lens"]
    served = scores > EMPTY
    bad = np.zeros(served.shape, bool)
    bad[:, 0] |= ~served[:, 0]
    bad[:, 1:] |= served[:, 1:] & (scores[:, 1:] > scores[:, :-1] + 1e-3)
    for b, n in zip(*np.nonzero(served)):
        a = host["aligns"][b, n]
        path = a[:al[b, n]]
        if al[b, n] < 1 or (a[al[b, n]:] != -1).any() or (path < 0).any() or (path >= vocab).any():
            bad[b, n] = True
            continue
        labels = path[path != 0]
        blanks = len(path) - len(labels)
        tok = host["tokens"][b, n]
        if (blanks > t_enc - 1 or (n == 0 and blanks != t_enc - 1) or lens[b, n] != len(labels)
                or lens[b, n] > um or (tok[:lens[b, n]] != labels).any()
                or (tok[lens[b, n]:] != -1).any()):
            bad[b, n] = True
    return int(bad.sum()), served & ~bad


def sample(ctx, run: dict) -> list:
    """The batches the check compares: the one whose best hypothesis has
    the longest alignment, and others drawn from the seed."""
    done = run["done"]
    longest = max(range(len(done)), key=lambda j: done[j][1]["align_lens"][:, 0].max())
    rng = np.random.default_rng(weights.sub_seed(ctx.seed, 3))
    rest = [j for j in rng.permutation(len(done)) if j != longest]
    return [done[j] for j in [longest] + rest[:ctx.traffic["check_batches"] - 1]]


def rescore(ctx, state: dict, pool: list, cmvn: tuple, picked: list,
            prec=M.FLOAT32) -> list:
    """For each picked batch: (the program's scores, the reference's score
    along the listed alignment and finished, the served mask, the
    malformed count)."""
    config, t_enc = ctx.config, ctx.shapes["t_enc"]
    out = []
    for i, host in picked:
        bad, ok = malformed(host, t_enc, ctx)
        b, n = ok.shape
        enc = reference.encode(state, pool[i]["wavs"], config["model"], config["features"], cmvn,
                               prec)
        dev = enc.device

        def flat(x):
            return torch.as_tensor(x.reshape(b * n, *x.shape[2:]), device=dev)

        utt = torch.arange(b, device=dev).repeat_interleave(n)
        mix = ctx.traffic
        listed, finished, rank = reference.alignment_scores(
            state, enc, utt, flat(host["tokens"]), flat(host["lens"]).long(), flat(host["aligns"]),
            flat(host["align_lens"]).long(), config["model"], mix["sm_scale"], mix["beam"],
            mix["max_symbols"], prec)
        out.append((host["scores"].reshape(-1), listed.cpu().numpy(), finished.cpu().numpy(),
                    ok.reshape(-1), bad, rank.cpu().numpy()))
    return out


def score_gap(rescored: list) -> float:
    """The widest gap between a served score and the reference's score of
    its alignment (finished or not, whichever is nearer)."""
    gap = 0.0
    for got, listed, finished, ok, *_ in rescored:
        g = np.minimum(np.abs(got - listed), np.abs(got - finished))[ok]
        if g.size:
            gap = max(gap, float(np.nan_to_num(g, nan=np.inf).max()))
    return gap


def readings(rescored: list) -> dict:
    """The numbers a decode cell compares: ``score_gap``, ``rank_gap`` (the
    widest gap of a served token below the K-th best of its beam's
    candidates, under the reference) and ``malformed``."""
    rank = [float(r[5][r[3]].max()) for r in rescored if r[3].any()]
    return {"score_gap": score_gap(rescored), "rank_gap": max(rank, default=0.0),
            "malformed": float(sum(r[4] for r in rescored))}


def release(ctx, run: dict) -> None:
    """Pick the batches to compare, then free the program's state; the
    inputs and the picked N-best stay."""
    run["picked"] = sample(ctx, run)
    for key in ("model", "feat", "done"):
        run.pop(key)


def check(ctx, run: dict) -> dict:
    state = weights.make_state(run["layout"]["shapes"], ctx.seed, ctx.device)
    return readings(rescore(ctx, state, run["pool"], run["cmvn"], run["picked"]))
