"""The repo's synthetic-but-hard ASR corpus, written through the port's
data layer (the port's copy of ``tools/make_hard_corpus.py``: the same
flags and the same draws in the same order, so one seed gives the same
bytes).

Each of 30 vocabulary tokens is a formant pair (F1, F2) on a distinct
grid point, rendered as a harmonic source (per-utterance fundamental
90-220 Hz) shaped by Gaussian spectral envelopes -- crude vowels.  Speaker
variation: every utterance draws a formant scale and its own pitch, so the
same token varies across utterances.  The TEST set additionally has
babble-like noise mixed at --test_snr dB SNR (train-time noise robustness
must come from --snr_range augmentation with the separately generated
noise archive); a clean copy of the same test utterances is written to
test_clean/.  With --grammar_branching the transcripts follow a sparse
bigram grammar, and --grammar_text writes grammar-sampled text for LM
estimation.

Usage:
    python -m pika_tpu_torch.recipes.hard_corpus OUTDIR [--train 1500] [--test 200]
Writes OUTDIR/{train,test,test_clean}/{wav.scp,label.txt}, OUTDIR/noise.{mrk,seq}.0 +
OUTDIR/noise.lst, OUTDIR/char.txt [, OUTDIR/grammar_text.txt].
"""

import argparse
import os
import random

import numpy as np

from pika_tpu_torch.data import MrkSeqWriter, write_int_vectors, write_wav
from pika_tpu_torch.data import segment as seg

SR = 16000
VOCAB = 30  # token ids 1..30 (blank 0)


def token_formants(tok: int):
    """30 tokens on a 6x5 (F1, F2) grid with GEOMETRIC spacing: formant
    confusability is multiplicative (speaker scale multiplies both
    formants), so constant-ratio spacing (27%/28% per step) keeps every
    adjacent pair separated by well over the ±8% speaker variation.  A
    linear grid is ill-posed at the top (1000/860 = 1.16 — inside the
    speaker range).  (Speed perturbation would add another ±10% shift;
    the recipe keeps it off for this corpus.)"""
    i = (tok - 1) % 6
    j = (tok - 1) // 6
    f1 = 300.0 * (1000.0 / 300.0) ** (i / 5.0)    # 300..1000, ratio 1.272
    f2 = 1150.0 * (3070.0 / 1150.0) ** (j / 4.0)  # 1150..3070, ratio 1.278
    return f1, f2


def synth_token(tok, f0, scale, dur_s, rng):
    f1, f2 = token_formants(tok)
    f1, f2 = f1 * scale, f2 * scale
    n = int(dur_s * SR)
    t = np.arange(n) / SR
    sig = np.zeros(n)
    bw = 110.0 * scale
    harmonics = np.arange(1, int(4200 / f0) + 1)
    for amp, form in ((1.0, f1), (0.6, f2)):
        fk = harmonics * f0
        w = amp * np.exp(-0.5 * ((fk - form) / bw) ** 2)
        keep = w > 1e-3
        for wk, fkk in zip(w[keep], fk[keep]):
            sig += wk * np.sin(2 * np.pi * fkk * t + rng.uniform(0, 2 * np.pi))
    # attack/decay envelope
    a = max(1, int(0.015 * SR))
    env = np.ones(n)
    env[:a] = np.linspace(0, 1, a)
    env[-a:] = np.linspace(1, 0, a)
    return sig * env


def synth_utt(toks, rng):
    f0 = rng.uniform(90.0, 220.0)
    scale = rng.uniform(0.94, 1.08)
    pieces = [np.zeros(int(rng.uniform(0.03, 0.07) * SR))]
    for tok in toks:
        pieces.append(synth_token(int(tok), f0, scale,
                                  rng.uniform(0.08, 0.16), rng))
        pieces.append(np.zeros(int(rng.uniform(0.01, 0.04) * SR)))
    x = np.concatenate(pieces)
    x = x / max(1e-6, np.abs(x).max()) * rng.uniform(0.15, 0.5)
    return (x * 32767 * 0.5).astype(np.int16)


def synth_noise(dur_s, rng):
    """Babble-ish: overlapping OUT-OF-VOCABULARY formant bursts (random
    continuous formants, not grid tokens — in-vocab babble would inject
    competing labels and make the task ill-posed) + pink-ish noise."""
    n = int(dur_s * SR)
    x = np.zeros(n)
    for _ in range(int(dur_s * 6)):
        f0 = rng.uniform(90, 220)
        dur = rng.uniform(0.1, 0.25)
        m = int(dur * SR)
        t = np.arange(m) / SR
        piece = np.zeros(m)
        for _k in range(2):
            form = rng.uniform(400, 2800)
            for kk in range(1, int(4200 / f0) + 1):
                fk = kk * f0
                w = np.exp(-0.5 * ((fk - form) / 130.0) ** 2)
                if w > 1e-3:
                    piece += w * np.sin(2 * np.pi * fk * t + rng.uniform(0, 2 * np.pi))
        off = int(rng.integers(0, max(1, n - len(piece))))
        x[off : off + len(piece)] += 0.4 * piece
    white = rng.standard_normal(n)
    pink = np.cumsum(white) * 0.02
    pink -= pink.mean()
    x += 0.3 * pink / max(1e-6, np.abs(pink).max())
    x = x / max(1e-6, np.abs(x).max()) * 0.4
    return (x * 32767 * 0.5).astype(np.int16)


def mix_at_snr(sig_i16, noise_i16, snr_db, rng):
    x = seg.to_float32(sig_i16)
    noise = seg.to_float32(noise_i16)
    if len(noise) < len(x):
        noise = np.tile(noise, int(np.ceil(len(x) / len(noise))))
    out = seg.add_noise(x, SR, noise, snr_db, rng=random.Random(int(rng.integers(1 << 30))))
    return seg.from_float32(out, "int16")


def make_grammar(branching: int, seed: int = 7):
    """A sparse bigram grammar: from each token (and from start) only
    ``branching`` of the 30 tokens may follow, with random (Dirichlet)
    transition probabilities.  This gives transcripts real language-model
    signal — an n-gram LM estimated on the training transcripts carries
    ~log2(30/branching) bits/token — so FST shallow fusion and rescoring
    stages have something to earn (with uniform-random transcripts every
    LM is flat and rescoring deltas are pure noise).
    The grammar seed is FIXED (independent of the corpus seed): train and
    test draw from the same language."""
    g = np.random.default_rng(seed)
    succ = np.zeros((VOCAB + 1, branching), np.int64)   # row 0 = start
    prob = np.zeros((VOCAB + 1, branching))
    for ctx in range(VOCAB + 1):
        succ[ctx] = g.choice(np.arange(1, VOCAB + 1), size=branching,
                             replace=False)
        prob[ctx] = g.dirichlet(np.full(branching, 1.0))
    return succ, prob


def sample_grammar_toks(grammar, n_toks, rng):
    succ, prob = grammar
    toks, ctx = [], 0
    for _ in range(n_toks):
        k = rng.choice(succ.shape[1], p=prob[ctx])
        tok = int(succ[ctx, k])
        toks.append(tok)
        ctx = tok
    return np.array(toks, np.int64)


def write_split(outdir, name, n_utts, rng, noise_clips=None,
                snr_range=(12.0, 22.0), clean_copy=None, grammar=None):
    """Write a split; with ``clean_copy``, also write the same utterances
    WITHOUT noise under that name (clean-vs-noisy WER on identical
    content isolates the noise-robustness gap)."""
    d = os.path.join(outdir, name)
    os.makedirs(os.path.join(d, "wavs"), exist_ok=True)
    dc = None
    if clean_copy is not None:
        dc = os.path.join(outdir, clean_copy)
        os.makedirs(os.path.join(dc, "wavs"), exist_ok=True)
        scp_clean = open(os.path.join(dc, "wav.scp"), "w")
    labels = []
    with open(os.path.join(d, "wav.scp"), "w") as scp:
        for i in range(n_utts):
            n_toks = int(rng.integers(4, 11))
            if grammar is not None:
                toks = sample_grammar_toks(grammar, n_toks, rng)
            else:
                toks = rng.integers(1, VOCAB + 1, n_toks)
            pcm = synth_utt(toks, rng)
            uttid = f"{name}{i:05d}"
            if dc is not None:
                path_c = os.path.join(dc, "wavs", f"{uttid}.wav")
                write_wav(path_c, pcm, SR)
                scp_clean.write(f"{uttid} {path_c}\n")
            if noise_clips is not None:
                k = int(rng.integers(0, len(noise_clips)))
                pcm = mix_at_snr(pcm, noise_clips[k],
                                 rng.uniform(*snr_range), rng)
            path = os.path.join(d, "wavs", f"{uttid}.wav")
            write_wav(path, pcm, SR)
            scp.write(f"{uttid} {path}\n")
            labels.append((uttid, [int(t) for t in toks]))
    write_int_vectors(os.path.join(d, "label.txt"), labels)
    if dc is not None:
        scp_clean.close()
        write_int_vectors(os.path.join(dc, "label.txt"), labels)


def main(argv=None):
    ap = argparse.ArgumentParser(description="synthetic formant-token corpus")
    ap.add_argument("outdir")
    ap.add_argument("--train", type=int, default=1500)
    ap.add_argument("--test", type=int, default=200)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--test_snr", type=str, default="12,22",
                    help="lo,hi dB SNR for baked-in test noise.  The babble "
                         "is in-band formant bursts — spectrally inside the "
                         "token class — so SNRs below ~10 dB bury the "
                         "formant identity that IS the label")
    ap.add_argument("--grammar_branching", type=int, default=0,
                    help="if >0, draw transcripts from a sparse bigram "
                         "grammar with this many successors per token "
                         "(fixed grammar seed, shared by train and test) "
                         "instead of uniform-random tokens; gives LM/"
                         "rescoring stages real signal")
    ap.add_argument("--grammar_split", choices=["all", "test"], default="all",
                    help="'test': only test/dev transcripts follow the "
                         "grammar; TRAIN stays uniform so the model's "
                         "internal LM cannot learn the structure — the "
                         "realistic AM-on-broad-data / LM-on-domain-text "
                         "split where external fusion must carry the "
                         "signal")
    ap.add_argument("--grammar_text", type=int, default=0,
                    help="write N grammar-sampled TEXT-ONLY transcripts "
                         "(no audio) to grammar_text.txt in label.txt "
                         "format, for LM estimation")
    args = ap.parse_args(argv)
    snr_lo, snr_hi = (float(v) for v in args.test_snr.split(","))
    grammar = (make_grammar(args.grammar_branching)
               if args.grammar_branching else None)
    train_grammar = grammar if args.grammar_split == "all" else None

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.outdir, exist_ok=True)

    # training noise archive (for --noise_lst / --snr_range augmentation)
    train_noise = [synth_noise(8.0, rng) for _ in range(12)]
    with MrkSeqWriter(os.path.join(args.outdir, "noise.mrk"),
                      os.path.join(args.outdir, "noise.seq")) as w:
        for i, clip in enumerate(train_noise):
            w.write(f"noise{i}", clip)
        shards = list(w.shards)
    with open(os.path.join(args.outdir, "noise.lst"), "w") as f:
        for mrk, seq in shards:
            f.write(f"{mrk} {seq} -\n")

    # test noise: DIFFERENT realizations, baked into the test wavs
    test_noise = [synth_noise(8.0, rng) for _ in range(8)]

    write_split(args.outdir, "train", args.train, rng, grammar=train_grammar)
    write_split(args.outdir, "test", args.test, rng, noise_clips=test_noise,
                snr_range=(snr_lo, snr_hi), clean_copy="test_clean",
                grammar=grammar)

    if args.grammar_text:
        assert grammar is not None, "--grammar_text needs --grammar_branching"
        text = []
        for i in range(args.grammar_text):
            n_toks = int(rng.integers(4, 11))
            text.append((f"text{i:06d}",
                         [int(t) for t in sample_grammar_toks(grammar, n_toks, rng)]))
        write_int_vectors(os.path.join(args.outdir, "grammar_text.txt"), text)

    with open(os.path.join(args.outdir, "char.txt"), "w") as f:
        f.write("<blk> 0\n")
        for k in range(1, VOCAB + 1):
            f.write(f"w{k} {k}\n")
    print(f"corpus at {args.outdir}: {args.train} train, {args.test} test "
          f"(noisy {snr_lo:.0f}-{snr_hi:.0f} dB SNR, disjoint noise; "
          f"clean copy in test_clean/)")


if __name__ == "__main__":
    main()
