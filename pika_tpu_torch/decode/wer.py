"""Edit distance and WER/CER scoring in numpy (the port's own copy of
``pika_tpu/decode/wer.py``, which it cannot import: that package's
``decode/__init__.py`` imports JAX).  Replaces the ``editdistance`` package
and Kaldi's ``compute-wer``."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance (two-row DP)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = np.arange(m + 1)
    cur = np.zeros(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        cur[0] = i
        sub = prev[:-1] + (np.asarray(hyp) != ref[i - 1])
        for j in range(1, m + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub[j - 1])
        prev, cur = cur, prev
    return int(prev[m])


def edit_distance_batch(refs: np.ndarray, ref_lens: np.ndarray, hyps: np.ndarray, hyp_lens: np.ndarray) -> np.ndarray:
    """Pairwise edit distance over padded int arrays: (N, U) vs (N, V) → (N,)."""
    out = np.zeros(len(refs), dtype=np.int64)
    for i in range(len(refs)):
        out[i] = edit_distance(refs[i][: ref_lens[i]].tolist(), hyps[i][: hyp_lens[i]].tolist())
    return out


def score_wer(
    refs: Dict[str, List[str]], hyps: Dict[str, List[str]]
) -> Tuple[float, Dict[str, int]]:
    """Corpus WER: (wer, counts{errors, words, ins, del, sub, sent_err}).

    Utterances missing from ``hyps`` count as fully deleted, matching
    compute-wer semantics for empty hypotheses.  Hypothesis ids absent
    from ``refs`` are NOT scored (there is nothing to align them to);
    they are counted in ``counts["unmatched_hyps"]`` so an id-format
    drift between label file and decode output cannot silently yield an
    optimistic all-deletions WER — callers should warn when nonzero.
    """
    total_err = 0
    total_words = 0
    ins = dele = sub = 0
    sent_err = 0
    for uttid, ref in refs.items():
        hyp = hyps.get(uttid, [])
        n, m = len(ref), len(hyp)
        dp = np.zeros((n + 1, m + 1), dtype=np.int64)
        dp[:, 0] = np.arange(n + 1)
        dp[0, :] = np.arange(m + 1)
        for i in range(1, n + 1):
            for j in range(1, m + 1):
                dp[i, j] = min(
                    dp[i - 1, j] + 1,
                    dp[i, j - 1] + 1,
                    dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]),
                )
        # backtrace for ins/del/sub counts
        i, j = n, m
        e_i = e_d = e_s = 0
        while i > 0 or j > 0:
            if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
                if ref[i - 1] != hyp[j - 1]:
                    e_s += 1
                i, j = i - 1, j - 1
            elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
                e_d += 1
                i -= 1
            else:
                e_i += 1
                j -= 1
        err = e_i + e_d + e_s
        total_err += err
        total_words += n
        ins += e_i
        dele += e_d
        sub += e_s
        if err:
            sent_err += 1
    wer = total_err / max(1, total_words)
    return wer, {
        "errors": total_err, "words": total_words,
        "ins": ins, "del": dele, "sub": sub,
        "sent_err": sent_err, "sents": len(refs),
        "unmatched_hyps": sum(1 for u in hyps if u not in refs),
    }
