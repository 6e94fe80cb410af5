"""N-best reranking (port of ``pika_tpu/decode/rescore.py:rerank_nbest``;
LAS rescoring, ``las_score_hyps``, waits for the LAS port: ROADMAP Queue 1
item 6)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def rerank_nbest(rnnt_scores: np.ndarray, lens: np.ndarray,
                 fw_scores: Optional[np.ndarray] = None, bw_scores: Optional[np.ndarray] = None,
                 rnnt_scale: float = 1.0, fw_scale: float = 0.3, bw_scale: float = 0.7):
    """Length-normalized fusion of (B, N) scores; returns (best_idx (B,),
    fused (B, N)).  Empty hypotheses are normalized by 0.001, as the
    reference's ``nbest_rerank.py`` does."""
    score = rnnt_scale * np.asarray(rnnt_scores, np.float32)
    if fw_scores is not None:
        score = score + fw_scale * np.asarray(fw_scores, np.float32)
    if bw_scores is not None:
        score = score + bw_scale * np.asarray(bw_scores, np.float32)
    lens = np.asarray(lens)
    fused = score / np.where(lens == 0, np.float32(0.001), lens.astype(np.float32))
    return np.argmax(fused, axis=1), fused
