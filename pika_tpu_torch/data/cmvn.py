"""Global CMVN statistics: accumulation and Kaldi-compatible text I/O (the
port's own copy of ``pika_tpu/data/cmvn.py``).

Stats layout (Kaldi's): a 2 x (dim+1) float64 matrix, row 0 = [sum(x) per
dim, frame count], row 1 = [sum(x^2) per dim, 0], in Kaldi's text matrix
format.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class CmvnStats:
    def __init__(self, dim: int):
        self.stats = np.zeros((2, dim + 1), dtype=np.float64)

    @property
    def dim(self) -> int:
        return self.stats.shape[1] - 1

    def accumulate(self, feats: np.ndarray) -> None:
        """Accumulate frames (num_frames, dim)."""
        feats = np.asarray(feats, dtype=np.float64)
        self.stats[0, :-1] += feats.sum(axis=0)
        self.stats[1, :-1] += (feats ** 2).sum(axis=0)
        self.stats[0, -1] += feats.shape[0]

    def write(self, path: str) -> None:
        write_kaldi_matrix(path, self.stats)

    @classmethod
    def read(cls, path: str) -> "CmvnStats":
        mat = read_kaldi_matrix(path)
        if mat.shape[0] != 2:
            raise ValueError(f"CMVN stats must have 2 rows, got {mat.shape}")
        obj = cls(mat.shape[1] - 1)
        obj.stats = mat
        return obj


def write_kaldi_matrix(path: str, mat: np.ndarray) -> None:
    """Write a matrix in Kaldi text format: `` [\\n  row\\n ... row ]``."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(" [")
        for i, row in enumerate(np.asarray(mat)):
            f.write("\n  " + " ".join(repr(float(x)) for x in row))
            if i == mat.shape[0] - 1:
                f.write(" ]")
        f.write("\n")


def read_kaldi_matrix(path: str) -> np.ndarray:
    """Parse a Kaldi text-format matrix."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    text = text.replace("[", " ").replace("]", " ")
    rows = [r for r in text.splitlines() if r.strip()]
    return np.array([[float(x) for x in r.split()] for r in rows], dtype=np.float64)


def offset_scale(stats: np.ndarray, splice_copies: int = 1,
                 var_floor: float = 1.0e-20) -> Tuple[np.ndarray, np.ndarray]:
    """(offset, scale) = (-mean, 1/sqrt(var)), each tiled ``splice_copies``
    times across the spliced context.  Raises on a degenerate variance."""
    stats = np.asarray(stats, dtype=np.float64)
    count = stats[0, -1]
    mean = stats[0, :-1] / count
    var = stats[1, :-1] / count - mean * mean
    if np.min(np.abs(var)) < var_floor:
        raise ValueError("problematic cmvn_stats, variance too small")
    offset = np.tile(-mean, splice_copies).astype(np.float32)
    scale = np.tile(1.0 / np.sqrt(var), splice_copies).astype(np.float32)
    return offset, scale
