"""Parsers for the Kaldi text data layout the decode CLI reads (the port's
own copy of part of ``pika_tpu/data/scp.py``): ``wav.scp``, text int-vector
archives (``label.txt``) and symbol tables."""

from __future__ import annotations

from typing import Dict

import numpy as np


def read_wav_scp(path: str) -> Dict[str, str]:
    """Read wav.scp -> ordered {uttid: path_or_pipe}."""
    out: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            uttid, rest = line.split(None, 1)
            out[uttid] = rest
    return out


def read_int_vectors(rspec: str) -> Dict[str, np.ndarray]:
    """Read a Kaldi text int-vector archive -> ordered {uttid: int32
    vector}: a plain filename or an rspecifier ``ark:filename`` /
    ``ark,t:filename``."""
    out: Dict[str, np.ndarray] = {}
    with open(rspec.rsplit(":", 1)[-1], "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if parts:
                out[parts[0]] = np.array([int(x) for x in parts[1:]], dtype=np.int32)
    return out


def read_symbol_table(path: str) -> Dict[int, str]:
    """Read a ``symbol id`` table -> {id: symbol}; lines of another shape
    are skipped."""
    table: Dict[int, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            table[int(parts[1])] = parts[0]
    return table
