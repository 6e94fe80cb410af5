"""Parsers for the Kaldi text data layout (the port's own copy of
``pika_tpu/data/scp.py``): ``wav.scp``, text int-vector archives
(``label.txt``), symbol tables and the data ``.lst`` of ``mrk seq
label_rspec`` triplets the training loader reads."""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

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


def iter_int_vectors(rspec: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate a Kaldi text int-vector archive: a plain filename or an
    rspecifier ``ark:filename`` / ``ark,t:filename``."""
    with open(rspec.rsplit(":", 1)[-1], "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if parts:
                yield parts[0], np.array([int(x) for x in parts[1:]], dtype=np.int32)


def read_int_vectors(rspec: str) -> Dict[str, np.ndarray]:
    """Read a Kaldi text int-vector archive -> ordered {uttid: int32 vector}."""
    return dict(iter_int_vectors(rspec))


def write_int_vectors(path: str, items) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for uttid, vec in items:
            f.write(uttid + " " + " ".join(str(int(x)) for x in vec) + "\n")


def read_data_lst(path: str) -> List[Tuple[str, str, str]]:
    """Read a data .lst of ``mrk seq label_rspec`` triplets; lines with
    fewer fields are skipped."""
    triplets = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                triplets.append((parts[0], parts[1], parts[2]))
    return triplets


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
