"""Length-based utterance list splitting and shuffling (the port's own copy
of ``pika_tpu/data/lists.py``):
  * utterances are sorted longest-first, grouped into blocks of
    ``batch_size * world_size`` (split) or ``batch_size`` (shuffle),
  * blocks are shuffled (or reversed to shortest-first when not random),
  * split writes one list per worker, interleaving batch-sized runs.

Length-grouped batching keeps padding waste low.
"""

from __future__ import annotations

import random
from typing import List, Tuple


def _read_len_file(path: str, min_len: int, max_len: int) -> List[Tuple[str, int]]:
    tuples = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            uttid, uttlen = parts[0], int(parts[1])
            if min_len <= uttlen <= max_len:
                tuples.append((uttid, uttlen))
    return tuples


def split_by_length(
    feats_len_path: str,
    batch_size: int = 16,
    world_size: int = 8,
    min_len: int = 0,
    max_len: int = 3000,
    full_batch: bool = False,
    shuffle: bool = False,
    seed: int = None,
) -> List[str]:
    """Split an ``uttid length`` file into per-worker length-grouped lists.

    Writes ``{feats_len_path}.{worker}`` files and returns their paths.
    """
    tuples = _read_len_file(feats_len_path, min_len, max_len)
    tuples.sort(key=lambda t: t[1], reverse=True)
    block = batch_size * world_size
    n = len(tuples) // block * block if full_batch else len(tuples)
    blocks = [tuples[i : i + block] for i in range(0, n, block)]
    if shuffle:
        rng = random.Random(seed)
        rng.shuffle(blocks)
    else:
        blocks.reverse()
    paths = [f"{feats_len_path}.{i}" for i in range(world_size)]
    files = [open(p, "w", encoding="utf-8") for p in paths]
    try:
        for blk in blocks:
            for i in range(world_size):
                for j in range(batch_size):
                    k = i * batch_size + j
                    if k < len(blk):
                        files[i].write(f"{blk[k][0]} {blk[k][1]}\n")
    finally:
        for f in files:
            f.close()
    return paths


def shuffle_by_length(
    feats_len_path: str,
    out_path: str,
    batch_size: int = 16,
    max_len: int = 3000,
    full_batch: bool = False,
    shuffle: bool = False,
    seed: int = None,
) -> None:
    """Write a single length-grouped (optionally shuffled) list, the order
    of utterances for batch decoding."""
    tuples = _read_len_file(feats_len_path, 0, max_len)
    tuples.sort(key=lambda t: t[1], reverse=True)
    n = len(tuples) // batch_size * batch_size if full_batch else len(tuples)
    blocks = [tuples[i : i + batch_size] for i in range(0, n, batch_size)]
    if shuffle:
        rng = random.Random(seed)
        rng.shuffle(blocks)
    else:
        blocks.reverse()
    with open(out_path, "w", encoding="utf-8") as f:
        for blk in blocks:
            for uttid, uttlen in blk:
                f.write(f"{uttid} {uttlen}\n")
