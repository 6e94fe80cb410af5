"""mrk/seq raw-PCM archives: writer and reader (the port's own copy of
``pika_tpu/data/archive.py``; the files are byte-identical to the JAX
writer's, and each package reads the other's).

Format:

  * ``seq``  — concatenated raw little-endian int16 PCM samples
  * ``mrk``  — one text line per utterance: ``uttid byte_offset num_bytes``

Archives shard every ``num_wav_per_seq`` (default 2000)
utterances, appending ``.0``, ``.1``, ... suffixes.
"""

from __future__ import annotations

import io
from typing import Iterator, List, Optional, Tuple

import numpy as np

from pika_tpu_torch.data.wavio import pcm_to_int16, read_wav


class MrkSeqWriter:
    """Sharded mrk/seq archive writer."""

    def __init__(self, mrk_prefix: str, seq_prefix: str, num_wav_per_seq: int = 2000):
        self.mrk_prefix = mrk_prefix
        self.seq_prefix = seq_prefix
        self.num_wav_per_seq = num_wav_per_seq
        self._shard = -1
        self._offset = 0
        self._count = 0
        self._mrk: Optional[io.TextIOBase] = None
        self._seq: Optional[io.BufferedWriter] = None
        self.shards: List[Tuple[str, str]] = []

    def _roll(self) -> None:
        self.close()
        self._shard += 1
        self._offset = 0
        mrk_path = f"{self.mrk_prefix}.{self._shard}"
        seq_path = f"{self.seq_prefix}.{self._shard}"
        self._mrk = open(mrk_path, "w", encoding="utf-8")
        self._seq = open(seq_path, "wb")
        self.shards.append((mrk_path, seq_path))

    def write(self, uttid: str, samples: np.ndarray) -> None:
        if self._count % self.num_wav_per_seq == 0:
            self._roll()
        pcm = np.asarray(samples)
        if pcm.dtype != np.int16:
            if np.issubdtype(pcm.dtype, np.floating):
                pcm = np.clip(pcm * 32768.0, -32768, 32767).astype(np.int16)
            else:
                # scale, never modulo-wrap: int32 sources (24/32-bit wavs)
                # keep their top 16 bits instead of becoming noise
                pcm = pcm_to_int16(pcm)
        raw = pcm.astype("<i2").tobytes()
        self._seq.write(raw)
        self._mrk.write(f"{uttid} {self._offset} {len(raw)}\n")
        self._offset += len(raw)
        self._count += 1

    def close(self) -> None:
        if self._mrk is not None:
            self._mrk.close()
            self._seq.close()
            self._mrk = self._seq = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MrkSeqReader:
    """Random/sequential reader over one mrk/seq shard pair.

    Seek to ``offset``, read ``num_bytes`` (truncated to an even count),
    reinterpret as int16.
    """

    def __init__(self, mrk_path: str, seq_path: str):
        self.entries: List[Tuple[str, int, int]] = []
        with open(mrk_path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    self.entries.append((parts[0], int(parts[1]), int(parts[2])))
        self._seq = open(seq_path, "rb")

    def __len__(self) -> int:
        return len(self.entries)

    def read_entry(self, idx: int) -> Tuple[str, np.ndarray]:
        uttid, offset, num_bytes = self.entries[idx]
        num_bytes -= num_bytes % 2
        self._seq.seek(offset)
        raw = self._seq.read(num_bytes)
        return uttid, np.frombuffer(raw, dtype="<i2")

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        for i in range(len(self.entries)):
            yield self.read_entry(i)

    def close(self) -> None:
        self._seq.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def wav_scp_to_mrk_seq(wav_scp: str, out_mrk: str, out_seq: str, num_wav_per_seq: int = 2000) -> List[Tuple[str, str]]:
    """Convert a wav.scp to sharded mrk/seq archives; returns the
    (mrk, seq) path of each shard."""
    from pika_tpu_torch.data.scp import read_wav_scp

    with MrkSeqWriter(out_mrk, out_seq, num_wav_per_seq) as w:
        for uttid, src in read_wav_scp(wav_scp).items():
            samples, _rate = read_wav(src)
            if samples.ndim > 1:
                samples = samples[:, 0]
            w.write(uttid, samples)
        return list(w.shards)


def wav_scp_to_bytes(wav_scp: str, out_path: str) -> None:
    """Write ``uttid num_bytes`` per utterance (2 bytes per int16 sample)."""
    from pika_tpu_torch.data.scp import read_wav_scp

    with open(out_path, "w", encoding="utf-8") as f:
        for uttid, src in read_wav_scp(wav_scp).items():
            samples, _ = read_wav(src)
            if samples.ndim > 1:
                samples = samples[:, 0]
            f.write(f"{uttid} {2 * len(samples)}\n")
