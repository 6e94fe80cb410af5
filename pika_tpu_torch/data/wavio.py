"""RIFF/WAVE reading and writing in numpy (the port's own copy of
``pika_tpu/data/wavio.py``): PCM 16/24/32-bit (and 8-bit) and IEEE float
32/64, mono or multi-channel, plus Kaldi-style pipe entries in wav.scp (an
entry ending in ``|`` is run through a shell and its stdout parsed)."""

from __future__ import annotations

import io
import os
import struct
import subprocess
from typing import Tuple, Union

import numpy as np

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


def _parse_riff(data: bytes) -> Tuple[np.ndarray, int]:
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    n = len(data)
    while pos + 8 <= n:
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            if fmt[0] == _EXTENSIBLE and len(body) >= 26:
                # the sub-format GUID's first two bytes carry the real tag
                (sub_format,) = struct.unpack("<H", body[24:26])
                fmt = (sub_format,) + fmt[1:]
        elif chunk_id == b"data":
            if fmt is None:
                raise ValueError("data chunk before fmt chunk")
            audio_format, channels, rate, _, _, bits = fmt
            if audio_format == _EXTENSIBLE:
                raise ValueError("extensible WAV without readable sub-format")
            if audio_format == _PCM:
                if bits == 16:
                    arr = np.frombuffer(body, dtype="<i2")
                elif bits == 32:
                    arr = np.frombuffer(body, dtype="<i4")
                elif bits == 8:
                    arr = (np.frombuffer(body, dtype=np.uint8).astype(np.int16) - 128) << 8
                elif bits == 24:
                    raw = np.frombuffer(body[: len(body) - len(body) % 3], dtype=np.uint8)
                    raw = raw.reshape(-1, 3)
                    arr = (
                        raw[:, 0].astype(np.int32)
                        | (raw[:, 1].astype(np.int32) << 8)
                        | (raw[:, 2].astype(np.int32) << 16)
                    )
                    # left-align to full int32 scale (sign lands at bit 31),
                    # so int32 samples are uniformly full-scale regardless of
                    # source depth — to_float32 / int16 conversion then only
                    # need the container dtype, like the 8-bit branch above
                    arr = arr << 8
                else:
                    raise ValueError(f"unsupported PCM bit depth {bits}")
            elif audio_format == _IEEE_FLOAT:
                arr = np.frombuffer(body, dtype="<f4" if bits == 32 else "<f8")
            else:
                raise ValueError(f"unsupported WAVE format tag {audio_format}")
            if channels > 1:
                arr = arr[: (len(arr) // channels) * channels].reshape(-1, channels)
            samples = arr
        pos += 8 + chunk_size + (chunk_size & 1)
        if samples is not None and fmt is not None:
            break
    if samples is None:
        raise ValueError("no data chunk found")
    return samples, fmt[2]


def read_wav(source: Union[str, bytes, os.PathLike, io.IOBase]) -> Tuple[np.ndarray, int]:
    """Read a WAV file and return ``(samples, sample_rate)``.

    ``samples`` keeps the on-disk integer container dtype for PCM
    (int16/int32), as Kaldi's wave representation does.  8- and 24-bit sources are left-aligned to
    full int16/int32 scale, so integer samples are always full-scale for
    their dtype (``pcm_to_int16`` / ``segment.to_float32`` rely on this).

    ``source`` may be a path, raw bytes, a file object, or a Kaldi-style
    pipe command ending in ``|``.
    """
    if isinstance(source, bytes):
        return _parse_riff(source)
    if hasattr(source, "read"):
        return _parse_riff(source.read())
    text = os.fspath(source)
    if text.rstrip().endswith("|"):
        cmd = text.rstrip().rstrip("|")
        out = subprocess.run(cmd, shell=True, check=True, stdout=subprocess.PIPE).stdout
        return _parse_riff(out)
    with open(text, "rb") as f:
        return _parse_riff(f.read())


def pcm_to_int16(samples: np.ndarray) -> np.ndarray:
    """Convert integer PCM to int16 by scale, never by modulo wrap.

    int16 passes through; full-scale int32 (what read_wav returns for
    24/32-bit sources) shifts down to the top 16 bits.  A bare
    ``astype(np.int16)`` would keep the LOW 16 bits — full-scale noise —
    so any other integer dtype is rejected loudly.
    """
    samples = np.asarray(samples)
    if samples.dtype == np.int16:
        return samples
    if samples.dtype == np.int32:
        return (samples >> 16).astype(np.int16)
    raise TypeError(
        f"integer PCM must be int16 or full-scale int32, got {samples.dtype}")


def write_wav(path: Union[str, os.PathLike], samples: np.ndarray, sample_rate: int) -> None:
    """Write mono/multi-channel samples as a PCM16 or float32 WAV.

    Integer input follows the ``pcm_to_int16`` convention: int16 passes
    through bit-exact; int32 is assumed FULL-SCALE (as read_wav returns
    for 24/32-bit sources) and is shifted down to its top 16 bits.  An
    int32 array merely *holding* 16-bit-range samples would come out
    ~65536x attenuated, so it is rejected."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        channels = 1
    else:
        channels = samples.shape[1]
    if samples.dtype == np.float32 or samples.dtype == np.float64:
        body = samples.astype("<f4").tobytes()
        audio_format, bits = _IEEE_FLOAT, 32
    else:
        if samples.dtype == np.int32 and samples.size:
            peak = int(np.abs(samples).max())
            if 0 < peak <= 0x7FFF:
                raise ValueError(
                    "write_wav: int32 input peaks at "
                    f"{peak} (<= int16 full scale) — int32 is treated as "
                    "full-scale PCM and shifted >>16, which would write "
                    "near-silence.  Cast 16-bit-range samples to int16.")
        body = pcm_to_int16(samples).astype("<i2").tobytes()
        audio_format, bits = _PCM, 16
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(body)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, audio_format, channels, sample_rate, byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(body)))
        f.write(body)
