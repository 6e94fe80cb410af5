"""Kaldi binary/text archive readers and writers for feature matrices
(the port's own copy of ``pika_tpu/data/kaldi_ark.py``, numpy):

  * binary float/double matrices ("\\0B" + "FM "/"DM " + per-dim
    int32 sizes) and vectors ("FV "/"DV "), and the compressed matrices
    ("CM", "CM2", "CM3")
  * text matrices ("[" rows "]")
  * ``ark`` streams of ``uttid <obj>`` records and ``scp`` files of
    ``uttid path:offset`` pointers
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np


def _read_token(f) -> str:
    tok = b""
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        tok += c
    return tok.decode()


def _read_basic_int(f) -> int:
    size = f.read(1)[0]
    if size == 4:
        return struct.unpack("<i", f.read(4))[0]
    if size == 8:
        return struct.unpack("<q", f.read(8))[0]
    raise ValueError(f"unexpected int size marker {size}")


def read_kaldi_object(f) -> np.ndarray:
    """Read one Kaldi object (matrix/vector, binary or text) at the
    current position."""
    start = f.read(2)
    if start == b"\0B":
        tok = _read_token(f)
        if tok in ("FM", "DM"):
            dtype = "<f4" if tok == "FM" else "<f8"
            rows = _read_basic_int(f)
            cols = _read_basic_int(f)
            data = np.frombuffer(f.read(rows * cols * np.dtype(dtype).itemsize), dtype=dtype)
            return data.reshape(rows, cols).astype(np.float32)
        if tok in ("FV", "DV"):
            dtype = "<f4" if tok == "FV" else "<f8"
            n = _read_basic_int(f)
            return np.frombuffer(f.read(n * np.dtype(dtype).itemsize), dtype=dtype).astype(np.float32)
        if tok in ("CM", "CM2", "CM3"):
            return _read_compressed(f, tok)
        raise ValueError(f"unknown Kaldi binary object {tok!r}")
    # text object: read until the closing bracket.  The 2-byte binary
    # probe may already contain the opening '[' — count brackets in it
    # too, or the depth match runs to EOF and swallows later records.
    text = start.decode(errors="replace")
    depth = 0
    started = False
    for ch in text:
        if ch == "[":
            depth += 1
            started = True
        elif ch == "]":
            depth -= 1
    while not (started and depth == 0):
        c = f.read(1)
        if not c:
            break
        ch = c.decode(errors="replace")
        text += ch
        if ch == "[":
            depth += 1
            started = True
        elif ch == "]":
            depth -= 1
    rows = [r for r in text.replace("[", " ").replace("]", " ").splitlines() if r.strip()]
    return np.array([[float(x) for x in r.split()] for r in rows], dtype=np.float32)


def _read_compressed(f, tok: str) -> np.ndarray:
    """Decode a Kaldi CompressedMatrix payload positioned after its token.

    Layout per kaldi/src/matrix/compressed-matrix.cc: ``Write`` emits the
    format token ("CM" = one-byte-with-column-headers, "CM2" = two-byte,
    "CM3" = one-byte) followed by the GlobalHeader minus its leading
    format int32 — ``float min_value, float range, int32 num_rows, int32
    num_cols`` — then the payload.  "CM" stores 8 bytes of per-column
    uint16 percentiles (p0/p25/p75/p100, each scaled into
    [min, min+range] by u/65535) followed by column-major uint8 codes
    decoded piecewise-linearly between the percentiles (``CharToFloat``:
    0-64 -> [p0,p25], 64-192 -> [p25,p75], 192-255 -> [p75,p100]).
    "CM2" stores row-major uint16 codes (u/65535 of the global range);
    "CM3" row-major uint8 codes (u/255).
    """
    min_value, rng = struct.unpack("<ff", f.read(8))
    rows, cols = struct.unpack("<ii", f.read(8))
    if rows < 0 or cols < 0:
        raise ValueError(f"corrupt compressed matrix header {rows}x{cols}")
    if tok == "CM2":
        data = np.frombuffer(f.read(rows * cols * 2), dtype="<u2")
        return (min_value + rng * (1.0 / 65535.0) * data.astype(np.float32)
                ).reshape(rows, cols)
    if tok == "CM3":
        data = np.frombuffer(f.read(rows * cols), dtype=np.uint8)
        return (min_value + rng * (1.0 / 255.0) * data.astype(np.float32)
                ).reshape(rows, cols)
    # "CM": per-column percentile headers, then column-major uint8 codes.
    pch = np.frombuffer(f.read(cols * 8), dtype="<u2").reshape(cols, 4)
    perc = (min_value + rng * (1.0 / 65535.0) * pch.astype(np.float32))
    codes = np.frombuffer(f.read(cols * rows), dtype=np.uint8).reshape(cols, rows)
    c = codes.astype(np.float32)
    p0, p25, p75, p100 = (perc[:, i : i + 1] for i in range(4))
    low = p0 + (p25 - p0) * (c * (1.0 / 64.0))
    mid = p25 + (p75 - p25) * ((c - 64.0) * (1.0 / 128.0))
    high = p75 + (p100 - p75) * ((c - 192.0) * (1.0 / 63.0))
    out = np.where(codes <= 64, low, np.where(codes <= 192, mid, high))
    return np.ascontiguousarray(out.T)


def _float_to_uint16(min_value: float, rng: float, x: np.ndarray) -> np.ndarray:
    # compressed-matrix.cc FloatToUint16: scale into [0,65535] with the
    # +0.5 round and the exact-65535 guard for values at the range top.
    f = (x - min_value) / (rng if rng > 0 else 1.0)
    return np.clip(f * 65535.0 + 0.499, 0.0, 65535.0).astype("<u2")


def compress_matrix(mat: np.ndarray, fmt: int = 1) -> bytes:
    """Compress per Kaldi's CompressedMatrix formats (1="CM", 2="CM2",
    3="CM3"), returning the token+payload bytes as ``Write`` emits them
    (everything after the "\\0B" binary marker).  Used for interchange
    tests and for writing Kaldi-readable compressed archives."""
    mat = np.asarray(mat, np.float32)
    rows, cols = mat.shape
    min_value = float(mat.min()) if mat.size else 0.0
    rng = (float(mat.max()) - min_value) if mat.size else 1.0
    if rng <= 0:
        rng = 1.0
    header = struct.pack("<ffii", min_value, rng, rows, cols)
    if fmt == 2:
        codes = _float_to_uint16(min_value, rng, mat)
        return b"CM2 " + header + codes.astype("<u2").tobytes()
    if fmt == 3:
        f = (mat - min_value) / rng
        codes = np.clip(f * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
        return b"CM3 " + header + codes.tobytes()
    if fmt != 1:
        raise ValueError(f"unknown compression format {fmt}")
    # format 1: per-column percentiles from sorted codes (ComputeColHeader
    # uses order statistics at 0/25/75/100% with minimum separations).
    pchs = []
    payload = []
    for j in range(cols):
        col = np.sort(_float_to_uint16(min_value, rng, mat[:, j]).astype(np.int64))
        n = rows
        if n:
            q25 = min(col[n // 4], 65532)
            q75 = min(max(col[(3 * n) // 4], q25 + 1), 65533)
            p0 = min(col[0], q25 - 1 if q25 > 0 else 0)
            p0 = max(p0, 0)
            q25 = max(q25, p0 + 1)
            q75 = max(q75, q25 + 1)
            p100 = max(col[-1], q75 + 1)
            p100 = min(p100, 65535)
        else:
            p0, q25, q75, p100 = 0, 1, 2, 3
        pchs.append(struct.pack("<HHHH", p0, q25, q75, p100))
        f0, f25, f75, f100 = (min_value + rng * (v / 65535.0)
                              for v in (p0, q25, q75, p100))
        x = mat[:, j]
        codes = np.empty(rows, np.uint8)
        lo = x <= f25
        hi = x >= f75
        mi = ~(lo | hi)
        d25 = (f25 - f0) or 1.0
        d75 = (f75 - f25) or 1.0
        d100 = (f100 - f75) or 1.0
        codes[lo] = np.clip((x[lo] - f0) / d25 * 64.0 + 0.5, 0, 64)
        codes[mi] = np.clip(64.0 + (x[mi] - f25) / d75 * 128.0 + 0.5, 64, 192)
        codes[hi] = np.clip(192.0 + (x[hi] - f75) / d100 * 63.0 + 0.5, 192, 255)
        payload.append(codes.tobytes())
    return b"CM " + header + b"".join(pchs) + b"".join(payload)


def iter_matrix_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate ``uttid matrix`` records of a Kaldi .ark file."""
    with open(path, "rb") as f:
        while True:
            uttid = b""
            while True:
                c = f.read(1)
                if not c:
                    return
                if c in b" \t":
                    if uttid:
                        break
                    continue  # pad between records
                if c in b"\r\n":
                    # text objects end with ']\n'; the newline belongs to
                    # the previous record, not the next uttid
                    if uttid:
                        raise ValueError(
                            f"malformed ark {path}: uttid {uttid!r} not "
                            "followed by a space")
                    continue
                uttid += c
            yield uttid.decode(), read_kaldi_object(f)


def read_matrix_scp(path: str) -> Dict[str, Tuple[str, int]]:
    """Parse a feats.scp of ``uttid ark_path:byte_offset`` pointers."""
    out = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            ark, _, off = parts[1].rpartition(":")
            out[parts[0]] = (ark, int(off))
    return out


def read_matrix_at(ark_path: str, offset: int) -> np.ndarray:
    with open(ark_path, "rb") as f:
        f.seek(offset)
        return read_kaldi_object(f)


def iter_matrices_scp(scp_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    for uttid, (ark, off) in read_matrix_scp(scp_path).items():
        yield uttid, read_matrix_at(ark, off)


def write_matrix_ark(path: str, items) -> str:
    """Write ``uttid matrix`` records in Kaldi binary format; also emits a
    companion .scp file.  Returns the scp path."""
    scp_path = path + ".scp"
    with open(path, "wb") as f, open(scp_path, "w", encoding="utf-8") as scp:
        for uttid, mat in items:
            mat = np.asarray(mat, np.float32)
            f.write(uttid.encode() + b" ")
            offset = f.tell()
            f.write(b"\0BFM ")
            f.write(bytes([4]) + struct.pack("<i", mat.shape[0]))
            f.write(bytes([4]) + struct.pack("<i", mat.shape[1]))
            f.write(mat.astype("<f4").tobytes())
            scp.write(f"{uttid} {path}:{offset}\n")
    return scp_path
