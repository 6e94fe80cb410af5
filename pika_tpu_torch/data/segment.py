"""Sample-format conversions the decode CLI uses (the port's own copy of
``to_float32`` and ``from_float32`` of ``pika_tpu/data/segment.py``; the
augmentations wait for the loader's port)."""

from __future__ import annotations

import numpy as np


def to_float32(samples: np.ndarray) -> np.ndarray:
    """Convert int PCM to [-1, 1) float32 (floats pass through); average
    the channels of a multi-channel array."""
    samples = np.asarray(samples)
    if np.issubdtype(samples.dtype, np.integer):
        bits = np.iinfo(samples.dtype).bits
        out = samples.astype(np.float32) * np.float32(1.0 / 2 ** (bits - 1))
    elif np.issubdtype(samples.dtype, np.floating):
        out = samples.astype(np.float32)
    else:
        raise TypeError(f"unsupported sample dtype {samples.dtype}")
    if out.ndim >= 2:
        out = np.mean(out, axis=1)
    return out


def from_float32(samples: np.ndarray, dtype="int16") -> np.ndarray:
    """Rescale [-1, 1) float32 to an integer dtype with saturation."""
    dtype = np.dtype(dtype)
    out = samples.copy()
    if np.issubdtype(dtype, np.integer):
        bits = np.iinfo(dtype).bits
        out = out * float(2 ** (bits - 1))
        out = np.clip(out, np.iinfo(dtype).min, np.iinfo(dtype).max)
    return out.astype(dtype)
