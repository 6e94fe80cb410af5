"""Monaural audio segment DSP: the sample-format conversions and the
augmentation toolbox of the training loader (the port's own copy of
``pika_tpu/data/segment.py``, numpy, operation for operation):

  * int samples are scaled to [-1, 1) float32 on ingest
  * ``change_speed`` is linear interpolation onto ``linspace(0, n, n/rate)``
  * ``normalize`` targets an RMS level in dB
  * ``add_noise`` mixes a random subsegment of noise at a given SNR;
    ``convolve`` applies an RIR through FFT convolution

All ops are pure functions over float32 arrays on the host.
"""

from __future__ import annotations

import numpy as np


def to_float32(samples: np.ndarray) -> np.ndarray:
    """Convert int PCM to [-1, 1) float32; pass floats through."""
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


def rms_db(samples: np.ndarray) -> float:
    mean_square = max(1e-20, float(np.mean(samples.astype(np.float64) ** 2)))
    return 10.0 * np.log10(mean_square)


def gain_db(samples: np.ndarray, gain: float) -> np.ndarray:
    return samples * np.float32(10.0 ** (gain / 20.0))


def normalize(samples: np.ndarray, target_db: float = -20.0, max_gain_db: float = 300.0) -> np.ndarray:
    """Normalize to a target RMS level in dB, capped at ``max_gain_db``."""
    gain = target_db - rms_db(samples)
    if gain > max_gain_db:
        raise ValueError(
            f"required gain {gain:.1f} dB exceeds max_gain_db {max_gain_db:.1f} dB"
        )
    return gain_db(samples, min(max_gain_db, gain))


def change_speed(samples: np.ndarray, speed_rate: float) -> np.ndarray:
    """Speed perturbation by linear interpolation (no pitch preservation)."""
    if speed_rate <= 0:
        raise ValueError("speed_rate should be greater than zero.")
    if speed_rate == 1.0:
        return samples
    old_length = samples.shape[0]
    new_length = int(old_length / speed_rate)
    old_indices = np.arange(old_length)
    new_indices = np.linspace(start=0, stop=old_length, num=new_length)
    return np.interp(new_indices, old_indices, samples).astype(np.float32)


def normalize_online_bayesian(
    samples: np.ndarray,
    sample_rate: int,
    target_db: float,
    prior_db: float,
    prior_samples: float,
    startup_delay: float = 0.0,
) -> np.ndarray:
    """Online/causal RMS normalization with a gamma prior (audio.py:264-303)."""
    n = samples.shape[0]
    startup_sample_idx = min(n - 1, int(sample_rate * startup_delay))
    prior_mean_squared = 10.0 ** (prior_db / 10.0)
    prior_sum_of_squares = prior_mean_squared * prior_samples
    cumsum_of_squares = np.cumsum(samples ** 2)
    sample_count = np.arange(n) + 1.0
    if startup_sample_idx > 0:
        cumsum_of_squares[:startup_sample_idx] = cumsum_of_squares[startup_sample_idx]
        sample_count[:startup_sample_idx] = sample_count[startup_sample_idx]
    mean_squared_estimate = (cumsum_of_squares + prior_sum_of_squares) / (
        sample_count + prior_samples
    )
    rms_estimate_db = 10.0 * np.log10(mean_squared_estimate)
    return samples * (10.0 ** ((target_db - rms_estimate_db) / 20.0)).astype(np.float32)


def resample(samples: np.ndarray, orig_rate: int, target_rate: int) -> np.ndarray:
    """Polyphase resampling (replaces the reference's resampy dependency)."""
    if orig_rate == target_rate:
        return samples
    from math import gcd

    from scipy import signal  # imported where used: it takes seconds

    g = gcd(orig_rate, target_rate)
    return signal.resample_poly(samples, target_rate // g, orig_rate // g).astype(np.float32)


def pad_silence(samples: np.ndarray, sample_rate: int, duration: float, sides: str = "both") -> np.ndarray:
    z = np.zeros(int(duration * sample_rate), dtype=samples.dtype)
    if sides == "beginning":
        return np.concatenate([z, samples])
    if sides == "end":
        return np.concatenate([samples, z])
    if sides == "both":
        return np.concatenate([z, samples, z])
    raise ValueError(f"Unknown value for sides: {sides}")


def shift(samples: np.ndarray, sample_rate: int, shift_ms: float) -> np.ndarray:
    """Time shift with zero fill; positive = advance."""
    if abs(shift_ms) / 1000.0 > samples.shape[0] / sample_rate:
        raise ValueError("shift_ms must be smaller than audio duration")
    shift_samples = int(shift_ms * sample_rate / 1000)
    out = samples.copy()
    if shift_samples > 0:
        out[:-shift_samples] = samples[shift_samples:]
        out[-shift_samples:] = 0
    elif shift_samples < 0:
        out[-shift_samples:] = samples[:shift_samples]
        out[:-shift_samples] = 0
    return out


def subsegment(samples: np.ndarray, sample_rate: int, start_sec=None, end_sec=None) -> np.ndarray:
    duration = samples.shape[0] / sample_rate
    start_sec = 0.0 if start_sec is None else start_sec
    end_sec = duration if end_sec is None else end_sec
    if start_sec < 0.0:
        start_sec += duration
    if end_sec < 0.0:
        end_sec += duration
    if not (0.0 <= start_sec <= end_sec <= duration + 1e-9):
        raise ValueError(f"bad subsegment bounds [{start_sec}, {end_sec}] of {duration}")
    return samples[int(round(start_sec * sample_rate)) : int(round(end_sec * sample_rate))]


def random_subsegment(samples: np.ndarray, sample_rate: int, subsegment_length: float, rng=None) -> np.ndarray:
    import random as _random

    rng = _random.Random() if rng is None else rng
    duration = samples.shape[0] / sample_rate
    if subsegment_length > duration:
        raise ValueError("subsegment longer than original segment")
    start = rng.uniform(0.0, duration - subsegment_length)
    return subsegment(samples, sample_rate, start, start + subsegment_length)


def convolve(samples: np.ndarray, impulse: np.ndarray) -> np.ndarray:
    """RIR convolution ('same' mode FFT convolution)."""
    from scipy import signal

    return signal.fftconvolve(samples, impulse, "same").astype(np.float32)


def convolve_and_normalize(samples: np.ndarray, impulse: np.ndarray) -> np.ndarray:
    target_db = rms_db(samples)
    return normalize(convolve(samples, impulse), target_db)


def add_noise(
    samples: np.ndarray,
    sample_rate: int,
    noise: np.ndarray,
    snr_dB: float,
    max_gain_db: float = 300.0,
    rng=None,
) -> np.ndarray:
    """Mix noise at the given SNR; noise must be at least as long."""
    if noise.shape[0] < samples.shape[0]:
        raise ValueError("noise must be at least as long as base signal")
    noise_gain = min(rms_db(samples) - rms_db(noise) - snr_dB, max_gain_db)
    duration = samples.shape[0] / sample_rate
    chunk = random_subsegment(noise, sample_rate, duration, rng=rng)
    chunk = chunk[: samples.shape[0]]
    out = samples.copy()
    out[: chunk.shape[0]] += gain_db(chunk, noise_gain)
    return out
