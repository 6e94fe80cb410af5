"""Kaldi's log-mel filterbank and frame splicing in plain PyTorch: the
reference's featurizer.

Per frame of 25 ms every 10 ms (snip edges): dither (a unit normal draw
times ``dither``), removal of the frame's mean, pre-emphasis, the analysis
window, the power spectrum of a 512-point FFT, the triangular mel banks of
Kaldi's ``mel-computations.cc`` and the log floored at float32's epsilon.
Then each frame is spliced with ``lctx`` frames before and ``rctx`` after,
the edges replicated.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FLT_EPS = float(np.finfo(np.float32).eps)


def window(kind: str, n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    a = 2.0 * math.pi / (n - 1)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(a * i)
    if kind == "hanning":
        return 0.5 - 0.5 * np.cos(a * i)
    if kind == "povey":
        return (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    raise ValueError(f"window {kind!r} is not in the reference")


def mel_matrix(bins: int, fft_size: int, rate: float, low: float, high: float) -> np.ndarray:
    """(fft_size // 2, bins) triangular weights over FFT bins; ``high <= 0``
    counts back from the Nyquist frequency."""
    nyquist = rate / 2
    high = high if high > 0 else nyquist + high

    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    lo, hi = mel(low), mel(high)
    delta = (hi - lo) / (bins + 1)
    m = mel(rate / fft_size * np.arange(fft_size // 2))[:, None]
    left = lo + delta * np.arange(bins)[None, :]
    center, right = left + delta, left + 2 * delta
    w = np.minimum((m - left) / (center - left), (right - m) / (right - center))
    return np.where((m > left) & (m < right), np.maximum(w, 0.0), 0.0)


def fbank(wavs: torch.Tensor, feat: dict, generator: torch.Generator = None) -> torch.Tensor:
    """(B, samples) int16-scale waveforms -> (B, frames, num_mel_bins) log
    mel energies; the dither is drawn from ``generator`` when one is given
    (``torch.randn`` over the (B, frames, frame length) frames)."""
    rate = feat["sample_frequency"]
    flen, shift = int(rate * 0.025), int(rate * 0.010)
    fft_size = 1 << (flen - 1).bit_length()
    dev = wavs.device
    frames = wavs.float().unfold(1, flen, shift)
    if generator is not None and feat["dither"] != 0.0:
        frames = frames + feat["dither"] * torch.randn(frames.shape, generator=generator,
                                                       device=dev)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = frames - 0.97 * torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames * torch.tensor(window(feat["window_type"], flen), dtype=torch.float32,
                                   device=dev)
    spec = torch.fft.rfft(frames, n=fft_size, dim=-1)[..., :fft_size // 2]
    power = spec.real ** 2 + spec.imag ** 2
    mel = torch.tensor(mel_matrix(feat["num_mel_bins"], fft_size, rate, feat["low_freq"],
                                  feat["high_freq"]), dtype=torch.float32, device=dev)
    return torch.log(torch.clamp(power @ mel, min=FLT_EPS))


def splice(feats: torch.Tensor, lctx: int, rctx: int) -> torch.Tensor:
    """(B, T, D) -> (B, T, D * (lctx + 1 + rctx)), edges replicated."""
    t = feats.shape[1]
    idx = (torch.arange(t, device=feats.device)[:, None]
           + torch.arange(-lctx, rctx + 1, device=feats.device)).clamp(0, t - 1)
    return feats[:, idx].flatten(2)


def global_cmvn(wavs: torch.Tensor, feat: dict) -> tuple:
    """Global CMVN as a recipe's data preparation computes it over its
    corpus, here over ``wavs``: (offset, scale) = (-mean, 1 / std) of every
    spliced feature, without dither."""
    x = splice(fbank(wavs, feat), feat["lctx"], feat["rctx"]).flatten(0, 1)
    return -x.mean(0), torch.rsqrt(x.var(0) + 1e-10)


def spec_augment(feats: torch.Tensor, max_freq: int, max_time: int,
                 generator: torch.Generator) -> torch.Tensor:
    """One band of features and one span of frames zeroed across the batch:
    widths uniform over [0, max], starts uniform over [0, size - width],
    drawn from ``generator`` in that order (two ``randint``, two ``rand``)."""
    _, t, d = feats.shape
    dev = feats.device
    f_w = torch.randint(0, max_freq + 1, (), generator=generator, device=dev)
    t_w = torch.randint(0, max_time + 1, (), generator=generator, device=dev)

    def start(size, width):
        hi = torch.clamp(size - width + 1, min=1)
        u = torch.rand((), generator=generator, device=dev)
        return torch.minimum((u * hi).long(), hi - 1)

    f0, t0 = start(d, f_w), start(t, t_w)
    f_idx = torch.arange(d, device=dev)
    t_idx = torch.arange(t, device=dev)
    drop = (((f_idx >= f0) & (f_idx < f0 + f_w))[None, :]
            | ((t_idx >= t0) & (t_idx < t0 + t_w))[:, None])
    return feats * (~drop).float()
