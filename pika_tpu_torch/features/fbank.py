"""Kaldi-semantics log-mel filterbank, batched, on the tensor's device.

Port of ``pika_tpu/features/fbank.py``:

    frames -> (dither) -> remove-DC -> pre-emphasis -> window -> rFFT ->
    power spectrum -> mel filterbank matmul -> log

``FbankConfig``, ``feature_window`` and ``mel_banks_matrix`` are numpy copies
of the JAX package's helpers (that module imports JAX); the tests hold them
equal to the originals.  Input samples are in int16 scale.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from pika_tpu_torch.device import resolve_device

_FLT_EPSILON = float(np.finfo(np.float32).eps)


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    sample_frequency: float = 16000.0
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 0.0  # <= 0: offset from Nyquist
    dither: float = 1.0
    preemphasis_coefficient: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"
    round_to_power_of_two: bool = True
    use_log_fbank: bool = True
    use_power: bool = True
    snip_edges: bool = True

    @property
    def frame_length(self) -> int:
        return int(self.sample_frequency * 0.001 * self.frame_length_ms)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_frequency * 0.001 * self.frame_shift_ms)

    @property
    def padded_window_size(self) -> int:
        n = self.frame_length
        if self.round_to_power_of_two:
            p = 1
            while p < n:
                p *= 2
            return p
        return n

    @classmethod
    def from_conf(cls, path: str) -> "FbankConfig":
        """Parse a Kaldi-style conf file (e.g. egs/fbank.conf)."""
        kv = {}
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.split("#")[0].strip()
                if not line.startswith("--"):
                    continue
                key, _, val = line[2:].partition("=")
                kv[key.strip().replace("-", "_")] = val.strip()

        def flag(s):
            return s.lower() == "true"

        mapping = {
            "sample_frequency": ("sample_frequency", float),
            "frame_length": ("frame_length_ms", float),
            "frame_shift": ("frame_shift_ms", float),
            "num_mel_bins": ("num_mel_bins", int),
            "low_freq": ("low_freq", float),
            "high_freq": ("high_freq", float),
            "dither": ("dither", float),
            "preemphasis_coefficient": ("preemphasis_coefficient", float),
            "remove_dc_offset": ("remove_dc_offset", flag),
            "window_type": ("window_type", str),
            "round_to_power_of_two": ("round_to_power_of_two", flag),
            "use_log_fbank": ("use_log_fbank", flag),
            "use_power": ("use_power", flag),
            "snip_edges": ("snip_edges", flag),
        }
        kwargs = {}
        for key, val in kv.items():
            if key in mapping:
                field, conv = mapping[key]
                kwargs[field] = conv(val)
        return cls(**kwargs)


def feature_window(config: FbankConfig, dtype=np.float64) -> np.ndarray:
    """The analysis window function (feature-window.cc:FeatureWindowFunction)."""
    n = config.frame_length
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if config.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif config.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif config.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif config.window_type == "rectangular":
        w = np.ones(n)
    elif config.window_type == "blackman":
        blackman_coeff = 0.42
        w = blackman_coeff - 0.5 * np.cos(a * i) + (0.5 - blackman_coeff) * np.cos(2 * a * i)
    else:
        raise ValueError(f"unknown window type {config.window_type}")
    return w.astype(dtype)


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_banks_matrix(config: FbankConfig, dtype=np.float64) -> np.ndarray:
    """Dense (num_fft_bins, num_mel_bins) mel weight matrix over fft bins
    ``[0, padded_window/2)`` (mel-computations.cc); negative high_freq means
    Nyquist + high_freq."""
    num_fft_bins = config.padded_window_size // 2
    nyquist = 0.5 * config.sample_frequency
    low_freq = config.low_freq
    high_freq = config.high_freq if config.high_freq > 0.0 else nyquist + config.high_freq
    if not (0.0 <= low_freq < nyquist and 0.0 < high_freq <= nyquist and low_freq < high_freq):
        raise ValueError(f"bad mel frequency range [{low_freq}, {high_freq}]")
    fft_bin_width = config.sample_frequency / config.padded_window_size
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (config.num_mel_bins + 1)

    mel = mel_scale(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))
    bins = np.arange(config.num_mel_bins, dtype=np.float64)
    left = mel_low + bins * mel_delta
    center = mel_low + (bins + 1.0) * mel_delta
    right = mel_low + (bins + 2.0) * mel_delta
    up = (mel[:, None] - left[None, :]) / (center - left)[None, :]
    down = (right[None, :] - mel[:, None]) / (right - center)[None, :]
    weights = np.where((mel[:, None] > left) & (mel[:, None] < right), np.minimum(up, down), 0.0)
    return np.maximum(weights, 0.0).astype(dtype)


def make_fbank_fn(config: FbankConfig, max_samples: int, device=None):
    """Build a batched fbank over padded waveforms on ``device`` (the CUDA
    card unless the caller names another, e.g. ``"cpu"``).

    Returns ``fbank(waveforms[B, max_samples], num_samples[B], generator=None,
    noise=None) -> (feats[B, max_frames, num_mel_bins], frame_lens[B])``.
    Frames past an element's true length are computed on padding and must be
    masked by the caller through ``frame_lens``.  Dither is drawn from
    ``generator`` when one is given and ``config.dither`` is non-zero;
    ``noise`` (B, frames, frame_length) gives the dither's unit normal draws
    instead (the data prep draws them with numpy, as the JAX tool does).
    """
    flen, fshift = config.frame_length, config.frame_shift
    padded = config.padded_window_size
    max_frames = max(0, 1 + (max_samples - flen) // fshift)
    device = resolve_device(device)
    window = torch.as_tensor(feature_window(config, np.float32), device=device)
    mel = torch.as_tensor(mel_banks_matrix(config, np.float32), device=device)
    preemph = config.preemphasis_coefficient

    def fbank(waveforms: torch.Tensor, num_samples: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None):
        x = waveforms.float()
        frames = x.unfold(1, flen, fshift)  # (B, max_frames, flen), a view
        if config.dither != 0.0 and noise is not None:
            frames = frames + config.dither * noise
        elif config.dither != 0.0 and generator is not None:
            frames = frames + config.dither * torch.randn(
                frames.shape, generator=generator, device=frames.device)
        if config.remove_dc_offset:
            frames = frames - frames.mean(dim=-1, keepdim=True)
        if preemph != 0.0:
            shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
            frames = frames - preemph * shifted
        frames = frames * window
        # rFFT in place of the TPU's matmul-DFT; the mel banks read bins [0, padded/2)
        spec = torch.fft.rfft(frames, n=padded, dim=-1)[..., : padded // 2]
        power = spec.real ** 2 + spec.imag ** 2
        if not config.use_power:
            power = torch.sqrt(power)
        energies = power @ mel
        if config.use_log_fbank:
            energies = torch.log(torch.clamp(energies, min=_FLT_EPSILON))
        frame_lens = torch.clamp(1 + torch.div(num_samples - flen, fshift, rounding_mode="floor"),
                                 min=0)
        return energies, frame_lens

    return fbank
