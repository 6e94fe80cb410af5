"""CLI plumbing shared by the entry points (port of part of
``pika_tpu/train/common.py``): the loader flags and the builders that turn
them into an fbank configuration and a featurizer."""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from pika_tpu_torch.data.cmvn import CmvnStats, offset_scale
from pika_tpu_torch.device import resolve_device
from pika_tpu_torch.features.fbank import FbankConfig
from pika_tpu_torch.train.step import FeaturizerConfig, make_featurizer


def add_loader_args(parser: argparse.ArgumentParser) -> None:
    """Loader flags, the JAX package's set (the reference's
    ``loader/otf_utt_loader.py:68-114``)."""
    parser.add_argument("--lctx", type=int, default=1)
    parser.add_argument("--rctx", type=int, default=1)
    parser.add_argument("--max_len", type=int, default=6000)
    parser.add_argument("--num_workers", type=int, default=2)
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--batch_first", action="store_true")
    parser.add_argument("--reverse_labels", action="store_true")
    parser.add_argument("--feat_config", type=str, default=None)
    parser.add_argument("--stride", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--SOS", type=int, default=-1)
    parser.add_argument("--EOS", type=int, default=-1)
    parser.add_argument("--queue_size", type=int, default=8)
    parser.add_argument("--TU_limit", type=int, default=15000)
    parser.add_argument("--padding_tgt", type=int, default=0)
    parser.add_argument("--feats_dim", type=int, default=80)
    parser.add_argument("--gain_range", type=str, default="55,10")
    parser.add_argument("--speed_rate", type=str, default="0.9,1.0,1.1")
    parser.add_argument("--no_augment", action="store_true",
                        help="disable speed/gain perturbation")
    parser.add_argument("--noise_lst", type=str, default=None,
                        help="mrk/seq list of noise segments for on-the-fly mixing")
    parser.add_argument("--rir_lst", type=str, default=None,
                        help="mrk/seq list of room impulse responses (hook)")
    parser.add_argument("--snr_range", type=str, default="",
                        help="comma separated SNR range in dB, e.g. 0,20")
    parser.add_argument("--noise_prob", type=float, default=1.0,
                        help="fraction of utterances that get noise mixed in")
    parser.add_argument("--max_wav_seconds", type=float, default=20.0,
                        help="largest waveform bucket in seconds")


def fbank_from_args(args) -> FbankConfig:
    if args.feat_config:
        return FbankConfig.from_conf(args.feat_config)
    return FbankConfig(sample_frequency=args.sample_rate, window_type="hamming", dither=1.0,
                       low_freq=40.0, high_freq=-200.0, num_mel_bins=args.feats_dim)


def featurizer_from_args(args, spec_augment: Optional[bool] = None, device=None):
    """Returns (featurizer, input_dim, max_samples); the featurizer runs on
    ``device`` (the card unless the caller names another)."""
    fb = fbank_from_args(args)
    max_samples = int(args.max_wav_seconds * args.sample_rate)
    offset = scale = None
    if args.cmvn_stats:
        stats = CmvnStats.read(args.cmvn_stats)
        off, sc = offset_scale(stats.stats, splice_copies=args.lctx + 1 + args.rctx)
        offset, scale = (torch.from_numpy(x).to(resolve_device(device)) for x in (off, sc))
    cfg = FeaturizerConfig(
        fbank=fb, max_samples=max_samples, lctx=args.lctx, rctx=args.rctx, stride=args.stride,
        cmn=args.cmn, spec_augment=args.spec_augment if spec_augment is None else spec_augment,
        max_freq_span=args.max_freq_span, max_time_span=args.max_time_span)
    featurizer = make_featurizer(cfg, offset, scale, device=device)
    return featurizer, fb.num_mel_bins * (args.lctx + 1 + args.rctx), max_samples
