"""Data preparation CLI (port of ``pika_tpu/data/prep.py``; it takes the
JAX tool's command lines):

    python -m pika_tpu_torch.data.prep wav_to_seq WAV_SCP OUT_MRK OUT_SEQ
    python -m pika_tpu_torch.data.prep wav_to_bytes WAV_SCP OUT
    python -m pika_tpu_torch.data.prep split_by_length LENS --batch_size N --world_size W
    python -m pika_tpu_torch.data.prep shuffle_by_length LENS OUT --batch_size N
    python -m pika_tpu_torch.data.prep compute_global_cmvn DATA_LST OUT_STATS [--feat_config F]

Every subcommand takes ``--device``: the fbank of ``compute_global_cmvn``
runs there (``features/fbank.py``, float32), on the card unless the caller
names another (``--device cpu``).  Its random draws are the JAX tool's:
speed and gain from numpy seeded ``--seed``, the dither's normals from
numpy seeded ``--seed + 1``, so its statistics agree with the JAX tool's
(a float64 numpy fbank) to float32 rounding.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pika_tpu_torch.device import resolve_device


def _cmd_wav_to_seq(args):
    from pika_tpu_torch.data.archive import wav_scp_to_mrk_seq

    shards = wav_scp_to_mrk_seq(args.wav_scp, args.out_mrk, args.out_seq, args.num_wav_per_seq)
    for mrk, seq in shards:
        print(mrk, seq)


def _cmd_wav_to_bytes(args):
    from pika_tpu_torch.data.archive import wav_scp_to_bytes

    wav_scp_to_bytes(args.wav_scp, args.byte_file)


def _cmd_split(args):
    from pika_tpu_torch.data.lists import split_by_length

    paths = split_by_length(args.feats_len, args.batch_size, args.world_size, args.min_len,
                            args.max_len, args.full_batch, args.random, args.seed)
    print("\n".join(paths))


def _cmd_shuffle(args):
    from pika_tpu_torch.data.lists import shuffle_by_length

    shuffle_by_length(args.feats_len, args.feats_len_shuffled, args.batch_size, args.max_len,
                      args.full_batch, args.random, args.seed)


def _cmd_cmvn(args):
    """Global CMVN over augmented fbank features: the training loader's
    speed and gain perturbation, then the fbank, accumulated into Kaldi-format
    statistics."""
    from pika_tpu_torch.data import segment as seg
    from pika_tpu_torch.data.archive import MrkSeqReader
    from pika_tpu_torch.data.cmvn import CmvnStats
    from pika_tpu_torch.data.scp import read_data_lst
    from pika_tpu_torch.features.fbank import FbankConfig, make_fbank_fn

    if args.feat_config:
        fb = FbankConfig.from_conf(args.feat_config)
    else:
        fb = FbankConfig(sample_frequency=args.sample_rate, window_type="hamming", dither=1.0,
                         low_freq=40.0, high_freq=-200.0, num_mel_bins=args.feat_dim)
    device = args.device
    rng = np.random.default_rng(args.seed)
    dither_rng = np.random.default_rng(args.seed + 1) if fb.dither else None
    stats = CmvnStats(fb.num_mel_bins)
    speed_rates = [0.9, 1.0, 1.1]
    triplets = read_data_lst(args.data_lst)
    if not triplets:
        # 2-column fallback (`mrk seq` per line); blank and short lines skipped
        with open(args.data_lst) as lst_f:
            triplets = [(parts[0], parts[1], "") for parts in (line.split() for line in lst_f)
                        if len(parts) >= 2]
    for mrk_fn, seq_fn, _ in triplets:
        with MrkSeqReader(mrk_fn, seq_fn) as reader:
            for _, pcm in reader:
                x = seg.to_float32(pcm)
                x = seg.change_speed(x, speed_rates[int(rng.integers(0, 3))])
                if not args.no_normalize:
                    x = seg.normalize(x, float(rng.uniform(-55, -10)))
                x16 = seg.from_float32(x, "int16")
                n_frames = max(0, 1 + (len(x16) - fb.frame_length) // fb.frame_shift)
                if n_frames == 0:
                    continue
                noise = None
                if dither_rng is not None:
                    noise = torch.from_numpy(
                        dither_rng.standard_normal((1, n_frames, fb.frame_length))
                        .astype(np.float32)).to(device)
                fbank = make_fbank_fn(fb, len(x16), device=device)
                feats, _ = fbank(torch.from_numpy(x16).to(device)[None].float(),
                                 torch.tensor([len(x16)], device=device), noise=noise)
                feats = feats[0].double().cpu().numpy()
                if args.cmn:
                    feats = feats - feats.mean(axis=0)
                stats.accumulate(feats)
    stats.write(args.cmvn_stats)


def main(argv=None):
    parser = argparse.ArgumentParser(description="pika_tpu_torch data preparation")
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' to run without one)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("wav_to_seq", parents=[device])
    p.add_argument("wav_scp")
    p.add_argument("out_mrk")
    p.add_argument("out_seq")
    p.add_argument("--num_wav_per_seq", type=int, default=2000)
    p.set_defaults(fn=_cmd_wav_to_seq)

    p = sub.add_parser("wav_to_bytes", parents=[device])
    p.add_argument("wav_scp")
    p.add_argument("byte_file")
    p.set_defaults(fn=_cmd_wav_to_bytes)

    for name, fn in (("split_by_length", _cmd_split), ("shuffle_by_length", _cmd_shuffle)):
        p = sub.add_parser(name, parents=[device])
        p.add_argument("feats_len")
        if name == "shuffle_by_length":
            p.add_argument("feats_len_shuffled")
        p.add_argument("--batch_size", type=int, default=16)
        if name == "split_by_length":
            p.add_argument("--world_size", type=int, default=8)
            p.add_argument("--min_len", type=int, default=0)
        p.add_argument("--max_len", type=int, default=3000)
        p.add_argument("--full_batch", action="store_true")
        p.add_argument("--random", action="store_true")
        p.add_argument("--seed", type=int, default=None)
        p.set_defaults(fn=fn)

    p = sub.add_parser("compute_global_cmvn", parents=[device])
    p.add_argument("data_lst")
    p.add_argument("cmvn_stats")
    p.add_argument("--cmn", action="store_true")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--feat_config", type=str, default=None)
    p.add_argument("--feat_dim", type=int, default=80)
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--no_normalize", action="store_true")
    p.set_defaults(fn=_cmd_cmvn)

    args = parser.parse_args(argv)
    args.device = resolve_device(args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
