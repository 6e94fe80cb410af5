"""CLI plumbing shared by the entry points (port of
``pika_tpu/train/common.py``): the JAX CLIs' flag surface, and the builders
that turn parsed flags into featurizers, loader configurations and
optimizers, and the launch of the ranks of a distributed run
(``launch``, the counterpart of ``maybe_distributed_init``).
``--rng_impl`` is kept only as the policy behind ``--attn_cheap_dropout
auto`` (``resolve_rng_impl``)."""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Callable, Iterable, Optional

import torch

from pika_tpu_torch.data.cmvn import CmvnStats, offset_scale
from pika_tpu_torch.data.loader import OtfLoaderConfig
from pika_tpu_torch.device import resolve_device
from pika_tpu_torch.features.fbank import FbankConfig
from pika_tpu_torch.parallel.mesh import local_rendezvous, process_group, rank, world_size
from pika_tpu_torch.train.lr import make_optimizer
from pika_tpu_torch.train.step import FeaturizerConfig, make_featurizer, make_feats_featurizer


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


def add_model_args(parser: argparse.ArgumentParser) -> None:
    """Model flags, the JAX CLI's set."""
    parser.add_argument("--encoder_type", type=str, default="rnn",
                        choices=["rnn", "transformer", "conformer"],
                        help="transformer: the TDNN-Transformer; conformer: the Conformer "
                             "(--conformer_* flags, --rnn_size its output width)")
    parser.add_argument("--decoder_type", type=str, default="rnn",
                        choices=["rnn", "transformer"])
    parser.add_argument("--enc_layers", type=int, default=2)
    parser.add_argument("--dec_layers", type=int, default=2)
    parser.add_argument("--rnn_size", type=int, default=512)
    parser.add_argument("--embd_dim", type=int, default=300)
    parser.add_argument("--output_dim", type=int, default=8000)
    parser.add_argument("--model_lctx", type=int, default=0)
    parser.add_argument("--model_rctx", type=int, default=0)
    parser.add_argument("--model_stride", type=int, default=1)
    parser.add_argument("--brnn", action="store_true")
    parser.add_argument("--dropout", type=float, default=0.3,
                        help="dropout between the prediction net's LSTM layers")
    parser.add_argument("--tdnn_nhid", type=int, default=1024)
    parser.add_argument("--tdnn_layers", type=int, default=9)
    parser.add_argument("--tdnn_transformer_dropout", type=float, default=0.2,
                        help="attention/FFN dropout inside the TDNN-Transformer encoder's "
                             "transformer layers")
    parser.add_argument("--conformer_layers", type=int, default=17)
    parser.add_argument("--conformer_d_model", type=int, default=512)
    parser.add_argument("--conformer_heads", type=int, default=8)
    parser.add_argument("--conformer_d_ff", type=int, default=2048)
    parser.add_argument("--conformer_kernel", type=int, default=32,
                        help="the conformer's depthwise convolution over time")
    parser.add_argument("--conformer_dropout", type=float, default=0.1,
                        help="dropout inside the conformer encoder")
    parser.add_argument("--attn_chunk", type=int, default=0,
                        help="chunked encoder self-attention over query blocks of this size "
                             "(O(T*chunk) memory instead of O(T^2)); 0 = full attention. "
                             "Combine with --remat for the longest inputs.  In training its "
                             "attention dropout shares one mask across heads")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the encoder's transformer layers in the backward "
                             "instead of keeping their activations (the same dropout masks "
                             "are drawn again): longer utterances or larger batches per card")
    parser.add_argument("--attn_cheap_dropout", type=str, default="auto",
                        choices=["auto", "on", "off"],
                        help="attention-probability dropout through one bits-threshold mask "
                             "shared across heads (unbiased, head-correlated noise, 1/heads "
                             "of the random numbers); auto = on where --rng_impl resolves to "
                             "rbg (on the card), off on the CPU")


def resolve_rng_impl(args, device: torch.device) -> str:
    """The JAX CLI's ``--rng_impl`` policy as a resolution only: ``auto`` is
    ``rbg`` on the card and ``threefry2x32`` on the CPU.  The port's draws
    come from ``torch.Generator``s whatever it says; it only decides
    ``--attn_cheap_dropout auto`` (``resolve_cheap_dropout``).  Stashed as
    ``args.rng_impl_resolved``."""
    impl = getattr(args, "rng_impl", "auto")
    if impl == "auto":
        impl = "threefry2x32" if torch.device(device).type == "cpu" else "rbg"
    args.rng_impl_resolved = impl
    return impl


def resolve_cheap_dropout(args) -> bool:
    """``--attn_cheap_dropout``: on and off win; auto is on where the
    resolved ``--rng_impl`` is rbg (``resolve_rng_impl`` must have run)."""
    flag = getattr(args, "attn_cheap_dropout", "auto")
    if flag == "on":
        return True
    if flag == "off":
        return False
    return getattr(args, "rng_impl_resolved", "threefry2x32") == "rbg"


def add_train_args(parser: argparse.ArgumentParser) -> None:
    """Training flags, the JAX CLI's set."""
    parser.add_argument("--init_model", type=str, default=None)
    parser.add_argument("--cmn", action="store_true")
    parser.add_argument("--cmvn_stats", type=str, default=None)
    parser.add_argument("--optim", type=str, default="sgd", choices=["sgd", "adam", "adadelta"])
    parser.add_argument("--grad_clip", type=float, default=-1.0)
    parser.add_argument("--initial_lr", type=float, default=1.0)
    parser.add_argument("--final_lr", type=float, default=1.0)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--num_epochs", type=int, default=15)
    parser.add_argument("--num_batches_per_epoch", type=int, default=1000,
                        help="sets the LR schedule's length (num_epochs x this); an epoch "
                             "runs over the whole data list")
    parser.add_argument("--log_per_n_frames", type=int, default=1024 * 1024)
    parser.add_argument("--seed", type=int, default=777)
    parser.add_argument("--rng_impl", type=str, default="auto",
                        choices=["auto", "threefry2x32", "rbg"],
                        help="the JAX CLI's PRNG choice; in the port only the policy of "
                             "--attn_cheap_dropout auto (auto = rbg on the card, threefry2x32 "
                             "on the CPU): the draws come from torch.Generator")
    parser.add_argument("--dp_mode", type=str, default="sync",
                        choices=["sync", "bmuf", "blockadam", "bmufadam"])
    parser.add_argument("--num_devices", type=int, default=None,
                        help="cards of the whole run, one rank each (default: every visible "
                             "card of every process; with --device cpu one CPU rank per "
                             "process)")
    parser.add_argument("--block_momentum", type=float, default=0.9)
    parser.add_argument("--block_lr", type=float, default=1.0)
    parser.add_argument("--sync_period", type=int, default=5)
    parser.add_argument("--spec_augment", action="store_true")
    parser.add_argument("--max_freq_span", type=int, default=15)
    parser.add_argument("--max_time_span", type=int, default=35)
    parser.add_argument("--async_save", action="store_true",
                        help="write the per-epoch checkpoint and bundle on a thread, from a "
                             "host copy taken between epochs")
    parser.add_argument("--save_interval", type=int, default=1,
                        help="save checkpoints every N epochs (the final epoch always saves)")
    parser.add_argument("--steps_per_dispatch", type=int, default=4,
                        help="no effect in the port (the JAX CLI groups train steps into "
                             "one XLA dispatch); accepted so the JAX command lines parse")
    parser.add_argument("--loss_chunk", type=int, default=16)
    parser.add_argument("--loss_backend", type=str, default="auto",
                        choices=["auto", "xla", "pallas"],
                        help="auto and pallas: the kernels K1-K3 (their plain versions on the "
                             "CPU); xla: their plain PyTorch versions on every device")
    parser.add_argument("--pruned_loss_range", type=int, default=0,
                        help="N > 0: the pruned RNN-T objective (ops/rnnt_pruned.py): the full "
                             "gated joint only on a band of N label positions a frame, picked "
                             "by an additive 'simple' joint whose two linear heads it adds to "
                             "the model (config.simple_joint); 0: the full-lattice fused loss")
    parser.add_argument("--simple_loss_scale", type=float, default=0.5,
                        help="weight of the simple joint's loss under --pruned_loss_range")
    parser.add_argument("--pruned_warmup_epochs", type=int, default=2,
                        help="epochs whose steps weigh the banded term 0.1 while the simple "
                             "joint's alignment settles (a cold simple joint picks noise bands)")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="model compute precision (master params, gradients and "
                             "optimizer state stay float32)")
    parser.add_argument("--coordinator_address", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=1)
    parser.add_argument("--process_id", type=int, default=0)


def plan_launch(args) -> tuple[torch.device, int, int, int]:
    """(device, world size, ranks on this process's host, first rank here)
    of the command line, the JAX CLIs' interface: ``--num_devices N`` counts
    the cards of the whole run (by default every visible card of every
    process; one CPU worker per process with ``--device cpu``);
    ``--coordinator_address host:port --num_processes P --process_id i``
    gives each of the P processes N/P ranks, ``i * N/P`` onwards."""
    device = resolve_device(args.device)
    n_proc = args.num_processes
    if n_proc > 1 and not args.coordinator_address:
        raise ValueError("--num_processes > 1 needs --coordinator_address host:port")
    if not 0 <= args.process_id < n_proc:
        raise ValueError(f"--process_id {args.process_id} outside 0..{n_proc - 1}")
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    world = args.num_devices or visible * n_proc
    if world < 1 or world % n_proc:
        raise ValueError(f"--num_devices {world} does not split over {n_proc} processes")
    local = world // n_proc
    if device.type == "cuda" and local > visible:
        raise ValueError(f"--num_devices {world}: {local} cards per process, but only "
                         f"{visible} visible")
    return device, world, local, args.process_id * local


def launch(args, worker: Callable) -> None:
    """Run ``worker(args, device)`` on each rank this process owns
    (``plan_launch``), inside the default process group: NCCL on the card,
    gloo on the CPU; the device decides.  One rank runs in this process,
    more in worker processes started with ``spawn``, each on
    ``cuda:local_rank`` (or the CPU); a worker that fails makes this
    process fail too.  Ranks spawned here meet at ``local_rendezvous``'s
    file store unless ``--coordinator_address`` names a TCP one.  Sync
    training on one rank needs no process group and gets none; BMUF's
    collective runs in a world of one too."""
    device, world, local, first = plan_launch(args)
    init = f"tcp://{args.coordinator_address}" if args.coordinator_address else None
    if local == 1:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if world == 1 and args.dp_mode == "sync":
            worker(args, device)
            return
        with process_group(device, first, world, init):
            worker(args, device)
        return
    with contextlib.ExitStack() as stack:
        if init is None:
            init = stack.enter_context(local_rendezvous())
        try:
            torch.multiprocessing.start_processes(
                _run_rank, args=(args, worker, device.type, world, first, init,
                                 torch.get_num_threads()),
                nprocs=local, join=True, start_method="spawn")
        except torch.multiprocessing.ProcessExitedException as exc:
            raise SystemExit(exc.exit_code or 1) from exc


def _run_rank(local_rank: int, args, worker: Callable, device_type: str, world: int,
              first: int, init: str, threads: int) -> None:
    """A spawned worker: rank ``first + local_rank`` of ``world``."""
    torch.set_num_threads(threads)
    device = torch.device(device_type, local_rank) if device_type == "cuda" else \
        torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    with process_group(device, first + local_rank, world, init):
        worker(args, device)


def open_log(args):
    """This rank's log: ``WORKER-ID`` in ``--log`` becomes the rank; ranks
    other than 0 of a path without it write nowhere."""
    r = rank()
    if r and "WORKER-ID" not in args.log:
        return open(os.devnull, "w")
    return open(args.log.replace("WORKER-ID", str(r)), "w")


def seed_for(args, epoch: int) -> int:
    """The seed of a rank's epoch generator: ``--seed + epoch`` in a world
    of one, distinct per rank otherwise."""
    return (args.seed + epoch) * world_size() + rank()


def add_utt_loader_args(parser: argparse.ArgumentParser) -> None:
    """Loader selection: ``otf`` reads raw waveforms, ``utt`` precomputed
    feature archives (``data/feats_loader.py``)."""
    parser.add_argument("--loader", type=str, default="otf", choices=["otf", "utt"],
                        help="otf: raw-waveform archives with on-the-fly augmentation and "
                             "the fbank on the device; utt: precomputed features (data_lst "
                             "is a feats.scp/.ark, labels through --ali_rspec)")
    parser.add_argument("--ali_rspec", type=str, default=None,
                        help="label rspec (ark:label.txt) for --loader utt")
    parser.add_argument("--buffer_size", type=int, default=1024,
                        help="shuffle buffer (utterances) for --loader utt")


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
    offset, scale = _cmvn_tensors(args, device)
    cfg = FeaturizerConfig(
        fbank=fb, max_samples=max_samples, lctx=args.lctx, rctx=args.rctx, stride=args.stride,
        cmn=args.cmn, spec_augment=args.spec_augment if spec_augment is None else spec_augment,
        max_freq_span=args.max_freq_span, max_time_span=args.max_time_span)
    featurizer = make_featurizer(cfg, offset, scale, device=device)
    return featurizer, fb.num_mel_bins * (args.lctx + 1 + args.rctx), max_samples


def loader_cfg_from_args(args, batch_size: Optional[int] = None) -> OtfLoaderConfig:
    """The otf loader's configuration: the waveform buckets are 1/4, 1/2,
    3/4 and all of ``--max_wav_seconds``, the label buckets 16/32/64/128."""
    fb = fbank_from_args(args)
    gains = tuple(float(g) for g in args.gain_range.split(","))
    speeds = tuple(float(s) for s in args.speed_rate.split(","))
    max_samples = int(args.max_wav_seconds * args.sample_rate)
    buckets = tuple(int(max_samples * f) for f in (0.25, 0.5, 0.75, 1.0))
    snr = None
    if getattr(args, "snr_range", ""):
        lo, hi = (float(x) for x in args.snr_range.split(","))
        snr = (lo, hi)
    return OtfLoaderConfig(
        batch_size=batch_size or args.batch_size, snr_range=snr,
        noise_prob=getattr(args, "noise_prob", 1.0), sample_rate=args.sample_rate,
        frame_length=fb.frame_length, frame_shift=fb.frame_shift, stride=args.stride,
        max_len=args.max_len, tu_limit=args.TU_limit, speed_rates=speeds, gain_range=gains,
        num_workers=args.num_workers, queue_size=args.queue_size,
        reverse_labels=args.reverse_labels, sos=args.SOS, eos=args.EOS,
        pad_label=args.padding_tgt, seed=args.seed, wav_buckets=buckets,
        label_buckets=(16, 32, 64, 128), augment=not args.no_augment)


def _cmvn_tensors(args, device):
    if not args.cmvn_stats:
        return None, None
    stats = CmvnStats.read(args.cmvn_stats)
    off, sc = offset_scale(stats.stats, splice_copies=args.lctx + 1 + args.rctx)
    return (torch.from_numpy(x).to(resolve_device(device)) for x in (off, sc))


def feats_featurizer_from_args(args, spec_augment: Optional[bool] = None, device=None):
    """Featurizer and input_dim of the ``--loader utt`` path: the host
    loader splices and strides the features; CMVN and SpecAugment run on
    ``device`` (the card unless the caller names another)."""
    offset, scale = _cmvn_tensors(args, device)
    featurize = make_feats_featurizer(
        cmvn_offset=offset, cmvn_scale=scale, cmn=args.cmn,
        use_spec_augment=args.spec_augment if spec_augment is None else spec_augment,
        max_freq_span=args.max_freq_span, max_time_span=args.max_time_span)
    return featurize, args.feats_dim * (args.lctx + 1 + args.rctx)


def optimizer_from_args(args, params: Iterable[torch.nn.Parameter]):
    return make_optimizer(params, args.optim, args.initial_lr, args.final_lr,
                          args.num_epochs * args.num_batches_per_epoch, args.momentum,
                          args.grad_clip)


def expand_worker_lists(data_lst: str, n: int):
    """WORKER-ID substitution: per-worker lists are merged into one stream."""
    if "WORKER-ID" not in data_lst:
        return [data_lst]
    return [data_lst.replace("WORKER-ID", str(i)) for i in range(n)]


def load_noise_segments(noise_lst: Optional[str]):
    """Noise (or RIR) waveforms from an mrk/seq list file (``mrk seq
    [label]`` per line) as float32 in [-1, 1)."""
    if not noise_lst:
        return None
    from pika_tpu_torch.data import segment as seg
    from pika_tpu_torch.data.archive import MrkSeqReader
    from pika_tpu_torch.data.scp import read_data_lst

    out = []
    with open(noise_lst) as f:
        entries = read_data_lst(noise_lst) or [tuple(line.split()[:2]) + ("",) for line in f]
    for entry in entries:
        with MrkSeqReader(entry[0], entry[1]) as reader:
            for _, pcm in reader:
                out.append(seg.to_float32(pcm))
    return out
