"""LAS rescorer training CLI (port of ``pika_tpu/train/train_las.py``):

    python -m pika_tpu_torch.train.train_las DATA_LST LOG OUTPUT_DIR \\
        --shared_encoder_model RNNT_BUNDLE --SOS 0 --EOS 6268 --padding_tgt 6269 \\
        --padding_idx 6269 --output_dim 6269 --rnn_size 1024 ... [--reverse_labels] \\
        [--device cpu]

It takes the JAX CLI's command lines (``egs/train_las_rescorer.sh``) and
runs on the card unless ``--device`` names another.  ``--reverse_labels``
trains the backward rescorer; ``--shared_encoder_model`` freezes an RNN-T
bundle's encoder as the LAS input (otherwise the LAS encodes the features
itself); ``--pretrain_decoder`` trains the decoder alone as an LM.  Per
epoch: the training CLI's batches (the loader adds SOS and EOS and pads
with ``--padding_tgt``), stacked and pinned on a prefetch thread and
copied ``non_blocking``; one step each (``train/las_step.py``) with the
epoch's ``torch.Generator`` (seeded ``--seed + epoch``) and the scheduled
sampling probability (``--sampling_prob``, raised by 0.1 up to 0.4 from
``--increase_sampling_prob_epoch`` on with ``--sampling_decoder``); the
losses read every 8 steps; ``model.epoch.N`` bundles of kind ``las`` with
the metadata the decode CLI reads (``reverse_labels``, ``las_input``).  The
log lines are the JAX CLI's.

Distribution is the training CLI's (``train_transducer.py``): ranks from
``common.launch`` on their own rows of the global batch; ``--dp_mode sync``
sums the gradients over the ranks, the BMUF modes run rounds of
``--sync_period`` local steps (labels padded with the pad index to the
round's widest) and a block update.  Rank 0 writes the bundles.

``--lambda_coverage`` is parsed and unused, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist

from pika_tpu_torch.data.loader import prefetch_iter
from pika_tpu_torch.parallel import SumGradients, barrier, rank, replicate, world_size
from pika_tpu_torch.models.las import LASConfig, init_las
from pika_tpu_torch.train import common
from pika_tpu_torch.train.bundle import load_bundle, save_bundle
from pika_tpu_torch.train.las_step import make_las_train_step
from pika_tpu_torch.train.train_transducer import (
    DRAIN_EVERY,
    batch_stream,
    group_rounds,
    make_bmuf,
    pad_round,
    rank_batch,
    to_device,
)
from pika_tpu_torch.utils.logger import Logger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="LAS rescorer training")
    parser.add_argument("data_lst", type=str)
    parser.add_argument("log", type=str)
    parser.add_argument("output_dir", type=str)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the training (default: the CUDA card)")
    common.add_loader_args(parser)
    common.add_model_args(parser)
    common.add_train_args(parser)
    parser.add_argument("--padding_idx", type=int, default=-1)
    parser.add_argument("--global_attention", type=str, default="mlp",
                        choices=["dot", "general", "mlp"])
    parser.add_argument("--context_gate", type=str, default=None,
                        choices=[None, "source", "target", "both"])
    parser.add_argument("--coverage_attn", action="store_true",
                        help="coverage attention: the attention keys see the accumulated "
                             "attention mass")
    parser.add_argument("--lambda_coverage", type=float, default=1.0,
                        help="parsed for flag parity; no coverage penalty enters the loss")
    parser.add_argument("--use_downsampler", action="store_true")
    parser.add_argument("--downsampler_layers", type=int, default=1)
    parser.add_argument("--downsampler_rate", type=int, default=2)
    parser.add_argument("--sampling_decoder", action="store_true")
    parser.add_argument("--sampling_prob", type=float, default=0.0)
    parser.add_argument("--increase_sampling_prob_epoch", type=int, default=1000)
    parser.add_argument("--dec_loss_scale", type=float, default=1.0)
    parser.add_argument("--enc_loss_scale", type=float, default=0.0)
    parser.add_argument("--pretrain_decoder", action="store_true")
    parser.add_argument("--shared_encoder_model", type=str, default=None)
    common.add_utt_loader_args(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.launch(args, run)


def run(args, device: torch.device) -> None:
    """One rank of ``main``: its log, then ``train``."""
    with common.open_log(args) as log_f:
        train(args, device, log_f)


def train(args, device: torch.device, log_f) -> None:
    """The run of ``main`` on one rank after parsing, logging to ``log_f``."""
    pin = device.type == "cuda"
    r, w = rank(), world_size()
    if args.loader == "utt":
        if not args.ali_rspec:
            sys.exit("--loader utt requires --ali_rspec (ark:label.txt)")
        featurizer, input_dim = common.feats_featurizer_from_args(args, device=device)
    else:
        featurizer, input_dim, _ = common.featurizer_from_args(args, device=device)
    loader_cfg = common.loader_cfg_from_args(args, batch_size=args.batch_size * w)

    shared = None
    if args.shared_encoder_model:
        shared, _ = load_bundle(args.shared_encoder_model, device)
        shared.requires_grad_(False)
        input_dim = shared.config.hid_dim
    if args.init_model:
        model, _ = load_bundle(args.init_model, device)
    else:
        cfg = LASConfig(
            input_dim=input_dim, output_dim=args.output_dim,
            pad_idx=args.padding_idx if args.padding_idx >= 0 else args.output_dim,
            rnn_size=args.rnn_size, enc_layers=args.enc_layers, dec_layers=args.dec_layers,
            embd_dim=args.embd_dim, brnn=args.brnn, dropout=args.dropout,
            attn_type=args.global_attention, coverage_attn=args.coverage_attn,
            context_gate=args.context_gate, use_downsampler=args.use_downsampler,
            downsampler_layers=args.downsampler_layers, downsampler_rate=args.downsampler_rate)
        model = init_las(cfg, torch.Generator(device).manual_seed(args.seed), device)
        replicate(model.state_dict().values())
    optimizer = common.optimizer_from_args(args, model.parameters())
    bmuf = None
    if args.dp_mode != "sync":
        bmuf = make_bmuf(args, model, buffers=False)
    elif w > 1:
        optimizer = SumGradients(optimizer)
    step = make_las_train_step(model, optimizer, featurizer, shared, args.dec_loss_scale,
                               args.enc_loss_scale, args.pretrain_decoder)
    log_f.write(f"LAS training: devices {w} ({args.dp_mode}), "
                f"processes {args.num_processes}\n")
    log_f.flush()

    sampling_prob = args.sampling_prob
    step_count = 0
    for epoch in range(args.num_epochs):
        if args.sampling_decoder and epoch >= args.increase_sampling_prob_epoch:
            sampling_prob = min(0.4, sampling_prob + 0.1)  # the scheduled-sampling ramp
        log_f.write(f"===> Epoch {epoch} (sampling_prob {sampling_prob}) <===\n")
        logger = Logger(log_f, args.log_per_n_frames, ["Loss"])
        generator = torch.Generator(device).manual_seed(common.seed_for(args, epoch))
        pending = []  # device metrics, read every DRAIN_EVERY steps
        t_epoch = time.perf_counter()
        n_utts = 0

        def drain():
            if not pending:
                return
            rows = torch.stack([torch.stack([m["num_labels"].float(), m["loss"]])
                                for m in pending])
            if w > 1:
                dist.all_reduce(rows)  # the global batch's sums
            for n_labels, loss in rows.cpu().tolist():
                logger.update_and_log(int(n_labels), [loss])
            pending.clear()

        def local_step(host, sp=sampling_prob):
            return step(to_device(host, device), generator, sp)

        stream = batch_stream(args, loader_cfg, epoch)
        if bmuf is None:
            for host in prefetch_iter(stream, transform=lambda b: rank_batch(b, pin)):
                pending.append(local_step(host))
                n_utts += loader_cfg.batch_size
                if len(pending) >= DRAIN_EVERY:
                    drain()
        else:
            pad = {"labels": model.config.pad_idx}
            for host in prefetch_iter(group_rounds(stream, args.sync_period),
                                      transform=lambda g: [rank_batch(b, pin)
                                                           for b in pad_round(g, pad)]):
                ok, metrics = bmuf.round(optimizer, local_step, host, step_count)
                step_count += args.sync_period
                n_utts += loader_cfg.batch_size * args.sync_period
                if not ok:
                    log_f.write("NaN detected in BMUF sync — stopping\n")
                    sys.exit(1)
                logger.update_and_log(int(metrics["num_labels"].sum()),
                                      [float(metrics["loss"].sum())])
        drain()
        logger.summarize_and_log()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t_epoch
        log_f.write(f"===> Epoch {epoch} wall {dt:.1f}s, {n_utts} utts, "
                    f"{n_utts / max(dt, 1e-9):.1f} utt/s <===\n")
        if ((epoch + 1) % max(args.save_interval, 1) == 0 or epoch == args.num_epochs - 1):
            if r == 0:
                save_bundle(f"{args.output_dir}/model.epoch.{epoch}", model,
                            metadata={"epoch": epoch, "reverse_labels": args.reverse_labels,
                                      "las_input": ("enc" if args.shared_encoder_model
                                                    else "feats")})
            barrier()
    log_f.write("Training Finished\n")


if __name__ == "__main__":
    main()
