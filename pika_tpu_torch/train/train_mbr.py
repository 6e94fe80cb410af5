"""MBR fine-tuning CLI (port of ``pika_tpu/train/train_mbr.py``):

    python -m pika_tpu_torch.train.train_mbr DATA_LST LOG OUTPUT_DIR \\
        --init_model BUNDLE --beam_size 4 --sm_scale 1.2 --rnnt_scale 0.02 ... \\
        [--device cpu]

It takes the JAX CLI's command lines (``egs/train_transducer_mbr.sh``) and
runs on the card unless ``--device`` names another.  ``--init_model`` is
required: a port bundle (``train/bundle.py``; a JAX bundle converts with
``bundle_from_flax``), whose configuration wins over the model flags.  Per
epoch: the training CLI's batches (otf loader or ``--loader utt``), stacked
and pinned on a prefetch thread and copied ``non_blocking``; one MBR step
each (``train/mbr.py``: beam decode with ``prune_dups=False``, ``n_best =
beam_size`` and bf16 decode matmuls on the card, then the risk-weighted
surrogate plus ``--rnnt_scale`` times the RNN-T loss, and the optimizer) with
the epoch's ``torch.Generator`` (seeded ``--seed + epoch``); the "MBR Loss"
and "RNNT Loss" lines read every 8 steps; ``model.tmp`` every
``--tmp_save_batches`` steps and ``model.epoch.N`` bundles.  The log lines
are the JAX CLI's.

Distribution is the training CLI's (``train_transducer.py``): ranks from
``common.launch``, each decoding and stepping on its own rows of the global
batch; ``--dp_mode sync`` sums the gradients over the ranks and takes the
BatchNorm moments over all of them, the BMUF modes run rounds of
``--sync_period`` local MBR steps and a block update with the BatchNorm
statistics averaged.  Rank 0 writes the bundles.

Flags the JAX CLI parses and ignores (``--compute_dtype``, ``--remat``,
``--pruned_loss_range``, ...) are ignored here too.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist

from pika_tpu_torch.data.loader import prefetch_iter
from pika_tpu_torch.decode.beam import BeamConfig
from pika_tpu_torch.parallel import (
    SumGradients,
    barrier,
    global_batch_norm,
    rank,
    world_size,
)
from pika_tpu_torch.train import common
from pika_tpu_torch.train.bundle import load_bundle, save_bundle
from pika_tpu_torch.train.mbr import make_mbr_step
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
    parser = argparse.ArgumentParser(description="Transducer MBR training")
    parser.add_argument("data_lst", type=str)
    parser.add_argument("log", type=str)
    parser.add_argument("output_dir", type=str)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the training (default: the CUDA card)")
    common.add_loader_args(parser)
    common.add_model_args(parser)
    common.add_train_args(parser)
    parser.add_argument("--beam_size", type=int, default=4)
    parser.add_argument("--sm_scale", type=float, default=1.0)
    parser.add_argument("--rnnt_scale", type=float, default=0.0)
    parser.add_argument("--decode_max_symbols", type=int, default=220)
    parser.add_argument("--tmp_save_batches", type=int, default=3000)
    common.add_utt_loader_args(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.init_model:
        raise SystemExit("MBR training requires --init_model (an RNN-T bundle)")
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
        featurizer, _ = common.feats_featurizer_from_args(args, device=device)
    else:
        featurizer, _, _ = common.featurizer_from_args(args, device=device)
    model, _ = load_bundle(args.init_model, device)
    optimizer = common.optimizer_from_args(args, model.parameters())
    loader_cfg = common.loader_cfg_from_args(args, batch_size=args.batch_size * w)
    beam_cfg = BeamConfig(beam_size=args.beam_size, n_best=args.beam_size,
                          sm_scale=args.sm_scale, max_symbols=args.decode_max_symbols,
                          prune_dups=False, mm_dtype="auto")
    bmuf = None
    if args.dp_mode != "sync":
        bmuf = make_bmuf(args, model)
    elif w > 1:
        optimizer = SumGradients(optimizer)
        global_batch_norm(model)
    step = make_mbr_step(model, optimizer, featurizer, beam_cfg, rnnt_scale=args.rnnt_scale,
                         sm_scale=args.sm_scale, loss_chunk=args.loss_chunk,
                         loss_backend="plain" if args.loss_backend == "xla" else "auto")
    log_f.write(f"MBR fine-tuning: devices {w} ({args.dp_mode}), "
                f"processes {args.num_processes}, beam {args.beam_size}\n")
    log_f.flush()

    def save(path, metadata=None):
        if r == 0:
            save_bundle(path, model, metadata=metadata)
        barrier()

    num_done = 0
    step_count = 0
    for epoch in range(args.num_epochs):
        log_f.write(f"===> Epoch {epoch} <===\n")
        logger = Logger(log_f, args.log_per_n_frames, ["MBR Loss", "RNNT Loss"])
        generator = torch.Generator(device).manual_seed(common.seed_for(args, epoch))
        pending = []  # device metrics, read every DRAIN_EVERY steps
        t_epoch = time.perf_counter()
        n_utts = 0

        def drain():
            if not pending:
                return
            rows = torch.stack([torch.stack([m["num_labels"].float(), m["mbr_loss"],
                                             m["rnnt_loss"]]) for m in pending])
            if w > 1:
                dist.all_reduce(rows)  # the global batch's sums
            for n_labels, mbr, rnnt in rows.cpu().tolist():
                logger.update_and_log(int(n_labels), [mbr, rnnt])
            pending.clear()

        stream = batch_stream(args, loader_cfg, epoch)
        if bmuf is None:
            for host in prefetch_iter(stream, transform=lambda b: rank_batch(b, pin)):
                pending.append(step(to_device(host, device), generator))
                n_utts += loader_cfg.batch_size
                if len(pending) >= DRAIN_EVERY:
                    drain()
                num_done += 1
                if num_done % args.tmp_save_batches == 0:
                    drain()
                    save(f"{args.output_dir}/model.tmp")
        else:
            for host in prefetch_iter(group_rounds(stream, args.sync_period),
                                      transform=lambda g: [rank_batch(b, pin)
                                                           for b in pad_round(g)]):
                ok, metrics = bmuf.round(
                    optimizer, lambda h: step(to_device(h, device), generator), host, step_count)
                step_count += args.sync_period
                n_utts += loader_cfg.batch_size * args.sync_period
                num_done += args.sync_period
                if not ok:
                    log_f.write("NaN detected in BMUF sync — stopping\n")
                    sys.exit(1)
                logger.update_and_log(int(metrics["num_labels"].sum()),
                                      [float(metrics["mbr_loss"].sum()),
                                       float(metrics["rnnt_loss"].sum())])
                if num_done % args.tmp_save_batches < args.sync_period:
                    save(f"{args.output_dir}/model.tmp")
        drain()
        logger.summarize_and_log()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t_epoch
        log_f.write(f"===> Epoch {epoch} wall {dt:.1f}s, {n_utts} utts, "
                    f"{n_utts / max(dt, 1e-9):.1f} utt/s <===\n")
        if (epoch + 1) % max(args.save_interval, 1) == 0 or epoch == args.num_epochs - 1:
            save(f"{args.output_dir}/model.epoch.{epoch}", metadata={"epoch": epoch})
    log_f.write("Training Finished\n")


if __name__ == "__main__":
    main()
