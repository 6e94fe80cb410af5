"""RNN-T training CLI (port of ``pika_tpu/train/train_transducer.py``):

    python -m pika_tpu_torch.train.train_transducer DATA_LST LOG OUTPUT_DIR \\
        --encoder_type transformer --decoder_type rnn --rnn_size 1024 ... \\
        --dp_mode bmuf --sync_period 5 --block_momentum 0.9 [--device cpu]

It takes the JAX CLI's command lines (``egs/train_transducer.sh``) and runs
on the card unless ``--device`` names another.  ``--num_devices N`` ranks
(one per card; gloo workers with ``--device cpu``) and the multi-host flags
are launched by ``common.launch``; every rank reads the same global batch
stream (``--batch_size`` rows per rank) and takes its own rows.  Per epoch:
batches from the otf loader (``data/loader.py``) or, with ``--loader utt``,
from precomputed features (``data/feats_loader.py``), cut to the rank's
rows and pinned on a prefetch thread and copied to the card
``non_blocking`` on the main thread (all CUDA work stays there); then

* ``--dp_mode sync``: one train step each (``train/step.py``); with more
  than one rank the gradients are summed over the ranks before the clip and
  the encoder's BatchNorm takes global moments (``parallel/dp.py``);
* ``bmuf``, ``blockadam``, ``bmufadam``: rounds of ``--sync_period``
  batches (padded to the round's widest, as the JAX CLI stacks them), local
  steps from a fresh optimizer at the global step, then the block update
  (``parallel/bmuf.py``), the BatchNorm statistics averaged over the ranks;
  a non-finite delta stops the run with exit 1.

Every draw comes from the epoch's ``torch.Generator`` (seeded ``--seed +
epoch`` in a world of one).  The losses stay on the device and are read
every 8 steps (sync) or every round, summed or averaged over the ranks.
After each saving epoch rank 0 writes a full-state checkpoint
(``ckpt/<epoch>/``, ``train/checkpoint.py``; BMUF's block state and step
count included) and a model bundle (``model.epoch.N``, ``train/bundle.py``,
which the decode CLI reads) while the other ranks wait; ``--resume``
continues from the newest checkpoint.  The log lines are the JAX CLI's;
``WORKER-ID`` in LOG becomes the rank.

``--encoder_type transformer`` builds the TDNN-Transformer encoder and
``conformer`` the Conformer (``models/conformer.py``, its sizes from the
``--conformer_*`` flags: Conformer (L) by default; features unspliced with
``--lctx 0 --rctx 0``); ``--decoder_type transformer`` builds the
conv-transformer prediction net;
``--pruned_loss_range N`` adds the simple joint's heads and trains the
pruned objective (``train/step.py``) in the sync path and every BMUF
variant, its banded term weighed 0.1 for the first
``--pruned_warmup_epochs`` epochs; validation always takes the full fused
loss (K1).  ``--steps_per_dispatch`` is accepted and has no effect.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import itertools
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from pika_tpu_torch.data.loader import dataloader, prefetch_iter
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.parallel import (
    BMUF,
    BMUFConfig,
    SumGradients,
    all_sum,
    barrier,
    global_batch_norm,
    local_rows,
    rank,
    replicate,
    world_size,
)
from pika_tpu_torch.train import common
from pika_tpu_torch.train.bundle import load_bundle, save_bundle
from pika_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from pika_tpu_torch.train.step import make_eval_step, make_train_step
from pika_tpu_torch.utils.logger import Logger

DRAIN_EVERY = 8  # steps between reads of the device-side losses
ENCODER_TYPES = {"rnn": "rnn", "transformer": "tdnn_transformer", "conformer": "conformer"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Transducer training")
    parser.add_argument("data_lst", type=str, help="list of mrk, seq, ali files for data")
    parser.add_argument("log", type=str, help="log file for the job")
    parser.add_argument("output_dir", type=str, help="path to save models")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the training (default: the CUDA card)")
    common.add_loader_args(parser)
    common.add_model_args(parser)
    common.add_train_args(parser)
    parser.add_argument("--valid_data_lst", type=str, default=None,
                        help="held-out data list; evaluated after each epoch")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest full-state checkpoint in output_dir "
                             "(params + optimizer state + epoch)")
    parser.add_argument("--save_every_n_batches", type=int, default=0,
                        help="periodic temp bundle output_dir/model.tmp (0 = per-epoch only)")
    common.add_utt_loader_args(parser)
    return parser


def make_model(args, input_dim: int, device: torch.device):
    """(model, config): from ``--init_model`` (a port bundle, whose
    configuration wins, as in the JAX CLI) or fresh from ``--seed``."""
    if args.init_model:
        model, _ = load_bundle(args.init_model, device)
        return model, model.config
    cfg = TransducerConfig(
        input_dim=input_dim, vocab_size=args.output_dim, hid_dim=args.rnn_size,
        encoder_type=ENCODER_TYPES[args.encoder_type],
        decoder_type="transformer" if args.decoder_type == "transformer" else "rnn",
        enc_layers=args.enc_layers,
        dec_layers=args.dec_layers, embd_dim=args.embd_dim, dropout=args.dropout,
        brnn=args.brnn, tdnn_nhid=args.tdnn_nhid, tdnn_layers=args.tdnn_layers,
        tdnn_transformer_dropout=args.tdnn_transformer_dropout, remat=args.remat,
        attn_chunk=args.attn_chunk, attn_cheap_dropout=common.resolve_cheap_dropout(args),
        simple_joint=args.pruned_loss_range > 0, conformer_layers=args.conformer_layers,
        conformer_d_model=args.conformer_d_model, conformer_heads=args.conformer_heads,
        conformer_d_ff=args.conformer_d_ff, conformer_kernel=args.conformer_kernel,
        conformer_dropout=args.conformer_dropout)
    return init_transducer(cfg, torch.Generator(device).manual_seed(args.seed), device), cfg


def feats_batch_stream(args, batch_size: int, epoch: int, shuffle=True, required=True):
    """Precomputed-feature batches (``--loader utt``); ragged tails dropped."""
    from pika_tpu_torch.data.feats_loader import FeatsLoaderConfig, feats_dataloader

    cfg = FeatsLoaderConfig(
        batch_size=batch_size, lctx=args.lctx, rctx=args.rctx, stride=args.stride,
        max_len=args.max_len, reverse_labels=args.reverse_labels, pad_label=args.padding_tgt,
        sos=args.SOS, eos=args.EOS, shuffle_buffer=args.buffer_size if shuffle else 0,
        seed=args.seed + 1000 * epoch)
    n_yielded = n_dropped = 0
    for b in feats_dataloader(args.data_lst, args.ali_rspec, cfg):
        if len(b["uttids"]) == batch_size:
            n_yielded += 1
            yield b
        else:
            n_dropped += len(b["uttids"])
    if n_dropped:
        print(f"feats_batch_stream: dropped {n_dropped} tail utterances "
              f"(< batch_size {batch_size})", file=sys.stderr)
    if n_yielded == 0 and required:
        raise RuntimeError(
            f"feats_batch_stream: epoch produced 0 full batches "
            f"(batch_size {batch_size}, {n_dropped} utterances dropped) — "
            f"is the corpus smaller than the global batch?")
    if n_yielded == 0:
        print(f"feats_batch_stream: 0 full batches (batch_size "
              f"{batch_size}); skipping", file=sys.stderr)


def batch_stream(args, loader_cfg, epoch: int, noise=None, rir=None, required=True):
    """Merged stream over the (WORKER-ID-expanded) data lists, each loader
    seeded ``seed + 1000 * epoch + list``; ragged tail batches dropped."""
    if args.loader == "utt":
        yield from feats_batch_stream(args, loader_cfg.batch_size, epoch,
                                      shuffle=loader_cfg.augment, required=required)
        return
    lists = common.expand_worker_lists(args.data_lst, world_size())
    streams = [dataloader(lst, dataclasses.replace(loader_cfg,
                                                   seed=loader_cfg.seed + 1000 * epoch + i),
                          noise=noise, rir=rir)
               for i, lst in enumerate(lists)]
    expected = loader_cfg.batch_size
    n_yielded = n_dropped = 0
    for batches in itertools.zip_longest(*streams):
        for b in batches:
            if b is not None and len(b["uttids"]) == expected:
                n_yielded += 1
                yield b
            elif b is not None:
                n_dropped += len(b["uttids"])
    if n_dropped:
        print(f"batch_stream: dropped {n_dropped} tail utterances "
              f"(< batch_size {expected})", file=sys.stderr)
    if n_yielded == 0 and required:
        raise RuntimeError(
            f"batch_stream: epoch produced 0 full batches (batch_size "
            f"{expected}, {n_dropped} utterances dropped) — is the corpus "
            f"smaller than the global batch?")
    if n_yielded == 0:
        print(f"batch_stream: 0 full batches (batch_size {expected}); "
              f"skipping", file=sys.stderr)


def host_batch(batch, pin: bool) -> dict:
    """A loader batch as CPU tensors, pinned for a ``non_blocking`` copy
    when ``pin``.  Waveforms travel as int16 (the loader's values are
    integral; the featurizer promotes them)."""
    out = {}
    for k, v in batch.items():
        if k == "uttids":
            continue
        if k == "wavs":
            v = np.clip(v, -32768, 32767).astype(np.int16)
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory() if pin else t
    return out


def to_device(batch: dict, device: torch.device) -> dict:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def rank_batch(batch, pin: bool) -> dict:
    """This rank's rows of a global loader batch, as ``host_batch``."""
    return host_batch(local_rows(batch, rank(), world_size()), pin)


def group_rounds(stream, sync_period: int):
    """Lists of ``sync_period`` batches; a shorter tail is dropped."""
    pending = []
    for batch in stream:
        pending.append(batch)
        if len(pending) == sync_period:
            yield pending
            pending = []


def pad_round(batches: list, pad_values: dict = None) -> list:
    """A round's host batches with every array of two or more axes padded
    on axis 1 to the round's widest (``pad_values[key]``, default 0): the
    JAX CLI stacks a round into one array (``_stack_batches``), so its
    steps see these widths."""
    out = [dict(b) for b in batches]
    for k, v in batches[0].items():
        if k == "uttids" or np.ndim(v) < 2:
            continue
        width = max(np.shape(b[k])[1] for b in batches)
        fill = (pad_values or {}).get(k, 0)
        for b in out:
            a = np.asarray(b[k])
            b[k] = np.pad(a, [(0, 0), (0, width - a.shape[1])] + [(0, 0)] * (a.ndim - 2),
                          constant_values=fill)
    return out


def make_bmuf(args, model: torch.nn.Module, buffers=True) -> BMUF:
    """BMUF over ``model``'s parameters (and, with ``buffers``, its float
    buffers: the BatchNorm running statistics, averaged at each sync) from
    the block flags."""
    cfg = BMUFConfig(variant=args.dp_mode, block_momentum=args.block_momentum,
                     block_lr=args.block_lr, sync_period=args.sync_period)
    extra = [b for b in model.buffers() if b.is_floating_point()] if buffers else []
    return BMUF(model.parameters(), cfg, buffers=extra)


def _host_copy(state):
    """A CPU copy of a (nested) state dict, safe to write from a thread
    while training goes on."""
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: _host_copy(v) for k, v in state.items()}
    if isinstance(state, list):
        return [_host_copy(v) for v in state]
    return copy.deepcopy(state)


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.launch(args, run)


def run(args, device: torch.device) -> None:
    """One rank of ``main``: its log, then ``train``."""
    common.resolve_rng_impl(args, device)
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
    model, cfg = make_model(args, input_dim, device)
    replicate(model.state_dict().values())
    optimizer = common.optimizer_from_args(args, model.parameters())
    loader_cfg = common.loader_cfg_from_args(args, batch_size=args.batch_size * w)
    noise = common.load_noise_segments(args.noise_lst)
    rir = common.load_noise_segments(args.rir_lst)

    num_param = sum(p.numel() for p in model.parameters())
    log_f.write("*" * 60 + "\n")
    log_f.write(
        f"model: transducer  input dim: {input_dim}\toutput dim: {args.output_dim}\n"
        f"hidden dim: {args.rnn_size}\tenc_layers: {args.enc_layers}\n"
        f"dec_layers: {args.dec_layers}\tdevices: {w} ({args.dp_mode})\n"
        f"model size: {num_param / 1e6:.2f} M\n")
    log_f.write("*" * 60 + "\n")
    log_f.flush()

    bmuf = None
    if args.dp_mode != "sync":
        bmuf = make_bmuf(args, model)
    elif w > 1:
        optimizer = SumGradients(optimizer)
        global_batch_norm(model)

    start_epoch = 0
    resumed_steps = None
    ckpt_dir = f"{args.output_dir}/ckpt"
    if args.resume:
        try:
            state = restore_checkpoint(ckpt_dir, map_location=device)
            model.load_state_dict(state["model"])
            optimizer.load_state_dict(state["optimizer"])
            start_epoch = int(state["metadata"].get("epoch", -1)) + 1
            if bmuf is None:
                log_f.write(f"resumed from epoch {start_epoch - 1} "
                            f"(optimizer state included)\n")
            else:
                bmuf.load_state_dict(state["bmuf"])
                resumed_steps = int(state["bmuf"]["steps"])
                log_f.write(f"resumed BMUF state from epoch {start_epoch - 1} "
                            f"(step {resumed_steps})\n")
        except FileNotFoundError:
            log_f.write("no checkpoint found; starting fresh\n")
    # the BMUF schedule's global step: the checkpoint's when one was restored
    step_count = [resumed_steps if resumed_steps is not None
                  else start_epoch * args.num_batches_per_epoch]

    backend = "plain" if args.loss_backend == "xla" else "auto"
    cdt = torch.bfloat16 if args.compute_dtype == "bfloat16" else None
    def build_step(pruned_scale):
        return make_train_step(model, optimizer, featurizer, loss_chunk=args.loss_chunk,
                               loss_backend=backend, compute_dtype=cdt,
                               pruned_range=args.pruned_loss_range,
                               simple_scale=args.simple_loss_scale, pruned_scale=pruned_scale)

    full_step = build_step(1.0)
    # the pruned objective's warmup: the banded term at 0.1 for the first epochs
    warm_step = build_step(0.1) if args.pruned_loss_range > 0 else full_step
    utt_box = [0]  # utterances consumed this epoch (all ranks), for the epoch summary

    def save_tmp():
        if r == 0:
            save_bundle(f"{args.output_dir}/model.tmp", model)
        barrier()

    def run_epoch(epoch):
        logger = Logger(log_f, args.log_per_n_frames, ["Loss"])
        generator = torch.Generator(device).manual_seed(common.seed_for(args, epoch))
        step = warm_step if epoch < args.pruned_warmup_epochs else full_step
        pending = []  # device metrics, read every DRAIN_EVERY steps (no per-step sync)

        def drain():
            if not pending:
                return
            rows = torch.stack([torch.stack([m["loss"], m["num_labels"].float()])
                                for m in pending])
            if w > 1:
                dist.all_reduce(rows)  # the global batch's loss and labels
            for loss_val, n_labels in rows.cpu().numpy():
                loss_val = float(loss_val)
                if loss_val != loss_val:
                    log_f.write("NaN loss detected — stopping\n")
                    sys.exit(1)
                logger.update_and_log(int(n_labels), [loss_val])
            pending.clear()

        def pack(b):
            return rank_batch(b, pin), time.perf_counter()

        def pack_round(batches):
            return [rank_batch(b, pin) for b in pad_round(batches)], time.perf_counter()

        waits, leads = [], []  # consumer blocking; how long a ready batch sat
        n_batches = 0
        stream = batch_stream(args, loader_cfg, epoch, noise, rir)
        it = iter(prefetch_iter(stream, transform=pack) if bmuf is None else
                  prefetch_iter(group_rounds(stream, args.sync_period), transform=pack_round))
        while True:
            t0 = time.perf_counter()
            try:
                host, t_ready = next(it)
            except StopIteration:
                break
            t1 = time.perf_counter()
            waits.append(t1 - t0)
            leads.append(t1 - t_ready)
            if bmuf is None:
                pending.append(step(to_device(host, device), generator))
                utt_box[0] += loader_cfg.batch_size
                n_batches += 1
                if len(pending) >= DRAIN_EVERY:
                    drain()
                if args.save_every_n_batches and n_batches % args.save_every_n_batches == 0:
                    drain()
                    save_tmp()
                continue
            ok, metrics = bmuf.round(optimizer, lambda h: step(to_device(h, device), generator),
                                     host, step_count[0])
            step_count[0] += args.sync_period
            utt_box[0] += loader_cfg.batch_size * args.sync_period
            if not ok:
                log_f.write("NaN detected in BMUF sync — stopping\n")
                sys.exit(1)
            logger.update_and_log(int(metrics["num_labels"].sum()),
                                  [float(metrics["loss"].sum())])
        if leads:
            ahead = sum(1 for x in leads if x > 5e-3)
            unit = "batches" if bmuf is None else "rounds"
            log_f.write(f"prefetch overlap: {ahead}/{len(leads)} {unit} pinned before "
                        f"request; consumer wait total {sum(waits):.2f}s "
                        f"(max {max(waits):.2f}s)\n")
        drain()
        logger.summarize_and_log()

    eval_step = make_eval_step(model, featurizer) if args.valid_data_lst else None

    def run_validation(epoch):
        vcfg = dataclasses.replace(loader_cfg, augment=False)
        vargs = copy.copy(args)
        vargs.data_lst = args.valid_data_lst
        tot = np.zeros(2)
        # a valid set smaller than the batch logs and skips
        for batch in batch_stream(vargs, vcfg, 0, required=False):
            m = eval_step(to_device(rank_batch(batch, False), device))
            tot += [float(m["loss"]), float(m["num_labels"])]
        tot_loss, tot_labels = all_sum(tot, device)
        log_f.write(f"===> Epoch {epoch} valid loss/label: "
                    f"{tot_loss / max(tot_labels, 1.0):.4f} <===\n")
        log_f.flush()

    saver = {"thread": None, "error": None}

    def join_saver():
        """Wait for the saving thread; its failure fails the run."""
        if saver["thread"] is not None:
            saver["thread"].join()
            saver["thread"] = None
        if saver["error"] is not None:
            raise RuntimeError("saving a checkpoint failed") from saver["error"]

    def save(epoch):
        """The epoch's checkpoint and bundle, written by rank 0 while the
        other ranks wait; with --async_save written on a thread from a host
        copy taken here."""
        if r != 0:
            barrier()
            return
        join_saver()
        snap = _host_copy if args.async_save else (lambda x: x)
        model_state = snap(model.state_dict())
        opt_state = snap(optimizer.state_dict())
        bmuf_state = None if bmuf is None else snap({**bmuf.state_dict(),
                                                     "steps": step_count[0]})

        def write():
            save_checkpoint(ckpt_dir, epoch, model_state, opt_state, metadata={"epoch": epoch},
                            bmuf_state=bmuf_state)
            save_bundle(f"{args.output_dir}/model.epoch.{epoch}", model,
                        metadata={"epoch": epoch}, state_dict=model_state)

        def write_on_thread():
            try:
                write()
            except Exception as exc:  # re-raised on the main thread by join_saver
                saver["error"] = exc

        if args.async_save:
            saver["thread"] = threading.Thread(target=write_on_thread, daemon=False)
            saver["thread"].start()
        else:
            write()
        barrier()

    for epoch in range(start_epoch, args.num_epochs):
        log_f.write(f"===> Epoch {epoch} <===\n")
        log_f.flush()
        utt_box[0] = 0
        t_epoch = time.perf_counter()
        run_epoch(epoch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t_epoch
        log_f.write(f"===> Epoch {epoch} wall {dt:.1f}s, {utt_box[0]} utts, "
                    f"{utt_box[0] / max(dt, 1e-9):.1f} utt/s <===\n")
        log_f.flush()
        if (epoch + 1) % max(args.save_interval, 1) == 0 or epoch == args.num_epochs - 1:
            save(epoch)
        if eval_step is not None:
            run_validation(epoch)
    join_saver()
    log_f.write("Training Finished\n")


if __name__ == "__main__":
    main()
