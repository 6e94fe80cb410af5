"""End-to-end CLI training throughput: synthetic corpus -> the port's
``pika_tpu_torch.train.train_transducer`` entry point (threaded loader,
host augmentation, pinned prefetch, steps through K1-K3 on the card) on the
flagship config; the port's counterpart of the repo's
``tools/bench_cli_train.py``.  Run on the card:

    python -m pika_tpu_torch.tools.bench_cli_train [--utts 400] [--epochs 2]

Prints the per-epoch ``utt/s`` lines and the prefetch line the trainer
writes to its log (epoch 0 includes the first call's plans and the
kernels' load; later epochs are steady state), then the total wall time.
Comparable to ``bench_train``: same flagship model, the same 10 s
waveform bucket (source utterances are 9 s, so every speed-perturbed
variant still lands in it), labels in the 32-bucket against its fixed
U=40.  The corpus and the run's checkpoints live in a temporary directory,
removed at the end.
"""

from __future__ import annotations

import argparse
import re
import shutil
import tempfile
import time

import numpy as np

from pika_tpu_torch.data.archive import MrkSeqWriter
from pika_tpu_torch.data.scp import write_int_vectors
from pika_tpu_torch.train import train_transducer

VOCAB = 6268


def make_corpus(root: str, n_utts: int, seconds: float, n_labels: int, vocab: int) -> str:
    """``n_utts`` utterances of ``seconds`` s of int16 noise and
    ``n_labels`` random labels each, from numpy ``default_rng(0)``, as
    mrk/seq archives, a label.txt and a data list under ``root``; returns
    the data list's path."""
    rng = np.random.default_rng(0)
    sr = 16000
    labels = []
    with MrkSeqWriter(f"{root}/bench.mrk", f"{root}/bench.seq") as w:
        for i in range(n_utts):
            pcm = (rng.standard_normal(int(sr * seconds)) * 4000).astype(np.int16)
            uttid = f"utt{i:05d}"
            w.write(uttid, pcm)
            labels.append((uttid, rng.integers(1, vocab, n_labels).tolist()))
        shards = list(w.shards)
    write_int_vectors(f"{root}/label.txt", labels)
    lst = f"{root}/data.lst"
    with open(lst, "w") as f:
        for mrk, seq in shards:
            f.write(f"{mrk} {seq} ark:{root}/label.txt\n")
    return lst


def train_argv(lst: str, log: str, root: str, args) -> list:
    """The training CLI's command line: the flagship at ``--batch``."""
    return [
        lst, log, root,
        "--encoder_type", "transformer", "--decoder_type", "rnn",
        "--rnn_size", "1024", "--enc_layers", "9", "--dec_layers", "2",
        "--tdnn_nhid", "1024", "--tdnn_layers", "9",
        "--embd_dim", "100", "--output_dim", str(VOCAB),
        "--batch_size", str(args.batch), "--dp_mode", "sync", "--num_devices", "1",
        "--num_epochs", str(args.epochs),
        "--num_batches_per_epoch", str(max(1, args.utts // args.batch)),
        "--save_interval", str(args.save_interval),
        "--initial_lr", "0.003", "--final_lr", "0.0001",
        "--grad_clip", "3.0", "--spec_augment",
        "--max_wav_seconds", "10.0",
        "--num_workers", str(args.workers),
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--utts", type=int, default=400)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=9.0)
    ap.add_argument("--labels", type=int, default=30)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--save_interval", type=int, default=1,
                    help="checkpoint every N epochs (and after the last); >1 "
                         "takes the per-epoch checkpoint writes out of the "
                         "total wall time")
    args = ap.parse_args(argv)

    root = tempfile.mkdtemp(prefix="bench_cli_")
    try:
        lst = make_corpus(root, args.utts, args.seconds, args.labels, VOCAB)
        log = f"{root}/train.log"
        t0 = time.perf_counter()
        train_transducer.main(train_argv(lst, log, root, args))
        total = time.perf_counter() - t0
        with open(log) as f:
            for line in f:
                if re.search(r"wall .*utt/s|prefetch overlap", line):
                    print(line.strip(), flush=True)
        print(f"total wall (incl. first call + checkpoint saves): {total:.1f}s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
