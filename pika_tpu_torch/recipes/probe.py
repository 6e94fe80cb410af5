"""The warm-up convergence probe (``tests/test_convergence_probe.py``'s
run, on the port): the synthetic corpus at seed 11 (256 training
utterances, 4 test), the training CLI with the recipe's clean augmentation
(speed +-4 %, gain) and deterministic batch order, 12 epochs of 16 batches
of 16 x <= 2 s, a 2 x 128 rnn encoder, one LSTM layer of 128, V = 31, Adam
0.004 -> 0.002.  The RNN-T starts near 12 a label, sits at chance (ln 31 ~
3.43) for some epochs and then breaks out: the JAX package's calibration
reaches about 1.1 at epoch 11.

    python -m pika_tpu_torch.recipes.probe WORK [--device cpu]

prints the per-epoch "Overall Avg Loss" values and exits 1 unless they
meet the JAX probe's gates (``GATES``).
"""

from __future__ import annotations

import argparse
import json
import os

from pika_tpu_torch.recipes import hard_corpus
from pika_tpu_torch.recipes.stages import (
    Recipe,
    epoch_losses,
    global_cmvn,
    run_main,
    wav_to_seq,
    write_fbank_conf,
)

EPOCHS = 12
# (epoch, loss bound) of the JAX probe: learning in epoch 0, near chance by
# epoch 3, the plateau broken by epoch 11
GATES = ((0, 15.0), (3, 4.5), (11, 2.0))


def commands(work: str) -> dict:
    """The probe's corpus and training CLI argv (without ``--device``)."""
    return {
        "corpus": [work, "--train", "256", "--test", "4", "--seed", "11"],
        "train": [f"{work}/train/data.lst", f"{work}/train.log", f"{work}/exp",
                  "--feat_config", f"{work}/fbank.conf",
                  "--cmvn_stats", f"{work}/train/global_cmvn.stats",
                  "--optim", "adam", "--initial_lr", "0.004", "--final_lr", "0.002",
                  "--encoder_type", "rnn", "--enc_layers", "2", "--rnn_size", "128",
                  "--embd_dim", "64", "--decoder_type", "rnn", "--dec_layers", "1",
                  "--dropout", "0.1", "--output_dim", "31",
                  "--feats_dim", "40", "--lctx", "1", "--rctx", "1", "--stride", "1",
                  "--num_workers", "1",
                  "--speed_rate", "0.96,1.0,1.04", "--gain_range", "55,10",
                  "--grad_clip", "3.0", "--momentum", "0.9",
                  "--num_batches_per_epoch", "16", "--batch_size", "16",
                  "--max_wav_seconds", "2.0",
                  "--dp_mode", "sync", "--num_devices", "1",
                  "--num_epochs", str(EPOCHS), "--seed", "1"],
    }


def run_probe(work: str, device=None) -> dict:
    """The probe in ``work`` (made fresh each time): its per-epoch losses,
    the training's wall seconds and the stage times."""
    from pika_tpu_torch.train.train_transducer import main as train_main

    cmd = commands(work)
    r = Recipe(work, device)
    write_fbank_conf(f"{work}/fbank.conf")
    r.stage("probe corpus", None, lambda: r.cli(hard_corpus.main, cmd["corpus"], device=False))
    r.stage("probe prep", None, lambda: wav_to_seq(r, f"{work}/train", "train",
                                                   f"{work}/fbank.conf"))
    r.stage("probe CMVN", None, lambda: global_cmvn(r, f"{work}/train", "train",
                                                    f"{work}/fbank.conf"))
    if os.path.exists(f"{work}/train.log"):
        os.remove(f"{work}/train.log")
    r.stage("probe training", None, lambda: r.cli(train_main, cmd["train"]))
    return {"losses": epoch_losses(f"{work}/train.log"), "train_s": r.times["probe training"],
            "times": r.times}


def missed_gates(losses: list) -> list:
    """The gates ``losses`` misses, as text (all of them past its end)."""
    return [f"epoch {e}: {losses[e] if e < len(losses) else 'missing'} (gate < {bound})"
            for e, bound in GATES if not (e < len(losses) and losses[e] < bound)]


def main(argv=None):
    ap = argparse.ArgumentParser(description="the warm-up convergence probe on the port")
    ap.add_argument("work")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run_probe(args.work, args.device)
    missed = missed_gates(out["losses"])
    print(json.dumps({"losses": out["losses"], "train_s": out["train_s"], "missed": missed}))
    return not missed


if __name__ == "__main__":
    run_main(main)
