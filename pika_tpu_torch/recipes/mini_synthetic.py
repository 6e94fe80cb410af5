"""The mini end-to-end quality recipe on the port (``egs/mini_synthetic.sh``
stage by stage): a synthetic-but-hard corpus (formant tokens, unseen test
speakers, a noisy test set at 12-22 dB SNR with unseen noise and its clean
copy) -> prep -> CMVN -> two-phase RNN-T training (a clean warm-up, then a
resumed noisy phase) -> beam decode -> WER on the noisy and the clean test
set; with ``--full_pipeline`` (the script's ``FULL_PIPELINE=1``) also MBR
fine-tuning, the LAS forward and backward rescorers and the MBR model's
decode with both.

    python -m pika_tpu_torch.recipes.mini_synthetic WORK [--full_pipeline] [--device cpu]

Its defaults are the script's flags.  Only the overrides shrink it: the
corpus sizes (``--train``, ``--test``), the epochs (``--warmup_epochs``,
``--epochs``, ``--mbr_epochs``, ``--las_epochs``) and ``--set NAME=VALUE``,
which replaces a flag's value in every CLI that takes it (widths,
``num_batches_per_epoch``, ``batch_size``, ...).  Each stage is skipped when
its last artifact exists, and a finished decode is reused.  The WER lines
are printed and written to ``WORK/RESULTS`` (``TAG %WER ...``).  Besides
the script's decodes, stage 8 also decodes the MBR model without the
rescorers (the script's header quotes that number).
"""

from __future__ import annotations

import argparse
import os

from pika_tpu_torch.recipes import hard_corpus
from pika_tpu_torch.recipes.stages import (
    Recipe,
    epoch_losses,
    global_cmvn,
    parse_sets,
    run_main,
    summary,
    wav_to_seq,
    write_fbank_conf,
)

TRAIN, TEST = 1500, 200
WARMUP_EPOCHS, EPOCHS, MBR_EPOCHS, LAS_EPOCHS = 20, 160, 2, 8


def model_flags(seed=None) -> list:
    """``model_flags`` of the scripts (``egs/mini_synthetic.sh:70-78``;
    ``egs/mini_grammar.sh`` adds ``--seed``)."""
    return ["--encoder_type", "transformer", "--enc_layers", "9",
            "--tdnn_nhid", "256", "--tdnn_layers", "9",
            "--decoder_type", "rnn", "--dec_layers", "1", "--rnn_size", "256", "--embd_dim", "64",
            "--dropout", "0.1", "--tdnn_transformer_dropout", "0.1", "--output_dim", "31",
            "--feats_dim", "40", "--lctx", "1", "--rctx", "1", "--stride", "1",
            "--num_workers", "1",
            "--speed_rate", "0.96,1.0,1.04", "--gain_range", "55,10",
            "--grad_clip", "3.0", "--momentum", "0.9",
            "--num_batches_per_epoch", "94", "--batch_size", "16", "--max_wav_seconds", "4.0",
            "--dp_mode", "sync", "--num_devices", "1",
            *(["--seed", str(seed)] if seed is not None else []),
            "--rng_impl", "threefry2x32"]


def decode_flags(conf: str, stats: str) -> list:
    return ["--feat_config", conf, "--cmvn_stats", stats,
            "--beam_size", "4", "--n_best", "4", "--max_symbols", "16",
            "--feats_dim", "40", "--lctx", "1", "--rctx", "1", "--stride", "1",
            "--batch_size", "16", "--max_wav_seconds", "4.0", "--output_scores"]


def aug_flags(data: str) -> list:
    return ["--feats_dim", "40", "--lctx", "1", "--rctx", "1", "--stride", "1",
            "--speed_rate", "0.96,1.0,1.04", "--gain_range", "55,10",
            "--noise_lst", f"{data}/noise.lst", "--snr_range", "10,30", "--max_wav_seconds", "4.0",
            "--rng_impl", "threefry2x32"]


def train_commands(data: str, exp: str, conf: str, warmup_epochs: int, epochs: int,
                   seed=None) -> dict:
    """Stages 3a and 3b: the clean warm-up and the resumed noisy phase."""
    stats = f"{data}/train/global_cmvn.stats"
    return {
        "train_warmup": [f"{data}/train/data.lst", f"{exp}/train_warmup.log", exp,
                         "--feat_config", conf, "--cmvn_stats", stats,
                         "--optim", "adam", "--initial_lr", "0.001", "--final_lr", "0.0008",
                         "--num_epochs", str(warmup_epochs), *model_flags(seed)],
        "train": [f"{data}/train/data.lst", f"{exp}/train.log", exp,
                  "--feat_config", conf, "--cmvn_stats", stats,
                  "--optim", "adam", "--initial_lr", "0.001", "--final_lr", "0.00005",
                  "--num_epochs", str(epochs),
                  "--noise_lst", f"{data}/noise.lst", "--snr_range", "10,30",
                  "--resume", *model_flags(seed)],
    }


def mbr_command(data: str, out: str, conf: str, model: str, epochs: int, seed=None) -> list:
    return [f"{data}/train/data.lst", f"{out}/train.log", out,
            "--feat_config", conf, "--cmvn_stats", f"{data}/train/global_cmvn.stats",
            "--init_model", model,
            "--initial_lr", "2e-5", "--final_lr", "5e-6", "--grad_clip", "3.0", "--momentum", "0.9",
            "--num_epochs", str(epochs), "--num_batches_per_epoch", "94", "--batch_size", "16",
            "--output_dim", "31", "--beam_size", "4", "--sm_scale", "1.2", "--rnnt_scale", "0.02",
            *(["--seed", str(seed)] if seed is not None else []), *aug_flags(data)]


def las_command(data: str, out: str, conf: str, model: str, epochs: int, reverse: bool,
                seed=None) -> list:
    return [f"{data}/train/data.lst", f"{out}/train.log", out,
            "--feat_config", conf, "--cmvn_stats", f"{data}/train/global_cmvn.stats",
            "--shared_encoder_model", model,
            "--SOS", "0", "--EOS", "31", "--padding_tgt", "32", "--padding_idx", "32",
            "--output_dim", "32",
            "--enc_layers", "1", "--dec_layers", "1", "--rnn_size", "128", "--embd_dim", "32",
            "--global_attention", "mlp",
            "--optim", "adam", "--initial_lr", "3e-4", "--final_lr", "5e-5",
            "--num_epochs", str(epochs), "--num_batches_per_epoch", "94", "--batch_size", "16",
            "--sampling_decoder", "--sampling_prob", "0.1", "--increase_sampling_prob_epoch", "4",
            *(["--seed", str(seed)] if seed is not None else []),
            *(["--reverse_labels"] if reverse else []), *aug_flags(data)]


def commands(work: str, train: int = TRAIN, test: int = TEST,
             warmup_epochs: int = WARMUP_EPOCHS, epochs: int = EPOCHS,
             mbr_epochs: int = MBR_EPOCHS, las_epochs: int = LAS_EPOCHS) -> dict:
    """Each stage's CLI argv (without ``--device``), by stage."""
    data, exp, conf = f"{work}/data", f"{work}/exp", f"{work}/fbank.conf"
    stats = f"{data}/train/global_cmvn.stats"
    model = f"{exp}/model.epoch.{epochs - 1}"
    mbr_model = f"{work}/mbr/model.epoch.{mbr_epochs - 1}"
    dec = decode_flags(conf, stats)
    return {
        "corpus": [data, "--train", str(train), "--test", str(test)],
        **train_commands(data, exp, conf, warmup_epochs, epochs),
        "decode_noisy": [model, f"{data}/test/wav.scp", f"{work}/nbest_noisy.txt",
                         "--ref_labels", f"ark:{data}/test/label.txt", *dec],
        "decode_clean": [model, f"{data}/test_clean/wav.scp", f"{work}/nbest_clean.txt",
                         "--ref_labels", f"ark:{data}/test_clean/label.txt", *dec],
        "mbr": mbr_command(data, f"{work}/mbr", conf, model, mbr_epochs),
        "las_fw": las_command(data, f"{work}/las_fw", conf, model, las_epochs, False),
        "las_bw": las_command(data, f"{work}/las_bw", conf, model, las_epochs, True),
        "decode_mbr": [mbr_model, f"{data}/test/wav.scp", f"{work}/nbest_noisy_mbr.txt",
                       "--ref_labels", f"ark:{data}/test/label.txt", *dec],
        "decode_rescored": [mbr_model, f"{data}/test/wav.scp", f"{work}/nbest_noisy_rescored.txt",
                            "--ref_labels", f"ark:{data}/test/label.txt",
                            "--las_rescorer_model", f"{work}/las_fw/model.epoch.{las_epochs - 1}",
                            "--las_rescorer_bw_model",
                            f"{work}/las_bw/model.epoch.{las_epochs - 1}",
                            "--SOS", "0", "--EOS", "31", *dec],
    }


def run(work: str, device=None, full_pipeline: bool = False, flags=None,
        decode_timeout: float = 1500.0, train: int = TRAIN, test: int = TEST,
        warmup_epochs: int = WARMUP_EPOCHS, epochs: int = EPOCHS, mbr_epochs: int = MBR_EPOCHS,
        las_epochs: int = LAS_EPOCHS) -> dict:
    """The recipe in ``work``; returns its WERs by tag (None where a decode
    failed), the stage times and both training phases' epoch losses."""
    from pika_tpu_torch.train.train_las import main as las_main
    from pika_tpu_torch.train.train_mbr import main as mbr_main
    from pika_tpu_torch.train.train_transducer import main as train_main

    cmd = commands(work, train, test, warmup_epochs, epochs, mbr_epochs, las_epochs)
    r = Recipe(work, device, flags, results=f"{work}/RESULTS", decode_timeout=decode_timeout)
    data, exp, conf = f"{work}/data", f"{work}/exp", f"{work}/fbank.conf"
    os.makedirs(exp, exist_ok=True)
    write_fbank_conf(conf)

    r.stage(f"stage 0: synthesize corpus ({train} train / {test} noisy test)",
            f"{data}/char.txt", lambda: r.cli(hard_corpus.main, cmd["corpus"], device=False))
    r.stage("stage 1: wav.scp -> mrk/seq archives", f"{data}/train/data.lst",
            lambda: wav_to_seq(r, f"{data}/train", "train", conf))
    r.stage("stage 2: global CMVN", f"{data}/train/global_cmvn.stats",
            lambda: global_cmvn(r, f"{data}/train", "train", conf))
    r.stage(f"stage 3a: RNN-T warm-up, clean augmentation only ({warmup_epochs} epochs)",
            f"{exp}/model.epoch.{warmup_epochs - 1}", lambda: r.cli(train_main, cmd["train_warmup"]))
    r.stage(f"stage 3b: RNN-T training with noise SNR 10-30 dB (resume, to epoch {epochs})",
            f"{exp}/model.epoch.{epochs - 1}", lambda: r.cli(train_main, cmd["train"]))
    wers = {}
    r.say("=== stage 4: decode the NOISY held-out test set ===")
    wers["noisy"] = r.wer_of("noisy", cmd["decode_noisy"], f"{work}/decode_noisy.out")
    r.say("=== stage 5: decode the CLEAN copy of the same utterances ===")
    wers["clean"] = r.wer_of("clean", cmd["decode_clean"], f"{work}/decode_clean.out")
    if full_pipeline:
        os.makedirs(f"{work}/mbr", exist_ok=True)
        r.stage("stage 6: MBR fine-tuning", f"{work}/mbr/model.epoch.{mbr_epochs - 1}",
                lambda: r.cli(mbr_main, cmd["mbr"]))
        for d in ("fw", "bw"):
            os.makedirs(f"{work}/las_{d}", exist_ok=True)
            r.stage(f"stage 7: LAS {d} rescorer training",
                    f"{work}/las_{d}/model.epoch.{las_epochs - 1}",
                    lambda d=d: r.cli(las_main, cmd[f"las_{d}"]))
        r.say("=== stage 8: decode the MBR model, then with LAS fw/bw rescoring ===")
        wers["mbr"] = r.wer_of("mbr", cmd["decode_mbr"], f"{work}/decode_mbr.out")
        wers["mbr_las"] = r.wer_of("mbr_las", cmd["decode_rescored"],
                                   f"{work}/decode_mbr_las.out")
    return {"wer": wers, "times": r.times,
            "losses": {"warmup": epoch_losses(f"{exp}/train_warmup.log"),
                       "train": epoch_losses(f"{exp}/train.log")}}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="egs/mini_synthetic.sh on the port")
    ap.add_argument("work", nargs="?", default="recipe_work/mini_synthetic")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of every stage (default: the CUDA card)")
    ap.add_argument("--full_pipeline", action="store_true",
                    help="also MBR, the LAS rescorers and the rescored decode (stages 6-8)")
    ap.add_argument("--train", type=int, default=TRAIN)
    ap.add_argument("--test", type=int, default=TEST)
    ap.add_argument("--warmup_epochs", type=int, default=WARMUP_EPOCHS)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--mbr_epochs", type=int, default=MBR_EPOCHS)
    ap.add_argument("--las_epochs", type=int, default=LAS_EPOCHS)
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE",
                    help="replace --NAME's value in every CLI that takes it")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = run(args.work, args.device, args.full_pipeline, parse_sets(args.set),
              train=args.train, test=args.test,
              warmup_epochs=args.warmup_epochs, epochs=args.epochs,
              mbr_epochs=args.mbr_epochs, las_epochs=args.las_epochs)
    print(summary(out), flush=True)
    return all(w is not None for w in out["wer"].values())


if __name__ == "__main__":
    run_main(main)
