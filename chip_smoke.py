#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pika_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and nvcc.  It
builds the CUDA kernels from ``pika_tpu_torch/csrc``, holds each against its
plain PyTorch version at the shapes its path gives it (K1 at a ragged and
the eval shape, K2 and K3 at a ragged shape and at the training shape, fed
the cotangents of a real occupancy; K1-K3 at the bf16 rounding of the TPU
kernels they replace, and also against float32 within stated envelopes),
then drives the port at the flagship width
(``bench.py``'s model: TDNN-Transformer 9x1024, 2x1024 LSTM prediction net,
V=6268, random weights from a seed):

* the inference path: the eval step (RNN-T loss through K1) and greedy
  decoding of 8 utterances of 10 s;
* beam search on the same 8 utterances (beam 8, n_best 8, 200 symbols):
  the search replayed as a CUDA graph against its eager loop (identical
  N-bests), beam 1 against greedy, the N-best's invariants, bf16 ("auto")
  against float32, wall times of greedy and beam 8 graphed and eager and of
  beam 8 at bf16; the flash beam decode (3 K4 forward launches per encoder
  pass); and, after every other phase, a profiled graphed search;
* the decode CLI (``train/eval_transducer.py``) in-process on 8 synthetic
  10 s wavs and a port bundle of the model: 8 x 8 N-best lines and a WER
  line (a random model's WER is printed, not judged);
* FST shallow fusion on the same 8 utterances: a synthetic bigram ARPA over
  all V units written from a seed, ``compile_arpa`` and the advance cache
  (host build times, the cache written to its file and read back), beam 8
  in the per-beam, per-token top-8 cached, per-token exact and top-8 walk
  modes (each graphed against its eager loop, timed beside the plain
  beam), a trigram check of the walk's backoff levels (the card against
  the CPU and the cache), and the CLI with ``--fst_lm``; the exact and
  walk searches are profiled after every other phase;
* the training path: ``bench.py``'s step on 32 utterances of 10 s with 40
  labels -- dither 1.0, SpecAugment, dropout 0.2, the loss through K1
  forward and K2/K3 backward (bf16 products, z once per backward), inf-norm clipping
  at 3, SGD-Nesterov -- one
  warm-up step, then 3 timed steps from one seeded generator, a profiled
  step, and one step each on the kernel and the plain loss backends from
  the same weights and seed, which must agree;
* the training CLI (``train/train_transducer.py``) in process
  on a seeded synthetic corpus (64 training and 16 validation utterances
  of 2-12 s written by ``python -m pika_tpu_torch.data.prep wav_to_seq``,
  CMVN from ``compute_global_cmvn`` with ``egs/fbank.conf``), at the
  flagship width with the recipe's flags (``egs/train_transducer.sh``,
  ``--dp_mode sync``): 2 epochs with validation and bundles (the per-epoch
  lines, peak memory, K1-K3's launches), a ``--resume`` to a third epoch
  (the restored momentum and schedule step against the saved ones), one
  epoch at ``--compute_dtype bfloat16`` (its first batch within 2% of
  float32's), the bf16 and float32 steps timed at 8 x 12 s, one step each
  at 8 x 20 s and 2 x 60 s exact and 2 x 60 s with remat and 512-row
  chunked attention (wall time, peak memory), one ``--loader utt`` epoch
  over a Kaldi feature ark, and the decode CLI on the trained bundle;
* MBR fine-tuning on that corpus and bundle: the recipe's CLI
  (``egs/train_transducer_mbr.sh``: batch 4, beam 4, ``--sm_scale 1.2``,
  ``--rnnt_scale 0.02``, LR 2e-5 -> 5e-6, SpecAugment, 220 symbols) for 2
  epochs over 36 utterances with ``model.tmp`` every 4 steps (the epoch
  lines, peak memory, the beam loops it captured, K1-K3's launches), over
  references that the bundle's own hypotheses resemble (the bundle, trained
  on noise, emits to the 220-symbol cap: against the corpus' own labels
  every hypothesis of an utterance has one edit distance and the MBR
  weights are 0); then in process at 4 x 10 s of the corpus, with the
  CLI's featurizer and optimizer: non-zero sequence weights and surrogate,
  one step timed by stage through the step's own stage hook (decode, edit
  distance, loss forward + backward, optimizer), one launch each of K1, K2
  and K3 per step, the graphed N-best after an update against the eager
  loop, the objective, its RNN-T term and each parameter's gradient on
  the kernels against the plain loss backend, the surrogate's share of the
  gradient, and the surrogate (the alignment paths' gather, the blank
  steps' 1/T' weights, the sm_scale joint) and its gradients on the card
  against the CPU;
* the LAS rescorer on the same corpus with the bundle as its frozen shared
  encoder: the recipe's CLI (``egs/train_las_rescorer.sh``: rnn 1024, 2 + 2
  layers, mlp attention, V 6269, batch 8, Adam 1e-4, sampling 0.1) one
  epoch forward and one with ``--reverse_labels``; the decode CLI on 8
  synthetic 10 s wavs (beam 8, n_best 8) without the rescorers, then with
  both and ``--output_scores``, the rerank CLI on its N-best (the CLI's
  best hypotheses), the rescoring of the 8 x 8 hypotheses timed and
  profiled at their length and cut to 32 labels, and ``las_score_hyps`` on
  the card against the CPU (2 x 4 hypotheses);
* distributed training (``dist_path``) on the training CLI's corpus: the
  recipe's own command line (``--dp_mode bmuf --sync_period 5
  --block_momentum 0.9 --block_lr 1.0``) at world size 1 over NCCL for 2
  epochs and a ``--resume`` (the restored ``delta_prev`` and step count
  against the checkpoint's, K1-K3's launches), BMUF with block momentum 0
  and block LR 1 after one round against sync after the same 5 batches
  (random draws off; within twice the spread of two sync runs), a round's
  sync at the flagship's parameter count against its bytes bound, BMUF in
  the MBR CLI and BlockAdam and BMUF-Adam in the LAS CLI, and the rnn
  encoder at the CLI's defaults (steps at 4 x 10 s, a CLI epoch, the
  decode CLI on its bundle);
* the flash-attention path (``attn_flash=True``), whose encoder attention
  runs through K4: K4 forward and backward against their plain versions at
  ragged shapes, at the three encoder layers' shapes (B = 8 and 32) and at
  one 60 s shape, timed at the training shape beside their bound, their
  plain version and ``scaled_dot_product_attention`` (a yardstick the port
  never calls), and the d = 256 kernels at (32, 8, 239, 256) beside
  their plain version and SDPA; the eval step and greedy decode of 8
  utterances of 10 s
  (3 K4 launches per encoder pass; the loss against the exact path's); the
  eval step on 4 utterances of 60 s with 240 labels on the flash and on the
  exact path (peak memory, wall time, losses); the eval step of the model at
  ``tdnn_nhid=256`` (head widths 16, 16, 32: K4 zero-padded to 64) on the
  flash and the exact path; and ``bench.py``'s step with
  ``tdnn_transformer_dropout=0`` -- one warm-up and 2 timed steps through
  K1-K4, then one step each with flash and exact attention from the same
  weights and seed, which must agree;
* the quality recipes (``pika_tpu_torch/recipes/``): K1-K3 held and timed
  at their joints (V = 31, under one 64-column tile: the recipes' H 256
  and the probe's H 128, ragged lengths); the warm-up convergence probe
  (``recipes/probe.py``: the synthetic corpus at seed 11, the rnn encoder,
  12 epochs of 16 batches) held to the JAX probe's gates on its epoch
  losses, with K1-K3 launched; and ``recipes/mini_grammar.py`` end to end
  at a cut budget (corpus, prep, CMVN, bigram LM, the two training phases,
  the dev sweeps of FST fusion per beam and per token, MBR, LAS forward and
  backward, the LAS sweep and every test decode), every stage on the card,
  every RESULTS line of a known form, K1-K3 launched in training; its WERs
  printed, not judged; then ``recipes/las_diversity.py`` on its bundles
  (the independent LAS pair for 2 epochs of 4 batches, the nine-pair dev
  sweep, both test decodes; its RESULTS line forms) and the N-best oracle
  of the recipe's decodes beside their 1-best (``recipes/nbest_oracle.py``);
  then the pruned objective's grammar envelope in the same work directory
  (``recipes/pruned_grammar.py`` at 2 + 2 epochs of 4 batches,
  ``pruned_retune.py`` with one scale a sweep, ``pruned_finetune.py`` for 1
  epoch with its ``--sm_scale 0.5`` probe, ``exact_fusion_redecodes.py
  --seeds 1``): every RESULTS line of its recipe's form, the fine-tune's
  first epoch loss finite, K1-K3 launched in the fine-tune and not in the
  pruned training (its steps bypass them; no validation set); the stage
  seconds printed, the WERs printed, not judged; then ``pruned_grammar``
  twice more in new work directories over the same corpus: the same epoch
  losses, WERs and final weights, bit for bit;
* the pruned steps' repeat: a warm step and 3 flagship steps run twice on
  new models give the same losses and state, bit for bit;
* the throughput tools (``pika_tpu_torch/tools/``), each ``main`` in
  process at its defaults: ``bench_train`` (one JSON line after two
  repetitions of 10 steps within 10 %) with the full loss, launching
  K1-K3, and with ``BENCH_PRUNED=5``, launching none; ``bench_decode``
  without an LM (with its attribution) and per token through the advance
  cache; ``bench_cli_train`` at 64 utterances; each figure beside this
  script's own for the same work; then one of ``bench_train``'s steps
  traced through ``utils/profiling.trace``, the trace holding its
  ``span`` regions, the training step's own spans and K1's, K2's and
  K3's kernels;
* the LSTM's fused route (one cuDNN call per layer, packed ragged batches)
  held to its loop over frames at the independent LAS encoder's shape (16 x
  400 x 120, 3 bidirectional layers of 256), the probe's (16 x 198 x 120,
  2 of 128) and the prediction net's, unidirectional and unmasked (the
  grammar recipe's 16 x 18 x 64 into 256, the flagship's 32 x 41 x 100 into
  2 of 1024): outputs, final states and every gradient to 1e-5 relative
  L2, both routes timed; the probe's and the rnn encoder's step printed
  beside their times on the loop.

Float32 throughout, with TF32 off for matmuls and cuDNN (convolutions and
the LSTM), so the parity checks compare float32 with float32, except where
a phase says it runs with cuDNN's TF32 flag on as the CLIs leave it (the
two repeats, whose convolution backward does not repeat with it off, and
the prediction net's route, whose LSTM call sets cuDNN's flag to the
matmuls' either way); attention
rounds q, k, v and the probabilities to bf16 on both paths, as the JAX
package does.

Output: one line per phase; then the card's name and power limit as
nvidia-smi reports them; a JSON line with each kernel's launches on its
training path, max abs error against its plain version, its time, its
plain version's, its bound and the library call's where one exists; and
last ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line.  There is no CPU mode: without a CUDA card it exits 1.
"""

from __future__ import annotations

import contextlib
import gc
import glob
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from pika_tpu_torch.data.kaldi_ark import write_matrix_ark
from pika_tpu_torch.data.prep import main as prep_main
from pika_tpu_torch.data.wavio import read_wav, write_wav
from pika_tpu_torch.decode.beam import (
    BeamConfig,
    beam_search,
    beam_search_eager,
    beam_search_waveforms,
)
import pika_tpu_torch.decode.fst as fst_module
from pika_tpu_torch.decode.fst import (
    compile_arpa,
    fst_advance_sets,
    fst_final_scores,
    init_state_sets,
)
from pika_tpu_torch.decode.greedy import greedy_decode, greedy_decode_eager, greedy_decode_waveforms
from pika_tpu_torch.decode.rerank import main as rerank_main
from pika_tpu_torch.decode.rescore import las_score_hyps
from pika_tpu_torch.features.fbank import FbankConfig
from pika_tpu_torch.models.lstm import LSTM
from pika_tpu_torch.models.transducer import Transducer, TransducerConfig, init_transducer
from pika_tpu_torch.ops import cuda_build
from pika_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_di,
    flash_attention_fwd,
    flash_attention_reference,
)
from pika_tpu_torch.ops.rnnt_kernels import (
    joint_channels,
    joint_channels_bwd,
    joint_channels_bwd_in,
    joint_channels_bwd_reference,
    joint_channels_bwd_w,
    joint_channels_bwd_w_reference,
    joint_channels_reference,
    joint_launches,
    chunk_bounds,
)
from pika_tpu_torch.ops import rnnt_loss
from pika_tpu_torch.ops.rnnt_loss import (
    rnnt_alpha,
    rnnt_loss_forward,
    rnnt_loss_fused,
    rnnt_loss_numpy,
    rnnt_occupancy,
)
from pika_tpu_torch.ops.rnnt_pruned import prune_ranges, rnnt_loss_pruned, simple_channels
from pika_tpu_torch.features.fbank import make_fbank_fn
from pika_tpu_torch.train import common as cli_common
from pika_tpu_torch.train.bundle import load_bundle, save_bundle
from pika_tpu_torch.train.checkpoint import restore_checkpoint
import pika_tpu_torch.train.eval_transducer as eval_module
from pika_tpu_torch.train.eval_transducer import main as eval_main
from pika_tpu_torch.parallel import BMUF, BMUFConfig, process_group
from pika_tpu_torch.recipes import (
    exact_fusion_redecodes,
    las_diversity,
    mini_grammar,
    nbest_oracle,
    probe,
    pruned_finetune,
    pruned_grammar,
    pruned_retune,
)
from pika_tpu_torch.tools import bench_cli_train, bench_decode, bench_train
from pika_tpu_torch.train.lr import Optimizer, make_optimizer
from pika_tpu_torch.train.mbr import (
    make_mbr_step,
    mbr_decode,
    mbr_losses,
    mbr_risk,
    mbr_surrogate,
)
from pika_tpu_torch.train.train_las import main as las_main
from pika_tpu_torch.train.train_mbr import build_parser as mbr_parser, main as mbr_main
from pika_tpu_torch.train.train_transducer import batch_stream as train_cli_batches
from pika_tpu_torch.train.train_transducer import build_parser as train_cli_parser
from pika_tpu_torch.train.train_transducer import main as train_main
from pika_tpu_torch.train.step import (
    FeaturizerConfig,
    make_eval_step,
    make_featurizer,
    make_train_step,
)
from pika_tpu_torch.utils import profiling

VOCAB = 6268
BATCH = 8
SECONDS = 10
SR = 16000
U_MAX = 40
MAX_SYMBOLS = 200
BEAM = NBEST = 8
# K1 against its bf16 plain version (both round h and W2 to bf16 at the TPU
# kernel's points, sums in float32 in another order, exp2 against exp; the
# rare bf16 flip of an h by tanhf/expf against torch moves a logit by 2^-8
# of one of its H terms): lse (about 9 at V=6268) to 1e-4 relative, logits
# to 1e-3 absolute; against the float32 plain version each channel within
# K1_ENVELOPE absolute (the bf16 rounding of h and W2)
K1_RTOL, K1_ATOL, K1_ENVELOPE = 1e-4, 1e-3, 2e-2
# eval loss through K1 against the plain backend (the same bf16 function on
# the card), summed over the batch, a few thousand nats
LOSS_RTOL = 1e-4
# K2 and K3 against their bf16 plain version (both round h, W2 and dz to
# bf16 at the TPU kernels' points): float32 sums in another order, exp2
# against exp, and the rare bf16 flip of an h or dz that this moves across a
# rounding boundary; per gradient, relative L2 and the max abs error as a
# share of the largest reference entry (measured on an H100 at the training
# shape: K2 1.3e-05 and 5.0e-05, K3 2.9e-05 and 3.0e-05).  Against the
# float32 plain version:
# the envelope the TPU kernels' bf16 rounding was measured at (BASELINE.md,
# flagship scale)
K2_REL_L2, K2_MAX_REL = 1e-4, 1e-3
K3_REL_L2, K3_MAX_REL = 1e-4, 1e-3
ENVELOPE = 6.4e-3
TRAIN_BATCH = 32  # bench.py's batch
TIMED_STEPS = 3
# one train step on the kernel backend against the plain one, same weights
# and seed: the summed loss (float32, ~1e4 nats) to 1e-5 relative; each
# parameter's change to relative L2 1e-2, and 1e-1 in the encoder, whose
# gradients pass through the bf16-rounded attention (a rounding flipped by a
# last-bit difference from the joint moves them at the 1e-2 level: the CPU
# tests measure 5e-2 between the port and the JAX package); BatchNorm
# statistics to 1e-4
STEP_LOSS_RTOL = 1e-5
STEP_TOL, STEP_ENCODER_TOL, STATS_TOL = 1e-2, 1e-1, 1e-4
# a gradient leaf whose largest entry is below this share of the whole
# gradient's largest is zero to rounding (hold_gradients): at the flagship
# width the key biases' gradients (softmax ignores them) come to 1e-6 of
# the largest entry, the smallest real leaf (gate_y.weight) to 2.4e-4
ZERO_GRAD = 1e-4
FLAGSHIP = dict(input_dim=240, vocab_size=VOCAB, hid_dim=1024, encoder_type="tdnn_transformer",
                decoder_type="rnn", enc_layers=9, dec_layers=2, embd_dim=100, tdnn_nhid=1024,
                tdnn_layers=9)
FBANK = dict(sample_frequency=SR, window_type="hamming", low_freq=40.0, high_freq=-200.0,
             num_mel_bins=80)
OPTIM = dict(initial_lr=0.003, final_lr=0.0001, total_batches=100000, momentum=0.9,
             grad_clip=3.0)  # bench.py's optimizer
# K4 against its plain version: bf16 outputs and gradients, p rounded to bf16
# relative to the running max of the key tiles (kernel) or the row max
# (plain), so they agree to bf16 rounding: relative L2 and the max abs error
# as a share of the largest reference entry; lse is float32 (sums over T in
# another order)
K4_REL_L2, K4_MAX_REL, K4_LSE_ATOL = 1e-2, 1e-2, 1e-4
# a gradient whose reference stays under this is held to it absolute (times
# d / 128 past d = 128: ds = p (dp - di) at T = 1 is float32 noise of two
# sums over d taken in other orders)
K4_NOISE = 1e-5
# (heads, T, d_head) of the encoder's three attention layers at 10 s
FLASH_LAYERS = ((16, 992, 64), (16, 974, 64), (8, 239, 128))
# the third layer at tdnn_nhid = 2048, the smallest width whose heads
# (16, 16, 8) reach d_head 256: K4's d = 256 kernels
D256_LAYER = (8, 239, 256)
# FST fusion: a synthetic bigram ARPA over all V units (each context with
# FST_BIGRAMS continuations), lm_scale and nonblk_reward of the decode
FST_BIGRAMS, FST_SCALE, FST_REWARD = 40, 0.5, 0.5
SMALL_NHID = 256  # egs/mini_*.sh's tdnn_nhid: d_head 16, 16 and 32
# the quality recipes' joint (egs/mini_*.sh: --rnn_size 256, --output_dim 31,
# batch 16: a 4 s waveform bucket is 398 frames, T' 89 after the TDNN; the
# label bucket 16 makes U+1 17) and the warm-up probe's (--rnn_size 128, the
# rnn encoder does not subsample: a 2 s bucket is 198 frames): V under one
# 64-column tile
RECIPE_JOINTS = (("recipe", (16, 89, 17, 256, 31)), ("probe", (16, 198, 17, 128, 31)))
# the recipe path: egs/mini_grammar.sh at a cut budget (the corpus 64 train
# / 16 test, dev 16, 400 text lines; 2 + 2 epochs of 4 batches; MBR and LAS
# one epoch of 4 batches; sweeps of two scales and two LAS pairs)
RECIPE_CUT = dict(train=64, test=16, dev=16, text=400, warmup_epochs=2, epochs=4, mbr_epochs=1,
                  las_epochs=1)
RECIPE_SWEEPS = dict(fst_scales="0.4,0.8", pt_scales="0.8,1.2", las_sweep="0.05:0.05,0.3:0.7")
RECIPE_FLAGS = {"--num_batches_per_epoch": "4"}
# egs/las_diversity.sh after the cut recipe: the independent LAS pair for 2
# epochs of 4 batches each, the script's nine-pair dev sweep
LAS_IND_EPOCHS = 2
# tools/r5_pruned_*.sh after the cut recipe: the pruned training at its cut
# (2 + 2 epochs of 4 batches), one scale in each retune sweep, a 1-epoch
# full-loss fine-tune
PRUNED_SWEEPS = dict(fst_scales="0.8", pt_scales="1.2")
PRUNED_FT_EPOCHS = 1
# the LSTM's fused route (cuDNN) against its loop over frames: (name, batch,
# frames, input width, output width, bidirectional layers) of the independent
# LAS encoder (egs/las_diversity.sh: 4 s of 40 x 3 spliced fbank frames) and
# of the probe's rnn encoder (2 s buckets); ragged lengths from the full
# length down to 1, in shuffled order
LSTM_SHAPES = (("LAS encoder", 16, 400, 120, 256, 3), ("probe encoder", 16, 198, 120, 128, 2))
# the prediction net's form (unidirectional, unmasked) at (name, batch, U+1,
# embedding, hidden, layers): the grammar recipe's (egs/mini_grammar.sh:
# --embd_dim 64, --rnn_size 256, --dec_layers 1; the label bucket 17) and
# the flagship's; run with cuDNN's TF32 flag on, as the CLIs leave it
PREDICTION_SHAPES = (("recipe prediction net", 16, 18, 64, 256, 1),
                     ("flagship prediction net", 32, 41, 100, 1024, 2))
LSTM_RTOL = 1e-5  # relative L2, float32 on both routes (TF32 off)
# the records these phases print beside: their steps on the LSTM's loop over
# frames (PERF.md, NVIDIA H100 80GB HBM3, 700 W)
PROBE_STEP_S_BEFORE = "0.36-0.39 s"
RNN_STEP_S_BEFORE = "4.528-4.955 s"
LONG_SECONDS, LONG_BATCH, LONG_LABELS = 60, 4, 240
# flash against exact attention (same weights and seed), bf16 rounding in
# both, at other points: losses to 1e-3 relative (as the CPU tests hold the
# bf16 attention against JAX); one train step's parameter changes to
# STEP_TOL outside the encoder and 2e-1 inside it, BatchNorm statistics to
# 1e-2.  The flash backward rounds ds to bf16, the exact one keeps it
# float32; the transformer LayerNorm weights' small gradients amplify that
# (measured on an H100: 4.4e-2 to 8.3e-2 in the worst encoder tensor over
# three runs)
FLASH_LOSS_RTOL, FLASH_ENCODER_TOL, FLASH_STATS_TOL = 1e-3, 2e-1, 1e-2
# the training CLI phase: a seeded synthetic corpus in mrk/seq archives (64
# training and 16 validation utterances of 2-12 s of int16 noise, about 2.5
# labels a second, so that the longest stays under --TU_limit 15000 after
# speed 0.9), the recipe's command line (egs/train_transducer.sh:37-53) with
# --dp_mode sync, 2 epochs, a resume to a third, one bf16 epoch and one
# --loader utt epoch; the bf16 first batch within BF16_FIRST_RTOL of float32
REPO = os.path.dirname(os.path.abspath(__file__))
CLI_UTTS = {"train": 64, "valid": 16}
CLI_SECONDS = (2.0, 12.0)
CLI_LABELS_PER_SECOND = 2.5
CLI_MODEL_FLAGS = ["--encoder_type", "transformer", "--enc_layers", "9", "--tdnn_nhid", "1024",
                   "--decoder_type", "rnn", "--dec_layers", "2", "--rnn_size", "1024",
                   "--embd_dim", "100", "--output_dim", str(VOCAB)]
CLI_RECIPE_FLAGS = ["--initial_lr", "0.003", "--final_lr", "0.0001", "--grad_clip", "3.0",
                    "--momentum", "0.9", "--batch_size", "8", "--lctx", "1", "--rctx", "1",
                    "--stride", "1", "--TU_limit", "15000", "--spec_augment",
                    "--max_freq_span", "15", "--max_time_span", "35", "--dp_mode", "sync"]
CLI_EPOCHS, CLI_BATCHES_PER_EPOCH = 2, 8
BF16_FIRST_RTOL = 2e-2
# (batch, seconds, labels, model options) of the single long steps: the
# recipe's largest bucket (8 x 20 s), and 2 x 60 s exact and with the
# recipe's long-utterance levers
LONG_STEPS = ((8, 20, 50, {}), (2, 60, 150, {}), (2, 60, 150, {"remat": True, "attn_chunk": 512}))
# the MBR phase: the recipe's command line (egs/train_transducer_mbr.sh:13-25)
# on the training CLI's bundle, over the first MBR_UTTS utterances of its
# corpus (about 8 batches of 4 an epoch over the 5, 10 and 15 s buckets), 2
# epochs, model.tmp every 4 steps; the in-process step at MBR_BATCH x 10 s,
# MBR_LABELS labels where the bundle's hypothesis is empty
MBR_FLAGS = ["--initial_lr", "2e-5", "--final_lr", "5e-6", "--grad_clip", "3.0",
             "--momentum", "0.9", "--num_epochs", "2", "--num_batches_per_epoch", "20000",
             "--batch_size", "4", "--output_dim", str(VOCAB), "--lctx", "1", "--rctx", "1",
             "--stride", "1", "--beam_size", "4", "--sm_scale", "1.2", "--rnnt_scale", "0.02",
             "--spec_augment", "--decode_max_symbols", "220", "--tmp_save_batches", "4"]
MBR_UTTS, MBR_BATCH, MBR_LABELS = 36, 4, 25
MBR_BEAM = BeamConfig(beam_size=4, n_best=4, sm_scale=1.2, max_symbols=220, prune_dups=False,
                      mm_dtype="auto")
# the MBR surrogate on the card against the CPU, float32 with TF32 off on
# both (sums in another order over 1024-wide products, 6268-way softmaxes
# and 220 LSTM steps): the weights of an utterance sum to 0 over similar
# paths, so the value and its gradient cancel (to 3e-5 and about 1e-3 of
# their terms' sizes at the flagship width); each is held within this share
# of the surrogate under |weights|, whose terms do not cancel: the value
# against that value, each gradient's L2 difference against that
# gradient's L2 norm
SURROGATE_RTOL = 1e-4
# the LAS phase: the recipe's command line (egs/train_las_rescorer.sh:15-27)
# at its width on the training CLI's bundle as the shared encoder, one epoch
# forward and one with --reverse_labels over the training corpus
LAS_VOCAB = VOCAB + 1  # the labels and EOS 6268; pad 6269
LAS_FLAGS = ["--SOS", "0", "--EOS", str(VOCAB), "--padding_tgt", str(LAS_VOCAB),
             "--padding_idx", str(LAS_VOCAB), "--output_dim", str(LAS_VOCAB),
             "--enc_layers", "2", "--dec_layers", "2", "--rnn_size", "1024", "--embd_dim", "100",
             "--global_attention", "mlp", "--optim", "adam", "--initial_lr", "1e-4",
             "--final_lr", "1e-5", "--num_epochs", "1", "--num_batches_per_epoch", "20000",
             "--batch_size", "8", "--lctx", "1", "--rctx", "1", "--stride", "1",
             "--sampling_decoder", "--sampling_prob", "0.1", "--increase_sampling_prob_epoch", "2"]
# the rerank CLI's choice against the decode CLI's where they part: their
# fused scores within float32 rounding of sums over up to 221 per-token
# scores (relative)
RERANK_TIE = 1e-5
# las_score_hyps on the card against the CPU: 2 utterances x 4 hypotheses,
# float32 with TF32 off on both (sums in another order over 1024-wide
# products and 6269-way softmaxes)
LAS_RTOL = 1e-4
# the rescoring also timed with the N-best cut to this many labels: a
# trained model's length for 10 s at the corpus' 2.5 labels a second, with
# room for the beam's spread
RESCORE_CUT = 32
# the distributed phase: the recipe's block flags (egs/train_transducer.sh:52)
# at world size 1 over NCCL; the BMUF(0, 1) = sync hold on HOLD_UTTS
# utterances of one waveform and one label bucket (5 batches of 8: one
# round; no padding within it), its tolerance 2 x the spread of two sync
# runs plus HOLD_ULPS float32 ulps, relative L2 over all the parameters
# (BMUF's global - (global - local) rounds once); the rnn encoder at the CLI's
# defaults (2 x 512 bidirectional, frames not subsampled) with the recipe's V
DIST_FLAGS = ["--dp_mode", "bmuf", "--sync_period", "5", "--block_momentum", "0.9",
              "--block_lr", "1.0"]
HOLD_UTTS, HOLD_SECONDS, HOLD_LABELS, HOLD_ULPS = 40, (5.5, 6.0), 14, 4
SYNC_REPEATS = 10
OTHER_SYNC_PERIOD = 4  # the MBR and LAS phases' epochs have about 8 batches
RNN_MODEL_FLAGS = ["--encoder_type", "rnn", "--enc_layers", "2", "--rnn_size", "512", "--brnn",
                   "--output_dim", str(VOCAB)]
RNN_MODEL = dict(input_dim=240, vocab_size=VOCAB, hid_dim=512, encoder_type="rnn",
                 enc_layers=2, brnn=True, dec_layers=2, embd_dim=300, dropout=0.3)
RNN_BATCH, RNN_LABELS = 4, 25
# the transformer prediction net at TransducerConfig's widths (d_model 512,
# 8 heads, d_ff 2048), 2 layers, on the flagship encoder and joint
TRANSFORMER_DECODER = dict(decoder_type="transformer", dec_layers=2)
# the pruned objective at tools/r5_pruned_*.sh's band, its warm steps'
# weight; the pruned loss on the card against the CPU, float32 with TF32 off
# on both (sums in another order over 1024-wide products, 6268-way
# logsumexps and a DP over 239 frames), per utterance
PRUNED_RANGE, PRUNED_WARM_SCALE, PRUNED_RTOL = 5, 0.1, 1e-4
# the throughput tools (pika_tpu_torch/tools/) at their defaults, in process:
# bench_cli_train's --utts cut to BENCH_CLI_UTTS (depth: 8 steps of its batch
# 8 an epoch); a tool's figure more than TOOL_GAP from this script's own for
# the same work is flagged, to be explained (PERF.md); in a trace of
# bench_train's step, a kernel of each of K1-K3 (csrc/joint_fwd.cu's lse,
# csrc/joint_bwd.cu's dh and dW2 kernels) under kernel_label's labels
BENCH_CLI_UTTS = 64
TOOL_GAP = 0.15
TRACE_KERNELS = {"K1": "lse_kernel", "K2": "dh_kernel", "K3": "dw_kernel"}
# the spans of a float32 training step (utils/profiling.py)
TRAIN_SPANS = ("train.step", "features", "encoder", "prediction_net", "loss.k1", "loss.alpha",
               "train.backward", "loss.occupancy", "loss.k23", "optimizer")
# published H100 SXM peaks: float32 outside the tensor cores, bf16 dense,
# HBM bytes per second
PEAK_F32, PEAK_BF16, HBM_RATE = 67e12, 989e12, 3.35e12


def kernel_label(mangled: str) -> str:
    """``name<N>`` of a mangled kernel name such as
    ``_ZN.._cu_..20flash_bwd_dkv_kernelILi64EEEv..``: each name in it is
    prefixed by its length."""
    for found in re.finditer(r"\d+", mangled):
        digits = found[0]
        for k in range(len(digits)):  # a name's length may follow other digits (a file hash)
            name = mangled[found.end():found.end() + int(digits[k:])]
            if name.endswith("_kernel"):
                arg = re.match(r"ILi(\d+)E", mangled[found.end() + len(name):])
                return f"{name}<{arg[1]}>" if arg else name
    return mangled[:60]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, warmup: int, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak: float) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate for their type and the bytes over the memory rate."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def ragged_lengths(b: int, t: int, u1: int) -> tuple[list, list]:
    """Lengths of a padded batch: frames from t down to about t / 2, labels
    from u1 - 1 down to 4 (the corpus' fewest)."""
    return ([t - i * (t // 2) // (b - 1) for i in range(b)],
            [u1 - 1 - i * (u1 - 5) // (b - 1) for i in range(b)])


def joint_case(device, seed: int, b: int, t: int, u1: int, h: int, v: int):
    g = torch.Generator(device).manual_seed(seed)

    def randn(*shape, scale):
        return torch.randn(*shape, generator=g, device=device) * scale

    return (randn(b, t, h, scale=0.5), randn(b, t, h, scale=0.5),
            randn(b, u1, h, scale=0.5), randn(b, u1, h, scale=0.5),
            randn(h, v, scale=2.0 / math.sqrt(h)), randn(v, scale=0.1),
            torch.randint(0, v, (b, u1), generator=g, device=device, dtype=torch.int32))


def kernel_parity(device) -> dict:
    """K1 against joint_channels_reference at bf16 (and, within K1_ENVELOPE,
    at float32) at a ragged shape, at the quality recipes' and the probe's
    joints (V = 31) and at the flagship eval shape; times K1
    and its bf16 plain version at the eval shape, and K1 at the training
    shape (B = 32)."""
    worst = 0.0
    for name, shape in (("ragged", (2, 37, 11, 96, 301)), *RECIPE_JOINTS,
                        ("flagship", (BATCH, 239, U_MAX + 1, 1024, VOCAB))):
        args = joint_case(device, 1, *shape)
        ref = joint_channels_reference(*args, mm_dtype=torch.bfloat16)
        ref32 = joint_channels_reference(*args)
        got = joint_channels(*args)
        torch.cuda.synchronize()
        errs = []
        for ch, r, r32, k in zip(("lse", "z_blank", "z_label"), ref, ref32, got):
            err, err32 = (k - r).abs(), (k - r32).abs().max().item()
            check(bool(torch.isfinite(k).all()), f"K1 {name} {ch} finite")
            check(bool((err <= K1_ATOL + K1_RTOL * r.abs()).all()),
                  f"K1 {name} {ch} within rtol {K1_RTOL} atol {K1_ATOL} of bf16: max abs "
                  f"{err.max().item()}")
            check(err32 <= K1_ENVELOPE, f"K1 {name} {ch} vs float32: {err32} (tol {K1_ENVELOPE})")
            errs.append(f"{ch} {err.max().item():.3e} (vs float32 {err32:.3e})")
            worst = max(worst, err.max().item())
        say(f"kernel parity {name} B,T,U1,H,V={shape}: max abs err vs bf16 plain "
            f"{', '.join(errs)} (rtol {K1_RTOL}, atol {K1_ATOL}; vs float32 atol "
            f"{K1_ENVELOPE}): ok")
        del ref, ref32, got
    ms = time_ms(lambda: joint_channels(*args), warmup=2, iters=10)
    plain_ms = time_ms(lambda: joint_channels_reference(*args, mm_dtype=torch.bfloat16),
                       warmup=1, iters=5)

    def k1_bound(b, t, u1, h, v):  # W2 read as bf16, the product at the bf16 peak
        return bound(2.0 * b * t * u1 * h * v,
                     4 * (2 * b * t * h + 2 * b * u1 * h + v + b * u1 + 3 * b * t * u1)
                     + 2 * h * v, PEAK_BF16)

    flops, eval_bound = 2.0 * math.prod(shape), k1_bound(*shape)
    say(f"K1 flagship eval (B={BATCH}): {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s); bf16 plain "
        f"version: {plain_ms:.3f} ms; bound {eval_bound['bound_ms']:.3f} ms "
        f"({eval_bound['bound_by']}, bf16 {PEAK_BF16 / 1e12:.0f} TFLOP/s)")
    train_shape = (TRAIN_BATCH,) + shape[1:]
    del args
    args = joint_case(device, 1, *train_shape)
    train_ms = time_ms(lambda: joint_channels(*args), warmup=2, iters=10)
    train_bound = k1_bound(*train_shape)
    say(f"K1 flagship train (B={TRAIN_BATCH}): {train_ms:.3f} ms "
        f"({2.0 * math.prod(train_shape) / train_ms / 1e9:.1f} TFLOP/s); bound "
        f"{train_bound['bound_ms']:.3f} ms ({train_bound['bound_by']})")
    del args
    torch.cuda.empty_cache()

    # the loss through K1 against the literal numpy DP on a small input, its
    # log-probs from bf16-rounded h and W2 as K1 rounds them
    ax, gx, ay, gy, w2, b2, labels_ext = joint_case(device, 2, 2, 37, 11, 96, 301)
    labels = labels_ext[:, :-1].clamp(min=1)
    t_len = torch.tensor([37, 30], device=device)
    u_len = torch.tensor([10, 6], device=device)
    h = torch.tanh(ax[:, :, None] + ay[:, None]) * torch.sigmoid(gx[:, :, None] + gy[:, None])
    bf16 = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    log_probs = torch.log_softmax(bf16(h) @ bf16(w2) + b2, dim=-1)
    oracle = rnnt_loss_numpy(log_probs.cpu().numpy(), labels.cpu().numpy(),
                             t_len.cpu().numpy(), u_len.cpu().numpy())
    loss = rnnt_loss_forward(ax, gx, ay, gy, w2, b2, labels, t_len, u_len).cpu().numpy()
    check(bool(np.allclose(loss, oracle, rtol=1e-4)), f"K1 loss {loss} vs numpy DP {oracle}")
    say(f"loss through K1 vs numpy DP (bf16 h and W2): {loss.tolist()} vs {oracle.tolist()}: ok")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **eval_bound,
            "library_ms": None}


def occupancy_case(device, seed: int, b: int, t: int, u1: int, h: int, v: int, t_len, u_len):
    """K2/K3 inputs: random factors, K1's channels through the plain version,
    and the channel cotangents of the summed loss from the real occupancy."""
    ax, gx, ay, gy, w2, b2, labels_ext = joint_case(device, seed, b, t, u1, h, v)
    labels_ext = labels_ext.clamp(min=1)
    labels_ext[:, -1] = 0  # the column past the last label, as the loss builds it
    lse, zb, zy = joint_channels_reference(ax, gx, ay, gy, w2, b2, labels_ext,
                                           mm_dtype=torch.bfloat16)
    t_len = torch.tensor(t_len, device=device)
    u_len = torch.tensor(u_len, device=device)
    g_blank, g_emit = rnnt_occupancy(zb - lse, zy - lse, t_len, u_len)
    d_lse = -(g_blank + g_emit)
    return ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, g_blank, g_emit


def backward_parity(device) -> tuple[dict, dict]:
    """K2 and K3 against joint_channels_bwd_reference at bf16 (and, within
    ENVELOPE, at float32) at a ragged shape, at the recipes' and the probe's
    joints (V = 31, ragged lengths) and at the flagship training shape
    (bench.py's batch 32); times K2 and K3 alone, the fused backward
    (both from one z) and the bf16 plain versions at the flagship shape."""
    names = ("d_ax", "d_gx", "d_ay", "d_gy", "d_w2", "d_b2")
    worst = {"K2": 0.0, "K3": 0.0}
    cases = (("ragged", (3, 37, 11, 96, 301), [37, 20, 1], [10, 4, 0]),
             *((name, shape, *ragged_lengths(*shape[:3])) for name, shape in RECIPE_JOINTS),
             ("flagship train", (TRAIN_BATCH, 239, U_MAX + 1, 1024, VOCAB),
              [239] * TRAIN_BATCH, [U_MAX] * TRAIN_BATCH))
    for name, shape, t_len, u_len in cases:
        args = occupancy_case(device, 3, *shape, t_len, u_len)
        ref = joint_channels_bwd_reference(*args, mm_dtype=torch.bfloat16)
        ref32 = joint_channels_bwd_reference(*args)
        got = joint_channels_bwd(*args)
        torch.cuda.synchronize()
        parts = []
        for i, (g_name, g, r, r32) in enumerate(zip(names, got, ref, ref32)):
            kernel = "K2" if i < 4 else "K3"
            check(bool(torch.isfinite(g).all()), f"{name} {g_name} finite")
            rel32 = ((g - r32).norm() / r32.norm().clamp(min=1e-30)).item()
            err = (g - r).abs().max().item()
            scale = r.abs().max().item()
            rel = ((g - r).norm() / r.norm().clamp(min=1e-30)).item()
            rel_tol, max_tol = (K2_REL_L2, K2_MAX_REL) if kernel == "K2" else (K3_REL_L2,
                                                                              K3_MAX_REL)
            check(rel <= rel_tol and err <= max_tol * scale,
                  f"{kernel} {name} {g_name}: rel L2 {rel} (tol {rel_tol}), max abs {err} "
                  f"(tol {max_tol} x {scale})")
            check(rel32 <= ENVELOPE,
                  f"{kernel} {name} {g_name} vs float32: rel L2 {rel32} (tol {ENVELOPE})")
            parts.append(f"{g_name} max abs {err:.3e} (of {scale:.3e}), rel L2 {rel:.3e}, vs "
                         f"float32 {rel32:.3e}")
            worst[kernel] = max(worst[kernel], err)
        say(f"K2/K3 parity {name} B,T,U1,H,V={shape}, vs bf16 plain: " + "; ".join(parts)
            + f" (K2: rel L2 tol {K2_REL_L2}, max abs tol {K2_MAX_REL} x max|ref|; K3: "
            f"{K3_REL_L2}, {K3_MAX_REL} x max|ref|; vs float32: rel L2 tol {ENVELOPE}): ok")
        del ref, ref32, got
    k2_ms = time_ms(lambda: joint_channels_bwd_in(*args), warmup=2, iters=10)
    k3_ms = time_ms(lambda: joint_channels_bwd_w(*args), warmup=2, iters=10)
    fused_ms = time_ms(lambda: joint_channels_bwd(*args), warmup=2, iters=10)
    plain_ms = time_ms(lambda: joint_channels_bwd_reference(*args, mm_dtype=torch.bfloat16),
                       warmup=1, iters=2)
    k3_plain_ms = time_ms(lambda: joint_channels_bwd_w_reference(*args, mm_dtype=torch.bfloat16),
                          warmup=1, iters=2)
    product = 2.0 * math.prod(shape)  # one lattice-sized product
    b, t, u1, h, v = shape
    rows = b * t * u1
    # every kernel reads the factors, b2, the labels, the four channels and
    # W2 as bf16; K2 writes the four input gradients, K3 dW2 and db2
    read = 4 * (2 * b * t * h + 2 * b * u1 * h + v + b * u1 + 4 * rows) + 2 * h * v
    k2_out, k3_out = 4 * (2 * b * t * h + 2 * b * u1 * h), 4 * (h * v + v)
    k2_bound = bound(2 * product, read + k2_out, PEAK_BF16)  # z, dh
    k3_bound = bound(2 * product, read + k3_out, PEAK_BF16)  # z, dW2
    fused_bound = bound(3 * product, read + k2_out + k3_out, PEAK_BF16)  # z once, dW2, dh
    chunks = chunk_bounds(b, t, u1, v)
    rate = lambda n, ms: f"{n * product / ms / 1e9:.1f} TFLOP/s"  # noqa: E731
    say(f"K2 flagship train (h, dz, dh kernels): {k2_ms:.3f} ms ({rate(2, k2_ms)}), bound "
        f"{k2_bound['bound_ms']:.3f} ms ({k2_bound['bound_by']}, bf16 "
        f"{PEAK_BF16 / 1e12:.0f} TFLOP/s); bf16 plain backward (all six gradients, chunk 32): "
        f"{plain_ms:.3f} ms")
    say(f"K3 flagship train (h, dz, dW2 kernels): {k3_ms:.3f} ms ({rate(2, k3_ms)}), bound "
        f"{k3_bound['bound_ms']:.3f} ms; bf16 plain version: {k3_plain_ms:.3f} ms")
    say(f"K2 + K3 fused (h, dz, dW2, dh: z once): {fused_ms:.3f} ms ({rate(3, fused_ms)}, "
        f"wrapper included: padded bf16 W2 and W2^T, scratch, {len(chunks)} chunks of up to "
        f"{max(c1 - c0 for c0, c1 in chunks) * u1} rows), bound {fused_bound['bound_ms']:.3f} ms "
        f"({fused_bound['bound_by']}); K2 alone + K3 alone {k2_ms + k3_ms:.3f} ms")
    del args
    torch.cuda.empty_cache()
    return ({"max_abs_err": worst["K2"], "ms": k2_ms, "plain_ms": plain_ms, **k2_bound,
             "library_ms": None},
            {"max_abs_err": worst["K3"], "ms": k3_ms, "plain_ms": k3_plain_ms, **k3_bound,
             "library_ms": None})


def recipe_joint_times(device) -> None:
    """K1 and the fused K2 + K3 at the recipes' and the probe's joints beside
    their bf16 plain versions and their bounds (CUDA events)."""
    for name, shape in RECIPE_JOINTS:
        b, t, u1, h, v = shape
        args = occupancy_case(device, 4, *shape, *ragged_lengths(b, t, u1))
        fwd = args[:7]
        k1_ms = time_ms(lambda: joint_channels(*fwd), warmup=3, iters=20)
        k1_plain = time_ms(lambda: joint_channels_reference(*fwd, mm_dtype=torch.bfloat16),
                           warmup=2, iters=10)
        bwd_ms = time_ms(lambda: joint_channels_bwd(*args), warmup=3, iters=20)
        bwd_plain = time_ms(lambda: joint_channels_bwd_reference(*args, mm_dtype=torch.bfloat16),
                            warmup=2, iters=10)
        rows, product = b * t * u1, 2.0 * b * t * u1 * h * v
        read = 4 * (2 * b * t * h + 2 * b * u1 * h + v + b * u1) + 2 * h * v
        k1_bound = bound(product, read + 4 * 3 * rows, PEAK_BF16)
        bwd_bound = bound(3 * product, read + 4 * 4 * rows + 4 * (2 * b * t * h + 2 * b * u1 * h)
                          + 4 * (h * v + v), PEAK_BF16)
        say(f"{name} joint B,T,U1,H,V={shape}: K1 {k1_ms:.4f} ms (bf16 plain {k1_plain:.4f}, "
            f"bound {k1_bound['bound_ms']:.4f}, {k1_bound['bound_by']}); K2 + K3 fused "
            f"{bwd_ms:.4f} ms (bf16 plain {bwd_plain:.4f}, bound {bwd_bound['bound_ms']:.4f}, "
            f"{bwd_bound['bound_by']})")
        del args, fwd
    torch.cuda.empty_cache()


def flagship_batch(device, batch: int, seed: int = 0, seconds: int = SECONDS,
                   labels: int = U_MAX) -> dict:
    """bench.py's batch: ``batch`` utterances of ``seconds`` s of int16-scale
    noise and ``labels`` random labels each (10 s and 40 by default)."""
    rng = np.random.default_rng(seed)
    max_samples = SR * seconds
    wavs = (rng.standard_normal((batch, max_samples)) * 4000).astype(np.float32)
    return {
        "wavs": torch.from_numpy(wavs).to(device),
        "wav_lens": torch.full((batch,), max_samples, dtype=torch.int32, device=device),
        "labels": torch.from_numpy(rng.integers(1, VOCAB, (batch, labels)).astype(np.int32)).to(device),
        "label_lens": torch.full((batch,), labels, dtype=torch.int32, device=device),
    }


def eval_setup(device, seconds: int = SECONDS, **model_kw):
    """The flagship model from seed 0 (``model_kw`` override its config) and
    the eval featurizer for utterances of ``seconds`` s."""
    model = init_transducer(TransducerConfig(**{**FLAGSHIP, **model_kw}),
                            torch.Generator(device).manual_seed(0), device)
    featurizer = make_featurizer(FeaturizerConfig(fbank=FbankConfig(dither=0.0, **FBANK),
                                                  max_samples=SR * seconds, lctx=1, rctx=1),
                                 device=device)
    return model, featurizer


def check_hyps(hyps, lens, device) -> None:
    check(tuple(hyps.shape) == (BATCH, MAX_SYMBOLS) and tuple(lens.shape) == (BATCH,),
          f"hyp shapes {tuple(hyps.shape)}, {tuple(lens.shape)}")
    check(bool(((lens >= 0) & (lens <= MAX_SYMBOLS)).all()), f"hyp lens {lens.tolist()}")
    slots = torch.arange(MAX_SYMBOLS, device=device)[None, :]
    inside = slots < lens[:, None].long()
    check(bool(((hyps >= 1) & (hyps < VOCAB))[inside].all()), "hyp tokens in [1, V)")
    check(bool((hyps[~inside] == -1).all()), "hyp padding is -1")


def inference_path(device) -> tuple[int, float]:
    """Flagship-width eval step and greedy decode; returns K1's launches and
    the eval loss."""
    t0 = time.perf_counter()
    model, featurizer = eval_setup(device)
    batch = flagship_batch(device, BATCH)
    eval_step = make_eval_step(model, featurizer, loss_chunk=32)
    torch.cuda.synchronize()
    say(f"model init + inputs: {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    eval_step(batch)  # first call: cuBLAS/cuDNN/FFT plans
    torch.cuda.synchronize()
    say(f"eval step, first call: {time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats(device)
    joint_channels.launches = 0
    t0 = time.perf_counter()
    loss = eval_step(batch)["loss"]
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hyps, lens = greedy_decode_waveforms(model, featurizer, batch["wavs"], batch["wav_lens"],
                                         max_symbols=MAX_SYMBOLS)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = joint_channels.launches
    peak = torch.cuda.max_memory_allocated(device)
    say(f"eval step (K1): {eval_s:.3f} s, loss {loss.item():.4f}; greedy decode: "
        f"{decode_s:.3f} s; peak memory {peak / 2**30:.3f} GiB; K1 launches {launches}")

    check(launches > 0, "the eval step launched K1")
    check(bool(torch.isfinite(loss)), "eval loss finite")
    loss_plain = make_eval_step(model, featurizer, loss_chunk=32, loss_backend="plain")(batch)["loss"]
    rel = abs(loss.item() - loss_plain.item()) / abs(loss_plain.item())
    check(rel <= LOSS_RTOL, f"eval loss {loss.item()} vs plain backend {loss_plain.item()}")
    say(f"eval loss vs plain backend {loss_plain.item():.4f}: rel err {rel:.3e} "
        f"(rtol {LOSS_RTOL}): ok")
    # how far the bf16 function (the TPU kernel's mm_dtype) moves the eval
    # loss: the plain backend with float32 matmuls
    bf16_dtype = rnnt_loss.plain_mm_dtype
    rnnt_loss.plain_mm_dtype = lambda device: torch.float32
    try:
        loss_f32 = make_eval_step(model, featurizer, loss_chunk=32,
                                  loss_backend="plain")(batch)["loss"].item()
    finally:
        rnnt_loss.plain_mm_dtype = bf16_dtype
    say(f"eval loss (bf16 K1) vs float32 plain: {loss.item():.4f} vs {loss_f32:.4f}, rel "
        f"{abs(loss.item() - loss_f32) / abs(loss_f32):.3e}")

    check_hyps(hyps, lens, device)
    say(f"greedy decode: lens {lens.tolist()}: ok")
    return launches, loss.item()


def train_setup(device, batch: dict, backend: str = "auto", compute_dtype=None, step_kw=None,
                **model_kw):
    """A flagship model from seed 0 (``model_kw`` override its config) with
    bench.py's optimizer and the training featurizer (dither 1.0,
    SpecAugment), CMVN from the batch's own frames; returns
    ``(model, step)``, the step built with ``step_kw`` (the pruned
    objective's arguments)."""
    model = init_transducer(TransducerConfig(**{**FLAGSHIP, **model_kw}),
                            torch.Generator(device).manual_seed(0), device)
    feat_cfg = dict(max_samples=batch["wavs"].shape[1], lctx=1, rctx=1)
    with torch.no_grad():
        plain = make_featurizer(FeaturizerConfig(fbank=FbankConfig(dither=0.0, **FBANK),
                                                 **feat_cfg), device=device)
        feats, _ = plain(batch["wavs"], batch["wav_lens"])  # full-length utterances
        frames = feats.reshape(-1, feats.shape[-1])
        offset, scale = -frames.mean(0), 1.0 / frames.std(0)
    featurizer = make_featurizer(
        FeaturizerConfig(fbank=FbankConfig(dither=1.0, **FBANK), spec_augment=True, **feat_cfg),
        offset, scale, device=device)
    optimizer = make_optimizer(model.parameters(), "sgd", **OPTIM)
    return model, make_train_step(model, optimizer, featurizer, loss_chunk=16,
                                  loss_backend=backend, compute_dtype=compute_dtype,
                                  **(step_kw or {}))


def dp_seconds(fn, repeats: int = 3) -> float:
    """Median host-clock seconds of ``fn`` (a loop of small launches)."""
    times = []
    for _ in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times[1:])


def train_path(device) -> tuple[dict, float]:
    """bench.py's training step at flagship width: one warm-up step, then
    TIMED_STEPS steps from one seeded generator.  Returns the launches of
    K1, K2 and K3 over the timed steps, and the median step time."""
    t0 = time.perf_counter()
    batch = flagship_batch(device, TRAIN_BATCH)
    model, step = train_setup(device, batch)
    gen = torch.Generator(device).manual_seed(1)
    torch.cuda.synchronize()
    say(f"train: model init + inputs + CMVN: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    first = step(batch, gen)["loss"].item()
    say(f"train step, first call: {time.perf_counter() - t0:.3f} s, loss {first:.4f}")
    check(math.isfinite(first), "first train loss finite")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    torch.cuda.reset_peak_memory_stats(device)
    joint_channels.launches = joint_channels_bwd_in.launches = joint_channels_bwd_w.launches = 0
    times, losses = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(step(batch, gen)["loss"].item())  # .item() waits for the step
        times.append(time.perf_counter() - t0)
    launches = {"K1": joint_channels.launches, "K2": joint_channels_bwd_in.launches,
                "K3": joint_channels_bwd_w.launches}
    peak = torch.cuda.max_memory_allocated(device)
    step_s = statistics.median(times)
    say(f"train steps (K1 fwd, K2/K3 bwd), batch {TRAIN_BATCH} x {SECONDS} s: "
        f"{', '.join(f'{x:.4f}' for x in times)} s, median {step_s:.4f} s "
        f"({TRAIN_BATCH / step_s:.2f} utt/s); losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"peak memory {peak / 2**30:.3f} GiB; launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"train losses finite: {losses}")
    check(all(n > 0 for n in launches.values()), f"the train steps launched K1, K2, K3: {launches}")
    changed = sum(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    check(changed == len(before), f"{changed} of {len(before)} parameters changed")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "parameters finite")
    say(f"train: all {changed} parameter tensors changed and finite: ok")

    # the loss DP loops at this shape: T' host-driven steps of small ops each
    t_out = model.encoder_out_len(1 + (SR * SECONDS - 400) // 160)  # 25 ms frames, 10 ms hop
    g = torch.Generator(device).manual_seed(2)
    lp = -torch.rand((TRAIN_BATCH, t_out, U_MAX + 1), generator=g, device=device) * 5 - 0.1
    lens_t = torch.full((TRAIN_BATCH,), t_out, device=device)
    lens_u = torch.full((TRAIN_BATCH,), U_MAX, device=device)
    alpha = rnnt_alpha(lp, lp, lens_u)
    alpha_s = dp_seconds(lambda: rnnt_alpha(lp, lp, lens_u))
    occ_s = dp_seconds(lambda: rnnt_occupancy(lp, lp, lens_t, lens_u, alpha=alpha))
    say(f"loss DP at T'={t_out}, U+1={U_MAX + 1}: forward alpha loop {alpha_s * 1e3:.2f} ms "
        f"({alpha_s / step_s:.2%} of the step), backward beta loop + occupancy "
        f"{occ_s * 1e3:.2f} ms ({occ_s / step_s:.2%} of the step)")

    profile(lambda: step(batch, gen)["loss"].item(), "train step")
    del model, step, before
    torch.cuda.empty_cache()
    return launches, step_s


def write_cli_corpus(work: str, device) -> dict:
    """The CLI phase's corpus: CLI_UTTS seeded utterances per split as wavs,
    a label.txt, mrk/seq archives written by ``python -m
    pika_tpu_torch.data.prep wav_to_seq`` and a data list; then the global
    CMVN statistics of the training split with egs/fbank.conf (in process,
    on ``device``).  Returns the paths."""
    rng = np.random.default_rng(4)
    paths = {}
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    for split, n in CLI_UTTS.items():
        d = os.path.join(work, split)
        os.makedirs(d)
        with open(os.path.join(d, "wav.scp"), "w") as scp, \
                open(os.path.join(d, "label.txt"), "w") as lab:
            for i in range(n):
                secs = float(rng.uniform(*CLI_SECONDS))
                path = os.path.join(d, f"{split}{i}.wav")
                write_wav(path, (rng.standard_normal(int(SR * secs)) * 3000).astype(np.int16), SR)
                scp.write(f"{split}{i} {path}\n")
                n_labels = max(1, round(CLI_LABELS_PER_SECOND * secs))
                lab.write(f"{split}{i} " + " ".join(map(str, rng.integers(1, VOCAB, n_labels)))
                          + "\n")
        out = subprocess.run([sys.executable, "-m", "pika_tpu_torch.data.prep", "wav_to_seq",
                              os.path.join(d, "wav.scp"), os.path.join(d, "a.mrk"),
                              os.path.join(d, "a.seq"), "--device", str(device)],
                             cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        check(out.returncode == 0, f"prep wav_to_seq: {out.stderr[-2000:]}")
        with open(os.path.join(d, "data.lst"), "w") as f:
            for line in out.stdout.splitlines():
                mrk, seq = line.split()
                f.write(f"{mrk} {seq} ark:{os.path.join(d, 'label.txt')}\n")
        paths[split] = d
    t1 = time.perf_counter()
    paths["fbank"] = os.path.join(REPO, "egs", "fbank.conf")
    paths["stats"] = os.path.join(work, "global_cmvn.stats")
    prep_main(["compute_global_cmvn", os.path.join(paths["train"], "data.lst"), paths["stats"],
               "--feat_config", paths["fbank"], "--device", str(device)])
    say(f"train CLI corpus: {CLI_UTTS} utterances of {CLI_SECONDS[0]}-{CLI_SECONDS[1]} s: wavs + "
        f"prep wav_to_seq {t1 - t0:.3f} s, compute_global_cmvn (egs/fbank.conf) "
        f"{time.perf_counter() - t1:.3f} s")
    return paths


def cli_run(what: str, argv: list, log: str, main=None) -> tuple[list, float, float]:
    """A training CLI's ``main(argv)`` in process (the transducer CLI's
    unless ``main`` is given); prints the log's epoch lines and returns (the
    log's lines, wall seconds, peak device memory in GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (main or train_main)(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(log) as f:
        lines = f.read().splitlines()
    for line in lines:
        if line.startswith(("===>", "resumed", "prefetch", "Finished", "MBR ", "LAS ")):
            say(f"{what}: {line}")
    say(f"{what}: {secs:.3f} s in all, peak memory {peak:.3f} GiB")
    check(lines[-1] == "Training Finished", f"{what} finished")
    losses = [float(x) for line in lines
              for x in re.findall(r"Overall Avg [A-Z ]*Loss: (\S+)", line)]
    check(len(losses) > 0 and all(math.isfinite(x) for x in losses), f"{what} losses {losses}")
    return lines, secs, peak


def epoch_utt_s(lines: list) -> list:
    """The utt/s of each "===> Epoch N wall ..." line of a training log."""
    return [float(m[1]) for m in (re.match(r"===> Epoch \d+ wall \S+, \d+ utts, (\S+) utt/s", x)
                                  for x in lines) if m]


def first_batch_loss(lines: list) -> float:
    """The first per-batch line's loss per label (--log_per_n_frames 1)."""
    return float(next(re.match(r"Loss: (\S+)", x).group(1) for x in lines
                      if x.startswith("Loss: ")))


def write_feature_ark(paths: dict, device) -> str:
    """The training split's fbank features (egs/fbank.conf, no dither) as a
    Kaldi ark, for --loader utt."""
    fb = FbankConfig.from_conf(paths["fbank"])
    items = []
    with open(os.path.join(paths["train"], "wav.scp")) as scp:
        for line in scp:
            uttid, path = line.split()
            pcm, _ = read_wav(path)
            x = torch.from_numpy(pcm.astype(np.float32)).to(device)[None]
            feats, lens = make_fbank_fn(fb, x.shape[1], device=device)(
                x, torch.tensor([x.shape[1]], device=device))
            items.append((uttid, feats[0, :int(lens[0])].cpu().numpy()))
    ark = os.path.join(paths["train"], "feats.ark")
    write_matrix_ark(ark, items)
    return ark


def step_times(device) -> None:
    """The bf16-compute step beside the float32 step: the recipe's batch of
    8 utterances of 12 s, 30 labels, one warm-up and TIMED_STEPS timed
    steps each from one seeded generator."""
    batch = flagship_batch(device, 8, seconds=12, labels=30)
    medians = {}
    for name, dtype in (("float32", None), ("bf16", torch.bfloat16)):
        model, step = train_setup(device, batch, compute_dtype=dtype)
        gen = torch.Generator(device).manual_seed(1)
        step(batch, gen)["loss"].item()
        times, losses = [], []
        for _ in range(TIMED_STEPS):
            t0 = time.perf_counter()
            losses.append(step(batch, gen)["loss"].item())
            times.append(time.perf_counter() - t0)
        medians[name] = statistics.median(times)
        say(f"train step at compute_dtype {name}, batch 8 x 12 s: "
            f"{', '.join(f'{x * 1e3:.1f}' for x in times)} ms, median {medians[name] * 1e3:.1f} ms; "
            f"losses {', '.join(f'{x:.4f}' for x in losses)}")
        check(all(math.isfinite(x) for x in losses), f"{name} step losses finite")
        del model, step
        torch.cuda.empty_cache()
    say(f"train step bf16 / float32: {medians['bf16'] / medians['float32']:.3f}")


def long_train_steps(device) -> None:
    """One train step (after one warm-up step) at each of LONG_STEPS: wall
    time and peak memory, exact attention against remat + chunking."""
    for b, secs, labels, kw in LONG_STEPS:
        batch = flagship_batch(device, b, seconds=secs, labels=labels)
        model, step = train_setup(device, batch, **kw)
        gen = torch.Generator(device).manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        step(batch, gen)["loss"].item()
        t0 = time.perf_counter()
        loss = step(batch, gen)["loss"].item()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device)
        say(f"train step {b} x {secs} s, {labels} labels, {kw or 'exact attention'}: "
            f"{wall:.3f} s, peak memory {peak / 2**30:.3f} GiB, loss {loss:.4f}")
        check(math.isfinite(loss), "long train step loss finite")
        del model, step, batch
        torch.cuda.empty_cache()


def train_cli_path(device, work: str) -> tuple[dict, dict]:
    """The training CLI (``train/train_transducer.py``) in process on a
    seeded corpus at the flagship width with the recipe's flags: 2 epochs
    with validation and bundles, a resume to a third epoch (the restored
    momentum and schedule step against the saved ones), one bf16 epoch
    (its first batch against float32's), the bf16 and float32 steps timed,
    the long-utterance steps, one --loader utt epoch and the decode CLI on
    the trained bundle, all under ``work``.  Returns K1-K3's launches over
    the first run, the corpus' paths with the trained bundle (``"bundle"``)
    for the second-stage phases, and the first run's epochs' utt/s."""
    t_phase = time.perf_counter()
    paths = write_cli_corpus(work, device)
    train_lst = os.path.join(paths["train"], "data.lst")
    common = [*CLI_MODEL_FLAGS, *CLI_RECIPE_FLAGS, "--feat_config", paths["fbank"],
              "--cmvn_stats", paths["stats"], "--device", str(device),
              "--num_batches_per_epoch", str(CLI_BATCHES_PER_EPOCH), "--log_per_n_frames", "1"]
    exp = os.path.join(work, "exp")
    log = os.path.join(work, "train.log")
    reset_launches()
    lines, _, _ = cli_run("train CLI", [train_lst, log, exp, *common,
                                        "--num_epochs", str(CLI_EPOCHS), "--valid_data_lst",
                                        os.path.join(paths["valid"], "data.lst")], log)
    launches = {"K1": joint_channels.launches, "K2": joint_channels_bwd_in.launches,
                "K3": joint_channels_bwd_w.launches}
    say(f"train CLI launches over {CLI_EPOCHS} epochs with validation: {launches}")
    check(all(n > 0 for n in launches.values()), f"the CLI launched K1-K3: {launches}")
    check(sum("valid loss/label" in x for x in lines) == CLI_EPOCHS, "validation lines")
    for e in range(CLI_EPOCHS):
        check(os.path.exists(os.path.join(exp, f"model.epoch.{e}", "model.pt")),
              f"bundle model.epoch.{e}")
    f32_first = first_batch_loss(lines)
    epoch_rates = epoch_utt_s(lines)

    # --resume to a third epoch: the optimizer the CLI restores against
    # the saved state
    saved = restore_checkpoint(os.path.join(exp, "ckpt"), CLI_EPOCHS - 1, map_location=device)
    restored = []
    load = Optimizer.load_state_dict

    def recording_load(self, state):
        load(self, state)
        restored.append((self.count, [self.opt.state[p]["momentum_buffer"].clone()
                                      for p in self.params]))

    Optimizer.load_state_dict = recording_load
    try:
        lines, _, _ = cli_run("train CLI --resume", [
            train_lst, os.path.join(work, "resume.log"), exp, *common,
            "--num_epochs", str(CLI_EPOCHS + 1), "--resume"], os.path.join(work, "resume.log"))
    finally:
        Optimizer.load_state_dict = load
    check(any(x.startswith(f"resumed from epoch {CLI_EPOCHS - 1}") for x in lines), "resumed")
    count, moms = restored[0]
    saved_moms = [saved["optimizer"]["optimizer"]["state"][i]["momentum_buffer"]
                  for i in range(len(moms))]
    check(count == saved["optimizer"]["count"] > 0,
          f"schedule step restored: {count} vs saved {saved['optimizer']['count']}")
    check(len(moms) == len(saved["optimizer"]["optimizer"]["state"]) > 0
          and all(torch.equal(a, b) for a, b in zip(moms, saved_moms)),
          "momentum buffers restored")
    say(f"resume: schedule step {count} and {len(moms)} momentum buffers equal the saved "
        f"ones: ok")

    # one bf16 epoch from the same seed
    bf16_log = os.path.join(work, "bf16.log")
    lines, _, _ = cli_run("train CLI --compute_dtype bfloat16", [
        train_lst, bf16_log, os.path.join(work, "exp_bf16"), *common, "--num_epochs", "1",
        "--compute_dtype", "bfloat16"], bf16_log)
    bf16_first = first_batch_loss(lines)
    rel = abs(bf16_first - f32_first) / abs(f32_first)
    say(f"first batch loss/label bf16 {bf16_first} vs float32 {f32_first}: rel {rel:.3e} "
        f"(rtol {BF16_FIRST_RTOL})")
    check(rel <= BF16_FIRST_RTOL, "bf16 first batch within tolerance of float32")
    step_times(device)
    long_train_steps(device)

    # one --loader utt epoch over Kaldi arks of the training split
    t0 = time.perf_counter()
    ark = write_feature_ark(paths, device)
    say(f"feature ark of the training split: {time.perf_counter() - t0:.3f} s")
    utt_log = os.path.join(work, "utt.log")
    cli_run("train CLI --loader utt", [
        ark, utt_log, os.path.join(work, "exp_utt"), *common, "--num_epochs", "1",
        "--loader", "utt", "--ali_rspec", f"ark:{os.path.join(paths['train'], 'label.txt')}",
        "--feats_dim", "80"], utt_log)

    # the decode CLI on the resumed run's last bundle
    valid = paths["valid"]
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        wer = eval_main([os.path.join(exp, f"model.epoch.{CLI_EPOCHS}"),
                         os.path.join(valid, "wav.scp"), os.path.join(work, "nbest.txt"),
                         "--beam_size", str(BEAM), "--n_best", str(NBEST),
                         "--max_wav_seconds", str(int(CLI_SECONDS[1]) + 1),
                         "--feat_config", paths["fbank"], "--cmvn_stats", paths["stats"],
                         "--ref_labels", f"ark:{os.path.join(valid, 'label.txt')}",
                         "--device", str(device)])
    with open(os.path.join(work, "nbest.txt")) as f:
        n_lines = len(f.read().splitlines())
    for line in err.getvalue().splitlines():
        say(f"decode CLI on model.epoch.{CLI_EPOCHS}: {line}")
    check(n_lines == CLI_UTTS["valid"] * NBEST and wer is not None,
          f"decode CLI: {n_lines} N-best lines")
    say(f"decode CLI: {time.perf_counter() - t0:.3f} s, {n_lines} N-best lines, WER "
        f"{wer:.4f} (trained {CLI_EPOCHS + 1} epochs on noise: printed, not judged)")
    paths["bundle"] = os.path.join(exp, f"model.epoch.{CLI_EPOCHS}")
    say(f"train CLI phase: {time.perf_counter() - t_phase:.3f} s")
    return launches, paths, epoch_rates


def decode_cli_best(argv: list) -> tuple[dict, list]:
    """The decode CLI (``eval_main``) on ``argv`` (with --ref_labels);
    returns its best hypothesis of each utterance (label strings) and its
    stderr lines."""
    best = {}
    score_wer = eval_module.score_wer

    def recording_score_wer(refs, hyps):
        best.update(hyps)
        return score_wer(refs, hyps)

    eval_module.score_wer = recording_score_wer
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            eval_main(argv)
    finally:
        eval_module.score_wer = score_wer
    return best, err.getvalue().splitlines()


def resembling_ref(top: list, n: int) -> list:
    """``n`` labels that the hypothesis ``top`` resembles, as a model at
    20% WER sees its references: every s-th of its labels (s = len(top) //
    n), the fifth, tenth, ... of those replaced.  An utterance's hypotheses
    then have different edit distances to it, the top one the least."""
    s = max(1, len(top) // max(n, 1))
    ref = top[s - 1::s][:n]
    return [t % (VOCAB - 1) + 1 if i % 5 == 4 else t for i, t in enumerate(ref)]


def subset_archive(paths: dict, n: int, device) -> str:
    """A data list over the first ``n`` training utterances: their wav.scp
    through ``prep wav_to_seq`` in process, and a label file of references
    that the bundle's own hypotheses resemble (``resembling_ref`` of the
    top hypothesis of the MBR step's search, at each utterance's own label
    count, so that the loader's label buckets and T x U limit hold)."""
    d = os.path.join(os.path.dirname(paths["train"]), f"first{n}")
    os.makedirs(d)
    with open(os.path.join(paths["train"], "wav.scp")) as f:
        lines = f.read().splitlines()[:n]
    with open(os.path.join(d, "wav.scp"), "w") as f:
        f.write("\n".join(lines) + "\n")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        prep_main(["wav_to_seq", os.path.join(d, "wav.scp"), os.path.join(d, "a.mrk"),
                   os.path.join(d, "a.seq"), "--device", str(device)])
    own_file = os.path.join(paths["train"], "label.txt")
    with open(own_file) as f:
        own = {x.split()[0]: [int(t) for t in x.split()[1:]] for x in f.read().splitlines()}
    best, _ = decode_cli_best([
        paths["bundle"], os.path.join(d, "wav.scp"), os.path.join(d, "nbest.txt"),
        "--beam_size", str(MBR_BEAM.beam_size), "--n_best", "1", "--sm_scale",
        str(MBR_BEAM.sm_scale), "--max_symbols", str(MBR_BEAM.max_symbols),
        "--max_wav_seconds", str(int(CLI_SECONDS[1]) + 1), "--feat_config", paths["fbank"],
        "--cmvn_stats", paths["stats"], "--ref_labels", f"ark:{own_file}",
        "--device", str(device)])
    label_file = os.path.join(d, "label.txt")
    with open(label_file, "w") as f:
        for utt in (x.split()[0] for x in lines):
            ref = resembling_ref([int(t) for t in best[utt]], len(own[utt])) or own[utt]
            f.write(f"{utt} {' '.join(map(str, ref))}\n")
    with open(os.path.join(d, "data.lst"), "w") as f:
        for line in out.getvalue().splitlines():
            mrk, seq = line.split()
            f.write(f"{mrk} {seq} ark:{label_file}\n")
    return os.path.join(d, "data.lst")


def mbr_setup(device, paths: dict):
    """The MBR CLI's own model, training featurizer (egs/fbank.conf, the
    corpus' CMVN statistics, SpecAugment) and optimizer, from MBR_FLAGS on
    the training CLI's bundle; returns (model, featurizer, optimizer)."""
    args = mbr_parser().parse_args([
        "data.lst", "log", "out", *MBR_FLAGS, "--init_model", paths["bundle"], "--feat_config",
        paths["fbank"], "--cmvn_stats", paths["stats"], "--device", str(device)])
    model, _ = load_bundle(paths["bundle"], device)
    featurizer, _, _ = cli_common.featurizer_from_args(args, device=device)
    return model, featurizer, cli_common.optimizer_from_args(args, model.parameters())


def corpus_batch(paths: dict, device) -> dict:
    """MBR_BATCH utterances of the CLI corpus' training split that last at
    least SECONDS s, cut to SECONDS s, and their first MBR_LABELS labels:
    the audio the bundle decodes in the CLI."""
    with open(os.path.join(paths["train"], "label.txt")) as f:
        labels = {x.split()[0]: [int(t) for t in x.split()[1:]] for x in f.read().splitlines()}
    wavs, refs = [], []
    with open(os.path.join(paths["train"], "wav.scp")) as f:
        for utt, path in (x.split() for x in f.read().splitlines()):
            pcm = read_wav(path)[0]
            if len(pcm) >= SR * SECONDS and len(wavs) < MBR_BATCH:
                wavs.append(pcm[:SR * SECONDS].astype(np.float32))
                refs.append((labels[utt] + [0] * MBR_LABELS)[:MBR_LABELS])
    check(len(wavs) == MBR_BATCH, f"{MBR_BATCH} corpus utterances of {SECONDS} s")
    return {"wavs": torch.from_numpy(np.stack(wavs)).to(device),
            "wav_lens": torch.full((MBR_BATCH,), SR * SECONDS, dtype=torch.int32, device=device),
            "labels": torch.tensor(refs, dtype=torch.int32, device=device),
            "label_lens": torch.full((MBR_BATCH,), MBR_LABELS, dtype=torch.int32, device=device)}


def nbest_refs(nbest, batch: dict) -> dict:
    """``batch`` with references that its N-best resembles: each
    utterance's longest hypothesis (the best-scored of the longest) through
    ``resembling_ref`` at its own length, so that the hypotheses' edit
    distances differ also where the search stops after a label or two (the
    batch's own labels where every hypothesis is empty)."""
    longest = nbest["lens"].cpu().argmax(1).tolist()  # the first of the longest
    tops = [nbest["tokens"][b, k, :nbest["lens"][b, k]].tolist() for b, k in enumerate(longest)]
    own = [row[:n].tolist() for row, n in zip(batch["labels"].cpu(), batch["label_lens"].tolist())]
    refs = [resembling_ref(t, len(t)) or o for t, o in zip(tops, own)]
    u = max(map(len, refs))
    like = dict(dtype=batch["labels"].dtype, device=batch["labels"].device)
    return {**batch, "labels": torch.tensor([r + [0] * (u - len(r)) for r in refs], **like),
            "label_lens": torch.tensor([len(r) for r in refs], **like)}


def mbr_gradients(model, featurizer, batch: dict, nbest, backend: str, rnnt_scale: float):
    """The MBR objective, its RNN-T term and its gradient (unclipped) on
    ``backend`` for one decoded N-best, in train mode with generator seed 3
    (the same dither, SpecAugment and dropout draws in every call), K1-K3's
    launches; the running statistics are put back after the call."""
    stats = {n: x.clone() for n, x in model.named_buffers()}
    model.train()
    model.zero_grad(set_to_none=True)
    reset_launches()
    gen = torch.Generator(device=batch["wavs"].device).manual_seed(3)
    feats, feat_lens = featurizer(batch["wavs"], batch["wav_lens"], gen)
    total, metrics = mbr_losses(model, feats, feat_lens, batch["labels"], batch["label_lens"],
                                nbest, rnnt_scale, MBR_BEAM.sm_scale, loss_backend=backend,
                                generator=gen)
    total.backward()
    launches = [joint_channels.launches, joint_channels_bwd_in.launches,
                joint_channels_bwd_w.launches]
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    with torch.no_grad():
        for n, x in model.named_buffers():
            x.copy_(stats[n])
    model.eval()
    return total.item(), metrics["rnnt_loss"].item(), grads, launches


def hold_gradients(what: str, got: dict, ref: dict) -> None:
    """Each parameter's gradient to ``ref``'s: relative L2 within
    backend_parity's envelope (STEP_ENCODER_TOL in the encoder, STEP_TOL
    elsewhere); a leaf whose reference gradient is zero to rounding (its
    largest entry below ZERO_GRAD of the whole gradient's, such as the key
    biases, which softmax ignores) must be so on both: its difference held
    to ZERO_GRAD of the largest entry, absolute.  Prints those leaves and
    the worst of the others."""
    scale = max(g.abs().max().item() for g in ref.values())
    zero, worst = [], []
    for name, r in ref.items():
        g = got[name]
        if r.abs().max().item() < ZERO_GRAD * scale:
            err, tol = (g - r).abs().max().item(), ZERO_GRAD * scale
            zero.append((err / tol, err, tol, name, r.abs().max().item()))
        else:
            err = ((g - r).norm() / r.norm()).item()
            tol = STEP_ENCODER_TOL if name.startswith("encoder.") else STEP_TOL
            worst.append((err / tol, err, tol, name))
    zero.sort(reverse=True)
    worst.sort(reverse=True)
    least = min((r.abs().max().item(), n) for n, r in ref.items()
                if r.abs().max().item() >= ZERO_GRAD * scale)
    say(f"{what}: {len(zero)} leaves zero to rounding (reference max < {ZERO_GRAD:g} x "
        f"{scale:.4e}), max abs differences: " + ("; ".join(
            f"{n} {e:.2e} (ref max {m:.2e}, tol {t:.2e})" for _, e, t, n, m in zero) or "none")
        + f"; the least held leaf {least[1]} at {least[0] / scale:.2e} of the largest entry")
    say(f"{what}: largest relative L2 errors (tol): "
        + "; ".join(f"{n} {e:.2e} ({t:g})" for _, e, t, n in worst[:6]))
    bad = max(zero[:1] + worst[:1])
    check(bad[0] <= 1.0, f"{what}: {bad[3]} error {bad[1]} > tol {bad[2]}")


def surrogate_parity(model, featurizer, batch: dict, nbest) -> None:
    """``mbr_surrogate`` on the card against the CPU at the recipe width,
    on one encoder output (a leaf: the eval featurizer and the model in
    eval mode, so no draw differs), ``nbest`` and its sequence weights
    against ``batch``'s references: the value and the gradients of the
    prediction net, the joint and the encoder output within SURROGATE_RTOL
    of the surrogate's under the weights' magnitudes (log-probs are at most
    0, so that value is minus the sum of the terms' magnitudes)."""
    seq_grad = mbr_risk(nbest, batch["labels"], batch["label_lens"])[2]
    model.eval()
    with torch.no_grad():
        feats, feat_lens = featurizer(batch["wavs"], batch["wav_lens"])
        enc = model.encode(feats, feat_lens)
    with torch.device("meta"):
        cpu_model = type(model)(model.config)
    cpu_model = cpu_model.to_empty(device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_model.eval()

    def run(m, weights):
        dev = next(m.parameters()).device
        x = enc.detach().to(dev).requires_grad_()
        paths = {key: nbest[key].to(dev) for key in ("tokens", "lens", "aligns", "align_lens")}
        m.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        value = mbr_surrogate(m, x, paths, weights.to(dev), MBR_BEAM.sm_scale,
                              blank=MBR_BEAM.blank)
        value.backward()
        grads = {n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None}
        grads["encoder output"] = x.grad.cpu()
        m.zero_grad(set_to_none=True)
        return value.item(), grads, time.perf_counter() - t0

    v_card, g_card, t_card = run(model, seq_grad)
    v_abs, g_abs, _ = run(model, seq_grad.abs())
    v_cpu, g_cpu, t_cpu = run(cpu_model, seq_grad)
    err = abs(v_card - v_cpu) / -v_abs
    norm = lambda g: torch.cat([x.flatten() for x in g.values()]).norm().item()
    say(f"MBR surrogate on the card vs the CPU ({t_card:.3f} s and {t_cpu:.3f} s): {v_card:.6f} "
        f"vs {v_cpu:.6f}, difference {err:.3e} of the sum of the terms' magnitudes {-v_abs:.4f}"
        f" (tol {SURROGATE_RTOL:g}); the gradient's norm {norm(g_cpu):.4e}, under |weights| "
        f"{norm(g_abs):.4e}")
    check(err <= SURROGATE_RTOL, "MBR surrogate on the card = the CPU's")
    check(g_card.keys() == g_cpu.keys() and len(g_cpu) > 1, "MBR surrogate: the same gradients")
    worst = sorted((((g_card[n] - r).norm() / g_abs[n].norm()).item(),
                    ((g_card[n] - r).norm() / r.norm()).item(), n) for n, r in g_cpu.items())[::-1]
    say(f"MBR surrogate gradient, card vs CPU, {len(worst)} tensors: largest L2 differences as "
        f"a share of the gradient under |weights| (and of the gradient itself): " + "; ".join(
            f"{n} {e:.2e} ({e_own:.2e})" for e, e_own, n in worst[:6]))
    check(worst[0][0] <= SURROGATE_RTOL,
          f"MBR surrogate gradient on the card = the CPU's: {worst[0][2]} {worst[0][0]:.3e}")


def mbr_path(device, paths: dict) -> dict:
    """The MBR recipe's CLI (2 epochs, the per-epoch lines, peak memory, the
    captured beam loops, K1-K3's launches) on the training CLI's bundle
    over references that its hypotheses resemble (``subset_archive``), then
    in process at 4 x 10 s, with references that the N-best resembles
    (``nbest_refs``): one step timed by stage, K1-K3 launches per step, the
    graphed N-best after an update against the eager loop, and the
    objective and gradients on the kernels against the plain loss backend,
    the surrogate's share of the gradient, and the surrogate on the card
    against the CPU (``surrogate_parity``).  Returns the CLI's K1-K3
    launches."""
    import pika_tpu_torch.decode.beam as beam_module

    t_phase = time.perf_counter()
    data_lst = subset_archive(paths, MBR_UTTS, device)
    paths["mbr_lst"] = data_lst
    work = os.path.dirname(data_lst)
    loops = {}
    cached = beam_module.cached_loop

    def counting_loop(model, key, dtype, make):
        loop = cached(model, key, dtype, make)
        loops[(id(model), key)] = loop
        return loop

    beam_module.cached_loop = counting_loop
    reset_launches()
    try:
        log = os.path.join(work, "mbr.log")
        cli_run("MBR CLI", [
            data_lst, log, os.path.join(work, "mbr"), *MBR_FLAGS, "--init_model",
            paths["bundle"], "--feat_config", paths["fbank"], "--cmvn_stats", paths["stats"],
            "--device", str(device)], log, mbr_main)
    finally:
        beam_module.cached_loop = cached
    launches = {"K1": joint_channels.launches, "K2": joint_channels_bwd_in.launches,
                "K3": joint_channels_bwd_w.launches}
    loop_bytes = sum(t.nbytes for loop in loops.values()
                     for t in [*loop.state.values(), *loop.inputs.values()])
    say(f"MBR CLI: {len(loops)} captured beam loops (one per (B, T) bucket), their state "
        f"{loop_bytes / 2**20:.1f} MiB; launches {launches}")
    check(all(n > 0 for n in launches.values()), f"the MBR CLI launched K1-K3: {launches}")
    check(os.path.exists(os.path.join(work, "mbr", "model.tmp", "model.pt")), "MBR model.tmp")
    check(os.path.exists(os.path.join(work, "mbr", "model.epoch.1", "model.pt")),
          "MBR model.epoch.1")
    del loops

    # in process at MBR_BATCH x 10 s: references the N-best resembles, so
    # that the sequence weights are not 0
    batch = corpus_batch(paths, device)
    model, featurizer, optimizer = mbr_setup(device, paths)
    nbest = mbr_decode(model, featurizer, MBR_BEAM, batch["wavs"], batch["wav_lens"])
    batch = nbest_refs(nbest, batch)
    seq_grad = mbr_risk(nbest, batch["labels"], batch["label_lens"])[2]
    say(f"MBR batch: hypothesis lengths {nbest['lens'].tolist()}, reference lengths "
        f"{batch['label_lens'].tolist()}; sequence weights {seq_grad.cpu().numpy().round(4).tolist()}")
    check(seq_grad.abs().max().item() > 1e-3, "MBR: the sequence weights are not 0")

    # one step, timed by stage through the step's own stage hook
    gen = torch.Generator(device).manual_seed(1)
    step = make_mbr_step(model, optimizer, featurizer, MBR_BEAM, rnnt_scale=0.02,
                         sm_scale=MBR_BEAM.sm_scale)
    step(batch, gen)["loss"].item()  # warm-up: the capture, cuBLAS/cuDNN plans
    marks = []

    def stage(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    reset_launches()
    stage("start")
    out = step(batch, gen, stage)
    per_step = {"K1": joint_channels.launches, "K2": joint_channels_bwd_in.launches,
                "K3": joint_channels_bwd_w.launches}
    say(f"MBR step launches: {per_step}")
    check(per_step == {"K1": 1, "K2": 1, "K3": 1}, "one K1, K2, K3 launch per MBR step")
    say(f"MBR step at {MBR_BATCH} x {SECONDS} s, beam {MBR_BEAM.beam_size}, "
        f"{MBR_BEAM.max_symbols} symbols, by stage: " + "; ".join(
        f"{name} {(t - t_prev) * 1e3:.1f} ms" for (_, t_prev), (name, t) in zip(marks, marks[1:]))
        + f"; in all {(marks[-1][1] - marks[0][1]) * 1e3:.1f} ms")
    surrogate = out["loss"].item() - 0.02 * out["rnnt_loss"].item()
    say(f"MBR step: objective {out['loss'].item():.6f} = 0.02 x RNN-T {out['rnnt_loss'].item():.4f}"
        f" + surrogate {surrogate:.6f}; expected edit distance {out['mbr_loss'].item():.4f}")
    # its value is small (an utterance's weights sum to 0 over similar paths):
    # it must exceed float32 rounding of the objective; its gradient's share
    # is checked below
    check(abs(surrogate) > 16 * torch.finfo(torch.float32).eps * abs(out["loss"].item()),
          "MBR: the surrogate is not 0")
    # after that update: the graphed N-best against the eager loop's
    graphed = mbr_decode(model, featurizer, MBR_BEAM, batch["wavs"], batch["wav_lens"])
    eager = mbr_decode(model, featurizer, MBR_BEAM, batch["wavs"], batch["wav_lens"],
                       search=beam_search_eager)
    say(f"MBR decode after the update: {int(graphed['steps'])} loop steps")
    check(same_nbest(graphed, eager), "MBR: graphed N-best after an update = eager N-best")
    net = next(loop.net for key, loop in model.__dict__["_decode_loops"].items())
    check(torch.equal(net.fc2.weight, model.fc2.weight.to(net.fc2.weight.dtype)),
          "MBR: the captured loop reads the updated weights")
    say("MBR: the graphed N-best after an update equals the eager loop's, from the updated "
        "weights: ok")

    # the objective and its gradient on the kernels and on the plain loss
    # backend, on one N-best of these weights
    nbest = graphed
    t_k, r_k, g_k, n_k = mbr_gradients(model, featurizer, batch, nbest, "auto", 0.02)
    t_p, r_p, g_p, n_p = mbr_gradients(model, featurizer, batch, nbest, "plain", 0.02)
    g_s = mbr_gradients(model, featurizer, batch, nbest, "auto", 0.0)[2]
    check(n_k == [1, 1, 1] and n_p == [0, 0, 0], f"K1-K3 launches {n_k} and {n_p} (plain)")
    norm = lambda g: torch.cat([x.flatten() for x in g.values()]).norm().item()
    share = norm(g_s) / norm(g_p)
    rel_t, rel_r = abs(t_k - t_p) / abs(t_p), abs(r_k - r_p) / abs(r_p)
    say(f"MBR objective on the kernels vs the plain backend: {t_k:.6f} vs {t_p:.6f} (rel "
        f"{rel_t:.3e}), RNN-T term {r_k:.4f} vs {r_p:.4f} (rel {rel_r:.3e}), rtol "
        f"{STEP_LOSS_RTOL}; the surrogate's share of the gradient's norm {share:.3f}")
    check(rel_t <= STEP_LOSS_RTOL and rel_r <= STEP_LOSS_RTOL, "MBR objective and RNN-T term")
    # the share follows the bundle's N-best (its scores' spread, the edit
    # distances) and is printed; that the surrogate's part is right is held
    # on its own, against the CPU
    check(share > 0, "MBR: the surrogate's gradient is not 0")
    hold_gradients("MBR gradient, kernels vs plain backend", g_k, g_p)
    surrogate_parity(model, featurizer, batch, nbest)
    del model, optimizer, step, graphed, eager, nbest, g_k, g_p, g_s
    torch.cuda.empty_cache()
    say(f"MBR phase: {time.perf_counter() - t_phase:.3f} s")
    return launches


def fused_nbest_scores(lines: list) -> list:
    """(tokens, fused score) of each line of an --ids N-best file with the
    rnnt score and both LAS directions' per-token scores, as the rerank CLI
    fuses them (scales 1.0, 0.3, 0.7; length-normalised; float64)."""
    out = []
    for line in lines:
        parts = line.split()
        ntok = (len(parts) - 3) // 3
        per_token = [float(x) for x in parts[ntok + 1:]]
        half = len(per_token) // 2
        score = (float(parts[ntok]) + 0.3 * sum(per_token[:half])
                 + 0.7 * sum(per_token[half:]))
        out.append((tuple(parts[:ntok]), score / (ntok or 0.001)))
    return out


def las_path(device, paths: dict) -> None:
    """The LAS recipe's CLI at its width on the training CLI's bundle: one
    epoch forward and one with --reverse_labels; the decode CLI on 8
    synthetic 10 s wavs (beam 8, n_best 8), first without the rescorers,
    then with both and --output_scores; the rescoring of 8 x 8 hypotheses
    timed and profiled at the bundle's hypothesis length and cut to
    RESCORE_CUT labels; las_score_hyps on the card against the CPU; the
    rerank CLI on the CLI's N-best."""
    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(paths["train"]), "las")
    os.makedirs(work)
    common = [os.path.join(paths["train"], "data.lst"), *LAS_FLAGS, "--feat_config",
              paths["fbank"], "--cmvn_stats", paths["stats"], "--shared_encoder_model",
              paths["bundle"], "--device", str(device)]
    bundles = {}
    for name, extra in (("fw", []), ("bw", ["--reverse_labels"])):
        log = os.path.join(work, f"{name}.log")
        cli_run(f"LAS CLI {name}", [common[0], log, os.path.join(work, name), *common[1:],
                                    *extra], log, las_main)
        bundles[name] = os.path.join(work, name, "model.epoch.0")

    # the decode CLI on 8 synthetic 10 s wavs, without and with both rescorers
    rng = np.random.default_rng(7)
    with open(os.path.join(work, "wav.scp"), "w") as scp, \
            open(os.path.join(work, "label.txt"), "w") as lab:
        for i in range(BATCH):
            path = os.path.join(work, f"u{i}.wav")
            write_wav(path, (rng.standard_normal(SR * SECONDS) * 3000).astype(np.int16), SR)
            scp.write(f"utt{i} {path}\n")
            lab.write(f"utt{i} " + " ".join(map(str, rng.integers(1, VOCAB, 25))) + "\n")
    nbest_file = os.path.join(work, "nbest.txt")
    decode_args = [paths["bundle"], os.path.join(work, "wav.scp"), nbest_file,
                   "--beam_size", str(BEAM), "--n_best", str(NBEST),
                   "--max_wav_seconds", str(SECONDS), "--feat_config", paths["fbank"],
                   "--cmvn_stats", paths["stats"], "--SOS", "0", "--EOS", str(VOCAB),
                   "--ref_labels", f"ark:{os.path.join(work, 'label.txt')}",
                   "--device", str(device)]
    for line in decode_cli_best(decode_args)[1]:
        say(f"decode CLI without LAS (the same bundle and wavs): {line}")
    torch.cuda.reset_peak_memory_stats(device)
    best, err = decode_cli_best([*decode_args, "--las_rescorer_model", bundles["fw"],
                                 "--las_rescorer_bw_model", bundles["bw"], "--output_scores"])
    peak = torch.cuda.max_memory_allocated(device)
    for line in err:
        say(f"decode CLI with LAS fw + bw: {line}")
    with open(nbest_file) as f:
        lines = f.read().splitlines()
    check(len(lines) == BATCH * NBEST and len(best) == BATCH,
          f"decode CLI with LAS: {len(lines)} N-best lines")
    say(f"decode CLI with LAS fw + bw: {len(lines)} N-best lines, peak memory "
        f"{peak / 2**30:.3f} GiB")

    # the rerank CLI on that N-best gives the CLI's best hypotheses
    rerank_main([nbest_file, os.path.join(work, "best.txt"), "--nbest", str(NBEST), "--ids",
                 "--las_rescore", "--las_dirs", "both"])
    with open(os.path.join(work, "best.txt")) as f:
        reranked = [line.split() for line in f.read().splitlines()]
    # the decode CLI reranks float32 totals, the tool float64 sums of the
    # printed per-token scores: a row may part only where the two choices'
    # fused scores tie to float32 rounding (hypotheses at the symbol cap
    # that differ in a token or two)
    parted = [i for i in range(BATCH) if reranked[i] != best[f"utt{i}"]]
    gaps = []
    for i in parted:
        fused = dict(fused_nbest_scores(lines[i * NBEST:(i + 1) * NBEST]))
        top, chosen = fused[tuple(reranked[i])], fused[tuple(best[f"utt{i}"])]
        gaps.append(abs(top - chosen) / abs(top))
    check(all(g <= RERANK_TIE for g in gaps),
          f"rerank CLI on the N-best = the decode CLI's best hypotheses but at float32 ties "
          f"(rows {parted}, relative gaps {gaps})")
    say(f"rerank CLI on the decode CLI's N-best: {BATCH - len(parted)} of {BATCH} best "
        f"hypotheses the same, {len(parted)} at a float32 tie of the fused scores "
        f"(relative gaps {', '.join(f'{g:.1e}' for g in gaps) or 'none'}): ok")

    # the rescoring alone: 8 x 8 hypotheses of that decode, forward and
    # backward, at their length and cut to RESCORE_CUT labels
    model, _ = load_bundle(paths["bundle"], device)
    fw, _ = load_bundle(bundles["fw"], device)
    bw, _ = load_bundle(bundles["bw"], device)
    args = eval_module.build_parser().parse_args([
        paths["bundle"], "wav.scp", "out", "--feat_config", paths["fbank"], "--cmvn_stats",
        paths["stats"], "--max_wav_seconds", str(SECONDS)])
    args.spec_augment, args.max_freq_span, args.max_time_span = False, 0, 0
    featurizer, _, _ = cli_common.featurizer_from_args(args, spec_augment=False, device=device)
    wavs = torch.stack([torch.from_numpy(read_wav(line.split()[1])[0].astype(np.float32))
                        for line in open(os.path.join(work, "wav.scp"))]).to(device)
    wav_lens = torch.full((BATCH,), wavs.shape[1], dtype=torch.int32, device=device)
    out = beam_search_waveforms(model, featurizer, wavs, wav_lens,
                                BeamConfig(beam_size=BEAM, n_best=NBEST, max_symbols=220,
                                           mm_dtype="auto"))
    args = (out["enc_out"], out["enc_lens"], out["tokens"], out["lens"])
    cut = (*args[:2], args[2][..., :RESCORE_CUT], args[3].clamp(max=RESCORE_CUT))
    for what, hyps in ((f"longest {int(out['lens'].max())} labels", args),
                       (f"cut to {RESCORE_CUT} labels", cut)):
        def rescore():
            las_score_hyps(fw, *hyps, sos=0, eos=VOCAB)[0].sum().item()
            las_score_hyps(bw, *hyps, sos=0, eos=VOCAB, reverse=True)[0].sum().item()

        rescore()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rescore()
            times.append(time.perf_counter() - t0)
        say(f"LAS rescoring of {BATCH} x {NBEST} hypotheses ({what}), forward + backward: "
            f"{', '.join(f'{x * 1e3:.1f}' for x in times)} ms, median "
            f"{statistics.median(times) * 1e3:.1f} ms")
        profile(lambda: las_score_hyps(fw, *hyps, sos=0, eos=VOCAB)[0].sum().item(),
                f"las_score_hyps (forward, 8 x 8 hypotheses, {what})")

    # las_score_hyps on the card against the CPU: 2 utterances x 4 hypotheses
    sub = [x[:2] for x in args[:2]] + [x[:2, :4] for x in args[2:]]
    got = las_score_hyps(fw, *sub, sos=0, eos=VOCAB)
    fw_cpu, _ = load_bundle(bundles["fw"], "cpu")
    ref = las_score_hyps(fw_cpu, *(x.cpu() for x in sub), sos=0, eos=VOCAB)
    errs = [((g.cpu() - r).abs().max() / r.abs().max()).item() for g, r in zip(got, ref)]
    say(f"las_score_hyps on the card vs the CPU (2 x 4 hypotheses, float32, TF32 off): max "
        f"error / max value {errs[0]:.3e} (totals), {errs[1]:.3e} (per token); rtol {LAS_RTOL}")
    check(max(errs) <= LAS_RTOL, "las_score_hyps on the card = on the CPU")
    del model, fw, bw, fw_cpu, out, args
    torch.cuda.empty_cache()
    say(f"LAS phase: {time.perf_counter() - t_phase:.3f} s")


def profile(fn, what: str, also: str = "") -> None:
    """torch.profiler over one warm call of ``fn`` (which ends in a host
    sync): device-busy share of the wall time, the kernels with the most
    device time, and the device time of those whose name holds ``also``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    # the device's own entries (kernels, copies, memsets): each once
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us == 0:
        say(f"profiled {what}: the profiler saw no device time")
        return
    n_kernels = sum(e.count for e in events)
    say(f"profiled {what}: wall {wall:.4f} s (profiler on), device busy "
        f"{busy_us / 1e6:.4f} s ({busy_us / 1e6 / wall:.1%}), {n_kernels} device ops")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    for e in ranked[:10] + [e for e in ranked[10:] if also and also in e.key]:
        say(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x "
            f"{e.self_device_time_total / busy_us:6.1%}  {e.key[:90]}")


def one_step(device, batch: dict, what: str, backend: str = "auto", **model_kw):
    """One train step of a fresh flagship model from seed 0 with generator
    seed 3 (so the same dither, SpecAugment and dropout draws in every
    call); returns the loss and each parameter's change (each statistic's
    value)."""
    model, step = train_setup(device, batch, backend, **model_kw)
    init = {n: x.detach().clone() for n, x in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    loss = step(batch, torch.Generator(device).manual_seed(3))["loss"].item()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    state = {n: (x.detach() - init[n]) if not n.endswith(
        ("running_mean", "running_var", "num_batches_tracked")) else x.detach().clone()
        for n, x in model.state_dict().items()}
    say(f"train step {what}: loss {loss:.4f}, {secs:.3f} s (first step of a fresh model), "
        f"peak memory {peak / 2**30:.3f} GiB")
    del model, step, init
    torch.cuda.empty_cache()
    return loss, state


def compare_steps(what: str, got, ref, loss_rtol: float, encoder_tol: float,
                  stats_tol: float, attention=("encoder.",)) -> None:
    """Hold one step's loss, parameter changes (``encoder_tol`` relative L2 in
    the modules named by ``attention``, whose gradients pass through
    bf16-rounded attention: the encoder, and the transformer prediction
    net; STEP_TOL elsewhere) and BatchNorm statistics to another's;
    quantities that are 0 but for float noise to 1e-6 absolute."""
    (la, sa), (lp, sp) = got, ref
    rel = abs(la - lp) / abs(lp)
    check(rel <= loss_rtol, f"train loss {what}: {la} vs {lp}")
    worst = []
    for name, a in sa.items():
        if name.endswith("num_batches_tracked"):
            continue
        p = sp[name]
        err = ((a - p).norm() / p.norm().clamp(min=1e-30)).item()
        stats = name.endswith(("running_mean", "running_var"))
        tol = stats_tol if stats else encoder_tol if name.startswith(attention) else STEP_TOL
        if p.abs().max().item() < 1e-6:  # a quantity that is 0 but for float noise
            err, tol = (a - p).abs().max().item(), 1e-6
        worst.append((err / tol, err, tol, name))
    worst.sort(reverse=True)
    say(f"train step {what}: loss rel err {rel:.3e} (rtol {loss_rtol}); "
        "largest parameter-change / statistic errors (rel L2, tol): "
        + "; ".join(f"{n} {e:.2e} ({t:g})" for _, e, t, n in worst[:6]))
    check(worst[0][0] <= 1.0, f"train step {what}: {worst[0][3]} "
                              f"error {worst[0][1]} > tol {worst[0][2]}")
    say(f"train step {what}: ok")


def backend_parity(device) -> None:
    """One train step on the kernel backend and one on the plain backend,
    from the same weights and the same generator seed."""
    batch = flagship_batch(device, TRAIN_BATCH)
    got = one_step(device, batch, "on the auto loss backend")
    ref = one_step(device, batch, "on the plain loss backend", "plain")
    compare_steps("kernel vs plain backend", got, ref, STEP_LOSS_RTOL, STEP_ENCODER_TOL, STATS_TOL)


def k4_case(device, seed: int, b: int, h: int, t: int, d: int):
    """bf16 q (scaled as the layer scales it: scores of a few units), k, v
    and an output cotangent."""
    g = torch.Generator(device).manual_seed(seed)

    def randn(scale):
        return (torch.randn((b, h, t, d), generator=g, device=device) * scale).to(torch.bfloat16)

    return randn(2.0 / math.sqrt(d)), randn(1.0), randn(1.0), randn(1.0)


def k4_chunks(q):
    """Slices of a few utterances, so that one plain call's (b, h, T, T)
    float32 scores stay near 2 GB."""
    chunk = max(1, int(2e9 // (4 * q.shape[1] * q.shape[2] ** 2)))
    return [slice(i, i + chunk) for i in range(0, q.shape[0], chunk)]


def k4_reference(q, k, v):
    """K4's plain forward ``(o, lse)``, in chunks."""
    parts = [flash_attention_reference(q[sl], k[sl], v[sl]) for sl in k4_chunks(q)]
    return [torch.cat(x) for x in zip(*parts)]


def k4_bwd_reference(q, k, v, o, lse, do):
    """K4's plain backward ``(dq, dk, dv)`` from ``o`` and ``lse``, in chunks."""
    parts = [flash_attention_bwd_reference(q[sl], k[sl], v[sl], o[sl], lse[sl], do[sl])
             for sl in k4_chunks(q)]
    return [torch.cat(x) for x in zip(*parts)]


def k4_bytes(b, h, t, d, n_bf16: int, n_f32: int) -> float:
    return b * h * t * (2 * d * n_bf16 + 4 * n_f32)


def k4_parity(device) -> dict:
    """K4 forward, dk/dv and dq against their plain versions (the backward
    kernels fed the plain forward's o and lse) at ragged shapes, at the
    encoder layers' shapes at B = 8 and 32, and at one 60 s shape; then each
    kernel, its plain version and scaled_dot_product_attention timed over
    the three layers at the training shape (B = 32)."""
    worst = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    cases = [("ragged", (2, 3, 37, 64)), ("ragged", (2, 3, 130, 128)), ("ragged", (1, 2, 1, 64))]
    cases += [(f"layer {i} B={b}", (b, h, t, d)) for b in (BATCH, TRAIN_BATCH)
              for i, (h, t, d) in enumerate(FLASH_LAYERS)]
    cases.append((f"{LONG_SECONDS} s", (LONG_BATCH, 16, 5992, 64)))
    cases += [("ragged d=256", (2, 3, 37, 256)), ("ragged d=256", (1, 2, 1, 256)),
              ("d=256 layer B=8", (BATCH,) + D256_LAYER),
              ("d=256 layer B=32", (TRAIN_BATCH,) + D256_LAYER)]
    for name, shape in cases:
        q, k, v, do = k4_case(device, 4, *shape)
        # each kernel runs before the plain version of its output: a freed
        # block of the plain results can then never stand in for a kernel's
        # unwritten output
        o, lse = flash_attention_fwd(q, k, v)
        ref_o, ref_lse = k4_reference(q, k, v)
        dk, dv = flash_attention_bwd_dkv(q, k, v, ref_o, ref_lse, do)
        dq = flash_attention_bwd_dq(q, k, v, ref_o, ref_lse, do)
        torch.cuda.synchronize()
        ref_dq, ref_dk, ref_dv = k4_bwd_reference(q, k, v, ref_o, ref_lse, do)
        lse_err = (lse - ref_lse).abs().max().item()
        check(bool(torch.isfinite(lse).all()) and lse_err <= K4_LSE_ATOL,
              f"K4 {name} {shape} lse: max abs err {lse_err} (atol {K4_LSE_ATOL})")
        parts = [f"lse {lse_err:.2e}"]
        for kernel, g_name, got, ref in (("fwd", "o", o, ref_o), ("dkv", "dk", dk, ref_dk),
                                         ("dkv", "dv", dv, ref_dv), ("dq", "dq", dq, ref_dq)):
            got, ref = got.float(), ref.float()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            rel = ((got - ref).norm() / ref.norm().clamp(min=1e-30)).item()
            check(bool(torch.isfinite(got).all()), f"K4 {name} {shape} {g_name} finite")
            noise = K4_NOISE * max(1.0, shape[-1] / 128)
            if scale < noise:  # 0 but for float noise (dk at T = 1: ds = p (dp - di) = 0)
                rel, scale = 0.0, noise / K4_MAX_REL
            check(rel <= K4_REL_L2 and err <= K4_MAX_REL * scale,
                  f"K4 {name} {shape} {g_name}: rel L2 {rel} (tol {K4_REL_L2}), max abs {err} "
                  f"(tol {K4_MAX_REL} x {scale})")
            parts.append(f"{g_name} {err:.2e} of {scale:.2e}, rel L2 {rel:.2e}")
            worst[kernel] = max(worst[kernel], err)
        say(f"K4 parity {name} B,h,T,d={shape}: max abs err " + "; ".join(parts)
            + f" (rel L2 tol {K4_REL_L2}, max abs tol {K4_MAX_REL} x max|ref|): ok")
        del q, k, v, do, ref_o, ref_lse, ref_dq, ref_dk, ref_dv, o, lse, dk, dv, dq
        torch.cuda.empty_cache()

    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {key: 0.0 for key in ("fwd", "dkv", "dq", "di", "plain_fwd", "plain_bwd", "sdpa_fwd",
                                  "sdpa_bwd")}
    bounds = {"fwd": [0.0, 0.0], "dkv": [0.0, 0.0], "dq": [0.0, 0.0]}  # flops, bytes
    for h, t, d in FLASH_LAYERS:
        b = TRAIN_BATCH
        q, k, v, do = k4_case(device, 5, b, h, t, d)
        o, lse = flash_attention_fwd(q, k, v)
        # di = sum(o * do), which the autograd backward takes once for both
        # kernels: the kernels are timed without it, and it on its own
        di = flash_attention_di(o, do)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = sdpa(*leaves, scale=1.0)
        # 20 launches each (3 warm-up): a launch's host work nears the device
        # time of the smallest layer, so the first one is spread thin
        layer = {
            "fwd": time_ms(lambda: flash_attention_fwd(q, k, v), warmup=3, iters=20),
            "dkv": time_ms(lambda: flash_attention_bwd_dkv(q, k, v, o, lse, do, di=di), 3, 20),
            "dq": time_ms(lambda: flash_attention_bwd_dq(q, k, v, o, lse, do, di=di), 3, 20),
            "di": time_ms(lambda: flash_attention_di(o, do), 3, 20),
            "plain_fwd": time_ms(lambda: flash_attention_reference(q, k, v), 1, 3),
            "plain_bwd": time_ms(lambda: flash_attention_bwd_reference(q, k, v, o, lse, do), 1, 3),
            "sdpa_fwd": time_ms(lambda: sdpa(q, k, v, scale=1.0), 3, 20),
            "sdpa_bwd": time_ms(
                lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 3, 20),
        }
        flops = b * h * t * t * d
        # bytes: bf16 tensors read and written, f32 (B, h, T) rows (lse; lse and di)
        for key, mult, n_bf16, n_f32 in (("fwd", 4, 4, 1), ("dkv", 8, 6, 2), ("dq", 6, 5, 2)):
            bounds[key][0] += mult * flops
            bounds[key][1] += k4_bytes(b, h, t, d, n_bf16, n_f32)
        for key, ms in layer.items():
            times[key] += ms
        say(f"K4 layer B,h,T,d=({b}, {h}, {t}, {d}): fwd {layer['fwd']:.3f} ms "
            f"({4 * flops / layer['fwd'] / 1e9:.1f} TFLOP/s), dk/dv {layer['dkv']:.3f} ms "
            f"({8 * flops / layer['dkv'] / 1e9:.1f}), dq {layer['dq']:.3f} ms "
            f"({6 * flops / layer['dq'] / 1e9:.1f}), di {layer['di']:.3f} ms; "
            f"scaled_dot_product_attention fwd {layer['sdpa_fwd']:.3f}, "
            f"bwd {layer['sdpa_bwd']:.3f} ms")
        del q, k, v, do, o, lse, di, leaves, out
        torch.cuda.empty_cache()
    out = {}
    for key in ("fwd", "dkv", "dq"):
        plain, lib = ("plain_fwd", "sdpa_fwd") if key == "fwd" else ("plain_bwd", "sdpa_bwd")
        out[key] = {"max_abs_err": worst[key], "ms": times[key], "plain_ms": times[plain],
                    **bound(*bounds[key], PEAK_BF16), "library_ms": times[lib]}
        flops = bounds[key][0]
        say(f"K4 {key}, B={TRAIN_BATCH}, three layers: {times[key]:.3f} ms "
            f"({flops / times[key] / 1e9:.1f} TFLOP/s); plain {times[plain]:.3f} ms; "
            f"scaled_dot_product_attention {times[lib]:.3f} ms; bound "
            f"{out[key]['bound_ms']:.3f} ms ({out[key]['bound_by']}, bf16 "
            f"{PEAK_BF16 / 1e12:.0f} TFLOP/s)")
    say("  (the plain and library backward times are one call that yields dq, dk and dv)")
    k4_d256_times(device, sdpa)
    pair, pair_flops = times["dkv"] + times["dq"], bounds["dkv"][0] + bounds["dq"][0]
    say(f"K4 backward, B={TRAIN_BATCH}, three layers: dk/dv {times['dkv']:.3f} + dq "
        f"{times['dq']:.3f} = {pair:.3f} ms ({pair_flops / pair / 1e9:.1f} TFLOP/s; "
        f"{pair / times['sdpa_bwd']:.2f}x scaled_dot_product_attention's backward, "
        f"{times['sdpa_bwd']:.3f} ms); + di (torch) {times['di']:.3f} = "
        f"{pair + times['di']:.3f} ms as autograd runs it "
        f"({(pair + times['di']) / times['sdpa_bwd']:.2f}x)")
    return out



def k4_d256_times(device, sdpa) -> None:
    """K4's d = 256 kernels timed at the tdnn_nhid = 2048 model's third layer
    (B = 32): each beside its plain version, its bound and
    scaled_dot_product_attention at the same shape (not in the kernels line,
    which reports the flagship's three layers)."""
    b, (h, t, d) = TRAIN_BATCH, D256_LAYER
    q, k, v, do = k4_case(device, 6, b, h, t, d)
    o, lse = flash_attention_fwd(q, k, v)
    di = flash_attention_di(o, do)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = sdpa(*leaves, scale=1.0)
    ms = {
        "fwd": time_ms(lambda: flash_attention_fwd(q, k, v), 3, 20),
        "dkv": time_ms(lambda: flash_attention_bwd_dkv(q, k, v, o, lse, do, di=di), 3, 20),
        "dq": time_ms(lambda: flash_attention_bwd_dq(q, k, v, o, lse, do, di=di), 3, 20),
        "plain_fwd": time_ms(lambda: flash_attention_reference(q, k, v), 1, 3),
        "plain_bwd": time_ms(lambda: flash_attention_bwd_reference(q, k, v, o, lse, do), 1, 3),
        "sdpa_fwd": time_ms(lambda: sdpa(q, k, v, scale=1.0), 3, 20),
        "sdpa_bwd": time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 3, 20),
    }
    flops = b * h * t * t * d
    parts = []
    for key, mult, n_bf16, n_f32 in (("fwd", 4, 4, 1), ("dkv", 8, 6, 2), ("dq", 6, 5, 2)):
        bnd = bound(mult * flops, k4_bytes(b, h, t, d, n_bf16, n_f32), PEAK_BF16)
        parts.append(f"{key} {ms[key]:.3f} ms ({mult * flops / ms[key] / 1e9:.1f} TFLOP/s, bound "
                     f"{bnd['bound_ms']:.3f})")
    say(f"K4 d=256, B,h,T,d=({b}, {h}, {t}, {d}): " + ", ".join(parts)
        + f"; plain fwd {ms['plain_fwd']:.3f}, bwd {ms['plain_bwd']:.3f} ms; "
        f"scaled_dot_product_attention fwd {ms['sdpa_fwd']:.3f}, bwd {ms['sdpa_bwd']:.3f} ms; "
        f"backward {ms['dkv'] + ms['dq']:.3f} ms = "
        f"{(ms['dkv'] + ms['dq']) / ms['sdpa_bwd']:.2f}x SDPA's, forward "
        f"{ms['fwd'] / ms['sdpa_fwd']:.2f}x")
    del q, k, v, do, o, lse, di, leaves, out
    torch.cuda.empty_cache()


def reset_launches() -> None:
    for fn in (joint_channels, joint_channels_bwd_in, joint_channels_bwd_w, flash_attention_fwd,
               flash_attention_bwd_dkv, flash_attention_bwd_dq):
        fn.launches = 0


def k4_launches() -> dict:
    return {"fwd": flash_attention_fwd.launches, "dkv": flash_attention_bwd_dkv.launches,
            "dq": flash_attention_bwd_dq.launches}


def flash_inference_path(device, exact_loss: float) -> None:
    """The eval step and greedy decode of the inference path with
    ``attn_flash=True`` (same seed, so the same weights): 3 K4 launches per
    encoder pass, the loss against the exact path's."""
    model, featurizer = eval_setup(device, attn_flash=True)
    batch = flagship_batch(device, BATCH)
    eval_step = make_eval_step(model, featurizer, loss_chunk=32)
    eval_step(batch)  # first call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    loss = eval_step(batch)["loss"].item()
    eval_s = time.perf_counter() - t0
    eval_launches = k4_launches()
    reset_launches()
    t0 = time.perf_counter()
    hyps, lens = greedy_decode_waveforms(model, featurizer, batch["wavs"], batch["wav_lens"],
                                         max_symbols=MAX_SYMBOLS)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = k4_launches()
    peak = torch.cuda.max_memory_allocated(device)
    say(f"flash eval step (K4 + K1): {eval_s:.3f} s, loss {loss:.4f}; greedy decode: "
        f"{decode_s:.3f} s; peak memory {peak / 2**30:.3f} GiB; K4 launches: eval {eval_launches}, "
        f"decode {decode_launches}")
    expect = {"fwd": 3, "dkv": 0, "dq": 0}
    check(eval_launches == expect and decode_launches == expect,
          f"3 K4 forward launches per encoder pass: eval {eval_launches}, decode "
          f"{decode_launches}")
    check(math.isfinite(loss), "flash eval loss finite")
    rel = abs(loss - exact_loss) / abs(exact_loss)
    check(rel <= FLASH_LOSS_RTOL, f"flash eval loss {loss} vs exact {exact_loss}")
    say(f"flash eval loss vs exact attention {exact_loss:.4f}: rel err {rel:.3e} "
        f"(rtol {FLASH_LOSS_RTOL}): ok")
    check_hyps(hyps, lens, device)
    say(f"flash greedy decode: lens {lens.tolist()}: ok")


def long_utterances(device) -> None:
    """The eval step on 4 utterances of 60 s with 240 labels each, with flash
    and with exact attention from the same weights: peak memory, wall time
    (second call), losses."""
    batch = flagship_batch(device, LONG_BATCH, seconds=LONG_SECONDS, labels=LONG_LABELS)
    losses = {}
    for flash in (True, False):
        model, featurizer = eval_setup(device, LONG_SECONDS, attn_flash=flash)
        eval_step = make_eval_step(model, featurizer, loss_chunk=32)
        eval_step(batch)  # first call
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        t0 = time.perf_counter()
        losses[flash] = eval_step(batch)["loss"].item()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device)
        launches = flash_attention_fwd.launches
        say(f"{LONG_BATCH} x {LONG_SECONDS} s eval step, {'flash' if flash else 'exact'} "
            f"attention: {secs:.3f} s, peak memory {peak / 2**30:.3f} GiB, loss "
            f"{losses[flash]:.4f}, K4 launches {launches}")
        check(launches == (3 if flash else 0), f"K4 launches {launches}")
        check(math.isfinite(losses[flash]), "long eval loss finite")
        del model, featurizer, eval_step
        torch.cuda.empty_cache()
    rel = abs(losses[True] - losses[False]) / abs(losses[False])
    check(rel <= FLASH_LOSS_RTOL, f"long eval loss flash {losses[True]} vs exact {losses[False]}")
    say(f"{LONG_SECONDS} s eval loss, flash vs exact: rel err {rel:.3e} (rtol {FLASH_LOSS_RTOL}): ok")


def small_heads_path(device) -> None:
    """The eval step of the flagship model at tdnn_nhid=SMALL_NHID (d_head
    16, 16 and 32: K4 runs zero-padded to 64) with flash and with exact
    attention from the same seed: 3 K4 launches per encoder pass on the
    flash path, the losses agree."""
    batch = flagship_batch(device, BATCH)
    losses = {}
    for flash in (True, False):
        model, featurizer = eval_setup(device, tdnn_nhid=SMALL_NHID, attn_flash=flash)
        eval_step = make_eval_step(model, featurizer, loss_chunk=32)
        eval_step(batch)  # first call
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        losses[flash] = eval_step(batch)["loss"].item()
        secs = time.perf_counter() - t0
        launches = k4_launches()
        say(f"eval step at tdnn_nhid={SMALL_NHID} (d_head 16, 16, 32), "
            f"{'flash' if flash else 'exact'} attention: {secs:.3f} s, loss {losses[flash]:.4f}, "
            f"K4 launches {launches}")
        check(launches == {"fwd": 3 if flash else 0, "dkv": 0, "dq": 0}, f"K4 launches {launches}")
        check(math.isfinite(losses[flash]), "small-heads eval loss finite")
        del model, featurizer, eval_step
        torch.cuda.empty_cache()
    rel = abs(losses[True] - losses[False]) / abs(losses[False])
    check(rel <= FLASH_LOSS_RTOL, f"small-heads eval loss flash {losses[True]} vs exact "
                                  f"{losses[False]}")
    say(f"tdnn_nhid={SMALL_NHID} eval loss, flash (K4 zero-padded) vs exact: rel err {rel:.3e} "
        f"(rtol {FLASH_LOSS_RTOL}): ok")


def flash_train_path(device) -> dict:
    """bench.py's step with attn_flash=True and dropout 0: one warm-up step,
    then 2 timed steps and a profiled one; returns the launches of K1-K4
    over the timed steps."""
    batch = flagship_batch(device, TRAIN_BATCH)
    model, step = train_setup(device, batch, attn_flash=True, tdnn_transformer_dropout=0.0)
    gen = torch.Generator(device).manual_seed(1)
    t0 = time.perf_counter()
    first = step(batch, gen)["loss"].item()
    say(f"flash train step, first call: {time.perf_counter() - t0:.3f} s, loss {first:.4f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    times, losses = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        losses.append(step(batch, gen)["loss"].item())
        times.append(time.perf_counter() - t0)
    launches = {"K1": joint_channels.launches, "K2": joint_channels_bwd_in.launches,
                "K3": joint_channels_bwd_w.launches, **{f"K4 {k}": n for k, n in k4_launches().items()}}
    peak = torch.cuda.max_memory_allocated(device)
    say(f"flash train steps (K4 fwd/bwd, K1 fwd, K2/K3 bwd), batch {TRAIN_BATCH} x {SECONDS} s, "
        f"dropout 0: {', '.join(f'{x:.4f}' for x in times)} s; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; peak memory {peak / 2**30:.3f} GiB; "
        f"launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"flash train losses finite: {losses}")
    check(all(n > 0 for n in launches.values()), f"the flash train steps launched K1-K4: {launches}")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "parameters finite")
    profile(lambda: step(batch, gen)["loss"].item(), "train step", also="flash_")
    del model, step
    torch.cuda.empty_cache()
    return launches


def flash_step_parity(device) -> None:
    """One train step with flash and one with exact attention (dropout 0),
    from the same weights and generator seed."""
    batch = flagship_batch(device, TRAIN_BATCH)
    got = one_step(device, batch, "with flash attention", attn_flash=True,
                   tdnn_transformer_dropout=0.0)
    ref = one_step(device, batch, "with exact attention", tdnn_transformer_dropout=0.0)
    compare_steps("flash vs exact attention", got, ref, FLASH_LOSS_RTOL, FLASH_ENCODER_TOL,
                  FLASH_STATS_TOL)


def check_nbest(out, t_out: int, what: str) -> None:
    """An N-best of the flagship decode: sorted best-first, tokens in [1, V)
    padded with -1, alignments padded with -1, and the non-blanks of each
    alignment as many as its hypothesis' tokens."""
    tokens, lens, scores = out["tokens"], out["lens"].long(), out["scores"]
    aligns, align_lens = out["aligns"], out["align_lens"].long()
    check(tuple(tokens.shape) == (BATCH, NBEST, MAX_SYMBOLS)
          and tuple(aligns.shape) == (BATCH, NBEST, t_out + MAX_SYMBOLS),
          f"{what}: shapes {tuple(tokens.shape)}, {tuple(aligns.shape)}")
    check(bool(torch.isfinite(scores).all() and (scores[:, :-1] >= scores[:, 1:]).all()),
          f"{what}: scores finite and sorted")
    inside = torch.arange(MAX_SYMBOLS, device=tokens.device) < lens[..., None]
    check(bool(((tokens >= 1) & (tokens < VOCAB))[inside].all()), f"{what}: tokens in [1, V)")
    check(bool((tokens[~inside] == -1).all()), f"{what}: token padding is -1")
    a_inside = torch.arange(aligns.shape[-1], device=tokens.device) < align_lens[..., None]
    check(bool((aligns[~a_inside] == -1).all()), f"{what}: alignment padding is -1")
    check(bool((((aligns != 0) & a_inside).sum(-1) == lens).all()),
          f"{what}: non-blanks of each alignment = its length")


def same_nbest(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in ("tokens", "lens", "aligns", "align_lens",
                                                  "scores", "steps"))


def top1_agreement(a, b) -> int:
    """Rows whose best hypothesis is the same in both N-bests."""
    same = (a["lens"][:, 0] == b["lens"][:, 0]) & (a["tokens"][:, 0] == b["tokens"][:, 0]).all(-1)
    return int(same.sum())


def beam_path(device) -> dict:
    """Beam search at the flagship width on the inference batch (beam 8,
    n_best 8, max 200 symbols): the graphed search against the eager loop
    (identical N-bests), beam 1 against greedy, the N-best's invariants,
    bf16 ("auto") against float32; wall times of greedy and beam 8, eager
    and graphed, and beam 8 at bf16; the flag-check interval; peak memory
    (its profile is ``profile_beam``, the last phase).  Returns the wall
    times and loop steps, which the transformer decoder's are printed
    beside."""
    model, featurizer = eval_setup(device)
    batch = flagship_batch(device, BATCH)
    with torch.no_grad():
        feats, feat_lens = featurizer(batch["wavs"], batch["wav_lens"])
        enc = model.encode(feats, feat_lens)
        enc_lens = model.encoder_out_len(feat_lens)
    t_out = enc.shape[1]
    cfg = BeamConfig(beam_size=BEAM, n_best=NBEST, max_symbols=MAX_SYMBOLS)
    t0 = time.perf_counter()
    graphed = beam_search(model, enc, enc_lens, cfg)
    torch.cuda.synchronize()
    say(f"beam {BEAM}: first call (capture included) {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats(device)
    beam_s = dp_seconds(lambda: beam_search(model, enc, enc_lens, cfg))
    peak = torch.cuda.max_memory_allocated(device)
    eager = beam_search_eager(model, enc, enc_lens, cfg)
    eager_s = dp_seconds(lambda: beam_search_eager(model, enc, enc_lens, cfg), repeats=1)
    steps = int(graphed["steps"])
    check(same_nbest(beam_search(model, enc, enc_lens, cfg), graphed),
          "beam: two graphed searches give the same bits")
    check(same_nbest(graphed, eager), "beam: graphed = eager (tokens, lens, aligns, scores)")
    check_nbest(graphed, t_out, "beam 8")
    say(f"beam {BEAM}, n_best {NBEST}, B={BATCH}, T'={t_out}: graphed {beam_s:.4f} s, eager "
        f"{eager_s:.4f} s ({eager_s / beam_s:.2f}x), {steps} loop steps ({beam_s / steps * 1e3:.3f} "
        f"ms a step graphed); peak memory {peak / 2**30:.3f} GiB; graphed = eager, N-best "
        f"invariants: ok; top-1 lens {graphed['lens'][:, 0].tolist()}")
    for spc in (1, 4, 16, 64):
        secs = dp_seconds(lambda: beam_search(model, enc, enc_lens, cfg, steps_per_check=spc))
        say(f"  beam {BEAM} graphed, flag read every {spc} steps: {secs:.4f} s")

    greedy = greedy_decode(model, enc, enc_lens, MAX_SYMBOLS)
    greedy_s = dp_seconds(lambda: greedy_decode(model, enc, enc_lens, MAX_SYMBOLS))
    greedy_eager_s = dp_seconds(lambda: greedy_decode_eager(model, enc, enc_lens, MAX_SYMBOLS),
                                repeats=1)
    ref = greedy_decode_eager(model, enc, enc_lens, MAX_SYMBOLS)
    check(all(torch.equal(a, b) for a, b in zip(greedy, ref)), "greedy: graphed = eager")
    beam1 = beam_search(model, enc, enc_lens, BeamConfig(beam_size=1, n_best=1,
                                                         max_symbols=MAX_SYMBOLS))
    check(torch.equal(beam1["tokens"][:, 0], greedy[0]) and torch.equal(beam1["lens"][:, 0],
                                                                          greedy[1]),
          "beam 1 (float32) gives greedy's tokens")
    say(f"greedy (from the encoder output): graphed {greedy_s:.4f} s, eager {greedy_eager_s:.4f} s "
        f"({greedy_eager_s / greedy_s:.2f}x); graphed = eager, beam 1 = greedy: ok")

    bf16_cfg = BeamConfig(beam_size=BEAM, n_best=NBEST, max_symbols=MAX_SYMBOLS, mm_dtype="auto")
    bf16 = beam_search(model, enc, enc_lens, bf16_cfg)
    bf16_s = dp_seconds(lambda: beam_search(model, enc, enc_lens, bf16_cfg))
    check(bool(torch.isfinite(bf16["scores"]).all()), "beam bf16: scores finite")
    check_nbest(bf16, t_out, "beam 8 bf16")
    top = graphed["scores"][:, 0]
    say(f"beam {BEAM} at bf16 (auto), graphed: {bf16_s:.4f} s, {int(bf16['steps'])} steps; top-1 "
        f"agreement with float32 {top1_agreement(bf16, graphed)} of {BATCH} rows; top-1 scores "
        f"max rel diff {((bf16['scores'][:, 0] - top).abs() / top.abs()).max().item():.3e}")

    def decode_waveforms():
        beam_search_waveforms(model, featurizer, batch["wavs"], batch["wav_lens"], cfg)
        torch.cuda.synchronize()

    wave_s = dp_seconds(decode_waveforms)
    say(f"beam {BEAM} from the waveforms (fbank + encoder + graphed search): {wave_s:.4f} s "
        f"(RTF {wave_s / (BATCH * SECONDS):.5f})")
    del model, featurizer, enc
    torch.cuda.empty_cache()
    return {"beam_s": beam_s, "beam_eager_s": eager_s, "steps": steps, "greedy_s": greedy_s,
            "wave_s": wave_s,
            "bf16_s": bf16_s}


@contextlib.contextmanager
def bench_env(**knobs):
    """``os.environ`` without its ``BENCH_*`` variables and with ``knobs``
    set, restored on exit."""
    saved = {k: v for k, v in os.environ.items() if k.startswith("BENCH_")}
    for k in saved:
        del os.environ[k]
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k in [k for k in os.environ if k.startswith("BENCH_")]:
            del os.environ[k]
        os.environ.update(saved)


def run_tool(what: str, main, argv: list, **knobs) -> list:
    """A tool's ``main(argv)`` in process under ``bench_env(**knobs)``, its
    stderr and stdout captured and printed; a non-zero exit fails the run.
    Returns its stdout lines."""
    out, err = io.StringIO(), io.StringIO()
    code = 0
    t0 = time.perf_counter()
    with bench_env(**knobs), contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            main(argv)
        except SystemExit as exit_info:
            code = exit_info.code
    for line in err.getvalue().splitlines() + out.getvalue().splitlines():
        say(f"{what}: {line}")
    say(f"{what}: {time.perf_counter() - t0:.3f} s in all")
    check(code in (0, None), f"{what} exited {code}")
    gc.collect()
    torch.cuda.empty_cache()
    return out.getvalue().splitlines()


def bench_train_value(what: str, lines: list) -> float:
    """bench_train's one stdout line: the JSON result's utt/s."""
    check(len(lines) == 1, f"{what}: one stdout line, got {lines}")
    result = json.loads(lines[0])
    check(list(result) == ["metric", "value", "unit", "vs_baseline"]
          and result["metric"] == "rnnt_train_utterances_per_sec_per_chip"
          and result["value"] > 0, f"{what}: result {result}")
    return result["value"]


def bench_decode_ms(what: str, lines: list) -> float:
    """bench_decode's summary line: ms a batch."""
    found = [m for m in (re.match(r"beam=\d+ batch=\d+ fst=\w+: (\S+) ms/batch, \S+ utt/s, "
                                  r"RTF \S+", x) for x in lines) if m]
    check(len(found) == 1, f"{what}: one summary line in {lines}")
    return float(found[0][1])


def compare(what: str, tool: float, own: float, unit: str) -> None:
    gap = tool / own - 1
    say(f"{what}: the tool {tool:.4f} {unit}, chip_smoke's own {own:.4f} {unit}, gap {gap:+.1%}"
        + (f" (over {TOOL_GAP:.0%}: explained in PERF.md)" if abs(gap) > TOOL_GAP else ""))


def trace_kernel_label(name: str) -> str:
    """``kernel_label``'s form of a kernel's name in a trace, which the
    profiler demangles (``ns::name<N, ...>(args)``)."""
    found = re.search(r"(\w+_kernel)(?:<(\d+)[^>]*>)?", name)
    if not found:
        return name[:60]
    return f"{found[1]}<{found[2]}>" if found[2] else found[1]


def trace_bench_step(device, work: str) -> None:
    """One step of bench_train's (its model, featurizer, optimizer, batch)
    traced through ``utils/profiling.trace`` after a warm step: the Chrome
    trace must hold the ``span`` regions, the step's own spans and a kernel
    of each of K1-K3 under the label ``kernel_label`` gives it in the build
    log."""
    cfg, feat_cfg, _ = bench_train.config({}, device)
    _, step = bench_train.make_step(cfg, feat_cfg, device)
    batch = bench_train.make_batch(TRAIN_BATCH, feat_cfg.max_samples, VOCAB, device)
    gen = torch.Generator(device).manual_seed(1)
    step(batch, gen)["loss"].item()
    logdir = os.path.join(work, "bench_trace")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profiling.trace(logdir):
        with profiling.span("bench_train_step"):
            loss = step(batch, gen)["loss"]
        with profiling.span("bench_train_loss_read"):
            loss = loss.item()
    wall = time.perf_counter() - t0
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    check(len(files) == 1, f"one trace file in {logdir}: {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    kernels = {trace_kernel_label(e["name"]) for e in events if e.get("cat") == "kernel"}
    lib = cuda_build.build()
    built = [kernel_label(line.split("'")[1])
             for line in (lib.parent / "build.log").read_text().splitlines()
             if "Compiling entry function" in line]
    say(f"traced bench_train step: {wall:.3f} s (trace on), loss {loss:.4f}; "
        f"{os.path.getsize(files[0]) / 2**20:.1f} MiB, {len(events)} events, "
        f"{len(kernels)} distinct kernels")
    check({"bench_train_step", "bench_train_loss_read"} <= names, "the trace holds the annotations")
    check(set(TRAIN_SPANS) <= names, f"the trace holds the step's spans: {sorted(TRAIN_SPANS)}")
    for k, base in TRACE_KERNELS.items():
        labels = [x for x in built if x.split("<")[0] == base]
        seen = sorted(set(labels) & kernels)
        check(labels and seen, f"the trace holds {k}'s {base} (built as {labels})")
        say(f"  {k}: {', '.join(seen)} in the trace")
    shutil.rmtree(logdir)
    del step, batch
    gc.collect()
    torch.cuda.empty_cache()


def bench_tools_path(device, work: str, full_step_s: float, beam: dict, cli_epochs: list,
                     cli_paths: dict) -> None:
    """The throughput tools at their defaults, each ``main`` in process:
    ``bench_train`` with the full loss (K1-K3 launched) and with
    ``BENCH_PRUNED=5`` (none launched), ``bench_decode`` with ``--fst off
    --attribution``, at beam_path's symbol cap and with ``--fst per_token``
    (exact selection through the advance cache), ``bench_cli_train`` at
    ``--utts`` BENCH_CLI_UTTS; each tool's figure beside this script's own
    for the same work (train_path's step, beam_path's graphed beam 8, the
    training CLI phase's epochs on ``cli_paths``' corpus, whose batches'
    padded shapes are counted); then one of bench_train's steps traced
    through ``utils/profiling``."""
    t_phase = time.perf_counter()
    reset_launches()
    utt_s = bench_train_value("bench_train", run_tool("bench_train", bench_train.main, []))
    launches = joint_launches()
    say(f"bench_train launches: {launches}")
    check(all(n > 0 for n in launches.values()), f"bench_train launched K1-K3: {launches}")
    compare(f"bench_train step ({TRAIN_BATCH} x {SECONDS} s, full loss) against train_path's "
            f"median step", TRAIN_BATCH / utt_s, full_step_s, "s")

    reset_launches()
    what = f"bench_train BENCH_PRUNED={PRUNED_RANGE}"
    utt_s = bench_train_value(what, run_tool(what, bench_train.main, [],
                                             BENCH_PRUNED=str(PRUNED_RANGE)))
    check(sum(joint_launches().values()) == 0, f"{what} launched none of K1-K3")
    say(f"{what}: {TRAIN_BATCH / utt_s:.4f} s a step, no launch of K1-K3")

    what = "bench_decode --fst off"
    lines = run_tool(what, bench_decode.main, ["--attribution"])
    ms = bench_decode_ms(what, lines)
    enc_ms = float(next(re.search(r"featurizer\+encoder (\S+) ms", x)[1] for x in lines
                        if "attribution:" in x))
    compare(f"{what} (waveforms, bf16 matmuls, 64 symbols, sm_scale 1.2) against beam_path's "
            f"graphed beam 8 from the waveforms (float32, {MAX_SYMBOLS} symbols)", ms / 1e3,
            beam["wave_s"], "s")
    # the random model's hypotheses run to the cap: at beam_path's cap the
    # tool's search takes beam_path's loop steps, at bf16
    what = f"bench_decode --max_symbols {MAX_SYMBOLS}"
    ms = bench_decode_ms(what, run_tool(what, bench_decode.main, ["--max_symbols",
                                                                  str(MAX_SYMBOLS)]))
    compare(f"{what} against beam_path's bf16 search from the encoder output ({beam['steps']} "
            f"loop steps) plus the tool's featurizer and encoder", ms / 1e3,
            beam["bf16_s"] + enc_ms / 1e3, "s")
    what = "bench_decode --fst per_token"
    lines = run_tool(what, bench_decode.main, ["--fst", "per_token"])
    check(any(x.startswith("  advance cache:") for x in lines), f"{what}: the advance cache")
    bench_decode_ms(what, lines)

    what = f"bench_cli_train --utts {BENCH_CLI_UTTS}"
    reset_launches()
    lines = run_tool(what, bench_cli_train.main, ["--utts", str(BENCH_CLI_UTTS)])
    launches = joint_launches()
    say(f"{what} launches: {launches}")
    check(all(n > 0 for n in launches.values()), f"{what} launched K1-K3: {launches}")
    rates = epoch_utt_s(lines)
    check(len(rates) == 2 and any(x.startswith("total wall") for x in lines),
          f"{what}: 2 epoch lines and the total")
    compare(f"{what} epoch 1 (9 s utterances) against the training CLI phase's epoch 1 "
            f"({CLI_SECONDS[0]}-{CLI_SECONDS[1]} s)", rates[-1], cli_epochs[-1], "utt/s")
    # what each epoch's batches pad to: the phase's --max_wav_seconds
    # (default 20) makes 5/10/15/20 s buckets, the tool's 10 makes 2.5/5/7.5/10
    args = train_cli_parser().parse_args([os.path.join(cli_paths["train"], "data.lst"), "log",
                                          "exp", *CLI_MODEL_FLAGS, *CLI_RECIPE_FLAGS])
    cfg = cli_common.loader_cfg_from_args(args, batch_size=args.batch_size)
    padded = Counter(f"{b['wavs'].shape[1] / SR:g} s x {b['labels'].shape[1]}"
                     for b in train_cli_batches(args, cfg, 1))
    say(f"  the CLI phase's epoch-1 batches by padded shape (bucket s x label bucket): "
        f"{dict(padded)}; the tool's 9 s utterances (speed <= 1.04) all pad to 10 s")

    trace_bench_step(device, work)
    say(f"bench tools phase: {time.perf_counter() - t_phase:.3f} s")


def profile_beam(device, work: str) -> None:
    """The profiled graphed beam 8 search, then the FST per-token exact and
    walk searches (the bigram of ``fst_path``, its advance cache read from
    its file), last of all phases: with a profile in the beam phase, the
    host-driven work of later phases ran slower than before the decode
    phases existed (on an H100: the loss DP loops by about 40%, the 4 x 60 s
    eval step by 20%); with it here the eval and train steps matched the
    parent's again."""
    model, featurizer = eval_setup(device)
    batch = flagship_batch(device, BATCH)
    with torch.no_grad():
        feats, feat_lens = featurizer(batch["wavs"], batch["wav_lens"])
        enc = model.encode(feats, feat_lens)
        enc_lens = model.encoder_out_len(feat_lens)
    cfg = BeamConfig(beam_size=BEAM, n_best=NBEST, max_symbols=MAX_SYMBOLS)
    beam_search(model, enc, enc_lens, cfg)  # capture
    profile(lambda: beam_search(model, enc, enc_lens, cfg)["steps"].item(),
            f"graphed beam {BEAM} search")
    arpa = os.path.join(work, "lm.arpa")
    tables = compile_arpa(arpa, {f"u{k}": k + 1 for k in range(VOCAB)})
    base = dict(beam_size=BEAM, n_best=NBEST, max_symbols=MAX_SYMBOLS, lm_scale=FST_SCALE,
                nonblk_reward=FST_REWARD, lm_per_token=True)
    for name, cache_mb, topm in (("per-token exact", 512, 0), ("per-token top-8 walk", 0, 8)):
        tabs = tables.device_arrays(device, n_ilabels=VOCAB + 1, cache_max_bytes=cache_mb << 20,
                                    cache_file=arpa + ".advcache.npz")
        fst_cfg = BeamConfig(**base, lm_topm=topm)
        beam_search(model, enc, enc_lens, fst_cfg, tabs, tables.start)  # capture
        profile(lambda: beam_search(model, enc, enc_lens, fst_cfg, tabs,
                                    tables.start)["steps"].item(),
                f"graphed FST {name} beam {BEAM} search")
        del tabs
    del model, featurizer, enc
    torch.cuda.empty_cache()


def flash_beam_path(device) -> None:
    """Beam 8 from the waveforms with attn_flash=True: 3 K4 forward launches
    per encoder pass; its N-best against the exact path's."""
    cfg = BeamConfig(beam_size=BEAM, n_best=NBEST, max_symbols=MAX_SYMBOLS)
    batch = flagship_batch(device, BATCH)
    outs = {}
    for flash in (False, True):
        model, featurizer = eval_setup(device, attn_flash=flash)
        reset_launches()
        outs[flash] = beam_search_waveforms(model, featurizer, batch["wavs"], batch["wav_lens"], cfg)
        launches = k4_launches()
        check(launches == {"fwd": 3 if flash else 0, "dkv": 0, "dq": 0},
              f"beam decode K4 launches {launches}")
        del model, featurizer
    check_nbest(outs[True], outs[True]["enc_out"].shape[1], "flash beam 8")
    say(f"flash beam {BEAM} decode: K4 launches {launches}; top-1 agreement with exact attention "
        f"{top1_agreement(outs[True], outs[False])} of {BATCH} rows: ok")
    torch.cuda.empty_cache()


def eval_cli_path(device, extra=(), what="eval CLI") -> str:
    """The decode CLI in-process on 8 synthetic 10 s wavs: a port bundle of
    the seed-0 flagship model, beam 8, n_best 8, --ref_labels and the
    ``extra`` flags; 8 x 8 N-best lines and a WER line (a random model's WER
    is printed, not judged)."""
    model, _ = eval_setup(device)
    rng = np.random.default_rng(1)
    with tempfile.TemporaryDirectory() as tmp:
        bundle = save_bundle(os.path.join(tmp, "bundle"), model)
        del model
        with open(os.path.join(tmp, "wav.scp"), "w") as scp, \
                open(os.path.join(tmp, "label.txt"), "w") as lab:
            for i in range(BATCH):
                path = os.path.join(tmp, f"u{i}.wav")
                write_wav(path, (rng.standard_normal(SR * SECONDS) * 4000).astype(np.int16), SR)
                scp.write(f"utt{i} {path}\n")
                lab.write(f"utt{i} " + " ".join(map(str, rng.integers(1, VOCAB, U_MAX))) + "\n")
        with open(os.path.join(tmp, "units.txt"), "w") as f:
            f.write("".join(f"u{k} {k}\n" for k in range(VOCAB)))
        nbest = os.path.join(tmp, "nbest.txt")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            wer = eval_main([bundle, os.path.join(tmp, "wav.scp"), nbest,
                             "--beam_size", str(BEAM), "--n_best", str(NBEST),
                             "--max_symbols", str(MAX_SYMBOLS), "--max_wav_seconds", str(SECONDS),
                             "--symbols_map", os.path.join(tmp, "units.txt"),
                             "--ref_labels", f"ark:{os.path.join(tmp, 'label.txt')}",
                             "--output_scores", *extra])
        with open(nbest) as f:
            lines = f.read().splitlines()
    for line in err.getvalue().splitlines():
        say(f"{what}: {line}")
    check(len(lines) == BATCH * NBEST, f"{what} wrote {len(lines)} N-best lines")
    check(wer is not None and any(x.startswith("%WER") for x in err.getvalue().splitlines()),
          f"{what} printed a WER line")
    say(f"{what}: {len(lines)} N-best lines, WER {wer:.4f} (random weights, not judged): ok")
    return err.getvalue()



def write_arpa(path: str, grams: dict) -> None:
    """An ARPA file of ``grams``: {order: [(words, log10 p, log10 bow or
    None), ...]}."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n" + "".join(f"ngram {n}={len(g)}\n" for n, g in grams.items()))
        for n, g in grams.items():
            f.write(f"\n\\{n}-grams:\n")
            f.writelines(f"{p:.4f} {' '.join(w)}" + ("" if bow is None else f" {bow:.4f}") + "\n"
                         for w, p, bow in g)
        f.write("\n\\end\\\n")


def bigram_grams(seed: int = 0) -> dict:
    """A seeded bigram LM over all V units ("u0".."u{V-1}", the eval CLI's
    symbol table): every unit a unigram with a backoff weight, <s> and
    </s>, and FST_BIGRAMS distinct continuations of <s> and of each unit
    (</s> among them for a quarter of the contexts)."""
    rng = np.random.default_rng(seed)
    words = [f"u{k}" for k in range(VOCAB)]
    uni = [(("<s>",), -99.0, -0.5), (("</s>",), -1.5, None)]
    uni += [((w,), float(p), float(bow)) for w, p, bow in
            zip(words, rng.uniform(-5.0, -2.5, VOCAB), rng.uniform(-1.0, -0.1, VOCAB))]
    ctx = ["<s>"] + words
    # start + stride * j (mod V), stride < V / FST_BIGRAMS: FST_BIGRAMS distinct units
    start = rng.integers(0, VOCAB, (len(ctx), 1))
    stride = rng.integers(1, VOCAB // FST_BIGRAMS, (len(ctx), 1))
    nxt = (start + stride * np.arange(FST_BIGRAMS)) % VOCAB
    logp = rng.uniform(-2.5, -0.3, nxt.shape)
    ends = rng.random(len(ctx)) < 0.25
    bi = []
    for i, c in enumerate(ctx):
        bi += [((c, words[j]), float(p), None) for j, p in zip(nxt[i], logp[i])]
        if ends[i]:
            bi.append(((c, "</s>"), float(logp[i, 0]), None))
    return {1: uni, 2: bi}


def trigram_grams(seed: int = 1, n_words: int = 60) -> dict:
    """A seeded trigram LM over units 1..n_words: unigrams and bigrams with
    backoff weights, and trigrams after 200 of the bigram histories, so a
    walk collects matches at up to three backoff levels."""
    rng = np.random.default_rng(seed)
    words = [f"u{k}" for k in range(1, n_words + 1)]
    uni = [(("<s>",), -99.0, -0.4), (("</s>",), -1.6, None)]
    uni += [((w,), float(rng.uniform(-2.5, -1.0)), float(rng.uniform(-0.8, -0.1))) for w in words]
    bi = []
    for c in ["<s>"] + words:
        for j in rng.choice(n_words, 15, replace=False):
            bi.append(((c, words[j]), float(rng.uniform(-1.5, -0.2)),
                       float(rng.uniform(-0.6, -0.05))))
    tri = []
    for h in rng.choice(len(bi), 200, replace=False):
        for j in rng.choice(n_words, 5, replace=False):
            tri.append((bi[h][0] + (words[j],), float(rng.uniform(-1.0, -0.1)), None))
    return {1: uni, 2: bi, 3: tri}


def set_dicts(states, costs) -> list:
    """Each state set as {state: cost rounded to 1e-4}, for comparing sets
    whose slot order may differ."""
    return [{int(s): round(float(c), 4) for s, c in zip(row_s, row_c) if s >= 0}
            for row_s, row_c in zip(states.reshape(-1, states.shape[-1]).tolist(),
                                    costs.reshape(-1, costs.shape[-1]).tolist())]


def trigram_walk_check(device, work: str) -> None:
    """The walk path's backoff levels on a trigram: 8 x 8 state sets advanced
    12 steps on random labels by the walk on the card and on the CPU (bit
    for bit: float32 adds, mins and gathers), and by the advance cache on
    the card (the same sets; LM scores to 1e-5); some set holds matches of
    two or more levels.  Then the final scores, walked and cached."""
    path = os.path.join(work, "tri.arpa")
    write_arpa(path, trigram_grams())
    tables = compile_arpa(path, {f"u{k}": k + 1 for k in range(VOCAB)})
    walk, walk_cpu = tables.device_arrays(device), tables.device_arrays("cpu")
    cached = tables.device_arrays(device, n_ilabels=62, cache_max_bytes=64 << 20)
    check(int(cached["adv_cost"].shape[-1]) >= 2, "trigram advance cache holds 2+ matches")
    g = torch.Generator().manual_seed(3)
    sets = {name: init_state_sets(tables, (BATCH, BEAM), 4, dev)
            for name, dev in (("walk", device), ("cpu", "cpu"), ("cached", device))}
    widest = 0
    for step in range(12):
        labels = torch.randint(2, 62, (BATCH, BEAM), generator=g)
        lm = {}
        for name, tabs in (("walk", walk), ("cpu", walk_cpu), ("cached", cached)):
            st, co = sets[name]
            *sets[name], lm[name] = fst_advance_sets(tabs, st, co, labels.to(st.device), 6,
                                                     FST_REWARD)
        for x, y in zip(sets["walk"] + [lm["walk"]], sets["cpu"] + [lm["cpu"]]):
            check(torch.equal(x.cpu(), y), f"trigram walk, step {step}: card = CPU bit for bit")
        check(set_dicts(*sets["walk"]) == set_dicts(*sets["cached"]),
              f"trigram step {step}: walk and cache give the same sets")
        check(torch.allclose(lm["walk"], lm["cached"], rtol=1e-5, atol=1e-5),
              f"trigram step {step}: walk and cache give the same LM scores")
        widest = max(widest, int((sets["walk"][0] >= 0).sum(-1).max()))
    check(widest >= 2, "trigram sets hold matches of 2+ backoff levels")
    fin = fst_final_scores(walk, *sets["walk"])
    fin_cached = fst_final_scores(cached, *sets["cached"])
    check(torch.allclose(fin, fin_cached, rtol=1e-5, atol=1e-5), "trigram final scores")
    say(f"FST trigram ({tables.n_states} states, {len(tables.arc_ilabel)} arcs): 12 steps of 8 x 8 "
        f"sets, walk on the card = walk on the CPU bit for bit, = advance cache (Lm="
        f"{cached['adv_cost'].shape[-1]}); up to {widest} states a set: ok")


def fst_path(device, work: str) -> None:
    """FST shallow fusion at the flagship width on the inference batch: a
    synthetic bigram ARPA over all V units, compile_arpa and the advance
    cache (host build times, the cache kept in ``work``); beam 8, n_best 8,
    200 symbols in the per-beam, per-token top-8 cached, per-token exact and
    walk (no cache) modes, each graphed against its eager loop (identical
    N-bests) and timed beside the plain beam; the cached top-8 against the
    walk; the trigram check; the CLI with --fst_lm reading the cache file."""
    model, featurizer = eval_setup(device)
    batch = flagship_batch(device, BATCH)
    with torch.no_grad():
        feats, feat_lens = featurizer(batch["wavs"], batch["wav_lens"])
        enc = model.encode(feats, feat_lens)
        enc_lens = model.encoder_out_len(feat_lens)
    t_out = enc.shape[1]
    arpa = os.path.join(work, "lm.arpa")
    t0 = time.perf_counter()
    grams = bigram_grams()
    write_arpa(arpa, grams)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables = compile_arpa(arpa, {f"u{k}": k + 1 for k in range(VOCAB)})
    compile_s = time.perf_counter() - t0
    build, build_s = fst_module.build_advance_cache, []

    def timed_build(*args, **kwargs):  # the host build alone, inside device_arrays
        t0 = time.perf_counter()
        out = build(*args, **kwargs)
        build_s.append(time.perf_counter() - t0)
        return out

    fst_module.build_advance_cache = timed_build
    try:
        t0 = time.perf_counter()
        cached = tables.device_arrays(device, n_ilabels=VOCAB + 1, cache_max_bytes=512 << 20,
                                      cache_file=arpa + ".advcache.npz")
        torch.cuda.synchronize()
        cache_s = time.perf_counter() - t0
    finally:
        fst_module.build_advance_cache = build
    check(len(build_s) == 1, "the advance cache was built once")
    check("adv_cost" in cached, "the flagship bigram's advance cache fits 512 MB")
    adv = cached["adv_cost"]
    t0 = time.perf_counter()
    again = tables.device_arrays(device, n_ilabels=VOCAB + 1, cache_max_bytes=512 << 20,
                                 cache_file=arpa + ".advcache.npz")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(torch.equal(again["adv_cost"], adv) and torch.equal(again["adv_next"],
                                                                cached["adv_next"]),
          "the advance cache read back from its file")
    del again
    say(f"FST bigram ARPA over {VOCAB} units ({len(grams[2])} bigrams): written in {write_s:.3f} "
        f"s, compile_arpa {compile_s:.3f} s ({tables.n_states} states, {len(tables.arc_ilabel)} "
        f"arcs, {cached.search_iters} search steps); advance cache (N x V x Lm = "
        f"{tuple(adv.shape)}, {(adv.nbytes + cached['adv_next'].nbytes) / 2**20:.1f} MiB): "
        f"built on the host in {build_s[0]:.3f} s, with the file write and the copy to the card "
        f"{cache_s:.3f} s; read from its file and copied in {load_s:.3f} s")
    walk = tables.device_arrays(device, n_ilabels=VOCAB + 1)  # no advance cache
    plain_cfg = BeamConfig(beam_size=BEAM, n_best=NBEST, max_symbols=MAX_SYMBOLS)
    plain = beam_search(model, enc, enc_lens, plain_cfg)
    plain_s = dp_seconds(lambda: beam_search(model, enc, enc_lens, plain_cfg))
    plain_eager_s = dp_seconds(lambda: beam_search_eager(model, enc, enc_lens, plain_cfg), 1)
    say(f"FST: the plain beam {BEAM} (no LM) in this phase: graphed {plain_s:.4f} s, eager "
        f"{plain_eager_s:.4f} s, {int(plain['steps'])} steps")
    base = dict(beam_size=BEAM, n_best=NBEST, max_symbols=MAX_SYMBOLS, lm_scale=FST_SCALE,
                nonblk_reward=FST_REWARD)
    modes = (("per-beam", cached, dict()),
             ("per-token top-8 cached", cached, dict(lm_per_token=True, lm_topm=8)),
             ("per-token exact", cached, dict(lm_per_token=True, lm_topm=0)),
             ("per-token top-8 walk", walk, dict(lm_per_token=True, lm_topm=8)))
    outs = {}
    torch.cuda.reset_peak_memory_stats(device)
    for name, tabs, fusion in modes:
        cfg = BeamConfig(**base, **fusion)
        t0 = time.perf_counter()
        graphed = beam_search(model, enc, enc_lens, cfg, tabs, tables.start)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        graphed_s = dp_seconds(lambda: beam_search(model, enc, enc_lens, cfg, tabs, tables.start))
        t0 = time.perf_counter()  # one eager search: the walk's takes seconds
        eager = beam_search_eager(model, enc, enc_lens, cfg, tabs, tables.start)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        check(same_nbest(graphed, eager), f"FST {name}: graphed = eager")
        check_nbest(graphed, t_out, f"FST {name}")
        steps = int(graphed["steps"])
        say(f"FST {name}: graphed {graphed_s:.4f} s ({steps} steps, {graphed_s / steps * 1e3:.3f} "
            f"ms a step; first call with the capture {first_s:.3f} s), eager {eager_s:.4f} s "
            f"({eager_s / graphed_s:.2f}x); plain beam graphed {plain_s:.4f} s "
            f"({graphed_s / plain_s:.2f}x); top-1 lens {graphed['lens'][:, 0].tolist()}, N-best "
            f"mean length {graphed['lens'].float().mean().item():.2f}, top-1 "
            f"as the plain beam's on {top1_agreement(graphed, plain)} of {BATCH} rows; "
            f"graphed = eager: ok")
        outs[name] = graphed
    peak = torch.cuda.max_memory_allocated(device)
    a, b = outs["per-token top-8 cached"], outs["per-token top-8 walk"]
    check(all(torch.equal(a[k], b[k]) for k in ("tokens", "lens", "aligns", "align_lens"))
          and torch.allclose(a["scores"], b["scores"], rtol=1e-5),
          "FST top-8: the advance cache and the walk give the same N-best")
    say(f"FST: top-8 cached = top-8 walk (tokens, lens, aligns; scores to 1e-5): ok; peak "
        f"memory of the four modes {peak / 2**30:.3f} GiB (the cache on the card included)")
    del model, featurizer, enc, cached, walk, adv
    torch.cuda.empty_cache()
    trigram_walk_check(device, work)
    t0 = time.perf_counter()
    err = eval_cli_path(device, ["--fst_lm", arpa, "--fst_lm_scale", str(FST_SCALE),
                                 "--nonblk_reward", str(FST_REWARD), "--fst_cache_file", "auto"],
                        "eval CLI --fst_lm")
    check(any(x.startswith("FST advance cache") for x in err.splitlines()),
          "eval CLI --fst_lm: the advance cache line")
    say(f"eval CLI --fst_lm (per-token exact, the cache read from its file): "
        f"{time.perf_counter() - t0:.3f} s in all")


def line_forms(lines: list) -> set:
    """The log lines' forms: numbers and the --dp_mode name masked."""
    return {re.sub(r"\((sync|bmuf|blockadam|bmufadam)\)", "(MODE)",
                   re.sub(r"[0-9]+(\.[0-9]+)?", "#", x)) for x in lines}


def recipe_bmuf(device, paths: dict, work: str) -> None:
    """The recipe's command line as written (--dp_mode bmuf, --sync_period
    5, --block_momentum 0.9, --block_lr 1.0) at world size 1 over NCCL: 2
    epochs with validation (the epoch lines, K1-K3's launches), then
    --resume to a third (the restored delta_prev and step count against the
    checkpoint's)."""
    train_lst = os.path.join(paths["train"], "data.lst")
    common = [*CLI_MODEL_FLAGS, *CLI_RECIPE_FLAGS, *DIST_FLAGS, "--feat_config", paths["fbank"],
              "--cmvn_stats", paths["stats"], "--device", str(device),
              "--num_batches_per_epoch", str(CLI_BATCHES_PER_EPOCH), "--log_per_n_frames", "1"]
    exp = os.path.join(work, "bmuf")
    log = os.path.join(work, "bmuf.log")
    reset_launches()
    lines, _, _ = cli_run("train CLI --dp_mode bmuf", [
        train_lst, log, exp, *common, "--num_epochs", str(CLI_EPOCHS), "--valid_data_lst",
        os.path.join(paths["valid"], "data.lst")], log)
    launches = {"K1": joint_channels.launches, "K2": joint_channels_bwd_in.launches,
                "K3": joint_channels_bwd_w.launches}
    say(f"train CLI --dp_mode bmuf launches over {CLI_EPOCHS} epochs with validation: "
        f"{launches}")
    check(all(n > 0 for n in launches.values()), f"the BMUF CLI launched K1-K3: {launches}")
    check(any("devices: 1 (bmuf)" in x for x in lines), "BMUF CLI header")
    check(sum("valid loss/label" in x for x in lines) == CLI_EPOCHS, "BMUF validation lines")
    check(trained_utts(lines) > 0, "BMUF rounds ran")

    saved = restore_checkpoint(os.path.join(exp, "ckpt"), CLI_EPOCHS - 1, map_location=device)
    restored = []
    load = BMUF.load_state_dict

    def recording_load(self, state):
        load(self, state)
        restored.append([t.clone() for t in self.state.delta_prev])

    BMUF.load_state_dict = recording_load
    try:
        log = os.path.join(work, "bmuf_resume.log")
        lines, _, _ = cli_run("train CLI --dp_mode bmuf --resume", [
            train_lst, log, exp, *common, "--num_epochs", str(CLI_EPOCHS + 1), "--resume"], log)
    finally:
        BMUF.load_state_dict = load
    steps = saved["bmuf"]["steps"]
    check(any(x == f"resumed BMUF state from epoch {CLI_EPOCHS - 1} (step {steps})"
              for x in lines), f"resumed at the saved step {steps}")
    saved_dp = saved["bmuf"]["delta_prev"]
    check(len(restored) == 1 and len(restored[0]) == len(saved_dp) > 0
          and all(torch.equal(a, b) for a, b in zip(restored[0], saved_dp)),
          "delta_prev restored")
    norm = torch.linalg.vector_norm(torch.cat([t.flatten() for t in saved_dp])).item()
    check(norm > 0, "delta_prev after the saved rounds is not 0")
    say(f"resume: step {steps} and {len(saved_dp)} delta_prev tensors (norm {norm:.6g}) equal "
        f"the saved ones: ok")


def write_hold_corpus(work: str, device) -> str:
    """HOLD_UTTS seeded utterances of one waveform bucket (5-10 s) and one
    label bucket (16): mrk/seq archives through the prep in process; returns
    the data list."""
    rng = np.random.default_rng(6)
    d = os.path.join(work, "hold")
    os.makedirs(d)
    with open(os.path.join(d, "wav.scp"), "w") as scp, \
            open(os.path.join(d, "label.txt"), "w") as lab:
        for i in range(HOLD_UTTS):
            path = os.path.join(d, f"h{i}.wav")
            secs = float(rng.uniform(*HOLD_SECONDS))
            write_wav(path, (rng.standard_normal(int(SR * secs)) * 3000).astype(np.int16), SR)
            scp.write(f"h{i} {path}\n")
            lab.write(f"h{i} " + " ".join(map(str, rng.integers(1, VOCAB, HOLD_LABELS))) + "\n")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        prep_main(["wav_to_seq", os.path.join(d, "wav.scp"), os.path.join(d, "a.mrk"),
                   os.path.join(d, "a.seq"), "--device", str(device)])
    with open(os.path.join(d, "data.lst"), "w") as f:
        for line in out.getvalue().splitlines():
            mrk, seq = line.split()
            f.write(f"{mrk} {seq} ark:{os.path.join(d, 'label.txt')}\n")
    return os.path.join(d, "data.lst")


def bmuf_sync_hold(device, paths: dict, work: str) -> None:
    """BMUF with --block_momentum 0 --block_lr 1 --momentum 0 after its one
    round equals sync with --momentum 0 after the same 5 batches, the random
    draws off (dither 0, no SpecAugment, no speed/gain, dropout 0): the
    relative L2 distance of all the parameters within 2 x that of two sync
    runs (the card's training step is not bit for bit repeatable) plus
    HOLD_ULPS float32 ulps."""
    data_lst = write_hold_corpus(work, device)
    conf = os.path.join(work, "fbank_dither0.conf")
    with open(paths["fbank"]) as f, open(conf, "w") as g:
        g.write(re.sub(r"--dither=\S+", "--dither=0", f.read()))
    recipe = [x for x in CLI_RECIPE_FLAGS if x != "--spec_augment"]
    common = [*CLI_MODEL_FLAGS, *recipe, "--feat_config", conf, "--cmvn_stats", paths["stats"],
              "--no_augment", "--dropout", "0", "--tdnn_transformer_dropout", "0",
              "--momentum", "0", "--num_epochs", "1", "--num_batches_per_epoch",
              str(CLI_BATCHES_PER_EPOCH), "--device", str(device)]
    runs = {}
    for tag, name, extra in (("syncA", "sync A", []), ("syncB", "sync B", []),
                             ("bmuf", "bmuf(0, 1)", ["--dp_mode", "bmuf", "--sync_period", "5",
                                                     "--block_momentum", "0", "--block_lr",
                                                     "1"])):
        log = os.path.join(work, f"hold_{tag}.log")
        lines, _, _ = cli_run(f"hold {name}", [data_lst, log, os.path.join(work, f"hold_{tag}"),
                                               *common, *extra], log)
        check(any(f"{HOLD_UTTS} utts" in x for x in lines), f"hold {name}: {HOLD_UTTS} utterances")
        model, _ = load_bundle(os.path.join(work, f"hold_{tag}", "model.epoch.0"), "cpu")
        runs[name] = torch.cat([p.detach().double().flatten() for p in model.parameters()])
        runs[name + " loss"] = [x.split("\t")[0] for x in lines if "Overall Avg Loss" in x]
    a, b, m = runs["sync A"], runs["sync B"], runs["bmuf(0, 1)"]
    norm = torch.linalg.vector_norm(a).item()
    spread = torch.linalg.vector_norm(b - a).item() / norm
    diff = torch.linalg.vector_norm(m - a).item() / norm
    tol = 2 * spread + HOLD_ULPS * float(np.finfo(np.float32).eps)
    say(f"BMUF(0, 1) vs sync after 5 batches, all {a.numel()} parameters: rel L2 {diff:.3e} "
        f"(max |diff| {(m - a).abs().max().item():.3e}); spread of two sync runs {spread:.3e} "
        f"(max {(b - a).abs().max().item():.3e}); tolerance 2 x spread + {HOLD_ULPS} ulps = "
        f"{tol:.3e}; losses: sync {runs['sync A loss']} and {runs['sync B loss']}, "
        f"BMUF {runs['bmuf(0, 1) loss']}")
    check(diff <= tol, "BMUF(0, 1) after one round equals sync after the same batches")


def sync_cost(device) -> None:
    """A round's sync (the all-reduce of the flat buffer and the block
    update) at the flagship's parameter count, for bmuf and bmufadam, by
    CUDA events at world size 1 over NCCL, against the bytes it must move
    over the HBM rate: bmuf reads the global and the local parameters and
    delta_prev and writes all three (24 bytes a parameter); bmufadam also
    reads the local Adam moments and the reconciled ones and writes those
    (48)."""
    model = init_transducer(TransducerConfig(**FLAGSHIP), torch.Generator(device).manual_seed(0),
                            device)
    n = sum(p.numel() for p in model.parameters())
    stats = [b for b in model.buffers() if b.is_floating_point()]
    with process_group(device):
        for variant, optim, per_param in (("bmuf", "sgd", 24), ("bmufadam", "adam", 48)):
            opt = make_optimizer(model.parameters(), optim, **OPTIM)
            for p in model.parameters():
                p.grad = torch.randn_like(p) * 1e-3
            opt.step()  # the local optimizer's state exists, as after a round's steps
            bmuf = BMUF(model.parameters(), BMUFConfig(variant), buffers=stats)
            ms = time_ms(lambda: bmuf.sync(opt), warmup=2, iters=SYNC_REPEATS)
            nbytes = per_param * n + 8 * sum(b.numel() for b in stats)
            b = bound(0.0, nbytes, PEAK_F32)
            say(f"{variant} sync at the flagship's {n} parameters ({4 * n / 2**20:.1f} MiB): "
                f"{ms:.3f} ms (CUDA events, {SYNC_REPEATS} syncs), bound {b['bound_ms']:.3f} ms "
                f"({nbytes / 1e9:.3f} GB at 3.35 TB/s; {b['bound_ms'] / ms:.1%})")
            del bmuf, opt
    del model
    torch.cuda.empty_cache()


def trained_utts(lines: list) -> int:
    """The utterances of a CLI log's epoch lines."""
    return sum(int(m.group(1)) for x in lines for m in [re.search(r", (\d+) utts,", x)] if m)


def bmuf_other_clis(device, paths: dict) -> None:
    """--dp_mode bmuf in the MBR CLI (one epoch on its subset) and
    --dp_mode blockadam and bmufadam in the LAS CLI with the recipe's Adam
    (one epoch each), rounds of OTHER_SYNC_PERIOD batches (these epochs have
    about 8): finite losses, rounds that ran, and the sync runs' log-line
    forms."""
    work = os.path.dirname(paths["mbr_lst"])
    with open(os.path.join(work, "mbr.log")) as f:
        sync_forms = line_forms(f.read().splitlines())
    log = os.path.join(work, "mbr_bmuf.log")
    lines, _, _ = cli_run("MBR CLI --dp_mode bmuf", [
        paths["mbr_lst"], log, os.path.join(work, "mbr_bmuf"), *MBR_FLAGS, "--num_epochs", "1",
        "--dp_mode", "bmuf", "--sync_period", str(OTHER_SYNC_PERIOD), "--init_model", paths["bundle"], "--feat_config", paths["fbank"],
        "--cmvn_stats", paths["stats"], "--device", str(device)], log, mbr_main)
    extra = line_forms(lines) - sync_forms
    check(not extra, f"MBR bmuf log lines of the sync forms: {extra}")
    check(trained_utts(lines) > 0, "MBR bmuf: rounds ran")
    las_work = os.path.join(os.path.dirname(paths["train"]), "las")
    with open(os.path.join(las_work, "fw.log")) as f:
        sync_forms = line_forms(f.read().splitlines())
    for mode in ("blockadam", "bmufadam"):
        log = os.path.join(las_work, f"{mode}.log")
        lines, _, _ = cli_run(f"LAS CLI --dp_mode {mode}", [
            os.path.join(paths["train"], "data.lst"), log, os.path.join(las_work, mode),
            *LAS_FLAGS, "--dp_mode", mode, "--sync_period", str(OTHER_SYNC_PERIOD), "--feat_config", paths["fbank"], "--cmvn_stats",
            paths["stats"], "--shared_encoder_model", paths["bundle"], "--device", str(device)],
            log, las_main)
        extra = line_forms(lines) - sync_forms
        check(not extra, f"LAS {mode} log lines of the sync forms: {extra}")
        check(trained_utts(lines) > 0, f"LAS {mode}: rounds ran")


def rnn_encoder_path(device, paths: dict, work: str) -> None:
    """The rnn encoder at the CLI's defaults (--enc_layers 2 --rnn_size 512
    --brnn) with the recipe's V and stride 1: one eval and one training step
    at RNN_BATCH x 10 s (the lattice at T' = T through K1-K3; the LSTMs are
    host loops), the training CLI for one epoch, and the decode CLI on its
    bundle (beam 8, graphed)."""
    batch = flagship_batch(device, RNN_BATCH, labels=RNN_LABELS)
    model, step = train_setup(device, batch, **RNN_MODEL)
    featurizer = make_featurizer(FeaturizerConfig(fbank=FbankConfig(dither=0.0, **FBANK),
                                                  max_samples=SR * SECONDS, lctx=1, rctx=1),
                                 device=device)
    eval_step = make_eval_step(model, featurizer)
    feats, feat_lens = featurizer(batch["wavs"], batch["wav_lens"])
    t_out = model.encoder_out_len(feat_lens)
    check(torch.equal(t_out, feat_lens), "rnn encoder: T' = T")
    for what, fn in (("eval step", lambda: eval_step(batch)["loss"].item()),
                     ("train step", lambda: step(batch, gen)["loss"].item())):
        gen = torch.Generator(device).manual_seed(1)
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        t0 = time.perf_counter()
        loss = fn()
        wall = time.perf_counter() - t0
        launches = joint_launches()
        say(f"rnn encoder {what} at {RNN_BATCH} x {SECONDS} s (T' = {int(t_out.max())}, "
            f"{RNN_LABELS} labels, V {VOCAB}): {wall:.3f} s"
            + (f" (before the fused LSTM route: {RNN_STEP_S_BEFORE})" if what == "train step"
               else "") + ", peak memory "
            f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB, loss {loss:.4f}, "
            f"launches {launches}")
        check(math.isfinite(loss), f"rnn encoder {what}: finite loss")
        check(launches["K1"] == 1, f"rnn encoder {what}: one K1 launch ({launches})")
    del model, step, eval_step
    torch.cuda.empty_cache()

    log = os.path.join(work, "rnn.log")
    cli_run("train CLI --encoder_type rnn --brnn", [
        os.path.join(paths["train"], "data.lst"), log, os.path.join(work, "rnn"),
        *RNN_MODEL_FLAGS, *CLI_RECIPE_FLAGS, "--feat_config", paths["fbank"], "--cmvn_stats",
        paths["stats"], "--num_epochs", "1", "--num_batches_per_epoch",
        str(CLI_BATCHES_PER_EPOCH), "--device", str(device)], log)
    valid = paths["valid"]
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        wer = eval_main([os.path.join(work, "rnn", "model.epoch.0"),
                         os.path.join(valid, "wav.scp"), os.path.join(work, "rnn_nbest.txt"),
                         "--beam_size", str(BEAM), "--n_best", str(NBEST),
                         "--max_wav_seconds", str(int(CLI_SECONDS[1]) + 1),
                         "--feat_config", paths["fbank"], "--cmvn_stats", paths["stats"],
                         "--ref_labels", f"ark:{os.path.join(valid, 'label.txt')}",
                         "--device", str(device)])
    with open(os.path.join(work, "rnn_nbest.txt")) as f:
        n_lines = len(f.read().splitlines())
    for line in err.getvalue().splitlines():
        say(f"decode CLI on the rnn bundle: {line}")
    check(n_lines == CLI_UTTS["valid"] * NBEST and wer is not None,
          f"decode CLI on the rnn bundle: {n_lines} N-best lines")
    say(f"decode CLI on the rnn bundle: {time.perf_counter() - t0:.3f} s, {n_lines} N-best "
        f"lines, WER {wer:.4f} (one epoch on noise: printed, not judged)")


def dist_path(device, paths: dict) -> None:
    """The distributed training phase on the training CLI's corpus: the
    recipe's BMUF command line over NCCL with --resume, the BMUF(0, 1) =
    sync hold, the sync's cost against its bound, BMUF in the MBR and LAS
    CLIs, and the rnn encoder."""
    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(paths["train"]), "dist")
    os.makedirs(work)
    recipe_bmuf(device, paths, work)
    bmuf_sync_hold(device, paths, work)
    sync_cost(device)
    bmuf_other_clis(device, paths)
    rnn_encoder_path(device, paths, work)
    say(f"distributed phase: {time.perf_counter() - t_phase:.3f} s")


def transformer_decode(device, model, featurizer, lstm: dict) -> None:
    """Greedy and beam 8 (n_best 8, 200 symbols) of the transformer
    prediction net on the inference batch, graphed against eager bit for
    bit, beam 1 against greedy, bf16 ("auto") finite; wall times and loop
    steps beside the LSTM decoder's (``lstm``, from ``beam_path``)."""
    batch = flagship_batch(device, BATCH)
    with torch.no_grad():
        feats, feat_lens = featurizer(batch["wavs"], batch["wav_lens"])
        enc = model.encode(feats, feat_lens)
        enc_lens = model.encoder_out_len(feat_lens)
    t_out = enc.shape[1]
    cfg = BeamConfig(beam_size=BEAM, n_best=NBEST, max_symbols=MAX_SYMBOLS)
    t0 = time.perf_counter()
    graphed = beam_search(model, enc, enc_lens, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    beam_s = dp_seconds(lambda: beam_search(model, enc, enc_lens, cfg), repeats=1)
    peak = torch.cuda.max_memory_allocated(device)
    t0 = time.perf_counter()
    eager = beam_search_eager(model, enc, enc_lens, cfg)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    steps = int(graphed["steps"])
    check(same_nbest(graphed, eager), "transformer decoder beam: graphed = eager")
    check_nbest(graphed, t_out, "transformer decoder beam 8")
    say(f"transformer decoder beam {BEAM}, n_best {NBEST}, B={BATCH}, T'={t_out}: graphed "
        f"{beam_s:.4f} s ({steps} loop steps, {beam_s / steps * 1e3:.3f} ms a step; first call "
        f"with the capture {first_s:.3f} s), eager {eager_s:.4f} s; peak memory "
        f"{peak / 2**30:.3f} GiB; graphed = eager, N-best invariants: ok; top-1 lens "
        f"{graphed['lens'][:, 0].tolist()}")
    say(f"  beside the LSTM decoder (beam_path): graphed {lstm['beam_s']:.4f} s, "
        f"{lstm['steps']} steps ({lstm['beam_s'] / lstm['steps'] * 1e3:.3f} ms a step), eager "
        f"{lstm['beam_eager_s']:.4f} s: the transformer's search is "
        f"{beam_s / lstm['beam_s']:.2f}x")
    greedy = greedy_decode(model, enc, enc_lens, MAX_SYMBOLS)
    greedy_s = dp_seconds(lambda: greedy_decode(model, enc, enc_lens, MAX_SYMBOLS), repeats=1)
    t0 = time.perf_counter()
    ref = greedy_decode_eager(model, enc, enc_lens, MAX_SYMBOLS)
    torch.cuda.synchronize()
    greedy_eager_s = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(greedy, ref)),
          "transformer decoder greedy: graphed = eager")
    check_hyps(*greedy, device)
    beam1 = beam_search(model, enc, enc_lens, BeamConfig(beam_size=1, n_best=1,
                                                         max_symbols=MAX_SYMBOLS))
    check(torch.equal(beam1["tokens"][:, 0], greedy[0])
          and torch.equal(beam1["lens"][:, 0], greedy[1]),
          "transformer decoder: beam 1 (float32) gives greedy's tokens")
    say(f"transformer decoder greedy: graphed {greedy_s:.4f} s, eager {greedy_eager_s:.4f} s "
        f"(LSTM greedy graphed {lstm['greedy_s']:.4f} s); graphed = eager, beam 1 = greedy: ok")
    bf16_cfg = BeamConfig(beam_size=BEAM, n_best=NBEST, max_symbols=MAX_SYMBOLS, mm_dtype="auto")
    bf16 = beam_search(model, enc, enc_lens, bf16_cfg)
    bf16_s = dp_seconds(lambda: beam_search(model, enc, enc_lens, bf16_cfg), repeats=1)
    check(bool(torch.isfinite(bf16["scores"]).all()), "transformer decoder beam bf16: finite")
    check_nbest(bf16, t_out, "transformer decoder beam 8 bf16")
    say(f"transformer decoder beam {BEAM} at bf16 (auto), graphed: {bf16_s:.4f} s, "
        f"{int(bf16['steps'])} steps (LSTM {lstm['bf16_s']:.4f} s); top-1 agreement with "
        f"float32 {top1_agreement(bf16, graphed)} of {BATCH} rows")
    profile(lambda: beam_search(model, enc, enc_lens, cfg)["steps"].item(),
            "transformer decoder beam 8 graphed")


def transformer_decoder_path(device, paths: dict, work: str, lstm: dict) -> dict:
    """The transformer prediction net at the flagship width (TDNN 9 x 1024,
    hid 1024, V 6268; ConvTransformerLM at TransducerConfig's d_model 512, 8
    heads, d_ff 2048, 2 layers): the eval step at 8 x 10 s (one K1 launch),
    the decodes (``transformer_decode``), 3 training steps at 32 x 10 s (one
    launch each of K1, K2 and K3 per step), one step on the kernel against
    one on the plain loss backend; then the training CLI for 2 epochs on
    the training CLI phase's corpus with --decoder_type transformer, the
    decode CLI on its bundle without and with --fst_lm (``fst_path``'s
    bigram), and one MBR CLI epoch on that bundle.  Returns the decode
    CLI's best hypotheses and the reference file, for ``score_path``."""
    t_phase = time.perf_counter()
    model, featurizer = eval_setup(device, **TRANSFORMER_DECODER)
    eval_step = make_eval_step(model, featurizer, loss_chunk=32)
    batch = flagship_batch(device, BATCH)
    eval_step(batch)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    loss = eval_step(batch)["loss"].item()
    eval_s = time.perf_counter() - t0
    check(joint_channels.launches == 1 and math.isfinite(loss),
          f"transformer decoder eval step: {joint_channels.launches} K1 launches, loss {loss}")
    say(f"transformer decoder eval step (K1), {BATCH} x {SECONDS} s: {eval_s:.3f} s, loss "
        f"{loss:.4f}, K1 launches 1: ok")
    transformer_decode(device, model, featurizer, lstm)
    del model, featurizer, eval_step
    torch.cuda.empty_cache()

    batch = flagship_batch(device, TRAIN_BATCH)
    model, step = train_setup(device, batch, dropout=0.2, **TRANSFORMER_DECODER)
    gen = torch.Generator(device).manual_seed(1)
    step(batch, gen)["loss"].item()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    times, losses = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(step(batch, gen)["loss"].item())
        times.append(time.perf_counter() - t0)
    launches = {"K1": joint_channels.launches, "K2": joint_channels_bwd_in.launches,
                "K3": joint_channels_bwd_w.launches}
    peak = torch.cuda.max_memory_allocated(device)
    say(f"transformer decoder train steps (decoder dropout 0.2), batch {TRAIN_BATCH} x {SECONDS} "
        f"s: {', '.join(f'{x:.4f}' for x in times)} s, median {statistics.median(times):.4f} s; "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; peak memory {peak / 2**30:.3f} GiB; "
        f"launches {launches}")
    check(all(math.isfinite(x) for x in losses), "transformer decoder train losses finite")
    check(all(n == TIMED_STEPS for n in launches.values()),
          f"one launch each of K1, K2, K3 per transformer decoder step: {launches}")
    profile(lambda: step(batch, gen)["loss"].item(), "transformer decoder train step")
    del model, step
    torch.cuda.empty_cache()
    got = one_step(device, batch, "transformer decoder, auto backend", **TRANSFORMER_DECODER)
    ref = one_step(device, batch, "transformer decoder, plain backend", "plain",
                   **TRANSFORMER_DECODER)
    compare_steps("transformer decoder kernel vs plain backend", got, ref, STEP_LOSS_RTOL,
                  STEP_ENCODER_TOL, STATS_TOL, attention=("encoder.", "decoder."))

    # the CLIs on the training CLI phase's corpus
    exp = os.path.join(work, "exp_tdec")
    log = os.path.join(work, "tdec.log")
    reset_launches()
    cli_run("train CLI --decoder_type transformer", [
        os.path.join(paths["train"], "data.lst"), log, exp, *CLI_MODEL_FLAGS, *CLI_RECIPE_FLAGS,
        "--decoder_type", "transformer", "--feat_config", paths["fbank"],
        "--cmvn_stats", paths["stats"], "--device", str(device),
        "--num_batches_per_epoch", str(CLI_BATCHES_PER_EPOCH), "--num_epochs", str(CLI_EPOCHS),
        "--valid_data_lst", os.path.join(paths["valid"], "data.lst")], log)
    cli_launches = {"K1": joint_channels.launches, "K2": joint_channels_bwd_in.launches,
                    "K3": joint_channels_bwd_w.launches}
    check(all(n > 0 for n in cli_launches.values()),
          f"the transformer decoder CLI launched K1-K3: {cli_launches}")
    bundle = os.path.join(exp, f"model.epoch.{CLI_EPOCHS - 1}")
    check(load_bundle(bundle, "cpu")[0].config.decoder_type == "transformer",
          "the CLI's bundle has the transformer decoder")
    valid = paths["valid"]
    units = os.path.join(work, "units.txt")
    with open(units, "w") as f:
        f.write("".join(f"u{k} {k}\n" for k in range(VOCAB)))
    decode = [os.path.join(valid, "wav.scp"), "--beam_size", str(BEAM), "--n_best", str(NBEST),
              "--max_wav_seconds", str(int(CLI_SECONDS[1]) + 1), "--feat_config", paths["fbank"],
              "--cmvn_stats", paths["stats"], "--ref_labels",
              f"ark:{os.path.join(valid, 'label.txt')}", "--device", str(device)]
    out = {}
    for name, extra in (("plain", []), ("--fst_lm", [
            "--fst_lm", os.path.join(work, "lm.arpa"), "--fst_lm_scale", str(FST_SCALE),
            "--nonblk_reward", str(FST_REWARD), "--fst_cache_file", "auto",
            "--symbols_map", units])):
        nbest = os.path.join(work, f"tdec_nbest_{len(out)}.txt")
        t0 = time.perf_counter()
        best, err = decode_cli_best([bundle, decode[0], nbest, *decode[1:], *extra])
        with open(nbest) as f:
            n_lines = len(f.read().splitlines())
        wer_lines = [x for x in err if x.startswith("%WER")]
        say(f"decode CLI {name} on the transformer decoder's bundle: "
            f"{time.perf_counter() - t0:.3f} s, {n_lines} N-best lines; {' | '.join(wer_lines)}")
        check(n_lines == CLI_UTTS["valid"] * NBEST and len(wer_lines) == 1,
              f"decode CLI {name}: {n_lines} N-best lines, a WER line")
        out[name] = (best, wer_lines[0])

    mbr_log = os.path.join(work, "tdec_mbr.log")
    reset_launches()
    cli_run("MBR CLI on the transformer decoder's bundle", [
        paths["mbr_lst"], mbr_log, os.path.join(work, "tdec_mbr"), *MBR_FLAGS, "--num_epochs",
        "1", "--init_model", bundle, "--feat_config", paths["fbank"],
        "--cmvn_stats", paths["stats"], "--device", str(device)], mbr_log, mbr_main)
    mbr_launches = {"K1": joint_channels.launches, "K2": joint_channels_bwd_in.launches,
                    "K3": joint_channels_bwd_w.launches}
    check(all(n > 0 for n in mbr_launches.values()),
          f"the MBR CLI on the transformer decoder launched K1-K3: {mbr_launches}")
    say(f"transformer decoder phase: {time.perf_counter() - t_phase:.3f} s (CLI launches "
        f"{cli_launches}, MBR CLI {mbr_launches})")
    return {"best": out["plain"][0], "wer_line": out["plain"][1],
            "ref": os.path.join(valid, "label.txt")}


def pruned_path(device, paths: dict, full_step_s: float) -> None:
    """The pruned objective on the card: the full band held to the fused
    loss (K1) and its gradients to K2 + K3; ``prune_ranges`` and the pruned
    loss on the card against the CPU; 3 training steps at 32 x 10 s with
    --pruned_loss_range 5 and one warm step (pruned_scale 0.1), beside the
    full-loss step of ``train_path``, and a profiled step; then the
    training CLI for 2 epochs with --pruned_loss_range 5
    --pruned_warmup_epochs 1 (a warm epoch, then a full one; validation
    through K1)."""
    t_phase = time.perf_counter()
    with torch.device("meta"):
        t_out = Transducer(TransducerConfig(**FLAGSHIP)).encoder_out_len(
            1 + (SR * SECONDS - 400) // 160)  # 25 ms frames, 10 ms hop
    u1 = U_MAX + 1
    ax, gx, ay, gy, w2, b2, labels_ext = joint_case(device, 7, BATCH, t_out, u1, 1024, VOCAB)
    labels = labels_ext[:, :-1].clamp(min=1)
    t_len = torch.full((BATCH,), t_out, device=device)
    u_len = torch.full((BATCH,), U_MAX, device=device)
    f1 = [x.clone().requires_grad_() for x in (ax, gx, ay, gy, w2, b2)]
    f2 = [x.clone().requires_grad_() for x in (ax, gx, ay, gy, w2, b2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = rnnt_loss_pruned(*f1, labels, t_len, u_len,
                           torch.zeros(BATCH, t_out, dtype=torch.long, device=device), u1)
    got.sum().backward()
    torch.cuda.synchronize()
    band_s = time.perf_counter() - t0
    ref = rnnt_loss_fused(*f2, labels, t_len, u_len, 16)
    ref.sum().backward()
    rel = ((got - ref).norm() / ref.norm()).item()
    grads = {n: ((a.grad - b.grad).norm() / b.grad.norm()).item()
             for n, a, b in zip(("ax", "gx", "ay", "gy", "w2", "b2"), f1, f2)}
    say(f"pruned loss, full band (s_range {u1}, s_begin 0) at {BATCH} x {t_out} x {u1}, float32 "
        f"products, {band_s:.3f} s with its backward: losses vs the fused loss (K1, bf16 "
        f"products) rel L2 {rel:.3e}, gradients vs K2 + K3 rel L2 "
        + ", ".join(f"{n} {e:.2e}" for n, e in grads.items()) + f" (envelope {ENVELOPE})")
    check(rel <= ENVELOPE and all(e <= ENVELOPE for e in grads.values()),
          "full-band pruned loss within the bf16 envelope of K1-K3")
    del f1, f2, got, ref

    # the card against the CPU: band starts from the simple joint, then the
    # pruned loss on one set of band starts
    g = torch.Generator().manual_seed(8)
    am = torch.randn(BATCH, t_out, VOCAB, generator=g) * 2
    lm = torch.randn(BATCH, u1, VOCAB, generator=g) * 2
    cpu_labels = labels.cpu()
    t_len_cpu = torch.randint(t_out // 2, t_out + 1, (BATCH,), generator=g)
    u_len_cpu = torch.randint(U_MAX // 2, U_MAX + 1, (BATCH,), generator=g)
    with torch.no_grad():
        blank_lp, emit_lp = simple_channels(am, lm, cpu_labels)
    cpu_sb = prune_ranges(blank_lp, emit_lp, t_len_cpu, u_len_cpu, PRUNED_RANGE)
    card_sb = prune_ranges(blank_lp.to(device), emit_lp.to(device), t_len_cpu.to(device),
                           u_len_cpu.to(device), PRUNED_RANGE).cpu()
    for sb in (cpu_sb, card_sb):
        check(bool((sb[:, 0] == 0).all() and (sb.diff(dim=1) >= 0).all()
                   and (sb.diff(dim=1) <= PRUNED_RANGE - 1).all()
                   and (sb <= (u_len_cpu + 1 - PRUNED_RANGE).clamp(min=0)[:, None]).all()),
              "prune_ranges invariants")
    g_blank, g_emit = rnnt_occupancy(blank_lp, emit_lp, t_len_cpu, u_len_cpu)
    gamma = -(g_blank + g_emit).double()
    u = torch.arange(u1)

    def mass(sb):
        return (gamma * ((u >= sb[..., None]) & (u < sb[..., None] + PRUNED_RANGE))).sum((1, 2))

    differ = (card_sb != cpu_sb).any(dim=1)
    ties = int(differ.sum())
    check(bool(((mass(card_sb) - mass(cpu_sb)).abs()[differ]
                <= 1e-5 * mass(cpu_sb).abs().clamp(min=1.0)[differ]).all()),
          "prune_ranges: the card's band starts equal the CPU's but at float32 ties")
    say(f"prune_ranges card vs CPU ({BATCH} x {t_out}, U {U_MAX}, s_range {PRUNED_RANGE}): "
        f"{BATCH - ties} of {BATCH} utterances equal, {ties} differ at a float32 tie of two "
        f"bands' posterior mass; invariants: ok")
    factors = [x.detach().cpu() for x in (ax, gx, ay, gy, w2, b2)]
    with torch.no_grad():
        loss_cpu = rnnt_loss_pruned(*factors, cpu_labels, t_len_cpu, u_len_cpu, cpu_sb,
                                    PRUNED_RANGE)
        loss_card = rnnt_loss_pruned(*(x.to(device) for x in factors), labels, t_len_cpu.to(device),
                                     u_len_cpu.to(device), cpu_sb.to(device), PRUNED_RANGE).cpu()
    rel = ((loss_card - loss_cpu).abs() / loss_cpu.abs().clamp(min=1e-30)).max().item()
    say(f"pruned loss card vs CPU on the CPU's band starts: max rel err {rel:.3e} (rtol "
        f"{PRUNED_RTOL}); losses {', '.join(f'{x:.3f}' for x in loss_cpu.tolist())}")
    check(rel <= PRUNED_RTOL and bool((loss_cpu > 0).all()), "pruned loss card vs CPU")
    del ax, gx, ay, gy, w2, b2, am, lm

    batch = flagship_batch(device, TRAIN_BATCH)
    for scale in (PRUNED_WARM_SCALE, 1.0):
        model, step = train_setup(device, batch, simple_joint=True, step_kw=dict(
            pruned_range=PRUNED_RANGE, simple_scale=0.5, pruned_scale=scale))
        gen = torch.Generator(device).manual_seed(1)
        step(batch, gen)["loss"].item()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        times, losses = [], []
        for _ in range(TIMED_STEPS if scale == 1.0 else 1):
            t0 = time.perf_counter()
            losses.append(step(batch, gen)["loss"].item())
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(device)
        launches = {"K1": joint_channels.launches, "K2": joint_channels_bwd_in.launches,
                    "K3": joint_channels_bwd_w.launches}
        median = statistics.median(times)
        say(f"pruned train step{'s' if len(times) > 1 else ''} (s_range {PRUNED_RANGE}, "
            f"pruned_scale {scale}), batch {TRAIN_BATCH} x {SECONDS} s: "
            f"{', '.join(f'{x:.4f}' for x in times)} s, median {median:.4f} s "
            f"({median / full_step_s:.2f}x the full-loss step's {full_step_s:.4f} s); losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}; peak memory {peak / 2**30:.3f} GiB; "
            f"launches {launches}")
        check(all(math.isfinite(x) for x in losses), "pruned train losses finite")
        check(all(n == 0 for n in launches.values()),
              "the pruned objective runs outside K1-K3 (plain PyTorch, as in the JAX package)")
        if scale == 1.0:
            profile(lambda: step(batch, gen)["loss"].item(), "pruned train step")
        del model, step
        torch.cuda.empty_cache()
    pruned_repeat(device, batch)

    work = os.path.dirname(paths["stats"])
    log = os.path.join(work, "pruned.log")
    reset_launches()
    lines, _, _ = cli_run("train CLI --pruned_loss_range 5", [
        os.path.join(paths["train"], "data.lst"), log, os.path.join(work, "exp_pruned"),
        *CLI_MODEL_FLAGS, *CLI_RECIPE_FLAGS, "--pruned_loss_range", str(PRUNED_RANGE),
        "--pruned_warmup_epochs", "1", "--feat_config", paths["fbank"],
        "--cmvn_stats", paths["stats"], "--device", str(device),
        "--num_batches_per_epoch", str(CLI_BATCHES_PER_EPOCH), "--num_epochs", str(CLI_EPOCHS),
        "--valid_data_lst", os.path.join(paths["valid"], "data.lst")], log)
    launches = {"K1": joint_channels.launches, "K2": joint_channels_bwd_in.launches,
                "K3": joint_channels_bwd_w.launches}
    check(sum("valid loss/label" in x for x in lines) == CLI_EPOCHS and launches["K1"] > 0,
          f"pruned CLI: validation through K1 ({launches})")
    say(f"pruned phase: {time.perf_counter() - t_phase:.3f} s (CLI launches {launches}: K1 in "
        f"validation only)")


def pruned_repeat(device, batch: dict) -> None:
    """A warm step and TIMED_STEPS pruned steps (from seed 0, generator seed
    1) run twice, each time on a new model, with cuDNN's TF32 flag on as the
    CLIs leave it: the same losses and the same parameters and BatchNorm
    statistics, bit for bit (the band's and the simple joint's gathers sum
    their gradients in a fixed order).  With the flag off, as the rest of
    this script runs, cuDNN picks convolution backward algorithms for the
    TDNN that do not repeat, in the full-loss step too (PERF.md §6)."""
    runs = []
    torch.backends.cudnn.allow_tf32 = True
    try:
        for _ in range(2):
            model, step = train_setup(device, batch, simple_joint=True, step_kw=dict(
                pruned_range=PRUNED_RANGE, simple_scale=0.5, pruned_scale=1.0))
            gen = torch.Generator(device).manual_seed(1)
            losses = [step(batch, gen)["loss"].item() for _ in range(1 + TIMED_STEPS)]
            runs.append((losses, {k: v.clone() for k, v in model.state_dict().items()}))
            del model, step
    finally:
        torch.backends.cudnn.allow_tf32 = False
    (losses, state), (losses_again, state_again) = runs
    differ = [k for k in state if not torch.equal(state[k], state_again[k])]
    say(f"pruned steps run twice ({len(losses)} steps at {TRAIN_BATCH} x {SECONDS} s, cuDNN's "
        f"TF32 flag on): losses "
        f"{'equal' if losses == losses_again else f'{losses} against {losses_again}'}; "
        f"{len(state) - len(differ)} of {len(state)} tensors of the model's state equal")
    check(losses == losses_again and not differ,
          f"pruned steps repeat bit for bit (differ: {differ[:5]})")


def score_path(decoded: dict, work: str) -> None:
    """``python -m pika_tpu_torch.decode.score`` on the transformer decode
    CLI's best hypotheses against the references, with and without
    --char: without it, the decode CLI's own %WER line."""
    hyp = os.path.join(work, "score_hyp.txt")
    with open(hyp, "w") as f:
        for uttid, toks in decoded["best"].items():
            f.write(" ".join([uttid, *toks]) + "\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for extra in ([], ["--char"]):
        out = subprocess.run([sys.executable, "-m", "pika_tpu_torch.decode.score",
                              decoded["ref"], hyp, *extra], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        lines = out.stdout.splitlines()
        check(out.returncode == 0 and len(lines) == 2 and lines[0].startswith("%WER")
              and lines[1].startswith("%SER"), f"score CLI {extra}: {out.stderr[-1000:]}")
        if not extra:
            check(lines[0] == decoded["wer_line"],
                  f"score CLI: {lines[0]!r} vs the decode CLI's {decoded['wer_line']!r}")
        say(f"score CLI {' '.join(extra) or '(words)'}: {' | '.join(lines)}"
            + ("" if extra else " (= the decode CLI's WER line)"))


def convergence_probe(device, work: str) -> None:
    """The warm-up convergence probe (``recipes/probe.py``: the JAX probe's
    corpus, model, optimizer, augmentation and 12 epochs of 16 batches) on
    the card, held to the JAX probe's own gates; its K1-K3 launches."""
    reset_launches()
    out = probe.run_probe(work, str(device))
    launches = joint_launches()
    losses = out["losses"]
    argv = probe.commands(work)["train"]
    steps = probe.EPOCHS * int(argv[argv.index("--num_batches_per_epoch") + 1])
    say(f"convergence probe: epoch losses {losses} (chance ln 31 = {math.log(31):.2f}); "
        f"training {out['train_s']:.1f} s, {out['train_s'] / steps:.3f} s a step over {steps} "
        f"(before the fused LSTM route: {PROBE_STEP_S_BEFORE}); launches K1 {launches['K1']}, "
        f"K2 {launches['K2']}, K3 {launches['K3']}")
    check(len(losses) == probe.EPOCHS, f"probe: {len(losses)} epochs")
    missed = probe.missed_gates(losses)
    check(not missed, f"probe: the JAX probe's gates missed: {missed}")
    check(all(n > 0 for n in launches.values()), f"probe: K1-K3 launched {launches}")
    say(f"convergence probe: gates {probe.GATES} (epoch, loss below): ok")


def recipe_path(device, work: str) -> None:
    """``recipes/mini_grammar.py`` end to end on the card at a cut budget
    (RECIPE_CUT): every stage on the card, its last artifact written, every
    RESULTS line of a known form (the FST and LAS lines included), K1-K3
    launched in training; the WERs printed, not judged."""
    reset_launches()
    t0 = time.perf_counter()
    out = mini_grammar.run(work, seed=1, device=str(device), flags=RECIPE_FLAGS, **RECIPE_SWEEPS,
                           **RECIPE_CUT)
    wall = time.perf_counter() - t0
    launches = joint_launches()
    c = mini_grammar.Commands(work, 1, **RECIPE_CUT)
    check(out["ok"], "recipe: the FST scale could not be tuned")
    for artifact in (c.lm, f"{c.data}/train/global_cmvn.stats", f"{c.dev}/test/label.txt",
                     f"{c.exp}/model.epoch.{c.epochs[0] - 1}", c.model, c.mbr_model,
                     *c.las_models, f"{c.exp}/las_sweep.note"):
        check(os.path.exists(artifact), f"recipe: {artifact} written")
    stages = [t for t in out["times"] if t.startswith("stage")]
    check(len(stages) == 9, f"recipe: stages run {stages}")
    lines = open(c.results).read().splitlines()
    forms = mini_grammar.parse_results(lines)
    wers = {m[1]: float(m[2]) for form, m in forms if form == "wer"}
    check(not any(form == "failed" for form, _ in forms), f"recipe: a decode failed: {lines}")
    check(len(wers) == 10 and sum(form == "pair" for form, _ in forms) == 1
          and sum(form == "chosen" for form, _ in forms) == 2, f"recipe: RESULTS {lines}")
    check(all(n > 0 for n in launches.values()), f"recipe: K1-K3 launched {launches}")
    budget = ", ".join(f"{k} {v}" for k, v in {**RECIPE_CUT, **RECIPE_SWEEPS,
                                               **RECIPE_FLAGS}.items())
    say(f"recipe path (mini_grammar on the card; cut: {budget}): {wall:.1f} s; stages "
        + ", ".join(f"{t.split(' (')[0]} {s:.1f} s" for t, s in out["times"].items()
                    if t.startswith("stage"))
        + f"; launches K1 {launches['K1']}, K2 {launches['K2']}, K3 {launches['K3']}")
    say("recipe path WERs (printed, not judged): "
        + ", ".join(f"{tag} {w:.2f}" for tag, w in wers.items())
        + f"; chosen fst {out['fst_scale']}, pt {out['pt_scale']}, las {out['las_pair']}; "
        f"losses {out['losses']}")


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm().clamp(min=1e-30))


def lstm_route_path(device) -> None:
    """The LSTM's fused route (one cuDNN call per layer, packed ragged
    batches) against its loop over frames at LSTM_SHAPES (bidirectional,
    ragged) and PREDICTION_SHAPES (unidirectional, unmasked, train mode,
    cuDNN's TF32 flag on): outputs, final states and the gradients of the
    input and of every parameter from one backward of fixed cotangents;
    both routes' forward + backward timed by CUDA events."""
    shapes = [(*s, True) for s in LSTM_SHAPES] + [(*s, False) for s in PREDICTION_SHAPES]
    for name, b, t, d, h, layers, ragged in shapes:
        gen = torch.Generator().manual_seed(t)
        dirs = 2 if ragged else 1
        mod = LSTM(d, h, layers, bidirectional=ragged, device=device)
        with torch.no_grad():  # torch's LSTM initialisation, U(-1/sqrt(H), 1/sqrt(H))
            for p in mod.parameters():
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) / math.sqrt(h // dirs))
        x = torch.randn(b, t, d, generator=gen).to(device)
        lengths = None
        if ragged:
            lengths = torch.linspace(t, 1, b).round().long()[torch.randperm(b, generator=gen)]
        out_cot = torch.randn(b, t, h, generator=gen).to(device)
        state_cot = [torch.randn(layers * dirs, b, h // dirs, generator=gen).to(device)
                     for _ in range(2)]

        def run(route):
            mod.zero_grad()
            xr = x.clone().requires_grad_()
            out, (hh, cc) = getattr(mod, route)(
                xr, None, None if lengths is None else lengths.to(device))
            ((out * out_cot).sum() + (hh * state_cot[0]).sum()
             + (cc * state_cot[1]).sum()).backward()
            return {"out": out.detach(), "h": hh.detach(), "c": cc.detach(), "dx": xr.grad,
                    **{f"d{k}": p.grad.clone() for k, p in mod.named_parameters()}}

        torch.backends.cudnn.allow_tf32 = not ragged  # the CLIs leave it on
        try:
            fused, loop = run("forward_fused"), run("forward_loop")
            fused_ms = time_ms(lambda: run("forward_fused"), 2, 5)
            loop_ms = time_ms(lambda: run("forward_loop"), 1, 2)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        errs = {k: rel_l2(fused[k], loop[k]) for k in loop}
        worst = max(errs, key=errs.get)
        form = (f"{layers} bidirectional layers of {h}, lengths "
                f"{int(lengths.min())}-{int(lengths.max())}" if ragged else
                f"{layers} unidirectional layer{'s' if layers > 1 else ''} of {h}, unmasked, "
                f"train mode, cuDNN's TF32 flag on")
        say(f"LSTM route, {name} ({b} x {t} x {d}, {form}): fused (cuDNN) forward + "
            f"backward {fused_ms:.3f} ms, the loop {loop_ms:.3f} ms ({loop_ms / fused_ms:.1f}x); "
            f"{len(errs)} tensors within {errs[worst]:.2e} rel L2 (worst {worst})")
        check(all(e <= LSTM_RTOL for e in errs.values()),
              f"LSTM route {name}: fused against the loop {errs}")
        if ragged:
            check(not fused["out"][lengths.argmin(), 1:].any(),
                  f"LSTM route {name}: 0 past a length")


def las_diversity_path(device, work: str) -> None:
    """``recipes/las_diversity.py`` on the cut recipe's bundles
    (LAS_IND_EPOCHS of 4 batches a direction, the script's nine-pair sweep):
    its artifacts and its RESULTS line forms; then the N-best oracle of the
    recipe's decodes beside their 1-best."""
    t0 = time.perf_counter()
    out = las_diversity.run(work, seed=1, device=str(device), flags=RECIPE_FLAGS,
                            las_ind_epochs=LAS_IND_EPOCHS, **RECIPE_CUT)
    wall = time.perf_counter() - t0
    c = las_diversity.Commands(work, 1, las_ind_epochs=LAS_IND_EPOCHS, **RECIPE_CUT)
    check(out["ok"], "las_diversity: failed")
    for artifact in (*c.las_ind_models, f"{c.exp}/las_ind_sweep.note"):
        check(os.path.exists(artifact), f"las_diversity: {artifact} written")
    lines = open(c.results).read().splitlines()
    kinds = [next((k for k, rx in las_diversity.RESULT_FORMS.items() if rx.match(line)), None)
             for line in lines]
    check(kinds == ["sweep"] * 9 + ["pair", "wer", "wer"],
          f"las_diversity: RESULTS.las_ind.seed1 forms {lines}")
    steps = LAS_IND_EPOCHS * int(RECIPE_FLAGS["--num_batches_per_epoch"])
    say(f"las_diversity (independent LAS, {LAS_IND_EPOCHS} epochs of "
        f"{RECIPE_FLAGS['--num_batches_per_epoch']} batches a direction): {wall:.1f} s; "
        + ", ".join(f"{t.split(' (')[0]} {v:.1f} s ({v / steps:.3f} s a step)"
                    for t, v in out["times"].items() if t.startswith("stage"))
        + "; " + " | ".join(lines[-3:]) + " (printed, not judged)")
    g = mini_grammar.Commands(work, 1, **RECIPE_CUT)
    for nbest, symbols in (("nbest_base.txt", False), ("nbest_fst.txt", True),
                           ("nbest_fst_pt.txt", True), ("nbest_mbr_fst_pt_las_ind.txt", True)):
        first, best = nbest_oracle.oracle(f"{g.exp}/{nbest}", f"ark:{g.data}/test/label.txt",
                                          f"{g.data}/test/wav.scp", 4,
                                          g.char if symbols else None)
        check(best[1]["errors"] <= first[1]["errors"], f"oracle of {nbest}: above the 1-best")
        say(f"N-best oracle, {nbest}: {nbest_oracle.oracle_line(4, first, best)}")


def pruned_grammar_path(device, work: str) -> None:
    """The pruned objective's grammar recipes on the cut recipe's corpus and
    LM: ``pruned_grammar`` (the pruned training: no K1-K3 launch),
    ``pruned_retune`` (PRUNED_SWEEPS), ``pruned_finetune`` (PRUNED_FT_EPOCHS,
    through K1-K3, with the ``--sm_scale`` probe) and
    ``exact_fusion_redecodes --seeds 1`` on the recipe's bundles: each
    RESULTS line of its recipe's form, in its script's order; the stage
    seconds and the launches printed; the WERs printed, not judged."""
    run = dict(seed=1, device=str(device), flags=RECIPE_FLAGS, **RECIPE_CUT)
    launches, outs, walls = {}, {}, {}
    for name, fn in (("pruned_grammar", lambda: pruned_grammar.run(work, **run)),
                     ("pruned_retune", lambda: pruned_retune.run(work, **PRUNED_SWEEPS, **run)),
                     ("pruned_finetune", lambda: pruned_finetune.run(
                         work, ft_epochs=PRUNED_FT_EPOCHS, **run)),
                     ("exact_fusion_redecodes", lambda: exact_fusion_redecodes.run(
                         work, "1", **{k: v for k, v in run.items() if k != "seed"}))):
        reset_launches()
        t0 = time.perf_counter()
        outs[name] = fn()
        walls[name] = time.perf_counter() - t0
        launches[name] = joint_launches()
    check(outs["pruned_grammar"]["ok"] and outs["pruned_finetune"]["ok"],
          "pruned envelope: a recipe found no input")
    pruned = pruned_grammar.Commands(work, 1, **RECIPE_CUT)
    ft = pruned_finetune.Commands(work, 1, PRUNED_FT_EPOCHS, **RECIPE_CUT)
    for artifact in (f"{pruned.exp}/model.epoch.{pruned.epochs[0] - 1}", pruned.model,
                     ft.model):
        check(os.path.exists(artifact), f"pruned envelope: {artifact} written")
    kinds = {path: [k for k, _ in pruned_grammar.parse_results(open(path).read().splitlines())]
             for path in (pruned.results, ft.results, f"{work}/RESULTS.exact_fusion")}
    check(kinds[pruned.results] == ["wer"] * 4 + ["sweep", "chosen", "sweep", "chosen", "wer",
                                                  "wer"],
          f"pruned envelope: {pruned.results} forms {kinds[pruned.results]}")
    check(kinds[ft.results] == ["wer"] * 3 + ["heading", "oracle", "wer", "wer"],
          f"pruned envelope: {ft.results} forms {kinds[ft.results]}")
    exact = open(f"{work}/RESULTS.exact_fusion").read().splitlines()
    check(len(exact) == 2 and all("%WER" in line for line in exact),
          f"pruned envelope: RESULTS.exact_fusion {exact}")
    losses = outs["pruned_finetune"]["losses"]
    check(bool(losses) and math.isfinite(losses[0]),
          f"pruned envelope: the fine-tune's epoch losses {losses}")
    check(all(n > 0 for n in launches["pruned_finetune"].values()),
          f"pruned envelope: K1-K3 launched in the fine-tune {launches['pruned_finetune']}")
    # the pruned steps bypass K1-K3, and the recipe trains without a validation set
    check(not any(launches["pruned_grammar"].values()),
          f"pruned envelope: the pruned training launched {launches['pruned_grammar']}")
    for name, out in outs.items():
        stages = {t: v for t, v in out["times"].items() if not t.startswith("decode")}
        decodes = [v for t, v in out["times"].items() if t.startswith("decode")]
        say(f"{name} (cut: {RECIPE_FLAGS['--num_batches_per_epoch']} batches an epoch): "
            f"{walls[name]:.1f} s; "
            + "".join(f"{t} {v:.1f} s; " for t, v in stages.items())
            + f"{len(decodes)} decodes {sum(decodes):.1f} s; launches "
            + ", ".join(f"{k} {n}" for k, n in launches[name].items())
            + "; WERs (printed, not judged) "
            + ", ".join(f"{t} {w}" for t, w in out["wer"].items()))
    say(f"pruned_finetune: epoch losses {losses}; {open(ft.results).read().splitlines()[4]}")
    pruned_grammar_repeat(work, run)


def pruned_grammar_repeat(work: str, run: dict) -> None:
    """``pruned_grammar`` twice more, each in a new work directory over the
    cut recipe's corpus and LM, with cuDNN's TF32 flag on as the CLIs leave
    it (``pruned_repeat``): the cut pruned training's per-epoch losses, its
    WERs and its final bundle's weights equal, bit for bit."""
    outs, weights, walls = [], [], []
    torch.backends.cudnn.allow_tf32 = True
    try:
        for i in range(2):
            again = f"{work}_repeat{i}"
            os.makedirs(again)
            for name in ("data", "dev", "fbank.conf"):
                os.symlink(os.path.join(work, name), os.path.join(again, name))
            t0 = time.perf_counter()
            outs.append(pruned_grammar.run(again, **run))
            walls.append(time.perf_counter() - t0)
            weights.append(torch.load(os.path.join(
                pruned_grammar.Commands(again, 1, **RECIPE_CUT).model, "model.pt"),
                weights_only=True))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    differ = [k for k in weights[0] if not torch.equal(weights[0][k], weights[1][k])]
    say(f"pruned_grammar run twice ({walls[0]:.1f} and {walls[1]:.1f} s, cuDNN's TF32 flag on): "
        f"epoch losses {outs[0]['losses']} and {outs[1]['losses']}; WERs {outs[0]['wer']} and "
        f"{outs[1]['wer']}; {len(weights[0]) - len(differ)} of {len(weights[0])} tensors of the "
        f"final bundle equal")
    check(all(out["ok"] for out in outs) and outs[0]["losses"] == outs[1]["losses"]
          and outs[0]["wer"] == outs[1]["wer"] and not differ,
          f"pruned_grammar repeats bit for bit (differ: {differ[:5]})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on the GPU only",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off for matmuls and cuDNN")

    t0 = time.perf_counter()
    lib = cuda_build.build()
    say(f"build: {time.perf_counter() - t0:.3f} s -> {lib.relative_to(cuda_build.PKG_DIR.parent)}")
    kernel = ""
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_label(line.split("'")[1])
        if any(key in line for key in ("registers", "spill", "bytes smem", "warning", "C75")):
            say(f"  {kernel}: {line.strip()[:160]}")

    work = tempfile.mkdtemp(prefix="chip_smoke_")  # LM files, the CLI phases' corpus and bundles
    k1 = kernel_parity(device)
    k2, k3 = backward_parity(device)
    recipe_joint_times(device)
    lstm_route_path(device)
    k4 = k4_parity(device)
    inference_launches, exact_loss = inference_path(device)
    flash_inference_path(device, exact_loss)
    held = torch.cuda.memory_allocated(device)
    lstm_beam = beam_path(device)
    flash_beam_path(device)
    eval_cli_path(device)
    fst_path(device, work)
    say(f"device memory still allocated after the decode phases: "
        f"{(torch.cuda.memory_allocated(device) - held) / 2**20:+.1f} MiB")
    long_utterances(device)
    small_heads_path(device)
    launches, full_step_s = train_path(device)
    cli_launches, cli_paths, cli_epochs = train_cli_path(device, os.path.join(work, "train_cli"))
    mbr_launches = mbr_path(device, cli_paths)
    las_path(device, cli_paths)
    dist_path(device, cli_paths)
    decoded = transformer_decoder_path(device, cli_paths, work, lstm_beam)
    score_path(decoded, work)
    pruned_path(device, cli_paths, full_step_s)
    convergence_probe(device, os.path.join(work, "probe"))
    recipe_path(device, os.path.join(work, "mini_grammar"))
    las_diversity_path(device, os.path.join(work, "mini_grammar"))
    pruned_grammar_path(device, os.path.join(work, "mini_grammar"))
    backend_parity(device)
    flash_launches = flash_train_path(device)
    flash_step_parity(device)
    bench_tools_path(device, work, full_step_s, lstm_beam, cli_epochs, cli_paths)
    profile_beam(device, work)
    shutil.rmtree(work)

    say(f"K1 launches: inference path {inference_launches}, training path {launches['K1']}; "
        f"training CLI (2 epochs + validation) {cli_launches}; MBR CLI (2 epochs) "
        f"{mbr_launches}")
    say(card)
    print(json.dumps({"kernels": [
        {"name": "joint_channels_fwd", "route": "cuda",
         "source": "pika_tpu_torch/csrc/joint_fwd.cu",
         "replaces": "pika_tpu/ops/rnnt_pallas.py:151", "launches": launches["K1"], **k1},
        {"name": "joint_channels_bwd_in", "route": "cuda",
         "source": "pika_tpu_torch/csrc/joint_bwd.cu",
         "replaces": "pika_tpu/ops/rnnt_pallas.py:216", "launches": launches["K2"], **k2},
        {"name": "joint_channels_bwd_w", "route": "cuda",
         "source": "pika_tpu_torch/csrc/joint_bwd.cu",
         "replaces": "pika_tpu/ops/rnnt_pallas.py:284", "launches": launches["K3"], **k3},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "pika_tpu_torch/csrc/flash_attention.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758 "
                     "(via pika_tpu/models/transformer.py:181)",
         "launches": flash_launches["K4 fwd"], **k4["fwd"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": "pika_tpu_torch/csrc/flash_attention.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 "
                     "(via pika_tpu/models/transformer.py:181)",
         "launches": flash_launches["K4 dkv"], **k4["dkv"]},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "pika_tpu_torch/csrc/flash_attention.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456 "
                     "(via pika_tpu/models/transformer.py:181)",
         "launches": flash_launches["K4 dq"], **k4["dq"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
