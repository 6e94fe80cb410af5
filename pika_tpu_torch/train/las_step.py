"""LAS rescorer training step (port of ``pika_tpu/train/las_step.py``): the
decoder's NLL summed over the non-pad targets, an optional CTC auxiliary
loss on the encoder's projection, an optional frozen shared encoder taken
from an RNN-T bundle (eval mode, no gradients, BatchNorm on its running
statistics), scheduled sampling with the probability as an argument of the
step, and decoder-only LM pretraining.  Reversed labels (the backward
rescorer) come from the loader.

The CTC loss is ``F.ctc_loss``, which gives ``inf`` where a label sequence
cannot fit its frames; the JAX package's ``optax.ctc_loss`` gives a large
finite value there instead (its ``log_epsilon``).  The two agree wherever
the labels fit.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from pika_tpu_torch.models.las import LAS
from pika_tpu_torch.models.transducer import Transducer
from pika_tpu_torch.train.lr import Optimizer
from pika_tpu_torch.train.step import batch_inputs


def las_loss(model: LAS, src, src_lens, targets, dec_loss_scale: float = 1.0,
             enc_loss_scale: float = 0.0, pretrain_decoder: bool = False,
             sampling_prob: float = 0.0, generator: Optional[torch.Generator] = None):
    """Returns (loss, metrics) for targets (B, U) with SOS and EOS, padded
    with ``pad_idx``; the model runs in its own mode.  The NLL is summed over
    the non-pad targets.  With ``enc_loss_scale > 0`` the CTC loss of the
    encoder's projection is added on the targets' ids in (1, pad_idx),
    moved to the front in order (blank 0, summed)."""
    cfg = model.config
    outputs, _, enc_out = model(src, targets, src_lens, enable_enc=not pretrain_decoder,
                                sampling_prob=sampling_prob, generator=generator)
    lp = torch.log_softmax(model.output_logits(outputs), dim=-1)
    tgt_out = targets[:, 1:].long()
    mask = tgt_out != cfg.pad_idx
    tok_lp = lp.gather(-1, tgt_out.clamp(0, cfg.output_dim - 1)[..., None])[..., 0]
    nll = -torch.where(mask, tok_lp, 0.0).sum()
    loss = dec_loss_scale * nll
    metrics = {"dec_loss": nll.detach(), "num_labels": mask.sum()}
    if enc_loss_scale > 0.0 and not pretrain_decoder:
        enc_lp = torch.log_softmax(model.encoder_logits(enc_out).float(), dim=-1)
        ctc_ok = (tgt_out > 1) & (tgt_out < cfg.pad_idx)
        order = torch.argsort((~ctc_ok).to(torch.uint8), dim=1, stable=True)
        packed = torch.where(ctc_ok, tgt_out, 0).gather(1, order)
        ctc = F.ctc_loss(enc_lp.transpose(0, 1), packed, src_lens.long(), ctc_ok.sum(1),
                         blank=0, reduction="sum")
        loss = loss + enc_loss_scale * ctc
        metrics["enc_loss"] = ctc.detach()
    return loss, metrics


def make_las_train_step(model: LAS, optimizer: Optimizer, featurizer: Callable,
                        shared_encoder: Optional[Transducer] = None,
                        dec_loss_scale: float = 1.0, enc_loss_scale: float = 0.0,
                        pretrain_decoder: bool = False) -> Callable:
    """Build ``step(batch, generator, sampling_prob=0.0) -> {"loss",
    "dec_loss", "num_labels"[, "enc_loss"]}`` over a batch dict of ``wavs``
    and ``wav_lens`` (or ``feats`` and ``feat_lens``) and ``labels`` (the
    loader's SOS ... EOS targets).

    One step runs the training featurizer (dither, SpecAugment), the frozen
    shared encoder when given (its output is the LAS input), the LAS in
    train mode and one optimizer update.  Every random draw comes from
    ``generator``; the model's mode is restored on return."""

    def step(batch, generator: torch.Generator, sampling_prob: float = 0.0):
        was_training = model.training
        model.train()
        try:
            feats, feat_lens = featurizer(*batch_inputs(batch), generator)
            if shared_encoder is not None:
                shared_encoder.eval()
                with torch.no_grad():
                    src = shared_encoder.encode(feats, feat_lens)
                src_lens = shared_encoder.encoder_out_len(feat_lens)
            else:
                src, src_lens = feats, feat_lens
            optimizer.zero_grad()
            loss, metrics = las_loss(model, src, src_lens, batch["labels"], dec_loss_scale,
                                     enc_loss_scale, pretrain_decoder, sampling_prob, generator)
            loss.backward()
            optimizer.step()
        finally:
            model.train(was_training)
        metrics["loss"] = loss.detach()
        return metrics

    return step
