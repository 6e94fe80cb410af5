"""Featurizers, train step and eval step: waveforms (or precomputed
features) -> features -> model -> RNN-T loss (port of
``pika_tpu/train/step.py``).

The train step runs the loss through K1 forward and K2/K3 backward
(``ops/rnnt_loss.py:rnnt_loss_fused``), or with ``pruned_range > 0`` the
pruned objective (``ops/rnnt_pruned.py``, plain PyTorch as in the JAX
package), then the optimizer of ``train/lr.py``.  The eval step always
takes the full fused loss (K1).  Every random draw of a step (dither, SpecAugment, dropout)
comes from the one ``torch.Generator`` passed to it, so two runs from the
same seed draw the same numbers.

``compute_dtype=torch.bfloat16`` is the JAX step's mixed precision, not
``torch.autocast``: the model runs on bf16 casts of the float32 master
parameters with bf16 activations throughout (LayerNorm, BatchNorm and
softmax take bf16 inputs and give bf16 outputs, computing inside in
float32 as flax does); the gradients reach the masters through the casts;
the joint's factors go back to float32 before the loss, so K1-K3 see the
inputs they see at float32; the BatchNorm statistics are updated in
float32.
Not ported: the scanned multi-step (``--steps_per_dispatch``), which only
groups the JAX package's steps into one XLA dispatch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn
from torch.func import functional_call

from pika_tpu_torch.features.fbank import FbankConfig, make_fbank_fn
from pika_tpu_torch.features.pipeline import (
    apply_cmvn,
    spec_augment,
    splice,
    stride_subsample,
    strided_len,
)
from pika_tpu_torch.models.transducer import Transducer
from pika_tpu_torch.ops.rnnt_loss import rnnt_loss_fused
from pika_tpu_torch.ops.rnnt_pruned import prune_ranges, rnnt_loss_pruned, rnnt_loss_simple
from pika_tpu_torch.train.lr import Optimizer


@dataclasses.dataclass(frozen=True)
class FeaturizerConfig:
    fbank: FbankConfig
    max_samples: int
    lctx: int = 0
    rctx: int = 0
    stride: int = 1
    cmn: bool = False
    spec_augment: bool = False
    max_freq_span: int = 15
    max_time_span: int = 35


def make_featurizer(cfg: FeaturizerConfig, cmvn_offset: Optional[torch.Tensor] = None,
                    cmvn_scale: Optional[torch.Tensor] = None, device=None) -> Callable:
    """Build ``featurize(wavs, wav_lens, generator=None) -> (feats, feat_lens)``
    on ``device`` (the CUDA card unless the caller names another, e.g.
    ``"cpu"``).

    ``wavs`` are (B, max_samples) int16 or float32 in int16 scale.  The
    features are spliced, strided and normalized, ready for the encoder.
    Without a generator it is the eval featurizer (no dither, no
    SpecAugment); with one it is the training featurizer: dither drawn from
    the generator, then SpecAugment if ``cfg.spec_augment``.
    """
    fbank = make_fbank_fn(cfg.fbank, cfg.max_samples, device=device)

    def featurize(wavs, wav_lens, generator: Optional[torch.Generator] = None):
        feats, frame_lens = fbank(wavs.float(), wav_lens, generator=generator)
        feats = stride_subsample(splice(feats, cfg.lctx, cfg.rctx, frame_lens=frame_lens),
                                 cfg.stride)
        feat_lens = strided_len(frame_lens, cfg.stride)
        if cmvn_offset is not None:
            feats = apply_cmvn(feats, cmvn_offset, cmvn_scale, cmn=cfg.cmn)
        if cfg.spec_augment and generator is not None:
            feats = spec_augment(feats, cfg.max_freq_span, cfg.max_time_span, generator)
        return feats, feat_lens

    return featurize


def make_feats_featurizer(cmvn_offset: Optional[torch.Tensor] = None,
                          cmvn_scale: Optional[torch.Tensor] = None, cmn: bool = False,
                          use_spec_augment: bool = False, max_freq_span: int = 15,
                          max_time_span: int = 35) -> Callable:
    """Featurizer over precomputed features (``--loader utt``): the loader
    has spliced and strided them on the host, so only CMVN and, with a
    generator, SpecAugment remain.  Same signature as ``make_featurizer``'s
    result: ``featurize(feats, feat_lens, generator=None)``."""

    def featurize(feats, feat_lens, generator: Optional[torch.Generator] = None):
        feats = feats.float()
        if cmvn_offset is not None:
            feats = apply_cmvn(feats, cmvn_offset, cmvn_scale, cmn=cmn)
        if use_spec_augment and generator is not None:
            feats = spec_augment(feats, max_freq_span, max_time_span, generator)
        return feats, feat_lens

    return featurize


def batch_inputs(batch):
    """The step's input pair: raw waveforms (``--loader otf``) or
    precomputed features (``--loader utt``)."""
    if "wavs" in batch:
        return batch["wavs"], batch["wav_lens"]
    return batch["feats"], batch["feat_lens"]


def transducer_loss(model: Transducer, feats, feat_lens, labels, label_lens,
                    loss_chunk: int = 32, loss_backend: str = "auto",
                    generator: Optional[torch.Generator] = None, pruned_range: int = 0,
                    simple_scale: float = 0.5, pruned_scale: float = 1.0) -> torch.Tensor:
    """Summed RNN-T loss of a batch through the fused joint, in the model's
    mode (train: batch statistics and dropout from ``generator``), with
    autograd unless the caller turned it off.  The joint's factors enter the
    loss in float32 whatever the model's dtype.  ``loss_backend`` is that
    of ``rnnt_loss_fused``.

    ``pruned_range > 0`` takes the pruned objective instead (a model with
    ``simple_joint``): ``pruned_scale`` times the full gated joint's loss on
    a band of ``pruned_range`` label positions a frame, picked by the simple
    joint, plus ``simple_scale`` times the simple joint's loss, over T-chunks
    of ``max(loss_chunk, 64)`` frames.  ``pruned_scale < 1`` is the
    trainers' warmup (0.1 for the first ``--pruned_warmup_epochs``): a
    cold simple joint picks noise bands, which the pruned term would lock
    in."""
    enc_lens = model.encoder_out_len(feat_lens)
    enc = model.encode(feats, feat_lens, generator=generator)
    dec = model.predict(labels, label_lens, generator=generator)
    ax, gx, ay, gy = (x.float().contiguous() for x in model.joint_factors(enc, dec))
    w2, b2 = (x.float().contiguous() for x in model.joint_params())
    if pruned_range > 0:
        am, lm = (x.float() for x in model.simple_factors(enc, dec))
        simple, (blank_lp, emit_lp) = rnnt_loss_simple(am, lm, labels, enc_lens, label_lens)
        s_begin = prune_ranges(blank_lp, emit_lp, enc_lens, label_lens, pruned_range)
        pruned = rnnt_loss_pruned(ax, gx, ay, gy, w2, b2, labels, enc_lens, label_lens, s_begin,
                                  pruned_range, chunk=max(loss_chunk, 64))
        return pruned_scale * pruned.sum() + simple_scale * simple.sum()
    losses = rnnt_loss_fused(ax, gx, ay, gy, w2, b2, labels, enc_lens, label_lens,
                             loss_chunk, loss_backend)
    return losses.sum()


class _LossAndBackward(nn.Module):
    """The loss and its backward as one module call, so that
    ``functional_call`` keeps the bf16 casts in place through the backward
    too (where ``remat`` recomputes layers from them)."""

    def __init__(self, model: Transducer):
        super().__init__()
        self.model = model

    def forward(self, *args):
        loss = transducer_loss(self.model, *args)
        loss.backward()
        return loss.detach()


def loss_and_backward_cast(model: Transducer, dtype: torch.dtype, feats, *args) -> torch.Tensor:
    """``transducer_loss`` and its backward with the model on ``dtype``
    casts of its parameters (features cast too): the gradients land in the
    float32 parameters' ``.grad``; the BatchNorm buffers are the model's
    own, updated in float32."""
    cast = {f"model.{n}": p.to(dtype) for n, p in model.named_parameters()}
    return functional_call(_LossAndBackward(model), cast, (feats.to(dtype), *args))


def make_train_step(model: Transducer, optimizer: Optimizer, featurizer: Callable,
                    loss_chunk: int = 32, loss_backend: str = "auto",
                    compute_dtype: Optional[torch.dtype] = None, pruned_range: int = 0,
                    simple_scale: float = 0.5, pruned_scale: float = 1.0) -> Callable:
    """Build ``step(batch, generator) -> {"loss", "num_labels", "num_frames"}``
    over a batch dict of ``wavs`` and ``wav_lens`` (or ``feats`` and
    ``feat_lens`` with a ``make_feats_featurizer``), ``labels`` and
    ``label_lens``.

    One step runs the featurizer with dither and SpecAugment, the model in
    train mode, the summed loss and its backward, and one optimizer update.
    It updates the model's parameters and its BatchNorm running statistics
    in place (and restores the model's train/eval mode on return).  Every
    random draw comes from ``generator``.  ``loss_backend="plain"`` takes
    the plain versions of K1, K2 and K3 even on CUDA tensors.
    ``compute_dtype=torch.bfloat16`` runs the model in bf16 over float32
    masters (module docstring).  ``pruned_range``, ``simple_scale`` and
    ``pruned_scale`` select the pruned objective (``transducer_loss``).
    """

    def step(batch, generator: torch.Generator):
        was_training = model.training
        model.train()
        try:
            feats, feat_lens = featurizer(*batch_inputs(batch), generator)
            args = (feat_lens, batch["labels"], batch["label_lens"], loss_chunk, loss_backend,
                    generator, pruned_range, simple_scale, pruned_scale)
            optimizer.zero_grad()
            if compute_dtype is None or compute_dtype == torch.float32:
                loss = transducer_loss(model, feats, *args)
                loss.backward()
            else:
                loss = loss_and_backward_cast(model, compute_dtype, feats, *args)
            optimizer.step()
        finally:
            model.train(was_training)
        return {"loss": loss.detach(), "num_labels": batch["label_lens"].sum(),
                "num_frames": feat_lens.sum()}

    return step


def make_eval_step(model: Transducer, featurizer: Callable, loss_chunk: int = 32,
                   loss_backend: str = "auto") -> Callable:
    """Build ``step(batch) -> {"loss", "num_labels"}`` over a batch dict of
    ``wavs`` and ``wav_lens`` (or ``feats`` and ``feat_lens``), ``labels``
    and ``label_lens``; the model runs in eval mode (restored on return)."""

    @torch.inference_mode()
    def step(batch):
        was_training = model.training
        model.eval()
        try:
            feats, feat_lens = featurizer(*batch_inputs(batch))
            loss = transducer_loss(model, feats, feat_lens, batch["labels"],
                                   batch["label_lens"], loss_chunk, loss_backend)
        finally:
            model.train(was_training)
        return {"loss": loss, "num_labels": batch["label_lens"].sum()}

    return step
