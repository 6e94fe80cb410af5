"""Featurizer and eval step: waveforms -> features -> model -> RNN-T loss
(port of the eval path of ``pika_tpu/train/step.py``).

The training step, SpecAugment and the optimizer are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from pika_tpu_torch.features.fbank import FbankConfig, make_fbank_fn
from pika_tpu_torch.features.pipeline import apply_cmvn, splice, stride_subsample, strided_len
from pika_tpu_torch.models.transducer import Transducer
from pika_tpu_torch.ops.rnnt_loss import rnnt_loss_forward


@dataclasses.dataclass(frozen=True)
class FeaturizerConfig:
    fbank: FbankConfig
    max_samples: int
    lctx: int = 0
    rctx: int = 0
    stride: int = 1
    cmn: bool = False


def make_featurizer(cfg: FeaturizerConfig, cmvn_offset: Optional[torch.Tensor] = None,
                    cmvn_scale: Optional[torch.Tensor] = None, device=None) -> Callable:
    """Build the eval featurizer ``featurize(wavs, wav_lens) -> (feats, feat_lens)``.

    ``wavs`` are (B, max_samples) int16 or float32 in int16 scale.  The
    features are spliced, strided and normalized, ready for the encoder.
    No dither (that is the training featurizer's).
    """
    fbank = make_fbank_fn(cfg.fbank, cfg.max_samples, device=device)

    def featurize(wavs, wav_lens):
        feats, frame_lens = fbank(wavs.float(), wav_lens)
        feats = stride_subsample(splice(feats, cfg.lctx, cfg.rctx, frame_lens=frame_lens),
                                 cfg.stride)
        feat_lens = strided_len(frame_lens, cfg.stride)
        if cmvn_offset is not None:
            feats = apply_cmvn(feats, cmvn_offset, cmvn_scale, cmn=cfg.cmn)
        return feats, feat_lens

    return featurize


def transducer_loss(model: Transducer, feats, feat_lens, labels, label_lens,
                    loss_chunk: int = 32, loss_backend: str = "auto") -> torch.Tensor:
    """Summed RNN-T loss of a batch through the fused joint (eval mode).
    ``loss_backend`` is that of ``rnnt_loss_forward``."""
    enc_lens = model.encoder_out_len(feat_lens)
    enc = model.encode(feats, feat_lens)
    dec = model.predict(labels, label_lens)
    ax, gx, ay, gy = (x.float().contiguous() for x in model.joint_factors(enc, dec))
    w2, b2 = (x.float().contiguous() for x in model.joint_params())
    losses = rnnt_loss_forward(ax, gx, ay, gy, w2, b2, labels, enc_lens, label_lens,
                               loss_chunk, loss_backend)
    return losses.sum()


def make_eval_step(model: Transducer, featurizer: Callable, loss_chunk: int = 32,
                   loss_backend: str = "auto") -> Callable:
    """Build ``step(batch) -> {"loss", "num_labels"}`` over a batch dict of
    ``wavs``, ``wav_lens``, ``labels`` and ``label_lens``."""

    @torch.inference_mode()
    def step(batch):
        feats, feat_lens = featurizer(batch["wavs"], batch["wav_lens"])
        loss = transducer_loss(model, feats, feat_lens, batch["labels"], batch["label_lens"],
                               loss_chunk, loss_backend)
        return {"loss": loss, "num_labels": batch["label_lens"].sum()}

    return step
