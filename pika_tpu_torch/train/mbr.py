"""Minimum Bayes Risk (MBR) fine-tuning step for the RNN-T (port of
``pika_tpu/train/mbr.py``).

One step:

1. beam-decode the batch with the eval featurizer (no dither, no
   SpecAugment) and the model in eval mode, without gradients: the N-best
   label sequences, their scores and their full alignment paths
   (``decode/beam.py``, the CUDA-graphed loop on the card);
2. the expected edit distance: ``prob = softmax(scores)``, ``risk = sum
   prob * dist`` with ``dist`` from ``ops/edit_distance.py``;
3. the sequence-level gradient ``prob * (dist - E[dist])`` enters through a
   surrogate objective, the sum over path steps of ``w * log_softmax(
   sm_scale * joint(x_t, y_u))[token]`` with those weights held constant
   (blank steps scaled by 1 / the padded encoder length): its gradient is
   the reference's injected one;
4. plus ``rnnt_scale`` times the RNN-T loss on the reference labels through
   the fused loss (K1 forward, K2 and K3 backward), sharing one encoder
   forward in train mode.

The (t, u) lattice position of each path step is an exclusive cumulative
sum over the blank indicators of the recorded alignment.
"""

from __future__ import annotations

from typing import Callable

import torch

from pika_tpu_torch.decode.beam import BeamConfig, beam_search
from pika_tpu_torch.models.transducer import Transducer
from pika_tpu_torch.ops.edit_distance import edit_distance_batch
from pika_tpu_torch.ops.rnnt_loss import rnnt_loss_fused
from pika_tpu_torch.train.lr import Optimizer
from pika_tpu_torch.train.step import batch_inputs


def mbr_decode(model: Transducer, featurizer: Callable, beam_cfg: BeamConfig, x, x_lens,
               search: Callable = beam_search) -> dict:
    """The step's N-best: the eval featurizer (no dither, no SpecAugment)
    and the model in eval mode, without gradients, through ``search``
    (``beam_search``, or ``beam_search_eager`` to check it).  Leaves the
    model in eval mode."""
    model.eval()
    with torch.no_grad():
        feats, lens = featurizer(x, x_lens)
        enc = model.encode(feats, lens)
        return search(model, enc, model.encoder_out_len(lens), beam_cfg)


def mbr_risk(nbest: dict, labels, label_lens):
    """(prob, expected edit distance, sequence weights) of an N-best:
    ``prob = softmax(scores)`` over each utterance's K hypotheses, the
    edit distance of each to its reference (ids clipped at 0), and the
    constant weights ``prob * (dist - E[dist])``, (B, K), (B,), (B, K)."""
    b, k, um = nbest["tokens"].shape
    prob = torch.softmax(nbest["scores"].detach().float(), dim=1)
    dist = edit_distance_batch(labels.long().repeat_interleave(k, 0).clamp(min=0),
                               label_lens.repeat_interleave(k, 0),
                               nbest["tokens"].reshape(b * k, um).long().clamp(min=0),
                               nbest["lens"].reshape(b * k)).reshape(b, k).float()
    avg_dist = (prob * dist).sum(dim=1)
    return prob, avg_dist, prob * (dist - avg_dist[:, None])


def mbr_surrogate(model: Transducer, enc, nbest: dict, seq_grad, sm_scale: float,
                  generator=None, blank: int = 0):
    """The surrogate objective over encoder output ``enc`` (B, T', H) and
    the N-best's alignment paths: the sum over path steps of ``w *
    log_softmax(sm_scale * joint(x_t, y_u))[token]``, ``w`` the constant
    sequence weights ``seq_grad`` (B, K), blank steps scaled by 1 / T'
    (the padded length) and steps past ``align_lens`` by 0.  The
    prediction net runs in the model's mode on the hypotheses."""
    b, k, um = nbest["tokens"].shape
    t_pad, h = enc.shape[1], enc.shape[-1]
    hyps = nbest["tokens"].reshape(b * k, um).long()
    hyp_lens = nbest["lens"].reshape(b * k)
    aligns = nbest["aligns"].reshape(b * k, -1).long()               # (BK, S)
    align_lens = nbest["align_lens"].reshape(b * k)
    s_max = aligns.shape[1]
    is_blank = (aligns == blank).long()
    step_valid = torch.arange(s_max, device=aligns.device)[None, :] < align_lens[:, None]
    t_idx = is_blank.cumsum(1) - is_blank                             # exclusive cumsums
    u_idx = (1 - is_blank).cumsum(1) - (1 - is_blank)
    dec_hyp = model.predict(hyps * (hyps >= 0), hyp_lens, generator=generator)  # (BK, Um+1, H)
    x_path = enc.repeat_interleave(k, 0).gather(
        1, t_idx.clamp(0, t_pad - 1)[..., None].expand(-1, -1, h))
    y_path = dec_hyp.gather(1, u_idx.clamp(0, dec_hyp.shape[1] - 1)[..., None].expand(-1, -1, h))
    lp = torch.log_softmax(sm_scale * model.joint_step(x_path, y_path).float(), dim=-1)
    tok_lp = lp.gather(-1, aligns.clamp(min=0)[..., None])[..., 0]   # (BK, S)
    w = seq_grad.reshape(b * k, 1).expand(b * k, s_max)
    # blank steps scale by the padded encoder length, as the reference's
    # `mbr_grad[:, :, blk] /= float(T)` with T = x.size(1)
    w = torch.where(is_blank.bool(), w / float(t_pad), w)
    w = torch.where(step_valid, w, 0.0)
    return (w * tok_lp).sum()


def mbr_losses(model: Transducer, feats, feat_lens, labels, label_lens, nbest: dict,
               rnnt_scale: float, sm_scale: float, loss_chunk: int = 16,
               loss_backend: str = "auto", generator=None, blank: int = 0, risk=None):
    """Returns (total objective, metrics) for one batch given its decoded
    N-best (``beam_search``'s dict), differentiable with respect to the
    model's parameters.  The model runs in its own mode (train: batch
    statistics, running statistics updated, dropout from ``generator``).
    ``risk`` is ``mbr_risk``'s result when the caller has it already."""
    enc = model.encode(feats, feat_lens, generator=generator)
    enc_lens = model.encoder_out_len(feat_lens)

    # RNN-T loss on the reference labels
    dec_ref = model.predict(labels, label_lens, generator=generator)
    ax, gx, ay, gy = (x.float().contiguous() for x in model.joint_factors(enc, dec_ref))
    w2, b2 = (x.float().contiguous() for x in model.joint_params())
    rnnt = rnnt_loss_fused(ax, gx, ay, gy, w2, b2, labels, enc_lens, label_lens, loss_chunk,
                           loss_backend).sum()

    # expected edit distance and the constant sequence weights
    _, avg_dist, seq_grad = mbr_risk(nbest, labels, label_lens) if risk is None else risk
    surrogate = mbr_surrogate(model, enc, nbest, seq_grad, sm_scale, generator, blank)

    total = rnnt_scale * rnnt + surrogate
    metrics = {"mbr_loss": avg_dist.sum(), "rnnt_loss": rnnt.detach(),
               "num_labels": label_lens.sum()}
    return total, metrics


def make_mbr_step(model: Transducer, optimizer: Optimizer, featurizer: Callable,
                  beam_cfg: BeamConfig, rnnt_scale: float = 0.0, sm_scale: float = 1.0,
                  loss_chunk: int = 16, loss_backend: str = "auto") -> Callable:
    """Build ``step(batch, generator, stage=None) -> {"mbr_loss",
    "rnnt_loss", "num_labels", "loss"}`` over a batch dict of ``wavs`` and
    ``wav_lens`` (or ``feats`` and ``feat_lens``), ``labels`` and
    ``label_lens``.

    The decode (``mbr_decode``) runs the eval featurizer and the model in
    eval mode; the loss forward the training featurizer (dither,
    SpecAugment) and the model in train mode, so the BatchNorm running
    statistics move once per step.  Then one optimizer update.  Every
    random draw comes from ``generator``; the model's mode is restored on
    return.  ``stage(name)``, when given, is called after each of "decode",
    "edit distance", "loss forward + backward" and "optimizer" (to time
    them)."""

    def step(batch, generator: torch.Generator, stage: Callable = None):
        stage = stage or (lambda name: None)
        was_training = model.training
        x, x_lens = batch_inputs(batch)
        labels, label_lens = batch["labels"], batch["label_lens"]
        try:
            nbest = mbr_decode(model, featurizer, beam_cfg, x, x_lens)
            stage("decode")
            risk = mbr_risk(nbest, labels, label_lens)
            stage("edit distance")
            model.train()
            feats, feat_lens = featurizer(x, x_lens, generator)
            optimizer.zero_grad()
            total, metrics = mbr_losses(model, feats, feat_lens, labels, label_lens, nbest,
                                        rnnt_scale, sm_scale, loss_chunk, loss_backend,
                                        generator, beam_cfg.blank, risk)
            total.backward()
            stage("loss forward + backward")
            optimizer.step()
            stage("optimizer")
        finally:
            model.train(was_training)
        metrics["loss"] = total.detach()
        return metrics

    return step
