"""Precomputed-feature loader, the ``--loader utt`` path (the port's own
copy of ``pika_tpu/data/feats_loader.py``, numpy).

Reads feature archives (``feats.scp``/``.ark``, ``data/kaldi_ark.py``) and
text int-vector labels, splices and strides in the feature domain on the
host, and yields padded batches; an optional shuffle buffer reorders the
utterances.  ``ctc=True`` also emits the flattened targets.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np

from pika_tpu_torch.data.kaldi_ark import iter_matrices_scp, iter_matrix_ark
from pika_tpu_torch.data.scp import iter_int_vectors


def splice_numpy(feats: np.ndarray, lctx: int, rctx: int) -> np.ndarray:
    """Edge-replicating frame splicing (loader/otf_utt_loader.py:28-46)."""
    length, dim = feats.shape
    padding = np.zeros((length + lctx + rctx, dim), dtype=np.float32)
    padding[:lctx] = feats[0]
    padding[lctx : lctx + length] = feats
    padding[lctx + length :] = feats[-1]
    spliced = np.zeros((length, dim * (lctx + 1 + rctx)), dtype=np.float32)
    for i in range(lctx + 1 + rctx):
        spliced[:, i * dim : (i + 1) * dim] = padding[i : i + length, :]
    return spliced


@dataclasses.dataclass(frozen=True)
class FeatsLoaderConfig:
    batch_size: int = 8
    lctx: int = 0
    rctx: int = 0
    stride: int = 1
    max_len: int = 6000
    reverse_labels: bool = False
    sos: int = -1
    eos: int = -1
    pad_label: int = 0
    ctc: bool = False
    frame_buckets: Sequence[int] = (256, 512, 1024, 2048)
    label_buckets: Sequence[int] = (16, 32, 64, 128)
    # Buffered shuffle for training (the reference utt loader's
    # --buffer_size, loader/utt_loader.py:26-27): 0 = sequential order.
    shuffle_buffer: int = 0
    seed: int = 0


def _bucket(value, ladder):
    for b in ladder:
        if value <= b:
            return b
    return None


def _shuffled(it, buffer_size: int, seed: int):
    """Buffered shuffle: keep ``buffer_size`` items; emit a random one as
    each new item arrives (reference utt loader --buffer_size semantics)."""
    rng = np.random.RandomState(seed)
    buf = []
    for item in it:
        buf.append(item)
        if len(buf) >= buffer_size:
            j = rng.randint(len(buf))
            buf[j], buf[-1] = buf[-1], buf[j]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def feats_dataloader(
    feats_rspec: str,
    labels_rspec: Optional[str],
    cfg: FeatsLoaderConfig,
) -> Iterator[dict]:
    """Batches from a feats.scp (or .ark) and optional label ark.

    Yields dict(feats (B, T, D*(ctx)), feat_lens, labels, label_lens,
    uttids); with ``cfg.ctc`` also flat_labels (sum of label lens)."""
    if feats_rspec.endswith(".scp") or feats_rspec.startswith("scp:"):
        feat_iter = iter_matrices_scp(feats_rspec.split(":", 1)[-1])
    else:
        feat_iter = iter_matrix_ark(feats_rspec.split(":", 1)[-1])
    labels = dict(iter_int_vectors(labels_rspec)) if labels_rspec else None

    buf = []

    def flush(items):
        if not items:
            return None
        max_t = max(f.shape[0] for _, f, _ in items)
        max_u = max(len(a) for _, _, a in items)
        tb = _bucket(max_t, cfg.frame_buckets) or max_t
        ub = _bucket(max_u, cfg.label_buckets) or max(max_u, 1)
        b = len(items)
        dim = items[0][1].shape[1]
        feats = np.zeros((b, tb, dim), np.float32)
        feat_lens = np.zeros(b, np.int32)
        labs = np.full((b, ub), cfg.pad_label, np.int32)
        lab_lens = np.zeros(b, np.int32)
        uttids = []
        for i, (uttid, f, a) in enumerate(items):
            feats[i, : f.shape[0]] = f
            # pad with the last frame like the reference (otf:272-274)
            if f.shape[0] < tb:
                feats[i, f.shape[0] :] = f[-1]
            feat_lens[i] = f.shape[0]
            labs[i, : len(a)] = a
            lab_lens[i] = len(a)
            uttids.append(uttid)
        out = {
            "feats": feats, "feat_lens": feat_lens,
            "labels": labs, "label_lens": lab_lens, "uttids": uttids,
        }
        if cfg.ctc:
            out["flat_labels"] = np.concatenate(
                [a for _, _, a in items] or [np.zeros(0, np.int32)]
            ).astype(np.int32)
        return out

    if cfg.shuffle_buffer > 0:
        feat_iter = _shuffled(feat_iter, cfg.shuffle_buffer, cfg.seed)

    for uttid, mat in feat_iter:
        ali = np.zeros(0, np.int32)
        if labels is not None:
            if uttid not in labels:
                raise ValueError(f"utt {uttid} missing from labels")
            ali = labels[uttid]
            if cfg.reverse_labels:
                ali = ali[::-1]
            if cfg.sos >= 0:
                ali = np.concatenate(([cfg.sos], ali)).astype(np.int32)
            if cfg.eos >= 0:
                ali = np.concatenate((ali, [cfg.eos])).astype(np.int32)
        spliced = splice_numpy(mat.astype(np.float32), cfg.lctx, cfg.rctx)[:: cfg.stride]
        if cfg.ctc and spliced.shape[0] < len(ali):
            continue  # CTC length constraint (utt_loader.py:107)
        if 0 < spliced.shape[0] <= cfg.max_len:
            buf.append((uttid, spliced, ali))
        if len(buf) == cfg.batch_size:
            out = flush(buf)
            buf = []
            if out is not None:
                yield out
    out = flush(buf)
    if out is not None:
        yield out
