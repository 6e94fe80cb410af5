"""On-the-fly augmentation loader, host side (the port's own copy of
``pika_tpu/data/loader.py``).

Worker threads read raw PCM from mrk/seq archives and labels from text
arks, apply speed perturbation and gain normalization (and, when asked,
noise at an SNR and an RIR) in numpy, then emit fixed-shape padded batches
of raw waveforms.  Dither, fbank, splice, stride, CMVN and SpecAugment run
on the device inside the train step (``train/step.py``).

Waveform and label lengths are padded up to a small ladder of bucket sizes,
so a run sees few distinct shapes.

Batch dict fields: wavs (B, S) float32 in int16 scale, wav_lens (B,),
labels (B, U) int32, label_lens (B,), uttids (list).
"""

from __future__ import annotations

import dataclasses
import queue
import random
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from pika_tpu_torch.data import segment as seg
from pika_tpu_torch.data.archive import MrkSeqReader
from pika_tpu_torch.data.scp import iter_int_vectors, read_data_lst


@dataclasses.dataclass(frozen=True)
class OtfLoaderConfig:
    batch_size: int = 8
    sample_rate: int = 16000
    frame_length: int = 400          # fbank frame geometry, for length math
    frame_shift: int = 160
    stride: int = 1                  # loader-side frame subsampling factor
    max_len: int = 6000              # max frames allowed (reference --max_len)
    tu_limit: int = 15000            # T*U/3 cap (reference --TU_limit)
    speed_rates: Sequence[float] = (0.9, 1.0, 1.1)
    gain_range: Tuple[float, float] = (55.0, 10.0)  # negative dB targets
    snr_range: Optional[Tuple[float, float]] = None
    noise_prob: float = 1.0          # fraction of utterances that get noise mixed in
    num_workers: int = 2
    queue_size: int = 8
    reverse_labels: bool = False
    sos: int = -1
    eos: int = -1
    pad_label: int = 0
    seed: int = 777
    # bucket ladders (samples / labels); batches pad to the smallest fit
    wav_buckets: Sequence[int] = (16000 * 4, 16000 * 8, 16000 * 12, 16000 * 18)
    label_buckets: Sequence[int] = (16, 32, 64, 128)
    augment: bool = True


def _n_frames(samples: int, cfg: OtfLoaderConfig) -> int:
    return max(0, 1 + (samples - cfg.frame_length) // cfg.frame_shift)


def _bucket(value: int, ladder: Sequence[int]) -> Optional[int]:
    for b in ladder:
        if value <= b:
            return b
    return None


def _augment(pcm: np.ndarray, cfg: OtfLoaderConfig, rng: np.random.Generator,
             noise: Optional[List[np.ndarray]] = None,
             rir: Optional[List[np.ndarray]] = None) -> np.ndarray:
    """Speed + gain (+ optional noise and RIR) perturbation, returning
    int16-scale float32: the JAX loader's chain, in numpy (the JAX
    package's native library computes the same numbers,
    ``tests/test_native.py``)."""
    x = seg.to_float32(pcm)
    if cfg.augment:
        rate = cfg.speed_rates[int(rng.integers(0, len(cfg.speed_rates)))]
        x = seg.change_speed(x, rate)
        gain_lo, gain_hi = -cfg.gain_range[0], -cfg.gain_range[1]
        x = seg.normalize(x, float(rng.uniform(gain_lo, gain_hi)))
        if (cfg.snr_range is not None and noise
                and float(rng.uniform()) < cfg.noise_prob):
            snr = float(rng.uniform(*cfg.snr_range))
            n = noise[int(rng.integers(0, len(noise)))]
            if n.shape[0] >= x.shape[0]:
                x = seg.add_noise(x, cfg.sample_rate, n, snr,
                                  rng=random.Random(int(rng.integers(1 << 30))))
        if rir:
            # RIR convolution keeping the average power
            x = seg.convolve_and_normalize(x, rir[int(rng.integers(0, len(rir)))])
    # round-trip through int16, as the features are computed from int16 audio
    return seg.from_float32(x, "int16").astype(np.float32)


def _utt_generator(triplets, cfg: OtfLoaderConfig, rng: np.random.Generator,
                   noise=None, rir=None) -> Iterator[Tuple[str, np.ndarray, np.ndarray]]:
    for mrk_fn, seq_fn, ali_rspec in triplets:
        labels = dict(iter_int_vectors(ali_rspec))
        with MrkSeqReader(mrk_fn, seq_fn) as reader:
            for uttid, pcm in reader:
                if uttid not in labels:
                    raise ValueError(f"utt {uttid} missing from labels {ali_rspec}")
                ali = labels[uttid]
                if cfg.reverse_labels:
                    ali = ali[::-1]
                if cfg.sos >= 0:
                    ali = np.concatenate(([cfg.sos], ali)).astype(np.int32)
                if cfg.eos >= 0:
                    ali = np.concatenate((ali, [cfg.eos])).astype(np.int32)
                wav = _augment(pcm, cfg, rng, noise, rir)
                yield uttid, wav, ali


def _batch_generator(triplets, cfg: OtfLoaderConfig, rng, noise=None, rir=None):
    buf: List[Tuple[str, np.ndarray, np.ndarray]] = []
    count = 0

    def flush(items):
        if not items:
            return None
        max_s = max(len(w) for _, w, _ in items)
        max_u = max(len(a) for _, _, a in items)
        sb = _bucket(max_s, cfg.wav_buckets) or max_s
        ub = _bucket(max_u, cfg.label_buckets) or max_u
        b = len(items)
        wavs = np.zeros((b, sb), np.float32)
        wav_lens = np.zeros(b, np.int32)
        labels = np.full((b, ub), cfg.pad_label, np.int32)
        label_lens = np.zeros(b, np.int32)
        uttids = []
        for i, (uttid, w, a) in enumerate(items):
            wavs[i, : len(w)] = w
            wav_lens[i] = len(w)
            labels[i, : len(a)] = a
            label_lens[i] = len(a)
            uttids.append(uttid)
        return {
            "wavs": wavs, "wav_lens": wav_lens,
            "labels": labels, "label_lens": label_lens, "uttids": uttids,
        }

    for uttid, wav, ali in _utt_generator(triplets, cfg, rng, noise, rir):
        count += 1
        frames = _n_frames(len(wav), cfg)
        utt_len = -(-frames // cfg.stride)
        frames_ok = 0 < utt_len and frames <= cfg.max_len
        tu_ok = len(ali) * utt_len // 3 <= cfg.tu_limit
        fits = _bucket(len(wav), cfg.wav_buckets) is not None and _bucket(len(ali), cfg.label_buckets) is not None
        if frames_ok and tu_ok and fits and len(ali) > 0:
            buf.append((uttid, wav, ali))
        # flush on the ACCEPTED count: filtered utterances top up from the
        # stream instead of shrinking the batch, so every batch but the
        # tail is full
        if len(buf) == cfg.batch_size:
            out = flush(buf)
            buf = []
            if out is not None:
                yield out
    out = flush(buf)
    if out is not None:
        yield out


def prefetch_iter(iterator: Iterator, transform=None, size: int = 3) -> Iterator:
    """Decouple a host-side batch producer from the device loop.

    Pulls from ``iterator`` in a background thread, applying ``transform``
    there (the training CLI stacks and pins a batch; all CUDA work stays on
    the consumer's thread), keeping up to ``size`` ready items buffered.
    Producer exceptions re-raise in the consumer.
    """
    q: "queue.Queue" = queue.Queue(size)
    end = object()

    class _Err:
        def __init__(self, exc):
            self.exc = exc

    def producer():
        try:
            for item in iterator:
                q.put(transform(item) if transform is not None else item)
            q.put(end)
        except BaseException as exc:  # noqa: BLE001 — propagate to consumer
            q.put(_Err(exc))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is end:
            break
        if isinstance(item, _Err):
            raise RuntimeError("prefetch producer failed") from item.exc
        yield item
    t.join()


def dataloader(data_lst: str, cfg: OtfLoaderConfig, noise=None, rir=None) -> Iterator[dict]:
    """Threaded batch stream over a data .lst of mrk/seq/label triplets:
    ``cfg.num_workers`` threads, each over its share of the triplets with
    its own generator (``cfg.seed + worker``), feeding a bounded queue.
    With more than one worker the batch order depends on the threads'
    interleaving."""
    triplets = read_data_lst(data_lst)
    n_workers = max(1, min(cfg.num_workers, len(triplets)))
    shards = [triplets[i::n_workers] for i in range(n_workers)]
    q: "queue.Queue" = queue.Queue(cfg.queue_size)

    class _WorkerError:
        def __init__(self, idx: int, exc: BaseException):
            self.idx = idx
            self.exc = exc

    def worker(idx: int):
        rng = np.random.default_rng(cfg.seed + idx)
        try:
            for batch in _batch_generator(shards[idx], cfg, rng, noise, rir):
                q.put(batch)
            q.put(None)
        except BaseException as exc:  # noqa: BLE001 — propagate to consumer
            # a worker that dies (corrupt shard, missing label) fails the
            # training loop instead of silently shrinking the epoch
            q.put(_WorkerError(idx, exc))

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(n_workers)]
    for t in threads:
        t.start()
    done = 0
    while done < n_workers:
        item = q.get()
        if item is None:
            done += 1
            continue
        if isinstance(item, _WorkerError):
            raise RuntimeError(
                f"loader worker {item.idx} failed on shard of {data_lst}"
            ) from item.exc
        yield item
    for t in threads:
        t.join()
