"""Decoding: batched greedy search."""

from pika_tpu_torch.decode.greedy import greedy_decode, greedy_decode_waveforms
