"""Decoding: batched greedy and beam search, N-best reranking and WER
scoring."""

from pika_tpu_torch.decode.beam import (
    BeamConfig,
    beam_search,
    beam_search_eager,
    beam_search_features,
    beam_search_waveforms,
)
from pika_tpu_torch.decode.greedy import (
    greedy_decode,
    greedy_decode_eager,
    greedy_decode_waveforms,
)
from pika_tpu_torch.decode.rescore import rerank_nbest
from pika_tpu_torch.decode.wer import edit_distance, edit_distance_batch, score_wer
