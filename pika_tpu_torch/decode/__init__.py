"""Decoding: batched greedy and beam search with n-gram FST shallow fusion,
LAS rescoring, N-best reranking and WER scoring."""

from pika_tpu_torch.decode.beam import (
    BeamConfig,
    beam_search,
    beam_search_eager,
    beam_search_features,
    beam_search_waveforms,
)
from pika_tpu_torch.decode.fst import (
    FstTables,
    build_advance_cache,
    build_final_cache,
    compile_arpa,
    fst_advance_min_costs,
    fst_advance_min_costs_all,
    fst_advance_sets,
    fst_final_scores,
    init_state_sets,
    read_openfst_binary,
    read_text_fst,
    write_openfst_binary,
)
from pika_tpu_torch.decode.greedy import (
    greedy_decode,
    greedy_decode_eager,
    greedy_decode_waveforms,
)
from pika_tpu_torch.decode.rescore import las_score_hyps, rerank_nbest
from pika_tpu_torch.decode.wer import edit_distance, edit_distance_batch, score_wer
