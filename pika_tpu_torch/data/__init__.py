"""Host-side data layer: WAV I/O, Kaldi-layout text parsers, mrk/seq
archives, the augmentation DSP, CMVN statistics, length-grouped lists and
the training loaders (numpy; no JAX, no Kaldi)."""

from pika_tpu_torch.data.archive import (
    MrkSeqReader,
    MrkSeqWriter,
    wav_scp_to_bytes,
    wav_scp_to_mrk_seq,
)
from pika_tpu_torch.data.cmvn import CmvnStats, offset_scale, read_kaldi_matrix, write_kaldi_matrix
from pika_tpu_torch.data.lists import shuffle_by_length, split_by_length
from pika_tpu_torch.data.scp import (
    iter_int_vectors,
    read_data_lst,
    read_int_vectors,
    read_symbol_table,
    read_wav_scp,
    write_int_vectors,
)
from pika_tpu_torch.data.segment import from_float32, to_float32
from pika_tpu_torch.data.wavio import read_wav, write_wav
