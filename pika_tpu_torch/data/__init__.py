"""Host-side data the decode CLI reads: WAV I/O, Kaldi-layout text parsers,
sample-format conversion and CMVN statistics (numpy; no JAX, no Kaldi)."""

from pika_tpu_torch.data.cmvn import CmvnStats, offset_scale
from pika_tpu_torch.data.scp import read_int_vectors, read_symbol_table, read_wav_scp
from pika_tpu_torch.data.segment import from_float32, to_float32
from pika_tpu_torch.data.wavio import read_wav, write_wav
