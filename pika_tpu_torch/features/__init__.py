"""Feature extraction: Kaldi-semantics fbank, splice/stride and CMVN."""

from pika_tpu_torch.features.fbank import (
    FbankConfig,
    feature_window,
    make_fbank_fn,
    mel_banks_matrix,
)
from pika_tpu_torch.features.pipeline import apply_cmvn, splice, stride_subsample, strided_len
