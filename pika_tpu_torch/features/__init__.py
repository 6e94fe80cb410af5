"""Feature extraction: Kaldi-semantics fbank, splice/stride, CMVN and SpecAugment."""

from pika_tpu_torch.features.fbank import (
    FbankConfig,
    feature_window,
    make_fbank_fn,
    mel_banks_matrix,
)
from pika_tpu_torch.features.pipeline import (
    apply_cmvn,
    spec_augment,
    spec_augment_mask,
    splice,
    stride_subsample,
    strided_len,
)
