"""Featurizer and the eval step."""

from pika_tpu_torch.train.step import (
    FeaturizerConfig,
    make_eval_step,
    make_featurizer,
    transducer_loss,
)
