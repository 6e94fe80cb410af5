"""Featurizer, optimizers, train step and eval step."""

from pika_tpu_torch.train.lr import (
    Optimizer,
    clip_by_inf_norm,
    exp_interp_schedule,
    make_optimizer,
)
from pika_tpu_torch.train.step import (
    FeaturizerConfig,
    make_eval_step,
    make_featurizer,
    make_train_step,
    transducer_loss,
)
