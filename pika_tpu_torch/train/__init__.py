"""Featurizer, optimizers, train step and eval step, the MBR step and the
LAS step."""

from pika_tpu_torch.train.las_step import las_loss, make_las_train_step
from pika_tpu_torch.train.lr import (
    Optimizer,
    clip_by_inf_norm,
    exp_interp_schedule,
    make_optimizer,
)
from pika_tpu_torch.train.mbr import (
    make_mbr_step,
    mbr_decode,
    mbr_losses,
    mbr_risk,
    mbr_surrogate,
)
from pika_tpu_torch.train.step import (
    FeaturizerConfig,
    make_eval_step,
    make_featurizer,
    make_train_step,
    transducer_loss,
)
