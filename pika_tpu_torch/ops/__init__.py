"""RNN-T loss (forward) and the fused joint-channel kernel K1."""

from pika_tpu_torch.ops.rnnt_kernels import joint_channels, joint_channels_reference
from pika_tpu_torch.ops.rnnt_loss import rnnt_alpha, rnnt_loss_forward, rnnt_loss_numpy
