"""RNN-T loss, the fused joint-channel kernels K1 (forward), K2 and K3
(backward), and the flash-attention kernel K4 (forward and backward)."""

from pika_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_di,
    flash_attention_fwd,
    flash_attention_reference,
)
from pika_tpu_torch.ops.rnnt_kernels import (
    joint_channels,
    joint_channels_bwd,
    joint_channels_bwd_in,
    joint_channels_bwd_reference,
    joint_channels_bwd_w,
    joint_channels_bwd_w_reference,
    joint_channels_reference,
)
from pika_tpu_torch.ops.rnnt_loss import (
    rnnt_alpha,
    rnnt_beta,
    rnnt_loss_forward,
    rnnt_loss_fused,
    rnnt_loss_numpy,
    rnnt_occupancy,
)
