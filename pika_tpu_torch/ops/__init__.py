"""RNN-T loss, the fused joint-channel kernels K1 (forward), K2 and K3
(backward), the loss DP's kernels (forward and backward), the
flash-attention kernel K4 (forward and backward), the pruned RNN-T loss,
and the batched edit distance of the MBR step."""

from pika_tpu_torch.ops.edit_distance import edit_distance_batch
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
    dp_backward,
    dp_backward_reference,
    dp_forward,
    dp_forward_reference,
    rnnt_alpha,
    rnnt_beta,
    rnnt_loss_forward,
    rnnt_loss_fused,
    rnnt_loss_numpy,
    rnnt_occupancy,
)
from pika_tpu_torch.ops.rnnt_pruned import (
    prune_ranges,
    rnnt_alpha_banded,
    rnnt_loss_pruned,
    rnnt_loss_pruned_numpy,
    rnnt_loss_simple,
    simple_channels,
)
