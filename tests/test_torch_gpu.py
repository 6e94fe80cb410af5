"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Needs a CUDA card and nvcc; skips without a card.  This file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from pika_tpu_torch.ops.rnnt_kernels import joint_channels, joint_channels_reference
from pika_tpu_torch.ops.rnnt_loss import rnnt_loss_forward

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(device, b, t, u1, h, v, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) * 0.5
              for s in ((b, t, h), (b, t, h), (b, u1, h), (b, u1, h))]
    arrays += [rng.standard_normal((h, v)).astype(np.float32) * 0.2,
               rng.standard_normal(v).astype(np.float32) * 0.1,
               rng.integers(0, v, (b, u1)).astype(np.int32)]
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


@pytest.mark.parametrize("shape", [(2, 37, 11, 96, 301), (1, 1, 1, 4, 1), (3, 33, 5, 64, 256),
                                   (2, 8, 3, 1030, 513), (2, 8, 3, 1500, 513),
                                   (1, 6, 3, 2000, 300), (1, 5, 2, 4000, 129)])
def test_k1_matches_reference(cuda_device, shape):
    """K1 against its plain version (both float32, summation order differs):
    1e-4 relative, 1e-4 absolute.  One launch per call.  The H values reach
    each row tile the kernel picks (48, 32, 16 and 8 rows per block)."""
    args = _case(cuda_device, *shape)
    ref = joint_channels_reference(*args)
    before = joint_channels.launches
    got = joint_channels(*args)
    torch.cuda.synchronize()
    assert joint_channels.launches == before + 1
    for name, r, g in zip(("lse", "z_blank", "z_label"), ref, got):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4, msg=name)


def test_k1_rejects_bad_inputs(cuda_device):
    ax, gx, ay, gy, w2, b2, labels = _case(cuda_device, 2, 5, 3, 8, 10)
    with pytest.raises(ValueError, match="contiguous"):
        joint_channels(ax.transpose(0, 1).contiguous().transpose(0, 1), gx, ay, gy, w2, b2, labels)
    with pytest.raises(ValueError, match="labels_ext"):
        joint_channels(ax, gx, ay, gy, w2, b2, labels.long())
    with pytest.raises(ValueError, match="w2"):
        joint_channels(ax, gx, ay, gy, w2.double(), b2, labels)
    with pytest.raises(RuntimeError, match="CUDA error"):  # h tile beyond shared memory
        joint_channels(*_case(cuda_device, 1, 2, 2, 8192, 10))


def test_loss_through_k1_matches_plain(cuda_device):
    ax, gx, ay, gy, w2, b2, labels_ext = _case(cuda_device, 3, 20, 8, 32, 70, seed=1)
    labels = labels_ext[:, :-1].clamp(min=1)
    t_len = torch.tensor([20, 11, 0], device=cuda_device)
    u_len = torch.tensor([7, 4, 2], device=cuda_device)
    got = rnnt_loss_forward(ax, gx, ay, gy, w2, b2, labels, t_len, u_len)
    ref = rnnt_loss_forward(ax, gx, ay, gy, w2, b2, labels, t_len, u_len, backend="plain")
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
    assert got[2].item() == 0.0
