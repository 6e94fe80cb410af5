"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Needs a CUDA card and nvcc; skips without a card.  This file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from pika_tpu_torch.ops.rnnt_kernels import (
    joint_channels,
    joint_channels_bwd,
    joint_channels_bwd_in,
    joint_channels_bwd_reference,
    joint_channels_bwd_w,
    joint_channels_reference,
)
from pika_tpu_torch.ops.rnnt_loss import rnnt_loss_forward, rnnt_loss_fused

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


def _bwd_case(device, b, t, u1, h, v, seed=0):
    """Inputs of K2/K3: the factors, K1's lse, and random channel cotangents."""
    args = _case(device, b, t, u1, h, v, seed)
    lse = joint_channels_reference(*args)[0]
    gen = torch.Generator(device).manual_seed(seed + 1)
    cots = tuple(torch.randn(lse.shape, generator=gen, device=device) * 0.1 for _ in range(3))
    return args + (lse,) + cots


def _assert_grads_close(got, ref, rtol):
    """Each gradient within ``rtol`` of its largest reference entry, elementwise
    (float32 sums over up to B*T*U1 cells in another order)."""
    for name, g, r in zip(("d_ax", "d_gx", "d_ay", "d_gy", "d_w2", "d_b2"), got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32, name
        scale = max(r.abs().max().item(), 1e-6)
        err = (g - r).abs().max().item()
        assert err <= rtol * scale, f"{name}: max abs err {err} vs {rtol} x {scale}"


@pytest.mark.parametrize("shape", [(2, 37, 11, 96, 301), (1, 1, 1, 4, 1), (2, 1, 5, 64, 100),
                                   (2, 9, 1, 64, 100), (3, 33, 5, 64, 256),
                                   (2, 8, 3, 1030, 513), (2, 8, 3, 1500, 513),
                                   (1, 6, 3, 2000, 300), (1, 5, 2, 3100, 129)])
def test_k2_k3_match_reference(cuda_device, shape):
    """K2 and K3 against the plain chunked vjp: every gradient within 1e-4 of
    its largest entry.  One launch of each per call.  The H values reach each
    row tile K2 picks (24, 16 and 8 cells per block), K3's 48-, 32- and
    16-row chunks and its second pass over H (H > 1024); T = 1, U1 = 1,
    V = 1 and V not a multiple of either V tile are the degenerate shapes."""
    args = _bwd_case(cuda_device, *shape)
    ref = joint_channels_bwd_reference(*args)
    before = (joint_channels_bwd_in.launches, joint_channels_bwd_w.launches)
    got = joint_channels_bwd(*args)
    torch.cuda.synchronize()
    assert (joint_channels_bwd_in.launches, joint_channels_bwd_w.launches) == (
        before[0] + 1, before[1] + 1)
    _assert_grads_close(got, ref, 1e-4)


def test_k2_k3_blank_is_label(cuda_device):
    """Where labels_ext is 0 the blank and label cotangents both land on
    column 0."""
    args = list(_bwd_case(cuda_device, 2, 7, 4, 32, 50))
    args[6] = torch.zeros_like(args[6])
    _assert_grads_close(joint_channels_bwd(*args), joint_channels_bwd_reference(*args), 1e-4)


def test_k2_k3_reject_bad_inputs(cuda_device):
    args = list(_bwd_case(cuda_device, 2, 5, 3, 8, 10))
    bad = dict(enumerate(args))
    for i, x, match in ((0, args[0].transpose(0, 1).contiguous().transpose(0, 1), "contiguous"),
                        (6, args[6].long(), "labels_ext"), (4, args[4].double(), "w2"),
                        (8, args[8][:, :-1], "d_lse"), (7, args[7].cpu(), "lse")):
        for fn in (joint_channels_bwd, joint_channels_bwd_in, joint_channels_bwd_w):
            with pytest.raises(ValueError, match=match):
                fn(*{**bad, i: x}.values())
    with pytest.raises(RuntimeError, match="CUDA error"):  # h and dh tiles beyond shared memory
        joint_channels_bwd(*_bwd_case(cuda_device, 1, 2, 2, 4000, 10))


def test_loss_gradients_through_kernels_match_plain(cuda_device):
    """Autograd through K1, K2 and K3 against the plain backend, with empty
    and short utterances: losses to 1e-5, gradients within 1e-4 of their
    largest entry; the empty utterance's gradients are exactly 0."""
    ax, gx, ay, gy, w2, b2, labels_ext = _case(cuda_device, 3, 20, 8, 32, 70, seed=2)
    labels = labels_ext[:, :-1].clamp(min=1)
    t_len = torch.tensor([20, 11, 0], device=cuda_device)
    u_len = torch.tensor([7, 4, 2], device=cuda_device)
    out = {}
    for backend in ("auto", "plain"):
        leaves = [x.clone().requires_grad_() for x in (ax, gx, ay, gy, w2, b2)]
        loss = rnnt_loss_fused(*leaves, labels, t_len, u_len, 8, backend)
        loss.sum().backward()
        out[backend] = (loss.detach(), [x.grad for x in leaves])
    torch.testing.assert_close(out["auto"][0], out["plain"][0], rtol=1e-5, atol=1e-4)
    _assert_grads_close(out["auto"][1], out["plain"][1], 1e-4)
    for g in out["auto"][1][:4]:
        assert torch.count_nonzero(g[2]) == 0
