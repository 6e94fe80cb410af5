"""The loss DP's wrappers (``dp_forward``, ``dp_backward``) on CPU tensors,
where they take their plain versions: the loss against the literal numpy DP
(``rnnt_loss_numpy``, float64), the channel cotangents against autograd
through the plain alpha loop, and the fused loss's "auto" backend against
its "plain" one.  The CUDA kernels behind the wrappers run only on the
card: tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from pika_tpu_torch.ops.rnnt_loss import (
    dp_backward,
    dp_forward,
    dp_forward_reference,
    rnnt_loss_fused,
    rnnt_loss_numpy,
)

torch.set_num_threads(1)

CASES = {  # (T, U+1, t_len, u_len)
    "ragged": (9, 6, [9, 1, 0, 5], [5, 0, 3, 2]),  # t_len 0 and 1, u_len 0
    "no_labels": (7, 1, [7, 3], [0, 0]),            # U+1 = 1
    "one_frame": (1, 5, [1, 1, 0], [4, 2, 1]),      # T = 1
    "cell": (239, 41, [239, 200, 120, 1], [40, 33, 5, 0]),  # the training cell's T' x (U+1)
}
V = 6


def _lattice(t, u1, t_len, u_len, seed=0):
    """Log-probs (B, T, U+1, V) of a random joint, labels (B, U) in 1..V-1
    and the channel log-probs the DP reads (the emission at u = U is the
    blank's, as the fused loss's trailing label 0 gives)."""
    rng = np.random.default_rng(seed)
    b = len(t_len)
    lp = torch.log_softmax(torch.from_numpy(rng.standard_normal((b, t, u1, V)) * 1.5), -1)
    labels = torch.from_numpy(rng.integers(1, V, (b, u1 - 1)))
    idx = torch.nn.functional.pad(labels, (0, 1))[:, None, :, None].expand(b, t, u1, 1)
    blank_lp = lp[..., 0].float().contiguous()
    emit_lp = torch.gather(lp, -1, idx)[..., 0].float().contiguous()
    return lp.numpy(), labels.numpy(), blank_lp, emit_lp, torch.tensor(t_len), torch.tensor(u_len)


# float32 DP against the float64 oracle: rounding of sums of a few hundred
# terms, each a few nats
LOSS_RTOL = 1e-5
# the cotangents are posteriors (at most 1) times g_loss: the exponent's
# float32 rounding, two orders of summation over about 280 steps of
# alphas and betas of a few hundred nats (ulp 3e-5), moves them by up to
# 1e-4 of g_loss at the cell's shape, their sum over a frame by 3e-4
GRAD_ATOL = 1e-3


@pytest.mark.parametrize("case", list(CASES))
def test_dp_wrappers_match_numpy_and_autograd(case):
    t, u1, t_len, u_len = CASES[case]
    lp, labels, blank_lp, emit_lp, tl, ul = _lattice(t, u1, t_len, u_len)
    loss, alpha = dp_forward(blank_lp, emit_lp, tl, ul)
    assert loss.shape == (len(t_len),) and alpha.shape == blank_lp.shape
    full = tl > 0
    oracle = rnnt_loss_numpy(lp[full.numpy()], labels[full.numpy()], tl[full].numpy(),
                             ul[full].numpy())
    np.testing.assert_allclose(loss[full].numpy(), oracle, rtol=LOSS_RTOL)
    assert torch.equal(loss[~full], torch.zeros(int((~full).sum())))

    g_loss = torch.linspace(-0.5, 1.5, len(t_len))  # MBR weights may be negative
    d_zb, d_zy, d_lse = dp_backward(blank_lp, emit_lp, tl, ul, alpha, loss, g_loss)
    blank_g, emit_g = (x.clone().requires_grad_() for x in (blank_lp, emit_lp))
    (dp_forward_reference(blank_g, emit_g, tl, ul)[0] * g_loss).sum().backward()
    torch.testing.assert_close(d_zb, blank_g.grad, rtol=0, atol=GRAD_ATOL)
    torch.testing.assert_close(d_zy, emit_g.grad, rtol=0, atol=GRAD_ATOL)
    assert torch.equal(d_lse, -(d_zb + d_zy))
    t_pos = torch.arange(t)[None, :, None]
    u_pos = torch.arange(u1)[None, None, :]
    rows = t_pos < tl[:, None, None]
    assert not d_zb[~(rows & (u_pos <= ul[:, None, None]))].any()
    assert not d_zy[~(rows & (u_pos < ul[:, None, None]))].any()
    # each frame of a lattice is crossed by exactly one blank of every path
    occupancy = -d_zb.sum(-1)[full] / g_loss[full, None]
    frames = rows[full, :, 0]
    torch.testing.assert_close(occupancy[frames], torch.ones(int(frames.sum())), rtol=0,
                               atol=GRAD_ATOL)


def test_fused_loss_auto_equals_plain_on_cpu():
    """On CPU tensors the "auto" backend takes the same plain versions as
    "plain" (K1-K3 and the DP): the same losses and gradients, bit for bit."""
    rng = np.random.default_rng(1)
    b, t, u, h, v = 3, 11, 4, 16, 9
    shapes = ((b, t, h), (b, t, h), (b, u + 1, h), (b, u + 1, h), (h, v), (v,))
    factors = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.5) for s in shapes]
    labels = torch.from_numpy(rng.integers(1, v, (b, u)))
    t_len, u_len = torch.tensor([11, 6, 0]), torch.tensor([4, 1, 2])
    out = {}
    for backend in ("auto", "plain"):
        leaves = [x.clone().requires_grad_() for x in factors]
        loss = rnnt_loss_fused(*leaves, labels, t_len, u_len, 32, backend)
        (loss * torch.tensor([1.0, 0.5, 2.0])).sum().backward()
        out[backend] = [loss.detach()] + [x.grad for x in leaves]
    for got, ref in zip(out["auto"], out["plain"]):
        assert torch.equal(got, ref)
    assert out["auto"][0][2].item() == 0.0
