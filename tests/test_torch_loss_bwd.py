"""The RNN-T loss's backward in the port (pika_tpu_torch) against the JAX
package, on the same numpy inputs: the backward DP and occupancy, the fused
loss's gradients, and the plain version of K2/K3 against the
interpret-mode Pallas backward (split from tests/test_torch_train.py, the
test names kept).  Tolerances: float32 arithmetic in another order, 1e-5
relative unless a test says otherwise.  Kernels K2/K3 themselves run only on
the card: tests/test_torch_gpu.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pika_tpu.ops.rnnt_loss import (
    _chunk_channels,
    rnnt_alpha as rnnt_alpha_jax,
    rnnt_beta as rnnt_beta_jax,
    rnnt_loss_fused as rnnt_loss_fused_jax,
    rnnt_occupancy as rnnt_occupancy_jax,
)
from pika_tpu.ops.rnnt_pallas import joint_channels_pallas_bwd
from pika_tpu_torch.ops.rnnt_kernels import (
    joint_channels_bwd,
    joint_channels_bwd_in,
    joint_channels_bwd_reference,
    joint_channels_bwd_w,
)
from pika_tpu_torch.ops.rnnt_loss import rnnt_beta, rnnt_loss_fused, rnnt_occupancy

torch.set_num_threads(1)


def _factors(rng, b, t, u1, h, v):
    arrays = [rng.standard_normal(s).astype(np.float32) * 0.5
              for s in ((b, t, h), (b, t, h), (b, u1, h), (b, u1, h))]
    return arrays + [rng.standard_normal((h, v)).astype(np.float32) * 0.2,
                     rng.standard_normal(v).astype(np.float32) * 0.1]


# ---------------------------------------------------------------------------
# the loss's backward
# ---------------------------------------------------------------------------

LENS = [  # (T, U, t_len, u_len): full, ragged, short, empty (t_len = 0)
    (9, 4, [9, 6, 3, 0], [4, 2, 0, 3]),
    (1, 1, [1, 1, 0, 1], [1, 0, 1, 1]),
    (12, 6, [12, 12, 7, 2], [6, 1, 6, 0]),
]


@pytest.mark.parametrize("t,u,t_len,u_len", LENS)
def test_beta_and_occupancy_match_jax(rng, t, u, t_len, u_len):
    b = len(t_len)
    blank = np.log(rng.uniform(0.05, 0.9, (b, t, u + 1))).astype(np.float32)
    emit = np.log(rng.uniform(0.05, 0.9, (b, t, u + 1))).astype(np.float32)
    tl, ul = np.array(t_len, np.int32), np.array(u_len, np.int32)
    j = [jnp.asarray(x) for x in (blank, emit, tl, ul)]
    p = [torch.from_numpy(x) for x in (blank, emit, tl, ul)]
    np.testing.assert_allclose(rnnt_beta(*p).numpy(), np.asarray(jax.jit(rnnt_beta_jax)(*j)),
                               rtol=1e-5, atol=1e-4)
    alpha = jax.jit(rnnt_alpha_jax)(j[0], j[1], j[3])
    ref = jax.jit(lambda b, e, t, u, a: rnnt_occupancy_jax(b, e, None, t, u, alpha=a))(
        j[0], j[1], j[2], j[3], alpha)
    got = rnnt_occupancy(*p, alpha=torch.from_numpy(np.array(alpha)))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
        assert not g[tl <= 0].any()  # empty utterances: no occupancy
    # without alpha given, it is computed
    for r, g in zip(ref, rnnt_occupancy(*p)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend,chunk", [("auto", 32), ("plain", 4), ("plain", 5)])
@pytest.mark.parametrize("t,u,t_len,u_len", LENS)
def test_fused_loss_gradients_match_jax(rng, backend, chunk, t, u, t_len, u_len):
    """Loss and all six gradients against jax.grad of the XLA fused loss,
    weighted per utterance; the empty utterance's loss and gradients are 0."""
    b, h, v = len(t_len), 8, 13
    args = _factors(rng, b, t, u + 1, h, v)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    tl, ul = np.array(t_len, np.int32), np.array(u_len, np.int32)
    weights = rng.uniform(0.5, 2.0, b).astype(np.float32)

    def loss_jax(*a):
        losses = rnnt_loss_fused_jax(*a, jnp.asarray(labels), jnp.asarray(tl), jnp.asarray(ul),
                                     chunk, "xla")
        return (losses * weights).sum(), losses

    (_, ref_losses), ref_grads = jax.jit(jax.value_and_grad(
        loss_jax, argnums=tuple(range(6)), has_aux=True))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    losses = rnnt_loss_fused(*leaves, torch.from_numpy(labels), torch.from_numpy(tl),
                             torch.from_numpy(ul), chunk, backend)
    (losses * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(ref_losses), rtol=1e-5,
                               atol=1e-5)
    for name, leaf, r in zip(("ax", "gx", "ay", "gy", "w2", "b2"), leaves, ref_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    empty = tl <= 0
    assert (losses.detach().numpy()[empty] == 0).all()
    for leaf in leaves[:4]:
        assert not leaf.grad[torch.from_numpy(empty)].any()


@pytest.mark.parametrize("shape", [(1, 20, 6, 16, 40), (2, 13, 5, 24, 37), (2, 1, 1, 8, 16)])
def test_bwd_reference_matches_pallas_interpret(rng, shape):
    """K2/K3's plain version (and the CPU path of their wrappers) against the
    Pallas backward kernels in interpret mode at mm_dtype float32, with
    random channel cotangents (tolerance as tests/test_rnnt_pallas.py:
    1e-4)."""
    b, t, u1, h, v = shape
    args = _factors(rng, b, t, u1, h, v) + [rng.integers(0, v, (b, u1)).astype(np.int32)]
    args[-1][:, -1] = 0  # the last column's label is the blank, as in labels_ext
    jargs = list(map(jnp.asarray, args))
    lse = np.array(_chunk_channels(*jargs)[0])
    cots = [(rng.standard_normal(lse.shape) * 0.1).astype(np.float32) for _ in range(3)]
    ref = jax.jit(lambda *a: joint_channels_pallas_bwd(
        *a, mm_dtype=jnp.float32, block_t=8, block_u=2, block_v=16))(
        *jargs, jnp.asarray(lse), *map(jnp.asarray, cots))
    pt = [torch.from_numpy(x) for x in args + [lse] + cots]
    for got in (joint_channels_bwd_reference(*pt, chunk=4), joint_channels_bwd(*pt),
                joint_channels_bwd_in(*pt) + joint_channels_bwd_w(*pt)):
        for name, r, g in zip(("d_ax", "d_gx", "d_ay", "d_gy", "d_w2", "d_b2"), ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4,
                                       err_msg=name)
